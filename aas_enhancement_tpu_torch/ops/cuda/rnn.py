"""Bidirectional masked LSTM and GRU recurrences: CUDA kernels
(``csrc/lstm_tm.cu``, ``csrc/gru_tm.cu``), forward and backward, and their
plain versions.

Replace ``aas_enhancement_tpu/ops/pallas/rnn_kernel.py::lstm_scan_tm`` and
``::gru_scan_tm`` with their VJPs.  Interface as there: gxf, gxb [T, B, G*H]
in natural time order (the two halves of the hoisted input product), m
[T, B], wh [2, H, G*H], bh [2, G*H] -> (yf, yb) [T, B, H], where yb[t] is the
backward direction's output at time t; G = 4 (LSTM) or 3 (GRU).

``lstm_scan_tm`` / ``gru_scan_tm`` take the plain version for CPU tensors
(autograd differentiates it).  For CUDA tensors they launch the inference
kernel, which saves nothing (through the operators ``aas_torch::lstm_scan_tm``
/ ``::gru_scan_tm`` of ``ops/library.py``, which take the plain version on
the CPU), or, when a gradient is wanted, a
``torch.autograd.Function`` whose forward is the training variant of the
same kernel (it also saves the pre-update states and the gate activations)
and whose backward launches the backward kernel (``lstm_scan_tm_bwd`` /
``gru_scan_tm_bwd``).  Each wrapper counts its kernel launches in
``.launches``: the forward wrappers both forward variants, the ``_bwd``
wrappers the backward kernels.

``lstm_scan_stacked`` / ``gru_scan_stacked`` replace ``::lstm_scan_pallas``
and ``::gru_scan_pallas`` with their VJPs: the same recurrences on the
stacked layout gx [T, 2, B, G*H], m [T, 2, B] -> y [T, 2, B, H], whose
direction 1 the caller has already flipped in time, so both directions walk
t = 0..T-1.  The same device code serves both layouts through explicit
strides (``csrc/rnn_bwd.cuh``): the stacked entries read gx and write y and
dgx in place, with no copy into the time-major layout.  The host code is
shared too (``_forward``, ``_backward``, ``_ScanFn``): an entry's name says
which cell and which layout.  The stacked entries have their own wrappers
and launch counts (``lstm_scan_stacked_bwd``, ``gru_scan_stacked_bwd``).
The plain versions of the time-major entries are the stacked plain versions
on a flipped copy.

Both forwards have two device routes, chosen by the shape alone
(``lstm_resident_cluster``, ``gru_resident_cluster``).  Where a thread-block
cluster of blocks of at most 32 hidden units each can hold wh[d] in shared
memory the resident kernel runs: wh[d] is read once per call and h travels
between the blocks through distributed shared memory.  The LSTM takes
clusters of at most 8 blocks (H = 256: 8 blocks of 128 KB), the GRU, with
three gates, of at most 16 (H = 512: 16 blocks of 192 KB).  Otherwise (an
LSTM at H = 512, either cell at H = 1024) the streaming kernel runs, which
reads wh[d] from L2 every step.  The backwards take the forward's route at
the same width (``bwd_resident_cluster``): the resident backward keeps each
block's gate columns of wh[d] in registers and reduce-scatters the partial dh
through distributed shared memory; the streaming backward reads whT from L2
every step.  A route is no fallback: a resident launch that is refused
raises.  Each wrapper's ``.route``, forward and backward, holds the route of
its last launch: the cluster size, or 0 for streaming.

The streams (gx, y, their cotangents dy and dgx, what the training forward
saves of the state, and the GRU's dgh) are float32, or bfloat16 (the bf16
models; each wrapper's ``.dtype`` holds its last launch's): the kernels and
the plain versions then run a step as the Pallas kernels do with bf16
streams, gx widened to f32, h rounded to bf16 before the recurrent product
(its state stays f32), f32 sums, bias, c and cell math, and y rounded to
bf16.  wh and bh stay float32 arguments; the bf16 model passes them rounded
through bf16 (``ops/rnn.py``), so each product is exact in f32.  At bf16 the
backward kernels follow the Pallas VJP (``rnn_kernel.py``): the training
forward saves h (and the LSTM's c) rounded to bf16, the cell backward reads
them so, with f32 math, the gate gradient is rounded to bf16 before the dh
product and on its store (dgx, dgh), dh and dc are carried in f32, and dWh,
dbh are f32 sums of the saved bf16 h and the bf16 gate gradient, computed
by ``torch.bmm`` on float32 copies (outside the kernel, as JAX computes them
outside its Pallas kernel).  The activations the port saves besides stay
float32; the Pallas VJP recomputes them from the same rounded h.

The plain versions' autograd at bf16 rounds where the Pallas VJP does at the
recurrent product (``_Bf16Product``: dh and dWh from the gate gradient
rounded to bf16, dh summed in f32) and at gx (its gradient rounded to bf16),
but its cell backward reads the f32 state of its own forward where the
Pallas VJP (and the kernels) read the bf16 copies of h and c: the two part
by a bf16 rounding of those terms.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build


# The resident forward kernels' limits (csrc/lstm_tm.cu, csrc/gru_tm.cu):
# shared memory a block may use on Hopper, and most hidden units of a block
# (two per warp).
_SMEM_LIMIT = 232448
_RES_UNITS = 32
STREAM_DTYPES = (torch.float32, torch.bfloat16)


def lstm_resident_cluster(h_dim: int) -> int:
    """The LSTM forward's route for hidden width ``h_dim``: the smallest
    cluster size C of 1, 2, 4, 8 (the portable sizes) that divides H into an
    even number U = H / C <= 32 of hidden units a block (a warp per two
    units) and whose blocks can each hold their slice of wh[d] (H padded to a
    multiple of 16, x 4U), h of a tile's rows twice and two mbarriers in
    shared memory; 0, the streaming kernel, where none does.  H = 16, 32 ->
    1, 64 -> 2, 128 -> 4, 256 -> 8, 512 -> 0.  Pure arithmetic on the shape,
    the same as the kernel's host code does (``res_smem``)."""
    chunks = -(-h_dim // 16)
    for c in (1, 2, 4, 8):
        u = h_dim // c
        if h_dim < 2 or h_dim % c or u % 2 or u > _RES_UNITS:
            continue
        if 16 * (u * chunks * 16 + 2 * 16 * chunks + 1) <= _SMEM_LIMIT:
            return c
    return 0


def gru_resident_cluster(h_dim: int) -> int:
    """The GRU forward's route for hidden width ``h_dim``: the smallest
    cluster size C of 1, 2, 4, 8, 16 (16 is above the portable size: the
    launcher asks for it) that divides H into an even number U = H / C <= 32
    of hidden units a block and whose blocks can each hold their slice of
    wh[d] (12 bytes per unit and input, H padded to a multiple of 64 inputs),
    h of a tile's rows twice (16 bytes per input) and two mbarriers in shared
    memory; 0, the streaming kernel, where none does.  H = 8, 16, 32 -> 1,
    64 -> 2, 128 -> 4, 256 -> 8, 320 and 512 -> 16, 250 and 1024 -> 0.  Pure
    arithmetic on the shape, the same as the kernel's host code does
    (``res_smem``)."""
    padded = 64 * -(-h_dim // 64)
    for c in (1, 2, 4, 8, 16):
        u = h_dim // c
        if h_dim < 2 or h_dim % c or u % 2 or u > _RES_UNITS:
            continue
        if 12 * u * padded + 32 * padded + 16 <= _SMEM_LIMIT:
            return c
    return 0


def bwd_resident_cluster(cell: str, h_dim: int) -> int:
    """The backward's route for ``cell`` ("lstm" or "gru") at width ``h_dim``:
    the forward's (``lstm_resident_cluster`` / ``gru_resident_cluster``).  The
    resident backward's own limits hold wherever the forward is resident (at
    most 32 units a block, so LSTM H <= 256, GRU H <= 512): one thread per
    input of dh (LSTM, 128 weights) or per two (GRU, 192), at least 128 and at
    most 256 threads of 255 registers; shared memory 16 (2 H + 2 x gates x 32)
    + 16 bytes.  The kernel's host code checks them (``res_bwd_config``).  The
    LSTM at H = 512 streams in both passes."""
    return (lstm_resident_cluster if cell == "lstm" else gru_resident_cluster)(h_dim)


def resident_clusters_at_once(cell: str, h_dim: int, cluster: int | None = None,
                              save: bool = False, backward: bool = False) -> int:
    """How many clusters of the resident forward kernel of ``cell`` ("lstm" or
    "gru"; ``save``: its training variant), or with ``backward`` of its
    resident backward, the card can run at once at width ``h_dim``, as
    ``cudaOccupancyMaxActiveClusters`` counts them; raises where the shape has
    no resident route or the card can schedule no such cluster.  More tiles
    of rows than that run in waves."""
    if cluster is None:
        cluster = (lstm_resident_cluster if cell == "lstm" else gru_resident_cluster)(h_dim)
    entry = f"aas_{cell}_res_clusters"
    n = getattr(kernel_build.load_library(), entry)(cluster, 2 if backward else int(save),
                                                     h_dim)
    if n < 1:
        raise RuntimeError(f"{entry} (clusters of {cluster}, H = {h_dim}): CUDA error {-n}")
    return n


class _Bf16Product(torch.autograd.Function):
    """h @ wh + bh of a bf16 step: h [2, B, H] rounded to ``stream``, f32
    products and sums.  Its backward rounds the gate gradient dg to
    ``stream`` before both products (dh = dg wh^T and dWh = h^T dg, f32
    sums), as the Pallas VJP does; dbh sums the rounded dg."""

    @staticmethod
    def forward(ctx, h, wh, bh, stream):
        hd = h.to(stream).float()
        ctx.save_for_backward(hd, wh)
        ctx.stream = stream
        return torch.bmm(hd, wh) + bh[:, None, :]

    @staticmethod
    def backward(ctx, dg):
        hd, wh = ctx.saved_tensors
        dgd = dg.to(ctx.stream).float()
        return (torch.bmm(dgd, wh.transpose(1, 2)), torch.bmm(hd.transpose(1, 2), dgd),
                dgd.sum(dim=1), None)


def _recurrent(h: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor,
               stream: torch.dtype) -> torch.Tensor:
    """The recurrent product h @ wh + bh as a step reads it (module docstring):
    f32, or at a bf16 stream ``_Bf16Product``."""
    if stream == torch.float32:
        return torch.bmm(h, wh) + bh[:, None, :]
    return _Bf16Product.apply(h, wh, bh, stream)


def lstm_scan_stacked_plain(gx: torch.Tensor, m: torch.Tensor, wh: torch.Tensor,
                            bh: torch.Tensor) -> torch.Tensor:
    """Per-step loop over gx [T, 2, B, 4H] with the state [2, B, H] of both
    directions; y in gx's dtype (module docstring)."""
    t_len, _, b, g4 = gx.shape
    h_dim = g4 // 4
    stream = gx.dtype
    h = gx.new_zeros((2, b, h_dim), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = []
    for s in range(t_len):
        m_t = m[s][..., None]
        gg = gx[s].float() + _recurrent(h, wh, bh, stream)
        i, f, gc, o = gg.split(h_dim, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gc)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = m_t * h_new + (1.0 - m_t) * h
        c = m_t * c_new + (1.0 - m_t) * c
        ys.append(h_new * m_t)
    return torch.stack(ys).to(stream)


def to_stacked(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Time-major inputs -> the stacked layout: direction 1 flipped in time."""
    return (torch.stack([gxf, gxb.flip(0)], dim=1),
            torch.stack([m, m.flip(0)], dim=1))


def lstm_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                       wh: torch.Tensor, bh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked plain version on direction 1 flipped in time."""
    ys = lstm_scan_stacked_plain(*to_stacked(gxf, gxb, m), wh, bh)
    return ys[:, 0], ys[:, 1].flip(0)


def lstm_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                 wh: torch.Tensor, bh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional LSTM, time-major (see module docstring).  Without a
    wanted gradient, the operator ``aas_torch::lstm_scan_tm``
    (``ops/library.py``: ``scan_kernel`` on the card, the plain version on
    the CPU)."""
    if _wants_grad(gxf, gxb, wh, bh):
        if uses_kernel("lstm_scan_tm", gxf):
            return _ScanFn.apply("lstm_scan_tm", m, wh, bh, gxf, gxb)
        return lstm_scan_tm_plain(gxf, gxb, m, wh, bh)
    return library.lstm_scan_tm(gxf, gxb, m, wh, bh)


lstm_scan_tm.launches = 0
lstm_scan_tm.route = None
lstm_scan_tm.dtype = None


def gru_scan_stacked_plain(gx: torch.Tensor, m: torch.Tensor, wh: torch.Tensor,
                           bh: torch.Tensor) -> torch.Tensor:
    """Per-step loop over gx [T, 2, B, 3H] with the state [2, B, H] of both
    directions; y in gx's dtype (module docstring)."""
    t_len, _, b, g3 = gx.shape
    h_dim = g3 // 3
    stream = gx.dtype
    h = gx.new_zeros((2, b, h_dim), dtype=torch.float32)
    ys = []
    for s in range(t_len):
        m_t = m[s][..., None]
        gh = _recurrent(h, wh, bh, stream)          # bh's n-slice: r * (...)
        xr, xz, xn = gx[s].float().split(h_dim, dim=-1)
        hr, hz, hn = gh.split(h_dim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        ys.append(m_t * h_new)
        h = m_t * h_new + (1.0 - m_t) * h
    return torch.stack(ys).to(stream)


def gru_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stacked plain version on direction 1 flipped in time."""
    ys = gru_scan_stacked_plain(*to_stacked(gxf, gxb, m), wh, bh)
    return ys[:, 0], ys[:, 1].flip(0)


def gru_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional GRU, time-major (see module docstring).  Without a
    wanted gradient, the operator ``aas_torch::gru_scan_tm``
    (``ops/library.py``: ``scan_kernel`` on the card, the plain version on
    the CPU)."""
    if _wants_grad(gxf, gxb, wh, bh):
        if uses_kernel("gru_scan_tm", gxf):
            return _ScanFn.apply("gru_scan_tm", m, wh, bh, gxf, gxb)
        return gru_scan_tm_plain(gxf, gxb, m, wh, bh)
    return library.gru_scan_tm(gxf, gxb, m, wh, bh)


gru_scan_tm.launches = 0
gru_scan_tm.route = None
gru_scan_tm.dtype = None


def lstm_scan_stacked(gx: torch.Tensor, m: torch.Tensor, wh: torch.Tensor,
                      bh: torch.Tensor) -> torch.Tensor:
    """Fused bidirectional LSTM on the stacked layout (see module docstring)."""
    if not uses_kernel("lstm_scan_stacked", gx):
        return lstm_scan_stacked_plain(gx, m, wh, bh)
    return _scan("lstm_scan_stacked", (gx,), m, wh, bh)


lstm_scan_stacked.launches = 0
lstm_scan_stacked.route = None
lstm_scan_stacked.dtype = None


def gru_scan_stacked(gx: torch.Tensor, m: torch.Tensor, wh: torch.Tensor,
                     bh: torch.Tensor) -> torch.Tensor:
    """Fused bidirectional GRU on the stacked layout (see module docstring)."""
    if not uses_kernel("gru_scan_stacked", gx):
        return gru_scan_stacked_plain(gx, m, wh, bh)
    return _scan("gru_scan_stacked", (gx,), m, wh, bh)


gru_scan_stacked.launches = 0
gru_scan_stacked.route = None
gru_scan_stacked.dtype = None

_FORWARD = {"lstm_scan_tm": lstm_scan_tm, "gru_scan_tm": gru_scan_tm,
            "lstm_scan_stacked": lstm_scan_stacked, "gru_scan_stacked": gru_scan_stacked}


def _wants_grad(*xs: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _scan(name: str, gx: tuple[torch.Tensor, ...], m: torch.Tensor,
          wh: torch.Tensor, bh: torch.Tensor):
    """The kernel route of a stacked entry ``name`` (gx is (gx,)) -> y."""
    if _wants_grad(*gx, wh, bh):
        return _ScanFn.apply(name, m, wh, bh, *gx)
    return scan_kernel(name, gx, m, wh, bh)


def scan_kernel(name: str, gx: tuple[torch.Tensor, ...], m: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor):
    """The inference forward kernel of entry ``name`` (the CUDA
    implementation of the operators ``aas_torch::lstm_scan_tm`` and
    ``::gru_scan_tm``): gx is (gxf, gxb) for a time-major entry and (gx,)
    for a stacked one; -> (yf, yb) or y."""
    ys, _ = _forward(name, gx, m, wh, bh, save=False)
    return ys[0] if len(ys) == 1 else ys


def _gates(name: str) -> int:
    return 4 if name.startswith("lstm") else 3


def _halves(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two directions of a stacked tensor [T, 2, B, .]."""
    return x[:, 0], x[:, 1]


def _forward(name: str, gx: tuple[torch.Tensor, ...], m: torch.Tensor,
             wh: torch.Tensor, bh: torch.Tensor, save: bool, route: int | None = None
             ) -> tuple[tuple[torch.Tensor, ...], tuple[torch.Tensor, ...]]:
    """Check what the forward kernels take, raise otherwise, and launch the
    inference variant, or with ``save`` the training variant -> (ys, saved):
    (yf, yb) [T, B, H] for the time-major gx (gxf, gxb), (y,) [T, 2, B, H] for
    the stacked (gx,); saved is what the backward kernel reads, one layout
    for both: h [2, T, B, H], for the LSTM also c [2, T, B, H], and the gate
    activations [2, T, B, 4H].  The route (cluster size, 0 = streaming)
    follows from H (``lstm_resident_cluster``, ``gru_resident_cluster``);
    ``route`` overrides it for measurements that set the two kernels side by
    side.  gx, y and the saved h and c are float32 or bfloat16 (the
    activations float32)."""
    dtype = check_kernel_inputs(name, (m, wh, bh), streams=gx, stream_dtypes=STREAM_DTYPES)
    gates, stacked = _gates(name), len(gx) == 1
    if stacked:
        if gx[0].ndim != 4 or gx[0].shape[1] != 2 or m.shape != gx[0].shape[:3]:
            raise ValueError(f"{name}: shapes gx {tuple(gx[0].shape)} m {tuple(m.shape)}: "
                             "need [T, 2, B, G*H] and [T, 2, B]")
        if not gx[0].is_contiguous():
            raise ValueError(f"{name}: gx must be contiguous")
        gx0, gx1 = _halves(gx[0])
    else:
        gx0, gx1 = gx
        if gx0.ndim != 3 or gx1.shape != gx0.shape or m.shape != gx0.shape[:2]:
            raise ValueError(
                f"{name}: shapes gxf {tuple(gx0.shape)} gxb {tuple(gx1.shape)} "
                f"m {tuple(m.shape)} wh {tuple(wh.shape)} bh {tuple(bh.shape)}")
        if gx0.stride() != gx1.stride() or gx0.stride(2) != 1:
            raise ValueError(f"{name}: gxf/gxb need unit last stride and equal strides")
    t_len, b, g = gx0.shape
    h_dim = g // gates
    if g % gates or wh.shape != (2, h_dim, g) or bh.shape != (2, g):
        raise ValueError(f"{name}: shapes wh {tuple(wh.shape)} bh {tuple(bh.shape)} "
                         f"for {g} gate features")
    if not (m.is_contiguous() and wh.is_contiguous() and bh.is_contiguous()):
        raise ValueError(f"{name}: m, wh, bh must be contiguous")
    if gates == 3 and (h_dim % 4 or wh.data_ptr() % 16 or bh.data_ptr() % 16):
        raise ValueError(f"{name}: needs H % 4 == 0 and 16-byte aligned wh, bh "
                         "(the kernel reads them as float4)")

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=gx0.device)

    if stacked:
        ys = (empty(t_len, 2, b, h_dim, dtype=dtype),)
        y0, y1 = _halves(ys[0])
    else:
        ys = y0, y1 = empty(t_len, b, h_dim, dtype=dtype), empty(t_len, b, h_dim, dtype=dtype)
    n_saved = gates - 1                                   # h, (c,) activations
    saved = ()
    if save:
        saved = (*(empty(2, t_len, b, h_dim, dtype=dtype) for _ in range(n_saved - 1)),
                 empty(2, t_len, b, 4 * h_dim))
    entry = f"aas_{name.split('_')[0]}_fwd"
    if route is None:
        route = (lstm_resident_cluster if gates == 4 else gru_resident_cluster)(h_dim)
    what = f"{entry} (" + (f"resident, clusters of {route}" if route else "streaming") + ")"
    err = getattr(kernel_build.load_library(), entry)(
        gx0.data_ptr(), gx1.data_ptr(), gx0.stride(0), gx0.stride(1),
        m.data_ptr(), wh.data_ptr(), bh.data_ptr(), y0.data_ptr(), y1.data_ptr(),
        *([x.data_ptr() for x in saved] or [None] * n_saved), int(stacked), route,
        int(dtype == torch.bfloat16), t_len, b, h_dim,
        torch.cuda.current_stream(gx0.device).cuda_stream)
    kernel_build.check(err, what)
    _FORWARD[name].launches += 1
    _FORWARD[name].route = route
    _FORWARD[name].dtype = dtype
    return ys, saved


def _backward(name: str, m: torch.Tensor, wh: torch.Tensor,
              saved: tuple[torch.Tensor, ...], dys: tuple[torch.Tensor, ...],
              need_dwh: bool, route: int | None = None
              ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor | None,
                         torch.Tensor | None]:
    """Launch the backward kernel of entry ``name`` on what its training
    forward saved and the cotangents dys, (dyf, dyb) or the stacked (dy,) ->
    (dgx, dwh [2, H, G*H], dbh [2, G*H]) with dgx (dgxf, dgxb) [T, B, G*H] or
    the stacked (dgx,) [T, 2, B, G*H].  dwh and dbh are None unless
    ``need_dwh``; without it the GRU kernel writes no dgh (a frozen GRU).
    The route (cluster size, 0 = streaming) follows from H
    (``bwd_resident_cluster``); ``route`` overrides it for measurements that
    set the two kernels side by side.  The stream dtype is the saved h's:
    dys must have it, dgx (and dgh) get it; dwh and dbh are float32."""
    gates, stacked = _gates(name), len(dys) == 1
    hp, acts = saved[0], saved[-1]
    _, t_len, b, h_dim = hp.shape
    dtype = check_kernel_inputs(f"{name}_bwd", (m, wh, acts), streams=(*saved[:-1], *dys),
                                stream_dtypes=STREAM_DTYPES)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=hp.device)

    g = gates * h_dim
    dgx = empty(t_len, 2, b, g) if stacked else empty(2, t_len, b, g)
    dys = tuple(dy.contiguous() for dy in dys)
    dy0, dy1 = _halves(dys[0]) if stacked else dys
    # The LSTM kernel reads c and the activations, the GRU kernel h and the
    # activations, and the GRU's dWh needs dgh [2, T, B, 3H] beside dgx (its
    # n-slice differs); the LSTM's dWh reads dgx itself.
    state = saved[1] if gates == 4 else hp
    dgh = empty(2, t_len, b, g) if gates == 3 and need_dwh else None
    extra = (dgh.data_ptr() if dgh is not None else None,) if gates == 3 else ()
    cell = name.split("_")[0]
    if route is None:
        route = bwd_resident_cluster(cell, h_dim)
    # The resident kernel reads its blocks' columns of wh itself; the
    # streaming kernel reads rows of whT.
    w = wh if route else _transposed(wh)
    entry = f"aas_{cell}_bwd"
    what = f"{entry} (" + (f"resident, clusters of {route}" if route else "streaming") + ")"
    err = getattr(kernel_build.load_library(), entry)(
        m.data_ptr(), w.data_ptr(), state.data_ptr(), acts.data_ptr(),
        dy0.data_ptr(), dy1.data_ptr(), dgx.data_ptr(), *extra, int(stacked), route,
        int(dtype == torch.bfloat16), t_len, b, h_dim,
        torch.cuda.current_stream(hp.device).cuda_stream)
    kernel_build.check(err, what)
    _BACKWARD[name].launches += 1
    _BACKWARD[name].route = route
    _BACKWARD[name].dtype = dtype
    dwh = dbh = None
    if need_dwh:
        dg = dgh if gates == 3 else dgx.transpose(0, 1) if stacked else dgx
        dwh, dbh = _weight_grads(hp, dg)
    return ((dgx,) if stacked else (dgx[0], dgx[1])), dwh, dbh


def _transposed(wh: torch.Tensor) -> torch.Tensor:
    """whT [2, G, H], contiguous, which the streaming backward kernels read as
    float4."""
    wh_t = wh.detach().transpose(1, 2).contiguous()
    if wh_t.shape[2] % 4 or wh_t.data_ptr() % 16:
        raise ValueError(f"backward: needs H % 4 == 0 and a 16-byte aligned whT, "
                         f"got whT {tuple(wh_t.shape)}")
    return wh_t


def _weight_grads(hp: torch.Tensor, dg: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """dWh[d] = sum_t h_prev[d, t]^T dg[d, t] and dbh[d] = sum_t dg[d, t], for
    hp [2, T, B, H] and dg [2, T, B, G] (a transposed view is copied), f32
    sums (of float32 copies of bf16 streams)."""
    two, t_len, b, h_dim = hp.shape
    g = dg.shape[-1]
    hp, dg = hp.float(), dg.float()
    dwh = torch.bmm(hp.reshape(two, t_len * b, h_dim).transpose(1, 2),
                    dg.reshape(two, t_len * b, g))
    return dwh, dg.sum(dim=(1, 2))


def lstm_scan_tm_bwd(m, wh, saved, dys, need_dwh: bool = True):
    """Backward kernel B1' (``_backward``): dys (dyf, dyb) -> ((dgxf, dgxb), dwh, dbh)."""
    return _backward("lstm_scan_tm", m, wh, saved, dys, need_dwh)


def gru_scan_tm_bwd(m, wh, saved, dys, need_dwh: bool = True):
    """Backward kernel B2' (``_backward``): dys (dyf, dyb) -> ((dgxf, dgxb), dwh, dbh)."""
    return _backward("gru_scan_tm", m, wh, saved, dys, need_dwh)


def lstm_scan_stacked_bwd(m, wh, saved, dys, need_dwh: bool = True):
    """The backward kernel of B7 (``_backward``): dys (dy,) -> ((dgx,), dwh, dbh)."""
    return _backward("lstm_scan_stacked", m, wh, saved, dys, need_dwh)


def gru_scan_stacked_bwd(m, wh, saved, dys, need_dwh: bool = True):
    """The backward kernel of B7' (``_backward``): dys (dy,) -> ((dgx,), dwh, dbh)."""
    return _backward("gru_scan_stacked", m, wh, saved, dys, need_dwh)


_BACKWARD = {"lstm_scan_tm": lstm_scan_tm_bwd, "gru_scan_tm": gru_scan_tm_bwd,
             "lstm_scan_stacked": lstm_scan_stacked_bwd,
             "gru_scan_stacked": gru_scan_stacked_bwd}
for _fn in _BACKWARD.values():
    _fn.launches = 0
    _fn.route = None
    _fn.dtype = None


class _ScanFn(torch.autograd.Function):
    """Entry ``name``'s training forward and backward kernels; gx is
    (gxf, gxb) or the stacked (gx,)."""

    @staticmethod
    def forward(ctx, name, m, wh, bh, *gx):
        ys, saved = _forward(name, gx, m, wh, bh, save=True)
        ctx.save_for_backward(m, wh, *saved)
        ctx.name = name
        return ys[0] if len(ys) == 1 else ys

    @staticmethod
    def backward(ctx, *dys):
        m, wh, *saved = ctx.saved_tensors
        need_wh, need_bh = ctx.needs_input_grad[2:4]
        dgx, dwh, dbh = _BACKWARD[ctx.name](m, wh, tuple(saved), dys,
                                            need_dwh=need_wh or need_bh)
        return (None, None, dwh if need_wh else None, dbh if need_bh else None, *dgx)
