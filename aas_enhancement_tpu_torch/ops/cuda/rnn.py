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
kernel, which saves nothing, or, when a gradient is wanted, a
``torch.autograd.Function`` whose forward is the training variant of the
same kernel (it also saves the pre-update states and the gate activations)
and whose backward launches the backward kernel (``lstm_scan_tm_bwd`` /
``gru_scan_tm_bwd``).  Each wrapper counts its kernel launches in
``.launches``: the forward wrappers both forward variants, the ``_bwd``
wrappers the backward kernels.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build


def lstm_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                       wh: torch.Tensor, bh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop with both directions stacked on one [2, B, H] state."""
    t_len, b, g4 = gxf.shape
    h_dim = g4 // 4
    h = gxf.new_zeros((2, b, h_dim))
    c = gxf.new_zeros((2, b, h_dim))
    ys_f, ys_b = [], []
    for s in range(t_len):
        tb = t_len - 1 - s                       # direction 1 walks backwards
        gx_t = torch.stack([gxf[s], gxb[tb]])
        m_t = torch.stack([m[s], m[tb]])[..., None]
        gg = gx_t + (torch.bmm(h, wh) + bh[:, None, :])
        i, f, gc, o = gg.split(h_dim, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gc)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = m_t * h_new + (1.0 - m_t) * h
        c = m_t * c_new + (1.0 - m_t) * c
        y = h_new * m_t
        ys_f.append(y[0])
        ys_b.append(y[1])
    return torch.stack(ys_f), torch.stack(ys_b[::-1])


def lstm_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                 wh: torch.Tensor, bh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional LSTM, time-major (see module docstring)."""
    if not uses_kernel("lstm_scan_tm", gxf):
        return lstm_scan_tm_plain(gxf, gxb, m, wh, bh)
    if _wants_grad(gxf, gxb, wh, bh):
        return _LSTMFn.apply(gxf, gxb, m, wh, bh)
    yf, yb, _ = _forward("lstm_scan_tm", 4, gxf, gxb, m, wh, bh, save=False)
    return yf, yb


lstm_scan_tm.launches = 0


def gru_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop with both directions stacked on one [2, B, H] state."""
    t_len, b, g3 = gxf.shape
    h_dim = g3 // 3
    h = gxf.new_zeros((2, b, h_dim))
    ys_f, ys_b = [], []
    for s in range(t_len):
        tb = t_len - 1 - s                       # direction 1 walks backwards
        gx_t = torch.stack([gxf[s], gxb[tb]])
        m_t = torch.stack([m[s], m[tb]])[..., None]
        gh = torch.bmm(h, wh) + bh[:, None, :]   # bh's n-slice stays inside r * (...)
        xr, xz, xn = gx_t.split(h_dim, dim=-1)
        hr, hz, hn = gh.split(h_dim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        y = m_t * h_new
        h = m_t * h_new + (1.0 - m_t) * h
        ys_f.append(y[0])
        ys_b.append(y[1])
    return torch.stack(ys_f), torch.stack(ys_b[::-1])


def gru_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional GRU, time-major (see module docstring)."""
    if not uses_kernel("gru_scan_tm", gxf):
        return gru_scan_tm_plain(gxf, gxb, m, wh, bh)
    if _wants_grad(gxf, gxb, wh, bh):
        return _GRUFn.apply(gxf, gxb, m, wh, bh)
    yf, yb, _ = _forward("gru_scan_tm", 3, gxf, gxb, m, wh, bh, save=False)
    return yf, yb


gru_scan_tm.launches = 0

_FORWARD = {"lstm_scan_tm": lstm_scan_tm, "gru_scan_tm": gru_scan_tm}


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def _forward(name: str, gates: int, gxf: torch.Tensor, gxb: torch.Tensor,
             m: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor, save: bool
             ) -> tuple[torch.Tensor, torch.Tensor, tuple[torch.Tensor, ...]]:
    """Check what the forward kernels take, raise otherwise, and launch the
    inference variant, or with ``save`` the training variant, which also
    returns what the backward kernel reads: (h [2, T, B, H], gate
    activations [2, T, B, 4H]) and for the LSTM c [2, T, B, H] in between."""
    check_kernel_inputs(name, (gxf, gxb, m, wh, bh), backward=None)
    t_len, b, g = gxf.shape
    h_dim = g // gates
    if (gxb.shape != gxf.shape or g % gates or m.shape != (t_len, b)
            or wh.shape != (2, h_dim, g) or bh.shape != (2, g)):
        raise ValueError(
            f"{name}: shapes gxf {tuple(gxf.shape)} gxb {tuple(gxb.shape)} "
            f"m {tuple(m.shape)} wh {tuple(wh.shape)} bh {tuple(bh.shape)}")
    if gxf.stride() != gxb.stride() or gxf.stride(2) != 1:
        raise ValueError(f"{name}: gxf/gxb need unit last stride and equal strides")
    if not (m.is_contiguous() and wh.is_contiguous() and bh.is_contiguous()):
        raise ValueError(f"{name}: m, wh, bh must be contiguous")
    if gates == 3 and (h_dim % 4 or wh.data_ptr() % 16 or bh.data_ptr() % 16):
        raise ValueError(f"{name}: needs H % 4 == 0 and 16-byte aligned wh, bh "
                         "(the kernel reads them as float4)")
    yf = torch.empty((t_len, b, h_dim), dtype=torch.float32, device=gxf.device)
    yb = torch.empty_like(yf)
    state = torch.empty((2, t_len, b, h_dim), dtype=torch.float32,
                        device=gxf.device) if save else None
    saved: tuple[torch.Tensor, ...] = ()
    if save:
        acts = torch.empty((2, t_len, b, 4 * h_dim), dtype=torch.float32,
                           device=gxf.device)
        saved = (state, acts) if gates == 3 else (state, torch.empty_like(state), acts)
    lib = kernel_build.load_library()
    entry = f"aas_{name.split('_')[0]}_tm_fwd" + ("_train" if save else "")
    err = getattr(lib, entry)(
        gxf.data_ptr(), gxb.data_ptr(), gxf.stride(0), gxf.stride(1),
        m.data_ptr(), wh.data_ptr(), bh.data_ptr(), yf.data_ptr(), yb.data_ptr(),
        *(x.data_ptr() for x in saved), t_len, b, h_dim,
        torch.cuda.current_stream(gxf.device).cuda_stream)
    kernel_build.check(err, entry)
    _FORWARD[name].launches += 1
    return yf, yb, saved


def _transposed(wh: torch.Tensor) -> torch.Tensor:
    """whT [2, G, H], contiguous, which the backward kernels read as float4."""
    wh_t = wh.detach().transpose(1, 2).contiguous()
    if wh_t.shape[2] % 4 or wh_t.data_ptr() % 16:
        raise ValueError(f"backward: needs H % 4 == 0 and a 16-byte aligned whT, "
                         f"got whT {tuple(wh_t.shape)}")
    return wh_t


def lstm_scan_tm_bwd(m: torch.Tensor, wh: torch.Tensor, hp: torch.Tensor,
                     cp: torch.Tensor, acts: torch.Tensor, dyf: torch.Tensor,
                     dyb: torch.Tensor, need_dwh: bool = True
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None,
                                torch.Tensor | None]:
    """Backward kernel B1' on what the training forward saved ->
    (dgxf, dgxb [T, B, 4H], dwh [2, H, 4H], dbh [2, 4H]); dwh and dbh are
    None unless ``need_dwh``."""
    _, t_len, b, h_dim = hp.shape
    dgx = torch.empty((2, t_len, b, 4 * h_dim), dtype=torch.float32, device=hp.device)
    dyf, dyb = dyf.contiguous(), dyb.contiguous()
    err = kernel_build.load_library().aas_lstm_tm_bwd(
        m.data_ptr(), _transposed(wh).data_ptr(), cp.data_ptr(), acts.data_ptr(),
        dyf.data_ptr(), dyb.data_ptr(), dgx.data_ptr(), t_len, b, h_dim,
        torch.cuda.current_stream(hp.device).cuda_stream)
    kernel_build.check(err, "aas_lstm_tm_bwd")
    lstm_scan_tm_bwd.launches += 1
    dwh, dbh = _weight_grads(hp, dgx) if need_dwh else (None, None)
    return dgx[0], dgx[1], dwh, dbh


lstm_scan_tm_bwd.launches = 0


def gru_scan_tm_bwd(m: torch.Tensor, wh: torch.Tensor, hp: torch.Tensor,
                    acts: torch.Tensor, dyf: torch.Tensor, dyb: torch.Tensor,
                    need_dwh: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None,
                               torch.Tensor | None]:
    """Backward kernel B2' on what the training forward saved ->
    (dgxf, dgxb [T, B, 3H], dwh [2, H, 3H], dbh [2, 3H]).  Without
    ``need_dwh`` (a frozen GRU) the kernel writes no dgh and dwh, dbh are None."""
    _, t_len, b, h_dim = hp.shape
    shape = (2, t_len, b, 3 * h_dim)
    dgx = torch.empty(shape, dtype=torch.float32, device=hp.device)
    dgh = torch.empty(shape, dtype=torch.float32, device=hp.device) if need_dwh else None
    dyf, dyb = dyf.contiguous(), dyb.contiguous()
    err = kernel_build.load_library().aas_gru_tm_bwd(
        m.data_ptr(), _transposed(wh).data_ptr(), hp.data_ptr(), acts.data_ptr(),
        dyf.data_ptr(), dyb.data_ptr(), dgx.data_ptr(),
        dgh.data_ptr() if need_dwh else None, t_len, b, h_dim,
        torch.cuda.current_stream(hp.device).cuda_stream)
    kernel_build.check(err, "aas_gru_tm_bwd")
    gru_scan_tm_bwd.launches += 1
    dwh, dbh = _weight_grads(hp, dgh) if need_dwh else (None, None)
    return dgx[0], dgx[1], dwh, dbh


gru_scan_tm_bwd.launches = 0


def _weight_grads(hp: torch.Tensor, dg: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """dWh[d] = sum_t h_prev[d, t]^T dg[d, t] and dbh[d] = sum_t dg[d, t]."""
    two, t_len, b, h_dim = hp.shape
    g = dg.shape[-1]
    dwh = torch.bmm(hp.reshape(two, t_len * b, h_dim).transpose(1, 2),
                    dg.reshape(two, t_len * b, g))
    return dwh, dg.sum(dim=(1, 2))


class _LSTMFn(torch.autograd.Function):
    """B1 training forward, B1' backward."""

    @staticmethod
    def forward(ctx, gxf, gxb, m, wh, bh):
        yf, yb, (hp, cp, acts) = _forward("lstm_scan_tm", 4, gxf, gxb, m, wh, bh,
                                          save=True)
        ctx.save_for_backward(m, wh, hp, cp, acts)
        return yf, yb

    @staticmethod
    def backward(ctx, dyf, dyb):
        m, wh, hp, cp, acts = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgxf, dgxb, dwh, dbh = lstm_scan_tm_bwd(m, wh, hp, cp, acts, dyf, dyb,
                                                need_dwh=need[3] or need[4])
        return dgxf, dgxb, None, dwh if need[3] else None, dbh if need[4] else None


class _GRUFn(torch.autograd.Function):
    """B2 training forward, B2' backward."""

    @staticmethod
    def forward(ctx, gxf, gxb, m, wh, bh):
        yf, yb, (hp, acts) = _forward("gru_scan_tm", 3, gxf, gxb, m, wh, bh, save=True)
        ctx.save_for_backward(m, wh, hp, acts)
        return yf, yb

    @staticmethod
    def backward(ctx, dyf, dyb):
        m, wh, hp, acts = ctx.saved_tensors
        need = ctx.needs_input_grad
        dgxf, dgxb, dwh, dbh = gru_scan_tm_bwd(m, wh, hp, acts, dyf, dyb,
                                               need_dwh=need[3] or need[4])
        return dgxf, dgxb, None, dwh if need[3] else None, dbh if need[4] else None
