"""Weight gradient of a SAME-padded conv: CUDA kernel (``csrc/conv_dw.cu``)
and its plain version.

Replaces ``aas_enhancement_tpu/ops/pallas/conv_dw_kernel.py::conv_dw_same``.
Interface as there (channels last): x [B, T, F, ci], dy [B, T, Fo, co] with
Fo = ceil(F / stride_f), kernel size (kt, kf), strides (1, 1) or (1, 2) ->
dW [kt, kf, ci, co] in f32,

    dW[dt, df, i, o] = sum_{b, t, f} x_pad[b, t + dt, s f + df, i] dy[b, t, f, o]

with x_pad the SAME-padded input (``ops/conv.py::same_pad``).  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
``conv_dw_same.launches`` counts the kernel launches, ``.dtype`` holds the
last launch's input dtype and ``.route`` its route.

x and dy are float32 or bfloat16 (a bf16 AM's conv2), one dtype for both;
dW is float32 either way: both versions multiply and sum the bf16 values in
float32, as the Pallas kernel does for a bf16 input.  ``conv_dw_plan`` picks
the route from the shape and dtype alone: bfloat16 takes "mma" (tensor-core
products of the bf16 values, f32 sums; a bf16 x bf16 product is exact in
f32); float32 takes "bf16x3" (each value split into three bf16 planes,
``split3_bf16``, and the six products of order at most 2^-16 on the same
tensor cores) wherever its stages fit a block's shared memory, and "fma"
(f32 FMAs on register tiles) where they do not.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build

STREAM_DTYPES = (torch.float32, torch.bfloat16)


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) zero padding of one axis for a SAME conv."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _check_shapes(x: torch.Tensor, dy: torch.Tensor, strides: tuple[int, int]) -> None:
    st, sf = strides
    if st != 1 or sf not in (1, 2):
        raise NotImplementedError(f"conv_dw_same: strides {strides}")
    b, t, f, _ = x.shape
    if dy.ndim != 4 or dy.shape[:3] != (b, t, -(-f // sf)):
        raise ValueError(f"conv_dw_same: x {tuple(x.shape)} and dy {tuple(dy.shape)} "
                         f"do not belong to one SAME conv with strides {strides}")


def conv_dw_same_plain(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                       strides: tuple[int, int] = (1, 1),
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Tap by tap: dW[dt, df] = (shifted, strided x)^T dy over all positions,
    in ``dtype`` (float32; float64 for a reference of the f32 routes)."""
    _check_shapes(x, dy, strides)
    x, dy = x.to(dtype), dy.to(dtype)
    sf = strides[1]
    t, fo = dy.shape[1], dy.shape[2]
    xp = F.pad(x, (0, 0, *same_pad(x.shape[2], kf, sf), *same_pad(t, kt, 1)))
    d = dy.reshape(-1, dy.shape[3])
    dw = x.new_empty((kt, kf, x.shape[3], dy.shape[3]))
    for dt in range(kt):
        for df in range(kf):
            xs = xp[:, dt:dt + t, df:df + sf * (fo - 1) + 1:sf]
            dw[dt, df] = xs.reshape(-1, x.shape[3]).T @ d
    return dw


MAX_SMEM = 227 * 1024      # dynamic shared memory of one H100 block, bytes
FMA_THREADS = 256          # the f32 kernel's most threads a block (kMaxThreads)
MMA_WARPS = 8              # the tensor-core kernel's multiplying warps a block (kMmaWarps)
MMA_WINDOW = 8             # its most dy rows a window
FLUSH_ROWS = 128           # dy rows a warp's running sums span before a flush, about


def split3_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The split route's planes of f32 values, as its staging warps make
    them: v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1), each
    rounded to nearest, the f32 subtractions exact, so that v0 + v1 + v2 = v
    wherever the planes stay above bf16's subnormals (|v| > 2^-108 or so)."""
    t = t.float()
    v0 = t.bfloat16()
    r = t - v0.float()
    v1 = r.bfloat16()
    return v0, v1, (r - v1.float()).bfloat16()


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """How the kernel splits one call.  ``slices`` row slices (0: the kernel
    does not take the shape) of ``blocks`` blocks each, ``smem`` bytes of
    dynamic shared memory a block.  "fma": ``taps`` frequency taps a thread,
    ``ndt`` time taps and ``ndfb`` tap chunks a block
    (``csrc/conv_dw.cu::make_plan``).  "mma" and "bf16x3" (``planes`` 1 and
    3): ``cx`` and ``cd`` chunks of 8 channels in a staged x and dy row (1, 2
    or 4; ci and co taken in chunks of 8 cx and 8 cd channels), ``groups``
    blocks of ``per_block`` taps for each chunk pair, windows of ``win`` dy
    rows; a block's taps span at most ``ndt`` time taps."""
    route: str
    slices: int
    smem: int
    blocks: int = 0
    taps: int = 0
    ndt: int = 0
    ndfb: int = 0
    cx: int = 0
    cd: int = 0
    groups: int = 0
    per_block: int = 0
    win: int = 0
    planes: int = 0


def _fma_plan(rows: int, fo: int, kt: int, kf: int, ci: int, co: int, sf: int,
              sms: int) -> DwPlan:
    """``csrc/conv_dw.cu``'s ``make_plan`` and ``aas_conv_dw_slices``."""
    ci4, co4 = -(-ci // 4), -(-co // 4)
    tile = ci4 * co4
    if min(kt, kf, ci, co) < 1 or tile > FMA_THREADS:
        return DwPlan("fma", 0, 0)
    taps = 5
    for k in (6, 7):
        if -(-kf // k) * k <= -(-kf // taps) * taps:
            taps = k
    groups = FMA_THREADS // tile
    ndfc = -(-kf // taps)
    ndfb = min(ndfc, groups)
    grid_z = -(-ndfc // ndfb)
    grid_y = -(-kt // min(groups // ndfb, kt))
    ndt = -(-kt // grid_y)
    smem = 2 * 4 * (fo * 4 * co4 + ndt * (sf * (fo - 1) + ndfc * taps) * 4 * ci4)
    blocks = grid_y * grid_z
    if rows < 1 or fo < 1 or sf < 1 or sms < 1 or smem > MAX_SMEM:
        return DwPlan("fma", 0, smem, blocks, taps, ndt, ndfb)
    slices = max(1, min(rows, -(-2 * sms // blocks)))
    return DwPlan("fma", slices, smem, blocks, taps, ndt, ndfb)


def mma_geometry(fo: int, kf: int, sf: int) -> tuple[int, int, int]:
    """(half, xp, tail) of the tensor-core kernel's staged x: positions a
    phase (Fo + (kf - 1) // sf); rows a time slot, at least sf * half and
    equal to Fo mod 8, so that a lane's rows move by multiples of 8 and keep
    their chunk XOR; rows staged past a window's win + ndt - 1 slots, so
    that the positions of its last step and of the step after it (which it
    prefetches), up to n Fo + 30, fall on staged rows."""
    half = fo + (kf - 1) // sf
    xp = sf * half + (fo - sf * half) % 8
    return half, xp, (30 // fo) * xp + (sf - 1) * half + 30 % fo + (kf - 1) // sf + 1


def mma_smem(planes: int, cx: int, cd: int, win: int, ndt: int, fo: int, kf: int,
             sf: int) -> int:
    """Two stages of a window and a zero row of 16 bytes.  A stage at one
    plane: ceil16(win Fo) + 16 dy rows of 8 cd bf16 channels and (win + ndt -
    1) xp + tail x rows of 8 cx; at three, three planes of ceil16(win Fo) dy
    rows and of (win + ndt - 1) xp x rows, and one tail of x rows after them
    (``csrc/conv_dw.cu::mma_stage_bytes``)."""
    _, xp, tail = mma_geometry(fo, kf, sf)
    dy_rows, x_rows = -(-win * fo // 16) * 16, (win + ndt - 1) * xp
    if planes == 1:
        return 2 * ((dy_rows + 16) * 16 * cd + (x_rows + tail) * 16 * cx) + 16
    return 2 * (planes * (dy_rows * 16 * cd + x_rows * 16 * cx) + tail * 16 * cx) + 16


def _units(planes: int, cx: int, cd: int) -> int:
    """Taps a warp: 128 f32 accumulators a thread over its m16 x n8 tiles
    (2 x 4 where cx = cd = 4; 1 x 2 for the narrowest) at one plane, 64 at
    three (``csrc/conv_dw.cu::mma_units``)."""
    return 32 // ((2 if cx == 4 else 1) * (4 if cd == 4 else 2)) // (1 if planes == 1 else 2)


def _tap_span(kt: int, kf: int, per_block: int) -> int:
    """The most time taps that one block's run of ``per_block`` taps spans."""
    n = kt * kf
    return max((min(n, g + per_block) - 1) // kf - g // kf + 1 for g in range(0, n, per_block))


def _mma_plan(planes: int, rows: int, fo: int, kt: int, kf: int, ci: int, co: int, sf: int,
              sms: int) -> DwPlan:
    """The tensor-core tiling at 1 ("mma") or 3 ("bf16x3") planes: staged
    rows of 8, 16 or 32 channels (ci and co chunked past 32), ``_units`` taps
    a warp, 8 multiplying warps a block (and a staging warpgroup); the fewest tap groups, and for them the longest window of dy
    rows, whose two stages fit a block's shared memory; row slices for about
    one block an SM."""
    route = "mma" if planes == 1 else "bf16x3"
    cx, cd = (1 if c <= 8 else 2 if c <= 16 else 4 for c in (ci, co))
    chunks = -(-ci // (8 * cx)) * -(-co // (8 * cd))
    ntaps = kt * kf
    for groups in range(-(-ntaps // (MMA_WARPS * _units(planes, cx, cd))), ntaps + 1):
        per_block = -(-ntaps // groups)
        if (groups - 1) * per_block >= ntaps:
            continue                 # as many blocks with fewer groups
        ndt = _tap_span(kt, kf, per_block)
        for win in range(MMA_WINDOW, 0, -1):
            smem = mma_smem(planes, cx, cd, win, ndt, fo, kf, sf)
            if smem <= MAX_SMEM:
                blocks = groups * chunks
                return DwPlan(route, max(1, min(rows, sms // blocks)), smem, blocks,
                              ndt=ndt, cx=cx, cd=cd, groups=groups, per_block=per_block,
                              win=win, planes=planes)
    return DwPlan(route, 0, 0)


@functools.lru_cache(maxsize=256)
def conv_dw_plan(dtype: torch.dtype, b: int, t: int, f: int, ci: int, co: int, kt: int,
                 kf: int, strides: tuple[int, int], sms: int) -> DwPlan:
    """The kernel's route and split for x [b, t, f, ci] and dy of co channels
    with a kt x kf kernel on a card of ``sms`` multiprocessors, from these
    alone: "mma" for bfloat16 streams; for float32 "bf16x3" where the two
    stages of its window fit a block's shared memory, else "fma" (shapes of
    many bins, tests/test_torch_conv_dw_plan.py).  0 slices for other
    strides than (1, 1) or (1, 2), a ci x co register tiling of more than a
    block's threads, or f32 staged rows beyond a block's shared memory, at
    either dtype; at bf16 also where the two stages of one dy row's window
    exceed a block's shared memory (only at the edge of the f32 limit: 1200
    bins or more)."""
    bf16 = dtype == torch.bfloat16
    if strides[0] != 1 or strides[1] not in (1, 2):
        return DwPlan("mma" if bf16 else "fma", 0, 0)
    rows, fo, sf = b * t, -(-f // strides[1]), strides[1]
    fma = _fma_plan(rows, fo, kt, kf, ci, co, sf, sms)
    if fma.slices < 1:
        return DwPlan("mma", 0, 0) if bf16 else fma
    split = _mma_plan(1 if bf16 else 3, rows, fo, kt, kf, ci, co, sf, sms)
    return split if bf16 or split.slices else fma


@functools.lru_cache(maxsize=8)
def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_slices(x: torch.Tensor, co: int, kt: int, kf: int,
                  strides: tuple[int, int]) -> int:
    """Slices of the (b, t) rows the kernel splits its sum over for x
    [B, T, F, ci] on x's card (``conv_dw_plan`` at x's dtype); 0 when the
    kernel does not take the shape."""
    if strides[0] != 1 or strides[1] not in (1, 2):
        return 0
    return conv_dw_plan(x.dtype, *x.shape, co, kt, kf, tuple(strides),
                        _multiprocessors(x.device)).slices


def _launch(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int, strides: tuple[int, int],
            plan: DwPlan) -> torch.Tensor:
    """Launch ``plan``'s route on CUDA x and dy (checked by the caller)."""
    b, t, f, ci = x.shape
    fo, co = dy.shape[2], dy.shape[3]
    part = torch.empty((plan.slices, kt, kf, ci, co), dtype=torch.float32, device=x.device)
    dw = torch.empty((kt, kf, ci, co), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
            x.stride(0), x.stride(1), x.stride(2), dy.stride(0), dy.stride(1), dy.stride(2),
            b, t, f, fo, ci, co, kt, kf, strides[1],
            same_pad(t, kt, 1)[0], same_pad(f, kf, strides[1])[0])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = kernel_build.load_library()
    if plan.route == "fma":
        err = lib.aas_conv_dw(*args, plan.slices, stream)
    else:
        err = lib.aas_conv_dw_mma(*args, plan.planes, plan.cx, plan.cd, plan.groups,
                                  plan.per_block, plan.win, plan.ndt, plan.slices, plan.smem,
                                  stream)
    kernel_build.check(err, f"aas_conv_dw ({plan.route})")
    return dw


def _checked(x: torch.Tensor, dy: torch.Tensor, strides: tuple[int, int]) -> torch.dtype:
    dtype = check_kernel_inputs("conv_dw_same", (), streams=(x, dy),
                                stream_dtypes=STREAM_DTYPES)
    _check_shapes(x, dy, strides)
    if x.stride(3) != 1 or dy.stride(3) != 1:
        raise ValueError(f"conv_dw_same: needs unit channel stride, got x strides "
                         f"{x.stride()} and dy strides {dy.stride()}")
    return dtype


def _refused(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int) -> ValueError:
    b, t, _, ci = x.shape
    return ValueError(f"conv_dw_same: the kernel does not take {ci} -> {dy.shape[3]} channels "
                      f"with a {kt} x {kf} kernel on {b * t} rows of {dy.shape[2]} bins")


def conv_dw_same(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                 strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """dW of a SAME conv (see module docstring).  x and dy need unit channel
    stride; their other strides are free, so the channels-last memory of an
    NCHW tensor (``t.permute(0, 2, 3, 1)``) is read in place."""
    if not uses_kernel("conv_dw_same", x):
        return conv_dw_same_plain(x, dy, kt, kf, strides)
    dtype = _checked(x, dy, strides)
    plan = conv_dw_plan(dtype, *x.shape, dy.shape[3], kt, kf, tuple(strides),
                        _multiprocessors(x.device))
    if plan.slices < 1:
        raise _refused(x, dy, kt, kf)
    dw = _launch(x, dy, kt, kf, strides, plan)
    conv_dw_same.launches += 1
    conv_dw_same.dtype = dtype
    conv_dw_same.route = plan.route
    return dw


conv_dw_same.launches = 0
conv_dw_same.dtype = None
conv_dw_same.route = None


def conv_dw_fma(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """The "fma" route on CUDA f32 x and dy whatever the plan says, to time
    and check it beside the route the plan takes; on no path, and not
    counted in ``conv_dw_same.launches``."""
    if _checked(x, dy, strides) != torch.float32:
        raise TypeError(f"conv_dw_fma: f32 x and dy, got {x.dtype}")
    b, t, f, ci = x.shape
    plan = _fma_plan(b * t, dy.shape[2], kt, kf, ci, dy.shape[3], strides[1],
                     _multiprocessors(x.device))
    if plan.slices < 1:
        raise _refused(x, dy, kt, kf)
    return _launch(x, dy, kt, kf, strides, plan)
