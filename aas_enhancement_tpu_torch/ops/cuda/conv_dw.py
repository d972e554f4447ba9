"""Weight gradient of a SAME-padded conv: CUDA kernel (``csrc/conv_dw.cu``)
and its plain version.

Replaces ``aas_enhancement_tpu/ops/pallas/conv_dw_kernel.py::conv_dw_same``.
Interface as there (channels last): x [B, T, F, ci], dy [B, T, Fo, co] with
Fo = ceil(F / stride_f), kernel size (kt, kf), strides (1, 1) or (1, 2) ->
dW [kt, kf, ci, co] in f32,

    dW[dt, df, i, o] = sum_{b, t, f} x_pad[b, t + dt, s f + df, i] dy[b, t, f, o]

with x_pad the SAME-padded input (``ops/conv.py::same_pad``).  A CPU tensor
takes the plain version; a CUDA tensor launches the kernel or raises.
``conv_dw_same.launches`` counts the kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build


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
                       strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """Tap by tap: dW[dt, df] = (shifted, strided x)^T dy over all positions."""
    _check_shapes(x, dy, strides)
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


def kernel_slices(x: torch.Tensor, co: int, kt: int, kf: int,
                  strides: tuple[int, int]) -> int:
    """Slices of the (b, t) rows the kernel splits its sum over for x
    [B, T, F, ci] on x's card; 0 when the kernel does not take the shape: other
    strides than (1, 1) or (1, 2), a ci x co register tiling of more than a
    block's threads, or staged rows beyond a block's shared memory."""
    if strides[0] != 1 or strides[1] not in (1, 2):
        return 0
    b, t, f, ci = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return kernel_build.load_library().aas_conv_dw_slices(
        b * t, -(-f // strides[1]), kt, kf, ci, co, strides[1], sms)


def conv_dw_same(x: torch.Tensor, dy: torch.Tensor, kt: int, kf: int,
                 strides: tuple[int, int] = (1, 1)) -> torch.Tensor:
    """dW of a SAME conv (see module docstring).  x and dy need unit channel
    stride; their other strides are free, so the channels-last memory of an
    NCHW tensor (``t.permute(0, 2, 3, 1)``) is read in place."""
    if not uses_kernel("conv_dw_same", x):
        return conv_dw_same_plain(x, dy, kt, kf, strides)
    check_kernel_inputs("conv_dw_same", (x, dy))
    _check_shapes(x, dy, strides)
    if x.stride(3) != 1 or dy.stride(3) != 1:
        raise ValueError(f"conv_dw_same: needs unit channel stride, got x strides "
                         f"{x.stride()} and dy strides {dy.stride()}")
    b, t, f, ci = x.shape
    fo, co = dy.shape[2], dy.shape[3]
    slices = kernel_slices(x, co, kt, kf, strides)
    if slices < 1:
        raise ValueError(f"conv_dw_same: the kernel does not take {ci} -> {co} channels "
                         f"with a {kt} x {kf} kernel on {b * t} rows of {fo} bins")
    part = torch.empty((slices, kt, kf, ci, co), dtype=torch.float32, device=x.device)
    dw = torch.empty((kt, kf, ci, co), dtype=torch.float32, device=x.device)
    err = kernel_build.load_library().aas_conv_dw(
        x.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
        x.stride(0), x.stride(1), x.stride(2), dy.stride(0), dy.stride(1), dy.stride(2),
        b, t, f, fo, ci, co, kt, kf, strides[1],
        same_pad(t, kt, 1)[0], same_pad(f, kf, strides[1])[0], slices,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(err, "aas_conv_dw")
    conv_dw_same.launches += 1
    return dw


conv_dw_same.launches = 0
