"""TF-style SAME strided convolution (the forward of
``aas_enhancement_tpu/ops/conv.py``'s ``SpaceToDepthConv`` and ``TapDWConv``),
and ``TapDWConv``'s replaceable weight gradient (``conv2d_tapdw`` there).

SAME pads so that the output has ceil(size / stride) positions and puts the
odd pad on the high side (``same_pad``): for T = 800, kernel 11, stride 2 the
time pad is (4, 5), for T = 801 it is (5, 5).  torch's ``padding="same"``
rejects stride > 1 and symmetric padding is wrong for an even size, so the pad
is explicit.  The JAX modules' space-to-depth fold and polyphase dx are TPU
layout work and are not ported (ROADMAP A15); the conv itself and dx are
cuDNN's, as the JAX package leaves them to XLA outside any Pallas kernel.

``conv2d_tapdw`` is the conv whose dW comes from the hand-written kernel
(``ops/cuda/conv_dw.py``, replacing the Pallas ``conv_dw_same``).  ``dw_impl``
is "auto" | "cudnn" | "kernel", the counterparts of the JAX function's
"auto" | "xla" | "pallas": "auto" takes the kernel for a CUDA tensor whose
shape the kernel route supports (``tapdw_supported``: time stride 1, frequency
stride 1 or 2, at least 8 input channels) and the kernel itself takes
(``conv_dw.kernel_slices``: its channel tiling and shared memory), and cuDNN
otherwise; "kernel" on an unsupported shape takes cuDNN as the JAX "pallas"
does, and on a supported shape calls ``conv_dw_same``, which on a CUDA
tensor launches the kernel or raises (on a CPU tensor it is the kernel's
plain version).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aas_enhancement_tpu_torch.ops.cuda.conv_dw import (
    conv_dw_same,
    kernel_slices,
    same_pad,
)

DW_IMPLS = ("auto", "cudnn", "kernel")


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` over NCHW with SAME padding computed from the input size.

    Parameters are ``weight`` [O, I, kh, kw] and ``bias`` [O]; ``convert.py``
    permutes a flax HWIO ``kernel`` into ``weight``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride: tuple[int, int] = (1, 1),
                 device: torch.device | str | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, _pads(x, self.kernel_size, self.stride)))


def _pads(x: torch.Tensor, kernel, stride) -> tuple[int, int, int, int]:
    """F.pad's (f low, f high, t low, t high) for a SAME conv of x [B, C, T, F]."""
    return (*same_pad(x.shape[3], kernel[1], stride[1]),
            *same_pad(x.shape[2], kernel[0], stride[0]))


def tapdw_supported(weight_shape, stride: tuple[int, int]) -> bool:
    """Shapes whose dW takes the kernel route (weight [O, I, kh, kw])."""
    return stride[0] == 1 and stride[1] in (1, 2) and weight_shape[1] >= 8


class _TapDWFn(torch.autograd.Function):
    """SAME conv over NCHW: forward and dx by cuDNN (the CPU's native conv for
    CPU tensors), dW by ``dw_impl``."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, pads, dw_impl):
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pads, ctx.dw_impl = stride, pads, dw_impl
        ctx.bias_sizes = None if bias is None else [weight.shape[0]]
        return F.conv2d(F.pad(x, pads), weight, bias, stride)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        stride, pads = ctx.stride, ctx.pads
        x_cl = x.permute(0, 2, 3, 1)
        kh, kw = weight.shape[2:]
        use_kernel = need_w and tapdw_supported(weight.shape, stride) and (
            ctx.dw_impl == "kernel" or (
                ctx.dw_impl == "auto" and x.is_cuda
                and kernel_slices(x_cl, weight.shape[0], kh, kw, stride) > 0))
        dx, dw, db = torch.ops.aten.convolution_backward(
            dy, F.pad(x, pads), weight, ctx.bias_sizes, list(stride), [0, 0], [1, 1],
            False, [0, 0], 1, [need_x, need_w and not use_kernel, need_b])
        if need_x:
            f0, f1, t0, t1 = pads
            dx = dx[:, :, t0:dx.shape[2] - t1, f0:dx.shape[3] - f1]
        if use_kernel:
            dy_cl = dy.permute(0, 2, 3, 1)
            if x_cl.stride(3) != 1:
                x_cl = x_cl.contiguous()
            if dy_cl.stride(3) != 1:
                dy_cl = dy_cl.contiguous()
            dw = conv_dw_same(x_cl, dy_cl, kh, kw, stride).permute(3, 2, 0, 1)
        return (dx if need_x else None, dw if need_w else None,
                db if need_b else None, None, None, None)


def conv2d_tapdw(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                 stride: tuple[int, int], dw_impl: str = "auto") -> torch.Tensor:
    """SAME conv of x [B, I, T, F] with weight [O, I, kh, kw]; the primal and
    dx are cuDNN's, dW follows ``dw_impl`` (module docstring)."""
    if dw_impl not in DW_IMPLS:
        raise ValueError(f"dw_impl {dw_impl!r}: one of {DW_IMPLS}")
    stride = tuple(stride)
    return _TapDWFn.apply(x, weight, bias, stride, _pads(x, weight.shape[2:], stride),
                          dw_impl)


class TapDWConv(SameConv2d):
    """``SameConv2d`` whose weight gradient follows ``dw_impl`` (port of the
    JAX ``TapDWConv``; its ``dx_impl`` and ``impl`` variants are TPU layout
    work, ROADMAP A15).  Same parameters as ``SameConv2d`` (``weight``
    [O, I, kh, kw], ``bias``), so state_dicts and ``convert.py`` are unchanged."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: tuple[int, int], stride: tuple[int, int] = (1, 1),
                 dw_impl: str = "auto", device: torch.device | str | None = None):
        super().__init__(in_channels, out_channels, kernel_size, stride, device=device)
        self.dw_impl = dw_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_tapdw(x, self.weight, self.bias, self.stride, self.dw_impl)
