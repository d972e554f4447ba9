"""TF-style SAME strided convolution (the forward of
``aas_enhancement_tpu/ops/conv.py``'s ``SpaceToDepthConv`` and ``TapDWConv``).

SAME pads so that the output has ceil(size / stride) positions and puts the
odd pad on the high side (``_same_pad``): for T = 800, kernel 11, stride 2 the
time pad is (4, 5), for T = 801 it is (5, 5).  torch's ``padding="same"``
rejects stride > 1 and symmetric padding is wrong for an even size, so the pad
is explicit.  The JAX modules' space-to-depth fold and polyphase gradients are
TPU layout work and are not ported (ROADMAP A15); the conv itself is cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) zero padding of one axis for a SAME conv."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


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
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        pt, pf = same_pad(x.shape[2], kh, sh), same_pad(x.shape[3], kw, sw)
        return super().forward(F.pad(x, (*pf, *pt)))
