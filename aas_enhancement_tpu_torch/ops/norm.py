"""Length-masked GroupNorm (port of ``aas_enhancement_tpu/ops/norm.py``).

Statistics come from valid frames only, so a padded batch gives the same
outputs as per-utterance runs.  The math lives in ``ops/cuda/gn.py``: the
CUDA kernels for a CUDA tensor (forward and backward, each one cooperative
launch of ``csrc/gn.cu``), the plain version for a CPU tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from aas_enhancement_tpu_torch.ops.cuda.gn import masked_group_norm_act


class MaskedGroupNorm(nn.Module):
    """GroupNorm over [B, T, F, C] with per-(batch, group) stats from valid
    frames, then an optional fused activation ("none" | "leaky_relu" |
    "hardtanh").  Parameters ``scale`` (ones) and ``bias`` (zeros), [C]."""

    def __init__(self, channels: int, num_groups: int = 8, epsilon: float = 1e-5,
                 act: str = "none", negative_slope: float = 0.2,
                 device: torch.device | str | None = None):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"channels {channels} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.act = act
        self.negative_slope = negative_slope
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        return masked_group_norm_act(
            x, self.scale, self.bias, lengths, num_groups=self.num_groups,
            eps=self.epsilon, act=self.act, slope=self.negative_slope)
