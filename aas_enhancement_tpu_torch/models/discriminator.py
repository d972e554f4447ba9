"""Spectrogram discriminator (port of ``aas_enhancement_tpu/models/discriminator.py``).

log1p-magnitude [B, T, F] + lengths -> 3 x (5x5 conv, stride (2, 2),
TF-style SAME padding -> leaky_relu(0.2) -> zero the frames past
ceil(len / 2)) -> flatten to [B, T', F'*C] -> mean over valid frames ->
Dense(1) -> raw score [B] (real > fake under LSGAN targets).  No layer mixes
batch rows.

The flatten puts feature f*C + c where the JAX model's ``reshape(b, t, f*c)``
does, so the head's rows line up with a converted flax kernel; F' is
161 -> 81 -> 41 -> 21 at the default 161 bins.  The convs are cuDNN and have
no TPU kernel behind them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aas_enhancement_tpu_torch.config import DiscriminatorConfig
from aas_enhancement_tpu_torch.ops.conv import SameConv2d
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.masking import apply_time_mask, conv_out_length, masked_mean


class Discriminator(nn.Module):
    """Parameters are created uninitialized; ``convert.init_like_flax`` draws
    them, or ``convert.disc_params_from_flax`` loads a flax tree."""

    def __init__(self, cfg: DiscriminatorConfig, num_bins: int,
                 device: torch.device | str | None = None):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(f"dtype {cfg.dtype}: only float32 is ported")
        chans = (1,) + tuple(cfg.channels)
        self.convs = nn.ModuleList(
            SameConv2d(c_in, c_out, (5, 5), (2, 2), device=device)
            for c_in, c_out in zip(chans[:-1], chans[1:]))
        f_out = num_bins
        for _ in cfg.channels:
            f_out = -(-f_out // 2)
        self.head = Dense(f_out * chans[-1], 1, device=device)

    def forward(self, log_mag: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        x = log_mag.to(torch.float32)[:, None]                   # [B, 1, T, F]
        cur = lengths
        for conv in self.convs:
            x = F.leaky_relu(conv(x), negative_slope=0.2)
            cur = conv_out_length(cur, 5, 2, "SAME")
            x = apply_time_mask(x.transpose(1, 2), cur).transpose(1, 2)
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, f * c)           # feature f*C + c
        return self.head(masked_mean(x, cur, axis=(1,)))[:, 0]
