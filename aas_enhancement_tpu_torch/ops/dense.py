"""``Dense``: flax's ``nn.Dense`` with its parameter layout kept.

``kernel`` is [in, out] (not ``nn.Linear``'s [out, in]) and ``bias`` is
[out], so a flax parameter tree converts without transposes
(``convert.py``) and y = x @ kernel + bias as in flax.
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 device: torch.device | str | None = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias
