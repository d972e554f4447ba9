"""``Dense``: flax's ``nn.Dense`` with its parameter layout kept.

``kernel`` is [in, out] (not ``nn.Linear``'s [out, in]) and ``bias`` is
[out], so a flax parameter tree converts without transposes
(``convert.py``) and y = x @ kernel + bias as in flax.  ``dtype`` is the
compute dtype, flax's ``dtype=``: the parameters stay float32 and are cast
with the input where they are used, so at bfloat16 the product is rounded
to bfloat16 and the bias added in bfloat16 (cuBLAS accumulates in float32
on the card).
"""

from __future__ import annotations

import torch
from torch import nn


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 device: torch.device | str | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(in_features, out_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        # One [rows, in] x [in, out] product whatever x's layout (the models'
        # time-major [T, B, in] views): torch.matmul folds a view that needs
        # a copy only for a kernel that requires grad, and otherwise runs a
        # batched product of B-row matrices, which cuBLAS runs many times
        # slower (PERF.md §5: the cast bf16 kernel requires no grad).
        y = torch.mm(x.reshape(-1, x.shape[-1]), self.kernel.to(dt))
        return y.reshape(*x.shape[:-1], y.shape[-1]) + self.bias.to(dt)
