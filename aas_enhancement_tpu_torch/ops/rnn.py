"""Masked bidirectional LSTM, time-major (port of ``aas_enhancement_tpu/ops/rnn.py``).

As in the JAX ``BiRNN(cell="lstm", time_major=True)``: the input-side gate
product of both directions is hoisted out of the time loop into one ``wx``
Dense to 2 * 4H (the first 4H features are direction 0), the recurrence runs
both directions in one fused scan (``ops/cuda/rnn.py``), and the directions
are SUMMED.  Gate order i, f, g, o with sigmoid(f + 1.0); the state freezes
where the mask is 0 and outputs there are 0.  The GRU cell is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from aas_enhancement_tpu_torch.ops.cuda.rnn import lstm_scan_tm
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.masking import time_mask


class BiRNN(nn.Module):
    """[T, B, D] -> [T, B, H], sum of both directions' masked outputs."""

    def __init__(self, in_features: int, hidden: int, cell: str = "lstm",
                 device: torch.device | str | None = None):
        super().__init__()
        if cell != "lstm":
            raise NotImplementedError(f"cell {cell!r}: only 'lstm' is ported "
                                      "(GRU is ROADMAP B2)")
        self.hidden = hidden
        self.wx = Dense(in_features, 2 * 4 * hidden, device=device)
        self.wh = nn.Parameter(torch.empty(2, hidden, 4 * hidden, device=device))
        self.bh = nn.Parameter(torch.zeros(2, 4 * hidden, device=device))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        g4 = 4 * self.hidden
        gates = self.wx(x)                                   # [T, B, 8H]
        gxf, gxb = gates[..., :g4], gates[..., g4:]          # strided views
        m = time_mask(lengths, x.shape[0]).T.contiguous()    # [T, B]
        yf, yb = lstm_scan_tm(gxf, gxb, m, self.wh, self.bh)
        return yf + yb
