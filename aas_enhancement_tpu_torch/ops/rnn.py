"""Masked bidirectional GRU/LSTM, time-major (port of ``aas_enhancement_tpu/ops/rnn.py``).

As in the JAX ``BiRNN(time_major=True)``: the input-side gate product of both
directions is hoisted out of the time loop into one ``wx`` Dense to 2 * G*H
(the first G*H features are direction 0), the recurrence runs both
directions in one fused scan (``ops/cuda/rnn.py``), and the directions are
SUMMED.  LSTM: gate order i, f, g, o with sigmoid(f + 1.0).  GRU: gate order
r, z, n with n = tanh(xn + r * (W_hn h + b_hn)), no forget offset.  The state
freezes where the mask is 0 and outputs there are 0.
"""

from __future__ import annotations

import torch
from torch import nn

from aas_enhancement_tpu_torch.ops.cuda.rnn import gru_scan_tm, lstm_scan_tm
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.masking import time_mask

_CELLS = {"gru": (3, gru_scan_tm), "lstm": (4, lstm_scan_tm)}


class BiRNN(nn.Module):
    """[T, B, D] -> [T, B, H], sum of both directions' masked outputs."""

    def __init__(self, in_features: int, hidden: int, cell: str = "lstm",
                 device: torch.device | str | None = None):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"unknown cell {cell!r}: 'gru' or 'lstm'")
        self.hidden = hidden
        self.gates, self.scan = _CELLS[cell]
        gh = self.gates * hidden
        self.wx = Dense(in_features, 2 * gh, device=device)
        self.wh = nn.Parameter(torch.empty(2, hidden, gh, device=device))
        self.bh = nn.Parameter(torch.zeros(2, gh, device=device))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        gh = self.gates * self.hidden
        gates = self.wx(x)                                   # [T, B, 2GH]
        gxf, gxb = gates[..., :gh], gates[..., gh:]          # strided views
        m = time_mask(lengths, x.shape[0]).T.contiguous()    # [T, B]
        yf, yb = self.scan(gxf, gxb, m, self.wh, self.bh)
        return yf + yb
