"""Masked bidirectional GRU/LSTM (port of ``aas_enhancement_tpu/ops/rnn.py``).

As in the JAX ``BiRNN``: the input-side gate product of both directions is
hoisted out of the time loop into one ``wx`` Dense to 2 * G*H (the first G*H
features are direction 0), the recurrence runs both directions in one fused
scan (``ops/cuda/rnn.py``), and the directions are SUMMED.  LSTM: gate order
i, f, g, o with sigmoid(f + 1.0).  GRU: gate order r, z, n with
n = tanh(xn + r * (W_hn h + b_hn)), no forget offset.  The state freezes
where the mask is 0 and outputs there are 0.

``time_major=True`` (x [T, B, D] -> [T, B, H]) hands the two halves of the
gates to the time-major scans as they are.  ``time_major=False`` (x
[B, T, D] -> [B, T, H]) builds the stacked layout of the JAX batch-major
route, gx [T, 2, B, G*H] and m [T, 2, B] with direction 1 flipped in time,
runs the stacked scans on it and flips direction 1's output back.  The
default here is ``True``, what both models pass and every caller of the port
relies on; the JAX module's default is ``False``.
"""

from __future__ import annotations

import torch
from torch import nn

from aas_enhancement_tpu_torch.ops.cuda.rnn import (gru_scan_stacked, gru_scan_tm,
                                                    lstm_scan_stacked, lstm_scan_tm)
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.masking import time_mask

# cell -> (gates, time-major scan, stacked scan)
_CELLS = {"gru": (3, gru_scan_tm, gru_scan_stacked),
          "lstm": (4, lstm_scan_tm, lstm_scan_stacked)}


class BiRNN(nn.Module):
    """[T, B, D] -> [T, B, H] (or batch-major, see the module docstring): the
    sum of both directions' masked outputs."""

    def __init__(self, in_features: int, hidden: int, cell: str = "lstm",
                 time_major: bool = True, device: torch.device | str | None = None):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"unknown cell {cell!r}: 'gru' or 'lstm'")
        self.hidden = hidden
        self.time_major = time_major
        self.gates, self.scan, self.scan_stacked = _CELLS[cell]
        gh = self.gates * hidden
        self.wx = Dense(in_features, 2 * gh, device=device)
        self.wh = nn.Parameter(torch.empty(2, hidden, gh, device=device))
        self.bh = nn.Parameter(torch.zeros(2, gh, device=device))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        gh = self.gates * self.hidden
        gates = self.wx(x)                                       # [..., 2GH]
        if self.time_major:
            gxf, gxb = gates[..., :gh], gates[..., gh:]          # strided views
            m = time_mask(lengths, x.shape[0]).T.contiguous()    # [T, B]
            yf, yb = self.scan(gxf, gxb, m, self.wh, self.bh)
            return yf + yb
        b, t, _ = x.shape
        gates = gates.reshape(b, t, 2, gh)
        mask = time_mask(lengths, t)                             # [B, T]
        # Per step, direction 0 in time order and direction 1 flipped in time.
        gx = torch.stack([gates[:, :, 0], gates[:, :, 1].flip(1)])   # [2, B, T, GH]
        gx = gx.permute(2, 0, 1, 3).contiguous()                 # [T, 2, B, GH]
        m = torch.stack([mask, mask.flip(1)]).permute(2, 0, 1).contiguous()  # [T, 2, B]
        ys = self.scan_stacked(gx, m, self.wh, self.bh)          # [T, 2, B, H]
        return ys[:, 0].transpose(0, 1) + ys[:, 1].transpose(0, 1).flip(1)
