"""Bidirectional masked LSTM recurrence, forward: CUDA kernel
(``csrc/lstm_tm.cu``) and its plain version.

Replaces ``aas_enhancement_tpu/ops/pallas/rnn_kernel.py::lstm_scan_tm``
(forward).  Interface as there: gxf, gxb [T, B, 4H] in natural time order
(the two halves of the hoisted input product), m [T, B], wh [2, H, 4H],
bh [2, 4H] -> (yf, yb) [T, B, H], where yb[t] is the backward direction's
output at time t.  ``lstm_scan_tm`` takes the kernel for CUDA tensors
(counted in ``.launches``) and ``lstm_scan_tm_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build


def lstm_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                       wh: torch.Tensor, bh: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop with both directions stacked on one [2, B, H] state."""
    t_len, b, g4 = gxf.shape
    h_dim = g4 // 4
    h = gxf.new_zeros((2, b, h_dim))
    c = gxf.new_zeros((2, b, h_dim))
    ys_f, ys_b = [], []
    for s in range(t_len):
        tb = t_len - 1 - s                       # direction 1 walks backwards
        gx_t = torch.stack([gxf[s], gxb[tb]])
        m_t = torch.stack([m[s], m[tb]])[..., None]
        gg = gx_t + (torch.bmm(h, wh) + bh[:, None, :])
        i, f, gc, o = gg.split(h_dim, dim=-1)
        c_new = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(gc)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        h = m_t * h_new + (1.0 - m_t) * h
        c = m_t * c_new + (1.0 - m_t) * c
        y = h_new * m_t
        ys_f.append(y[0])
        ys_b.append(y[1])
    return torch.stack(ys_f), torch.stack(ys_b[::-1])


def lstm_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                 wh: torch.Tensor, bh: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional LSTM forward, time-major (see module docstring)."""
    if not uses_kernel("lstm_scan_tm", gxf):
        return lstm_scan_tm_plain(gxf, gxb, m, wh, bh)
    check_kernel_inputs("lstm_scan_tm", (gxf, gxb, m, wh, bh), backward="B1'")
    t_len, b, g4 = gxf.shape
    h_dim = g4 // 4
    if (gxb.shape != gxf.shape or g4 % 4 or m.shape != (t_len, b)
            or wh.shape != (2, h_dim, g4) or bh.shape != (2, g4)):
        raise ValueError(
            f"lstm_scan_tm: shapes gxf {tuple(gxf.shape)} gxb {tuple(gxb.shape)} "
            f"m {tuple(m.shape)} wh {tuple(wh.shape)} bh {tuple(bh.shape)}")
    if gxf.stride() != gxb.stride() or gxf.stride(2) != 1:
        raise ValueError("lstm_scan_tm: gxf/gxb need unit last stride and equal strides")
    if not (m.is_contiguous() and wh.is_contiguous() and bh.is_contiguous()):
        raise ValueError("lstm_scan_tm: m, wh, bh must be contiguous")
    yf = torch.empty((t_len, b, h_dim), dtype=torch.float32, device=gxf.device)
    yb = torch.empty_like(yf)
    err = kernel_build.load_library().aas_lstm_tm_fwd(
        gxf.data_ptr(), gxb.data_ptr(), gxf.stride(0), gxf.stride(1),
        m.data_ptr(), wh.data_ptr(), bh.data_ptr(), yf.data_ptr(), yb.data_ptr(),
        t_len, b, h_dim, torch.cuda.current_stream(gxf.device).cuda_stream)
    kernel_build.check(err, "aas_lstm_tm_fwd")
    lstm_scan_tm.launches += 1
    return yf, yb


lstm_scan_tm.launches = 0
