"""Bidirectional masked LSTM and GRU recurrences, forward: CUDA kernels
(``csrc/lstm_tm.cu``, ``csrc/gru_tm.cu``) and their plain versions.

Replace ``aas_enhancement_tpu/ops/pallas/rnn_kernel.py::lstm_scan_tm`` and
``::gru_scan_tm`` (forward).  Interface as there: gxf, gxb [T, B, G*H] in
natural time order (the two halves of the hoisted input product), m [T, B],
wh [2, H, G*H], bh [2, G*H] -> (yf, yb) [T, B, H], where yb[t] is the
backward direction's output at time t; G = 4 (LSTM) or 3 (GRU).
``lstm_scan_tm`` / ``gru_scan_tm`` take the kernel for CUDA tensors (counted
in ``.launches``) and the ``*_plain`` version for CPU tensors.
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
    yf, yb = _launch("lstm_scan_tm", "aas_lstm_tm_fwd", 4, "B1'",
                     gxf, gxb, m, wh, bh)
    lstm_scan_tm.launches += 1
    return yf, yb


lstm_scan_tm.launches = 0


def gru_scan_tm_plain(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                      wh: torch.Tensor, bh: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step loop with both directions stacked on one [2, B, H] state."""
    t_len, b, g3 = gxf.shape
    h_dim = g3 // 3
    h = gxf.new_zeros((2, b, h_dim))
    ys_f, ys_b = [], []
    for s in range(t_len):
        tb = t_len - 1 - s                       # direction 1 walks backwards
        gx_t = torch.stack([gxf[s], gxb[tb]])
        m_t = torch.stack([m[s], m[tb]])[..., None]
        gh = torch.bmm(h, wh) + bh[:, None, :]   # bh's n-slice stays inside r * (...)
        xr, xz, xn = gx_t.split(h_dim, dim=-1)
        hr, hz, hn = gh.split(h_dim, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h_new = (1.0 - z) * n + z * h
        y = m_t * h_new
        h = m_t * h_new + (1.0 - m_t) * h
        ys_f.append(y[0])
        ys_b.append(y[1])
    return torch.stack(ys_f), torch.stack(ys_b[::-1])


def gru_scan_tm(gxf: torch.Tensor, gxb: torch.Tensor, m: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bidirectional GRU forward, time-major (see module docstring)."""
    if not uses_kernel("gru_scan_tm", gxf):
        return gru_scan_tm_plain(gxf, gxb, m, wh, bh)
    yf, yb = _launch("gru_scan_tm", "aas_gru_tm_fwd", 3, "B2'", gxf, gxb, m, wh, bh)
    gru_scan_tm.launches += 1
    return yf, yb


gru_scan_tm.launches = 0


def _launch(name: str, entry: str, gates: int, backward: str, gxf: torch.Tensor,
            gxb: torch.Tensor, m: torch.Tensor, wh: torch.Tensor, bh: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Check what the recurrence kernels take, raise otherwise, and launch."""
    check_kernel_inputs(name, (gxf, gxb, m, wh, bh), backward=backward)
    t_len, b, g = gxf.shape
    h_dim = g // gates
    if (gxb.shape != gxf.shape or g % gates or m.shape != (t_len, b)
            or wh.shape != (2, h_dim, g) or bh.shape != (2, g)):
        raise ValueError(
            f"{name}: shapes gxf {tuple(gxf.shape)} gxb {tuple(gxb.shape)} "
            f"m {tuple(m.shape)} wh {tuple(wh.shape)} bh {tuple(bh.shape)}")
    if gxf.stride() != gxb.stride() or gxf.stride(2) != 1:
        raise ValueError(f"{name}: gxf/gxb need unit last stride and equal strides")
    if not (m.is_contiguous() and wh.is_contiguous() and bh.is_contiguous()):
        raise ValueError(f"{name}: m, wh, bh must be contiguous")
    if gates == 3 and (h_dim % 4 or wh.data_ptr() % 16 or bh.data_ptr() % 16):
        raise ValueError(f"{name}: needs H % 4 == 0 and 16-byte aligned wh, bh "
                         "(the kernel reads them as float4)")
    yf = torch.empty((t_len, b, h_dim), dtype=torch.float32, device=gxf.device)
    yb = torch.empty_like(yf)
    err = getattr(kernel_build.load_library(), entry)(
        gxf.data_ptr(), gxb.data_ptr(), gxf.stride(0), gxf.stride(1),
        m.data_ptr(), wh.data_ptr(), bh.data_ptr(), yf.data_ptr(), yb.data_ptr(),
        t_len, b, h_dim, torch.cuda.current_stream(gxf.device).cuda_stream)
    kernel_build.check(err, entry)
    return yf, yb
