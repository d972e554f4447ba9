"""The enhance path's kernels as PyTorch operators (namespace ``aas_torch``).

``stft`` (B4), ``istft`` (B5), ``masked_group_norm_act`` (B3) and the
time-major recurrences ``lstm_scan_tm`` (B1) and ``gru_scan_tm`` (B2) are
registered with ``torch.library.custom_op``.  Each has two implementations:
on the CPU the kernel's plain version, on CUDA the kernel launcher of
``ops/cuda/{stft,gn,rnn}.py``, which reads the data (alignment checks,
pointers), picks the route, holds the window and DFT-table caches and counts
the launch.  A ``register_fake`` gives each output's shape, so
``torch.export`` traces one node per operator and a saved program calls the
launcher when it runs: its launches count then, as the live path's do.  The
schemas carry scalars only, never a cached tensor.  The GroupNorm and the
recurrences give their outputs in their streams' dtype (float32, or bfloat16
for a bf16 model), the STFT and the ISTFT float32.

The gradient-free branch of each wrapper (``ops/cuda/stft.py::stft`` and the
others) calls the operator on both devices; where a gradient is wanted the
wrappers keep their autograd Functions (CUDA) or the plain versions (CPU),
so no operator registers an autograd formula.  A CUDA tensor reaches its
kernel or raises; no operator falls back to its plain version.

Importing this module registers the operators: ``serving.py``'s loading
side imports it, and no model or training code.
"""

from __future__ import annotations

import torch
from torch import Tensor

from aas_enhancement_tpu_torch.dsp.stft import istft_length, stft_frames
from aas_enhancement_tpu_torch.ops.cuda import gn as _gn
from aas_enhancement_tpu_torch.ops.cuda import rnn as _rnn
from aas_enhancement_tpu_torch.ops.cuda import stft as _stft

NAMESPACE = "aas_torch"
OPERATORS = ("stft", "istft", "masked_group_norm_act", "lstm_scan_tm", "gru_scan_tm")

# The kernel modules import this one and call the operators at run time;
# each implementation below reads the modules' attributes when it runs, so
# the order in which the modules are first imported does not matter.


def _fresh(*ts: Tensor):
    """Contiguous copies at offset 0 of a plain version's outputs that are
    views (the trimmed ISTFT, a recurrence's direction): an operator's
    outputs are laid out as its fake implementation says, as the kernels'
    are."""
    out = tuple(t.clone(memory_format=torch.contiguous_format) for t in ts)
    return out[0] if len(out) == 1 else out


@torch.library.custom_op(f"{NAMESPACE}::stft", mutates_args=(), device_types="cpu")
def stft(x: Tensor, n_fft: int, hop_length: int, window: str, center: bool
         ) -> tuple[Tensor, Tensor]:
    """[B, n] -> (re, im) [B, T, n_fft//2+1]."""
    return _stft.stft_plain(x, n_fft, hop_length, window, center)


@stft.register_kernel("cuda")
def _(x, n_fft, hop_length, window, center):
    return _stft.stft_kernel(x, n_fft, hop_length, window, center)


@stft.register_fake
def _(x, n_fft, hop_length, window, center):
    shape = (x.shape[0], stft_frames(x.shape[1], n_fft, hop_length, center), n_fft // 2 + 1)
    return x.new_empty(shape, dtype=torch.float32), x.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::istft", mutates_args=(), device_types="cpu")
def istft(re: Tensor, im: Tensor, n_fft: int, hop_length: int, window: str, center: bool,
          length: int | None) -> Tensor:
    """(re, im) [B, T, n_fft//2+1] -> wav [B, istft_length(...)]: ``length``,
    or the trimmed overlap-add length, (T-1) hop + n_fft less the center
    trim, and no more than that where hop does not divide n_fft."""
    return _fresh(_stft.istft_plain(re, im, n_fft, hop_length, window, center, length))


@istft.register_kernel("cuda")
def _(re, im, n_fft, hop_length, window, center, length):
    return _stft.istft_kernel(re, im, n_fft, hop_length, window, center, length)


@istft.register_fake
def _(re, im, n_fft, hop_length, window, center, length):
    shape = (re.shape[0], istft_length(re.shape[1], n_fft, hop_length, center, length))
    return re.new_empty(shape, dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::masked_group_norm_act", mutates_args=(),
                         device_types="cpu")
def masked_group_norm_act(x: Tensor, scale: Tensor, bias: Tensor, lengths: Tensor,
                          num_groups: int, eps: float, act: str, slope: float) -> Tensor:
    """Masked GroupNorm + activation over [B, T, F, C]."""
    return _gn.masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=num_groups,
                                           eps=eps, act=act, slope=slope)


@masked_group_norm_act.register_kernel("cuda")
def _(x, scale, bias, lengths, num_groups, eps, act, slope):
    return _gn.gn_kernel(x, scale, bias, lengths, num_groups, eps, act, slope)[0]


@masked_group_norm_act.register_fake
def _(x, scale, bias, lengths, num_groups, eps, act, slope):
    return torch.empty_like(x)          # x's dtype: float32 or bfloat16


def _scan_fake(gxf, gxb, m, wh, bh):
    t, b, _ = gxf.shape
    shape = (t, b, wh.shape[1])
    return gxf.new_empty(shape), gxf.new_empty(shape)     # gx's dtype


@torch.library.custom_op(f"{NAMESPACE}::lstm_scan_tm", mutates_args=(), device_types="cpu")
def lstm_scan_tm(gxf: Tensor, gxb: Tensor, m: Tensor, wh: Tensor, bh: Tensor
                 ) -> tuple[Tensor, Tensor]:
    """Fused bidirectional LSTM, time-major: -> (yf, yb) [T, B, H]."""
    return _fresh(*_rnn.lstm_scan_tm_plain(gxf, gxb, m, wh, bh))


@lstm_scan_tm.register_kernel("cuda")
def _(gxf, gxb, m, wh, bh):
    return _rnn.scan_kernel("lstm_scan_tm", (gxf, gxb), m, wh, bh)


@torch.library.custom_op(f"{NAMESPACE}::gru_scan_tm", mutates_args=(), device_types="cpu")
def gru_scan_tm(gxf: Tensor, gxb: Tensor, m: Tensor, wh: Tensor, bh: Tensor
                ) -> tuple[Tensor, Tensor]:
    """Fused bidirectional GRU, time-major: -> (yf, yb) [T, B, H]."""
    return _fresh(*_rnn.gru_scan_tm_plain(gxf, gxb, m, wh, bh))


@gru_scan_tm.register_kernel("cuda")
def _(gxf, gxb, m, wh, bh):
    return _rnn.scan_kernel("gru_scan_tm", (gxf, gxb), m, wh, bh)


lstm_scan_tm.register_fake(_scan_fake)
gru_scan_tm.register_fake(_scan_fake)
