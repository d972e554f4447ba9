"""STFT / ISTFT, plain PyTorch (port of ``aas_enhancement_tpu/dsp/stft.py``).

These are the plain versions the CPU runs and the CUDA kernels
(``ops/cuda/stft.py``) are checked against.  Same algorithm as the JAX
reference: for hop | n_fft, framing is k = n_fft/hop hop-wide row slices of
the reshaped signal and the windowed DFT is k segment matrix products summed;
the ISTFT is the mirror image, k slice-adds, then window-square (COLA)
normalization clamped at 1e-8.  Periodic windows, center reflect padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def _dft_bases_np(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT bases [n_fft, n_fft//2+1] (rfft convention: cos, -sin)."""
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


def get_window(name: str, n: int) -> np.ndarray:
    """Periodic window (matches librosa/scipy sym=False) as float32 numpy."""
    if name == "hann":
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)
    if name == "hamming":
        return (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)
    raise ValueError(f"unknown window: {name!r}")


def num_frames(num_samples: int, n_fft: int, hop_length: int,
               center: bool = True) -> int:
    """Static frame count for a given signal length."""
    if center:
        return 1 + num_samples // hop_length
    return 1 + (num_samples - n_fft) // hop_length


def _check_hop(n_fft: int, hop_length: int) -> None:
    if n_fft % hop_length:
        raise ValueError(f"n_fft {n_fft} must be a multiple of hop {hop_length} "
                         "(the other case is not ported)")


def center_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[B, n] -> [B, n + n_fft], reflect-padded by n_fft//2 on both sides."""
    return F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann",
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT. [..., num_samples] -> (real, imag) each [..., T, n_fft//2+1]."""
    _check_hop(n_fft, hop_length)
    x = x.to(torch.float32)
    batch_shape = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    b, n = x.shape
    hop = hop_length
    k = n_fft // hop
    if center:
        x = center_pad(x, n_fft)
    t = num_frames(n, n_fft, hop, center)
    rows_needed = t - 1 + k
    need = rows_needed * hop - x.shape[1]
    if need > 0:
        x = F.pad(x, (0, need))
    rows = x[:, : rows_needed * hop].reshape(b, rows_needed, hop)

    win = get_window(window, n_fft)
    wc, ws = _dft_bases_np(n_fft)
    wc = torch.from_numpy(win[:, None] * wc).to(x.device)   # window folded in
    ws = torch.from_numpy(win[:, None] * ws).to(x.device)
    re = im = 0.0
    for j in range(k):
        seg = rows[:, j: j + t]                               # [B, T, hop]
        re = re + seg @ wc[j * hop: (j + 1) * hop]
        im = im + seg @ ws[j * hop: (j + 1) * hop]
    return (re.reshape(batch_shape + re.shape[1:]),
            im.reshape(batch_shape + im.shape[1:]))


def magnitude(re: torch.Tensor, im: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(re * re + im * im + eps)


def phase(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.atan2(im, re)


def inverse_weights(n_fft: int) -> np.ndarray:
    """g_k for the n_fft//2+1 bins: 1 at DC and Nyquist, 2 elsewhere (the
    inverse real DFT counts each interior bin for its mirror)."""
    g = np.full((n_fft // 2 + 1,), 2.0, np.float32)
    g[0] = 1.0
    if n_fft % 2 == 0:
        g[-1] = 1.0
    return g


def cola_norm(n_frames: int, n_fft: int, hop_length: int, window: str) -> np.ndarray:
    """Window-square sum over the overlap-add buffer, [(T-1)*hop + n_fft]."""
    hop = hop_length
    w2 = (get_window(window, n_fft) ** 2).reshape(n_fft // hop, hop)
    wsq = np.zeros((n_frames - 1 + n_fft // hop, hop), np.float32)
    for j in range(n_fft // hop):
        wsq[j: j + n_frames] += w2[j]
    return wsq.reshape(-1)


def trim(y: torch.Tensor, n_fft: int, center: bool,
         length: int | None) -> torch.Tensor:
    """Overlap-add buffer [B, L] -> output: center trim, then cut/pad to length."""
    if center:
        y = y[:, n_fft // 2:]
    if length is not None:
        y = y[:, :length]
        if y.shape[1] < length:
            y = F.pad(y, (0, length - y.shape[1]))
    return y


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT via windowed overlap-add with COLA normalization.

    (re, im): [..., T, n_fft//2+1] -> [..., num_samples].
    """
    _check_hop(n_fft, hop_length)
    batch_shape = re.shape[:-2]
    re = re.reshape((-1,) + re.shape[-2:])
    im = im.reshape((-1,) + im.shape[-2:])
    b, t, _ = re.shape
    hop = hop_length
    k = n_fft // hop

    win = get_window(window, n_fft)
    wc, ws = _dft_bases_np(n_fft)
    # x = (1/n_fft) * (re @ (g*cos)^T + im @ (g*sin)^T) (sin basis already
    # negated); the synthesis window folds in.
    wgt = inverse_weights(n_fft)
    icos = torch.from_numpy((wc * wgt[None, :]).T / n_fft * win[None, :]).to(re.device)
    isin = torch.from_numpy((ws * wgt[None, :]).T / n_fft * win[None, :]).to(re.device)

    y = torch.zeros((b, t - 1 + k, hop), dtype=torch.float32, device=re.device)
    for j in range(k):
        seg = (re @ icos[:, j * hop: (j + 1) * hop]
               + im @ isin[:, j * hop: (j + 1) * hop])
        y[:, j: j + t] += seg
    y = y.reshape(b, -1)
    wsq = torch.from_numpy(cola_norm(t, n_fft, hop, window)).to(re.device)
    y = trim(y / torch.clamp(wsq, min=1e-8), n_fft, center, length)
    return y.reshape(batch_shape + y.shape[1:])


def reconstruct(mag: torch.Tensor, ph: torch.Tensor, n_fft: int, hop_length: int,
                window: str = "hann", center: bool = True,
                length: int | None = None) -> torch.Tensor:
    """Enhanced magnitude + (noisy) phase -> waveform."""
    return istft(mag * torch.cos(ph), mag * torch.sin(ph), n_fft, hop_length,
                 window, center, length)
