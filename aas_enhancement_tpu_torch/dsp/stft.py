"""STFT / ISTFT and log-magnitude features, plain PyTorch (port of
``aas_enhancement_tpu/dsp/stft.py``).

These are the plain versions the CPU runs and the CUDA kernels
(``ops/cuda/stft.py``) are checked against.  Same algorithm as the JAX
reference: for hop | n_fft, framing is k = n_fft/hop hop-wide row slices of
the reshaped signal and the windowed DFT is k segment matrix products summed;
the ISTFT is the mirror image, k slice-adds, then window-square (COLA)
normalization clamped at 1e-8.  Any other hop takes the JAX package's
fallback: frames by gather (``frame_signal``) and one matrix product; the
overlap-add over the K = ceil(n_fft/hop) frames that can cover a sample
(each frame zero-padded to K hop-rows, K slice-adds).  Unlike the segment
route, the fallback ISTFT cuts its output to ``length`` and never zero-pads
up to it (``istft_length``).  Periodic windows, center reflect padding.
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


def stft_frames(num_samples: int, n_fft: int, hop_length: int,
                center: bool = True) -> int:
    """The frames ``stft`` returns: ``num_frames`` where hop | n_fft (the
    segment route), else ``frame_signal``'s count over the padded signal,
    which is one fewer for an odd n_fft with center when hop | num_samples."""
    if center and n_fft % hop_length:
        return 1 + (num_samples + 2 * (n_fft // 2) - n_fft) // hop_length
    return num_frames(num_samples, n_fft, hop_length, center)


def overlap(n_fft: int, hop_length: int) -> int:
    """K = ceil(n_fft / hop): the most frames that cover one sample, and the
    hop-rows a frame spans once zero-padded to a whole number of them."""
    return -(-n_fft // hop_length)


def istft_length(n_frames: int, n_fft: int, hop_length: int, center: bool,
                 length: int | None) -> int:
    """The samples ``istft`` returns: the overlap-add buffer, (T-1) hop +
    n_fft, less the center trim; ``length`` where given, except that where
    hop does not divide n_fft (the JAX fallback) the buffer is only cut to
    ``length``, never zero-padded up to it."""
    full = (n_frames - 1) * hop_length + n_fft - (n_fft // 2 if center else 0)
    if length is None:
        return full
    return length if n_fft % hop_length == 0 else min(length, full)


def center_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[B, n] -> [B, n + n_fft], reflect-padded by n_fft//2 on both sides."""
    return F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """[..., num_samples] -> [..., T, n_fft] frames (reflect-padded when center=True)."""
    if center:
        batch_shape = x.shape[:-1]
        x = center_pad(x.reshape(-1, x.shape[-1]), n_fft)
        x = x.reshape(batch_shape + x.shape[-1:])
    t = 1 + (x.shape[-1] - n_fft) // hop_length
    idx = torch.arange(t)[:, None] * hop_length + torch.arange(n_fft)[None, :]
    return x[..., idx.to(x.device)]


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann",
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Real STFT. [..., num_samples] -> (real, imag) each [..., T, n_fft//2+1]."""
    x = x.to(torch.float32)
    win = get_window(window, n_fft)
    wc, ws = _dft_bases_np(n_fft)
    wc = torch.from_numpy(win[:, None] * wc).to(x.device)   # window folded in
    ws = torch.from_numpy(win[:, None] * ws).to(x.device)
    if n_fft % hop_length:
        frames = frame_signal(x, n_fft, hop_length, center)
        return frames @ wc, frames @ ws
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


def pad_frames(frames: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """[..., n_fft] -> [..., K hop]: each frame zero-padded to whole hop-rows."""
    return F.pad(frames, (0, overlap(n_fft, hop_length) * hop_length - n_fft))


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """[B, T, K hop] -> [B, (T-1+K) hop]: frame t added at t * hop, K slice-adds."""
    b, t, width = frames.shape
    k = width // hop_length
    y = frames.new_zeros((b, t - 1 + k, hop_length))
    for j in range(k):
        y[:, j: j + t] += frames[..., j * hop_length: (j + 1) * hop_length]
    return y.reshape(b, -1)


def cola_norm(n_frames: int, n_fft: int, hop_length: int, window: str) -> np.ndarray:
    """Window-square sum over the overlap-add buffer, [(T-1)*hop + n_fft]."""
    hop, k = hop_length, overlap(n_fft, hop_length)
    w2 = np.zeros(k * hop, np.float32)
    w2[:n_fft] = get_window(window, n_fft) ** 2
    w2 = w2.reshape(k, hop)
    wsq = np.zeros((n_frames - 1 + k, hop), np.float32)
    for j in range(k):
        wsq[j: j + n_frames] += w2[j]
    return wsq.reshape(-1)[: (n_frames - 1) * hop + n_fft]


def trim(y: torch.Tensor, n_fft: int, center: bool,
         length: int | None, pad: bool = True) -> torch.Tensor:
    """Overlap-add buffer [B, L] -> output: center trim, then cut to length
    and, with ``pad`` (the segment route's rule; the fallback's is False),
    zero-pad up to it."""
    if center:
        y = y[:, n_fft // 2:]
    if length is not None:
        y = y[:, :length]
        if pad and y.shape[1] < length:
            y = F.pad(y, (0, length - y.shape[1]))
    return y


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """Inverse STFT via windowed overlap-add with COLA normalization.

    (re, im): [..., T, n_fft//2+1] -> [..., num_samples] (``istft_length``).
    """
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

    if n_fft % hop:
        y = overlap_add(pad_frames(re @ icos + im @ isin, n_fft, hop), hop)
        y = y[:, : (t - 1) * hop + n_fft]
    else:
        y = torch.zeros((b, t - 1 + k, hop), dtype=torch.float32, device=re.device)
        for j in range(k):
            seg = (re @ icos[:, j * hop: (j + 1) * hop]
                   + im @ isin[:, j * hop: (j + 1) * hop])
            y[:, j: j + t] += seg
        y = y.reshape(b, -1)
    wsq = torch.from_numpy(cola_norm(t, n_fft, hop, window)).to(re.device)
    y = trim(y / torch.clamp(wsq, min=1e-8), n_fft, center, length, pad=n_fft % hop == 0)
    return y.reshape(batch_shape + y.shape[1:])


def log_magnitude_features(x: torch.Tensor, n_fft: int, hop_length: int,
                           window: str = "hann", center: bool = True,
                           normalize: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """wav [..., n] -> (log1p-mag [..., T, F], mag [..., T, F], phase [..., T, F]),
    with ``normalize`` per utterance: minus the mean over (T, F), divided by
    the population std over (T, F) + 1e-5."""
    re, im = stft(x, n_fft, hop_length, window, center)
    mag = magnitude(re, im)
    ph = phase(re, im)
    log_mag = torch.log1p(mag)
    if normalize:
        mean = log_mag.mean(dim=(-2, -1), keepdim=True)
        std = log_mag.std(dim=(-2, -1), keepdim=True, correction=0)
        log_mag = (log_mag - mean) / (std + 1e-5)
    return log_mag, mag, ph


def reconstruct(mag: torch.Tensor, ph: torch.Tensor, n_fft: int, hop_length: int,
                window: str = "hann", center: bool = True,
                length: int | None = None) -> torch.Tensor:
    """Enhanced magnitude + (noisy) phase -> waveform."""
    return istft(mag * torch.cos(ph), mag * torch.sin(ph), n_fft, hop_length,
                 window, center, length)
