"""STFT/ISTFT entry points taking an ``AudioConfig`` (port of
``aas_enhancement_tpu/dsp/api.py``).

One implementation a device: a CUDA tensor runs the CUDA kernels and a CPU
tensor the plain segment-DFT (``ops/cuda/stft.py`` routes by device), for
every ``AudioConfig.stft_impl``.  The JAX package picks between its XLA
matmul-DFT and its Pallas kernels by that field; the port keeps the field so
that one config loads in both, and keeps its one check: ``"pallas"`` asks
n_fft == 2 * hop, so a config the JAX package refuses is refused here too.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.config import AudioConfig
from aas_enhancement_tpu_torch.ops.cuda import stft as _kernels


def _check_impl(a: AudioConfig) -> None:
    if getattr(a, "stft_impl", "auto") == "pallas" and a.n_fft != 2 * a.hop_length:
        raise ValueError("stft_impl=pallas requires n_fft == 2*hop_length")


def stft(a: AudioConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    _check_impl(a)
    return _kernels.stft(x, a.n_fft, a.hop_length, a.window, a.center)


def istft(a: AudioConfig, re: torch.Tensor, im: torch.Tensor,
          length: int | None = None) -> torch.Tensor:
    _check_impl(a)
    return _kernels.istft(re, im, a.n_fft, a.hop_length, a.window, a.center, length)


def reconstruct(a: AudioConfig, mag: torch.Tensor, ph: torch.Tensor,
                length: int | None = None) -> torch.Tensor:
    return istft(a, mag * torch.cos(ph), mag * torch.sin(ph), length)
