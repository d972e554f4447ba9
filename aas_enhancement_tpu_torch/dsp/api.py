"""STFT/ISTFT entry points taking an ``AudioConfig`` (port of
``aas_enhancement_tpu/dsp/api.py``).

There is no ``stft_impl`` switch: a CUDA tensor runs the CUDA kernels and a
CPU tensor the plain segment-DFT (``ops/cuda/stft.py`` routes by device).
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.config import AudioConfig
from aas_enhancement_tpu_torch.ops.cuda import stft as _kernels


def stft(a: AudioConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _kernels.stft(x, a.n_fft, a.hop_length, a.window, a.center)


def istft(a: AudioConfig, re: torch.Tensor, im: torch.Tensor,
          length: int | None = None) -> torch.Tensor:
    return _kernels.istft(re, im, a.n_fft, a.hop_length, a.window, a.center, length)


def reconstruct(a: AudioConfig, mag: torch.Tensor, ph: torch.Tensor,
                length: int | None = None) -> torch.Tensor:
    return istft(a, mag * torch.cos(ph), mag * torch.sin(ph), length)
