"""STFT and ISTFT: CUDA kernels (``csrc/stft.cu``, ``csrc/istft.cu``) and their
plain versions.

Replace ``aas_enhancement_tpu/ops/pallas/stft_kernel.py::stft_pallas`` and
``::istft_pallas``.  ``stft``/``istft`` here take the kernel for a CUDA tensor
and the plain segment-DFT (``dsp/stft.py``, re-exported as ``stft_plain`` and
``istft_plain``) for a CPU tensor.  As in the Pallas wrappers, the center
reflect pad happens before the STFT kernel, and the center trim and length
padding after the ISTFT kernel.  Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

import functools

import torch

from aas_enhancement_tpu_torch.dsp.stft import (
    _check_hop, center_pad, get_window, istft as istft_plain, num_frames,
    stft as stft_plain, trim)
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.utils import kernel_build

__all__ = ["stft", "istft", "stft_plain", "istft_plain"]


@functools.lru_cache(maxsize=8)
def _window(name: str, n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(get_window(name, n_fft)).to(device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: str = "hann",
         center: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, num_samples] -> (re, im) each [B, T, n_fft//2+1]."""
    if not uses_kernel("stft", x):
        return stft_plain(x, n_fft, hop_length, window, center)
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("stft", (x,), backward="A8")
    if x.ndim != 2:
        raise ValueError(f"stft: needs [B, n], got {tuple(x.shape)}")
    b, n = x.shape
    xp = (center_pad(x, n_fft) if center else x).contiguous()
    t = num_frames(n, n_fft, hop_length, center)
    f = n_fft // 2 + 1
    re = torch.empty((b, t, f), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    win = _window(window, n_fft, x.device)
    err = kernel_build.load_library().aas_stft(
        xp.data_ptr(), win.data_ptr(), re.data_ptr(), im.data_ptr(),
        b, xp.shape[1], t, n_fft, hop_length,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(err, "aas_stft")
    stft.launches += 1
    return re, im


stft.launches = 0


def istft(re: torch.Tensor, im: torch.Tensor, n_fft: int, hop_length: int,
          window: str = "hann", center: bool = True,
          length: int | None = None) -> torch.Tensor:
    """(re, im) [B, T, n_fft//2+1] -> wav [B, num_samples]."""
    if not uses_kernel("istft", re):
        return istft_plain(re, im, n_fft, hop_length, window, center, length)
    _check_hop(n_fft, hop_length)
    check_kernel_inputs("istft", (re, im), backward="A8")
    if re.ndim != 3 or re.shape != im.shape or re.shape[2] != n_fft // 2 + 1:
        raise ValueError(f"istft: needs re, im [B, T, {n_fft // 2 + 1}], got "
                         f"{tuple(re.shape)}, {tuple(im.shape)}")
    re, im = re.contiguous(), im.contiguous()
    b, t, _ = re.shape
    y = torch.empty((b, (t - 1 + n_fft // hop_length) * hop_length),
                    dtype=torch.float32, device=re.device)
    win = _window(window, n_fft, re.device)
    err = kernel_build.load_library().aas_istft(
        re.data_ptr(), im.data_ptr(), win.data_ptr(), y.data_ptr(),
        b, t, n_fft, hop_length,
        torch.cuda.current_stream(re.device).cuda_stream)
    kernel_build.check(err, "aas_istft")
    istft.launches += 1
    return trim(y, n_fft, center, length)


istft.launches = 0
