"""Host-side waveform augmentation (a copy of
``aas_enhancement_tpu/data/augment.py``, held to it by
``tests/test_torch_augment.py``).

- NoiseInjector: a random noise clip from a directory of wavs, at a random
  offset, mixed at a random SNR;
- gain_perturb: a uniform dB gain;
- speed_perturb: resampling by a random rate through linear interpolation;
- augment_wav: speed, gain, then noise with probability ``noise_prob``.

Every draw comes from the caller's ``np.random.Generator``, so for the same
generator state the arrays equal the JAX package's bit for bit; the dataset
keys it on (epoch, manifest position), so a resumed run sees the same audio.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from aas_enhancement_tpu_torch.data.wav import read_wav


class NoiseInjector:
    """Mixes random noise wavs into clean speech at a random SNR."""

    def __init__(self, noise_dir: str, sample_rate: int = 16000):
        self.paths = sorted(glob.glob(os.path.join(noise_dir, "*.wav")))
        if not self.paths:
            raise ValueError(f"no noise wavs in {noise_dir}")
        self.sample_rate = sample_rate
        self._cache: dict[str, np.ndarray] = {}

    def _noise(self, path: str) -> np.ndarray:
        if path not in self._cache:
            wav, sr = read_wav(path)
            if sr != self.sample_rate:
                raise ValueError(f"{path}: noise sample rate {sr}")
            self._cache[path] = wav
        return self._cache[path]

    def __call__(self, wav: np.ndarray, rng: np.random.Generator,
                 snr_range: tuple[float, float] = (0.0, 15.0)) -> np.ndarray:
        noise = self._noise(self.paths[int(rng.integers(len(self.paths)))])
        if len(noise) >= len(wav):
            off = int(rng.integers(0, len(noise) - len(wav) + 1))
            clip = noise[off: off + len(wav)]
        else:
            reps = int(np.ceil(len(wav) / len(noise)))
            clip = np.tile(noise, reps)[: len(wav)]
        snr_db = float(rng.uniform(*snr_range))
        p_sig = np.mean(wav ** 2) + 1e-12
        p_noise = np.mean(clip ** 2) + 1e-12
        scale = np.sqrt(p_sig / (p_noise * 10.0 ** (snr_db / 10.0)))
        out = wav + scale * clip
        peak = np.max(np.abs(out))
        return (out / peak if peak > 1.0 else out).astype(np.float32)


def gain_perturb(wav: np.ndarray, rng: np.random.Generator,
                 db_range: tuple[float, float] = (-6.0, 8.0)) -> np.ndarray:
    gain = 10.0 ** (float(rng.uniform(*db_range)) / 20.0)
    out = wav * gain
    peak = np.max(np.abs(out))
    return (out / peak if peak > 1.0 else out).astype(np.float32)


def speed_perturb(wav: np.ndarray, rng: np.random.Generator,
                  rate_range: tuple[float, float] = (0.9, 1.1)) -> np.ndarray:
    """Tempo change by linear-interpolation resampling (pitch shifts too — the
    standard cheap speed perturb)."""
    rate = float(rng.uniform(*rate_range))
    n_out = max(int(round(len(wav) / rate)), 1)
    src = np.linspace(0.0, len(wav) - 1.0, n_out)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, len(wav) - 1)
    frac = (src - lo).astype(np.float32)
    return (wav[lo] * (1.0 - frac) + wav[hi] * frac).astype(np.float32)


def augment_wav(wav: np.ndarray, rng: np.random.Generator,
                noise: NoiseInjector | None = None,
                noise_prob: float = 0.4,
                snr_range: tuple[float, float] = (0.0, 15.0),
                speed: bool = True, gain: bool = True) -> np.ndarray:
    """The reference's load_randomly_augmented_audio equivalent."""
    if speed:
        wav = speed_perturb(wav, rng)
    if gain:
        wav = gain_perturb(wav, rng)
    if noise is not None and rng.uniform() < noise_prob:
        wav = noise(wav, rng, snr_range)
    return wav
