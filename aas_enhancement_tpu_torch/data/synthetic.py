"""A synthetic noisy-speech corpus for smoke runs (counterpart of the plain
mode of ``aas_enhancement_tpu/data/synthetic.py``).

Each transcript is random words over A-Z and the apostrophe; each character
becomes an 80 ms formant-pair tone with vibrato under a Hann envelope, and
white, band-passed or amplitude-modulated noise is mixed in at a random SNR.
``generate_corpus(out_dir, n_utts, seed)`` writes the same files as the JAX
package's ``generate_corpus(out_dir, n_utts, seed, word_len=(2, 6))``.
"""

from __future__ import annotations

import os

import numpy as np

from aas_enhancement_tpu_torch.data.wav import write_wav

_CHARS = list("'ABCDEFGHIJKLMNOPQRSTUVWXYZ")


def _char_formants(c: str) -> tuple[float, float]:
    i = _CHARS.index(c) if c in _CHARS else 0
    return 220.0 + 40.0 * (i % 7), 900.0 + 150.0 * (i % 11)


def synth_utterance(text: str, sample_rate: int = 16000, char_dur: float = 0.08,
                    seed: int = 0) -> np.ndarray:
    """Transcript -> clean speech-like waveform, peak 0.7."""
    rng = np.random.default_rng(seed)
    n = int(char_dur * sample_rate)
    if not text:
        return np.zeros(n, np.float32)
    total = n * len(text)
    f1 = np.empty(total, np.float64)
    f2 = np.empty(total, np.float64)
    env = np.zeros(total, np.float32)
    prev = None
    for j, ch in enumerate(text):
        sl = slice(j * n, (j + 1) * n)
        if ch == " ":                     # hold the formants through silence
            f1[sl], f2[sl] = prev if prev else (300.0, 1200.0)
        else:
            prev = _char_formants(ch)
            f1[sl], f2[sl] = prev
            env[sl] = np.hanning(n).astype(np.float32) ** 0.5
    t = np.arange(total) / sample_rate
    vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t + rng.uniform(0, 2 * np.pi))
    ph1 = 2 * np.pi * np.cumsum(f1 * vib) / sample_rate
    ph2 = 2 * np.pi * np.cumsum(f2 * vib) / sample_rate
    x = 0.6 * np.sin(ph1) + 0.35 * np.sin(ph2) + 0.05 * rng.standard_normal(total)
    wav = (x * env).astype(np.float32)
    return (0.7 * wav / (np.max(np.abs(wav)) + 1e-8)).astype(np.float32)


def make_noise(n: int, kind: str, seed: int, sample_rate: int = 16000) -> np.ndarray:
    """Unit-variance noise: "white", "band" (300-3000 Hz) or "babble" (3 Hz AM)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    if kind == "band":
        spec = np.fft.rfft(x)
        freqs = np.fft.rfftfreq(n, 1.0 / sample_rate)
        spec[(freqs < 300) | (freqs > 3000)] = 0
        x = np.fft.irfft(spec, n=n).astype(np.float32)
    elif kind == "babble":
        am = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 3.0 * np.arange(n) / sample_rate
                                       + rng.uniform(0, 6.28)))
        x = (x * am).astype(np.float32)
    return x / (np.std(x) + 1e-8)


def mix_at_snr(clean: np.ndarray, noise: np.ndarray, snr_db: float) -> np.ndarray:
    """Additive mix at a target SNR, scaled down if it would clip."""
    p_clean = np.mean(clean ** 2) + 1e-12
    p_noise = np.mean(noise ** 2) + 1e-12
    mixed = clean + np.sqrt(p_clean / (p_noise * 10.0 ** (snr_db / 10.0))) * noise
    peak = np.max(np.abs(mixed))
    if peak > 1.0:
        mixed = mixed / peak
    return mixed.astype(np.float32)


def generate_corpus(out_dir: str, n_utts: int = 16, seed: int = 0,
                    sample_rate: int = 16000,
                    snr_range: tuple[float, float] = (0.0, 10.0)) -> dict[str, str]:
    """Write clean/noisy wavs, transcripts and two manifests under ``out_dir``.

    Returns {"clean": clean_manifest_path, "noisy": noisy_manifest_path}.
    """
    rng = np.random.default_rng(seed)
    for sub in ("clean", "noisy", "txt"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    lines = {"clean": [], "noisy": []}
    for i in range(n_utts):
        words = ["".join(rng.choice(_CHARS, size=int(rng.integers(2, 6))))
                 for _ in range(int(rng.integers(2, 5)))]
        text = " ".join(words)
        clean = synth_utterance(text, sample_rate, seed=seed + i)
        kind = ("white", "band", "babble")[i % 3]
        noise = make_noise(len(clean), kind, seed + 1000 + i, sample_rate)
        noisy = mix_at_snr(clean, noise, float(rng.uniform(*snr_range)))
        tpath = os.path.join(out_dir, "txt", f"utt{i:04d}.txt")
        with open(tpath, "w") as f:
            f.write(text)
        for sub, wav in (("clean", clean), ("noisy", noisy)):
            path = os.path.join(out_dir, sub, f"utt{i:04d}.wav")
            write_wav(path, wav, sample_rate)
            lines[sub].append(f"{path},{tpath}")
    manifests = {}
    for sub, entries in lines.items():
        manifests[sub] = os.path.join(out_dir, f"{sub}_manifest.csv")
        with open(manifests[sub], "w") as f:
            f.write("\n".join(entries) + "\n")
    return manifests
