"""Minimal WAV I/O (host-side, numpy only; counterpart of
``aas_enhancement_tpu/data/wav.py``).

Reads PCM16/PCM32/float32 RIFF files (first channel of multi-channel ones) and
writes PCM16 mono.
"""

from __future__ import annotations

import struct

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE file -> (float32 samples in [-1, 1] of shape [n], sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        chunk_sz = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8: pos + 8 + chunk_sz]
        if chunk_id == b"fmt ":
            audio_fmt, n_ch, sr, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            fmt = (audio_fmt, n_ch, sr, bits)
        elif chunk_id == b"data":
            samples = body
        pos += 8 + chunk_sz + (chunk_sz & 1)  # chunks are word-aligned

    if fmt is None or samples is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, bits = fmt

    if audio_fmt == 1 and bits == 16:
        x = np.frombuffer(samples, dtype="<i2").astype(np.float32) / 32768.0
    elif audio_fmt == 1 and bits == 32:
        x = np.frombuffer(samples, dtype="<i4").astype(np.float32) / 2147483648.0
    elif audio_fmt == 3 and bits == 32:
        x = np.frombuffer(samples, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format (fmt={audio_fmt}, bits={bits})")

    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)[:, 0].copy()
    return x, sr


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float32 samples in [-1, 1] as PCM16 mono WAV."""
    pcm = np.round(np.clip(np.asarray(x, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    body = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)
