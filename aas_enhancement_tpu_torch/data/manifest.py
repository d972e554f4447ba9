"""Manifests: CSV lines ``wav_path,txt_path`` (counterpart of
``aas_enhancement_tpu/data/manifest.py``)."""

from __future__ import annotations


def read_manifest(path: str) -> list[tuple[str, str]]:
    """-> list of (wav_path, transcript_path)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                wav, txt = line.split(",", 1)
                out.append((wav, txt))
    return out


def read_transcript(txt_path: str) -> str:
    with open(txt_path) as f:
        return f.read().strip()
