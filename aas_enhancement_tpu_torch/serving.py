"""Serving export: the enhance program as a self-contained artifact (port of
``aas_enhancement_tpu/serving.py``).

``export_enhancer`` exports the whole inference program, STFT -> conv/BiLSTM
enhancer -> ISTFT (``enhance.py::EnhancePipeline``) with the trained weights
in it, through ``torch.export``: one ``ExportedProgram`` per padded input
shape bucket, saved with ``torch.export.save``, plus a manifest.  The four
kernels of the path are operators of ``ops/library.py`` (``aas_torch::stft``,
``::istft``, ``::masked_group_norm_act``, ``::lstm_scan_tm``), one node each
in the graph, so a loaded program launches the hand-written kernels, and
counts them, when it runs.  A server loads the artifact with
``load_enhancer`` and runs it with no model code and no checkpoint: the
loading side imports only ``ops/library.py`` (which registers the operators),
``config.py`` and the standard library.

Why shape buckets: the programs are exported with static shapes, as the JAX
package's are; the bucket set is the deployment contract (the training
pipeline's duration buckets, ``data/dataset.py``).  An artifact runs on the
device type it was exported on (its manifest's ``platforms``).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.ops import library  # noqa: F401  (registers the operators)
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device

_MANIFEST = "manifest.json"


def export_enhancer(cfg: Config, model, out_dir: str,
                    batch_sizes: tuple[int, ...] = (1, 8),
                    seconds: tuple[float, ...] = (8.0,),
                    device: torch.device | str = "cuda") -> dict:
    """Export the enhance program of ``model`` (an ``Enhancer`` living on
    ``device``: the card by default; without a GPU that raises, pass
    ``"cpu"``) for each (batch, samples) bucket and write the manifest;
    -> the manifest.

    The weights are saved in each program, so the artifact needs no
    checkpoint at serving time."""
    from aas_enhancement_tpu_torch.enhance import EnhancePipeline

    device = resolve_device(device)
    on = {p.device.type for p in model.parameters()}
    if on != {device.type}:
        raise ValueError(f"export_enhancer: the model lives on {sorted(on)}, not {device}")
    os.makedirs(out_dir, exist_ok=True)
    pipeline = EnhancePipeline(cfg, model).eval()
    sr = cfg.audio.sample_rate
    entries = []
    with torch.no_grad():
        for b in batch_sizes:
            for sec in seconds:
                n = int(sr * sec)
                example = (torch.zeros((b, n), dtype=torch.float32, device=device),
                           torch.full((b,), n, dtype=torch.int64, device=device))
                program = torch.export.export(pipeline, example)
                fname = f"enhance_b{b}_n{n}.pt2"
                torch.export.save(program, os.path.join(out_dir, fname))
                entries.append({"batch": b, "samples": n, "file": fname,
                                "platforms": [device.type]})

    manifest = {
        "kind": "aas_enhancement_tpu.enhancer",
        "sample_rate": sr,
        "entries": sorted(entries, key=lambda e: (e["batch"], e["samples"])),
        "config": json.loads(cfg.to_json()),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ServedEnhancer:
    """Loaded serving artifact: shape-bucket dispatch over exported programs.

    enhance(wav [B, n], lengths) pads B and n up to the smallest covering
    bucket, runs the loaded program on ``device`` (the card by default), and
    strips the padding, as the training pipeline's buckets do.  An artifact
    exported on another device type raises."""

    def __init__(self, out_dir: str, device: torch.device | str = "cuda"):
        self.device = resolve_device(device)
        with open(os.path.join(out_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.sample_rate = self.manifest["sample_rate"]
        self._programs = {}
        for e in self.manifest["entries"]:
            if e["platforms"] != [self.device.type]:
                raise ValueError(f"{out_dir}: {e['file']} was exported for "
                                 f"{e['platforms']}, not {self.device.type!r}")
            program = torch.export.load(os.path.join(out_dir, e["file"]))
            self._programs[(e["batch"], e["samples"])] = program.module()
        if not self._programs:
            raise ValueError(f"{out_dir}: empty serving manifest")

    def buckets(self) -> list[tuple[int, int]]:
        return sorted(self._programs)

    def _pick(self, b: int, n: int) -> tuple[int, int]:
        fits = [(pb, pn) for (pb, pn) in self._programs if pb >= b and pn >= n]
        if not fits:
            raise ValueError(
                f"no exported bucket covers batch={b}, samples={n}; "
                f"available: {self.buckets()}")
        return min(fits, key=lambda s: (s[0] * s[1], s))

    def enhance(self, wav: np.ndarray, lengths: np.ndarray | None = None
                ) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        b, n = wav.shape
        if lengths is None:
            lengths = np.full((b,), n, np.int64)
        pb, pn = self._pick(b, n)
        pad_wav = np.zeros((pb, pn), np.float32)
        pad_wav[:b, :n] = wav
        pad_len = np.zeros((pb,), np.int64)
        pad_len[:b] = np.asarray(lengths, np.int64)
        with torch.inference_mode():
            out = self._programs[(pb, pn)](torch.from_numpy(pad_wav).to(self.device),
                                           torch.from_numpy(pad_len).to(self.device))
        return out.cpu().numpy()[:b, :n]


def load_enhancer(out_dir: str, device: torch.device | str = "cuda") -> ServedEnhancer:
    return ServedEnhancer(out_dir, device)
