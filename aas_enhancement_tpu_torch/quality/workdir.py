"""What the quality protocols share: the e2e workdir, the streamed manifests,
the checkpoints they write and the native host beam.

``cli/e2e.py`` leaves in its workdir ``sweep_state.json`` (``checkpoint``,
``test_noisy``, ``test_clean``, ``dev_noisy``, ``train_noisy``,
``train_clean``) and ``checkpoint/``, the AAS train state with its
optimizers; the JAX scripts read ``params_pkl`` (a pickle) where the port
reads ``checkpoint``.  ``load`` opens it with ``train/loop.py::load_state``
(the networks, fresh optimizers) and, for a run that continues training
(``streaming_finetune_eval``), ``utils/checkpoint.py::restore`` on top (the
saved optimizers and step).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.data.wav import read_wav, write_wav
from aas_enhancement_tpu_torch.decode import beam
from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
from aas_enhancement_tpu_torch.train.loop import load_state
from aas_enhancement_tpu_torch.train.state import TrainState
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt


@dataclasses.dataclass
class Workdir:
    meta: dict            # sweep_state.json
    cfg: Config           # the AAS run's configuration
    state: TrainState     # its G, D and frozen AM (and, restored, G's and D's Adam)


def load(workdir: str, device: torch.device, optimizers: bool = False) -> Workdir:
    """The workdir's manifests and AAS train state on ``device``; with
    ``optimizers`` the saved optimizer state and step count too."""
    with open(os.path.join(workdir, "sweep_state.json")) as f:
        meta = json.load(f)
    state, cfg = load_state(meta["checkpoint"], device)
    if optimizers:
        ckpt.restore(meta["checkpoint"], state.step, state)
    return Workdir(meta, cfg, state)


def streamed_manifest(cfg: Config, enhancer, manifest: str, sdir: str, chunk: float,
                      lookahead: float, history: float, device: torch.device) -> str:
    """Every utterance of ``manifest`` through a fresh ``StreamingEnhancer``
    at (chunk, lookahead, history) seconds, written to ``sdir`` under its own
    file name and cut to the input's length; -> ``sdir/manifest.csv`` (the
    enhanced wavs beside the original transcripts)."""
    os.makedirs(sdir, exist_ok=True)
    lines = []
    for line in open(manifest).read().splitlines():
        wav_path, txt_path = line.split(",")
        wav, sr = read_wav(wav_path)
        eng = StreamingEnhancer(cfg, enhancer, chunk_seconds=chunk,
                                lookahead_seconds=lookahead, history_seconds=history,
                                device=device)
        out = np.concatenate([eng.feed(wav), eng.flush()])
        spath = os.path.join(sdir, os.path.basename(wav_path))
        write_wav(spath, out[: len(wav)], sr)
        lines.append(f"{spath},{txt_path}")
    smani = os.path.join(sdir, "manifest.csv")
    with open(smani, "w") as f:
        f.write("\n".join(lines) + "\n")
    return smani


def save_checkpoint(ck_dir: str, cfg: Config, state: TrainState) -> None:
    """``state`` as a train-CLI checkpoint directory (``config.json`` and the
    step), which ``load_state`` opens."""
    os.makedirs(ck_dir, exist_ok=True)
    with open(os.path.join(ck_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    ckpt.save(ck_dir, state.step, state)


def require_native_beam(device: torch.device) -> None:
    """Build the native beam decoder where it is missing; on a CUDA device
    the host beam must run it."""
    if not beam.available() and not beam.build() and device.type == "cuda":
        raise RuntimeError("the native beam decoder did not build "
                           "(utils/native_build.py); no decode on the Python route on "
                           "the card")


def check_beam_route(device: torch.device) -> None:
    """Raise when a host beam decode on a CUDA device took the Python route."""
    if device.type == "cuda" and beam.beam_decode.route != "native":
        raise RuntimeError(f"host beam took the {beam.beam_decode.route!r} route on the card")


def write_json(path: str, result: dict, indent: int = 2, end: str = "") -> None:
    with open(path, "w") as f:
        json.dump(result, f, indent=indent)
        f.write(end)
