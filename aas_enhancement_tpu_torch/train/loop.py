"""The training loop: bucketed batches -> train steps -> metric records (port
of ``aas_enhancement_tpu/train/loop.py``, the part that runs the step).

Epochs over the noisy dataset's bucketed batches (the JAX package's order);
for ``adversarial`` / ``aas`` each batch gets an unpaired clean batch of the
same padded length; ``am`` trains the AM on the one manifest (typically the
clean corpus) and, with ``distill_lambda`` > 0, anchors it to a frozen copy of
the AM as the run started.  Real rows weigh 1 and the repeat-padded rows of a
short batch 0 (``row_weights``; every clean row weighs 1).  Every
``log_every`` steps, the first and the last, a record {step, epoch,
utts_per_sec, metrics...} is kept and printed to stderr as a JSON line.
Batches are assembled synchronously (the JAX loop's prefetch thread is not
ported).  Checkpoints, resume, validation, the grain loader, SortaGrad and
profiling raise (ROADMAP A9).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.convert import init_like_flax
from aas_enhancement_tpu_torch.data.dataset import AudioDataset, Batch, UnpairedCleanStream
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.evaluation import init_am
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.train.state import TrainState, adam, am_sgd
from aas_enhancement_tpu_torch.train.steps import OBJECTIVES, make_train_step


def init_state(cfg: Config, seed: int, device: torch.device | str = "cuda",
               g_seed: int | None = None, am_seed: int | None = None) -> TrainState:
    """The networks the objective needs, drawn on the CPU with flax's init
    distributions and moved to ``device``: G from ``g_seed`` (default
    ``seed``), D from ``seed + 1``, the AM from ``am_seed`` (default
    ``seed + 2``).  The AM is frozen for ``acoustic`` / ``aas`` and trained
    for ``am``, which has no G unless ``am_through_enhancer`` puts the frozen
    enhancer in front of the AM.  The default device is the card; without a
    GPU that raises (pass ``"cpu"``)."""
    device = resolve_device(device)
    objective = cfg.train.objective
    if objective not in OBJECTIVES:
        raise NotImplementedError(f"objective {objective!r}: not yet ported (ROADMAP A8)")
    t = cfg.train
    state = TrainState()
    am_seed = seed + 2 if am_seed is None else am_seed
    g_seed = seed if g_seed is None else g_seed
    if objective == "am":
        state.am = init_am(cfg, am_seed, device).train()
        state.am_opt = am_sgd(cfg, state.am.parameters(), t.lr_am)
        if t.am_through_enhancer:
            state.g = init_enhancer(cfg, g_seed, device).requires_grad_(False)
        return state
    state.g = init_enhancer(cfg, g_seed, device).train()
    state.g_opt = adam(cfg, state.g.parameters(), t.lr_g)
    if objective in ("adversarial", "aas"):
        gen = torch.Generator().manual_seed(seed + 1)
        state.d = init_like_flax(Discriminator(cfg.discriminator, cfg.audio.num_bins),
                                 gen).to(device)
        state.d_opt = adam(cfg, state.d.parameters(), t.lr_d)
    if objective in ("acoustic", "aas"):
        state.am = init_am(cfg, am_seed, device).requires_grad_(False)
    return state


def batch_dict(cfg: Config, batch: Batch, clean_stream: UnpairedCleanStream | None,
               device: torch.device | str) -> dict[str, torch.Tensor]:
    """A host batch (+ a clean batch for the GAN objectives) with row
    weights, on ``device``.  Both have ``batch_size`` rows (a short batch is
    repeat-padded by ``epoch_chunks``), which ``make_train_step`` requires to
    be a multiple of ``grad_accum``."""
    d = {"wav": batch.wav, "wav_lengths": batch.wav_lengths,
         "labels": batch.labels, "label_paddings": batch.label_paddings}
    if clean_stream is not None:
        cb = clean_stream.next_batch(batch.wav.shape[1])
        d["clean_wav"] = cb.wav
        d["clean_wav_lengths"] = cb.wav_lengths
    rw = np.zeros(batch.wav.shape[0], np.float32)
    rw[: batch.size] = 1.0
    d["row_weights"] = rw
    if "clean_wav" in d:
        d["clean_row_weights"] = np.ones(d["clean_wav"].shape[0], np.float32)
    return {key: torch.from_numpy(v).to(device) for key, v in d.items()}


def _check_ported(cfg: Config) -> None:
    t, data = cfg.train, cfg.data
    for on, what, item in (
            (data.use_grain, "DataConfig.use_grain (the grain loader)", "A9"),
            (bool(data.val_manifest), "validation (DataConfig.val_manifest)", "A9"),
            (t.sortagrad, "TrainConfig.sortagrad", "A9"),
            (bool(t.profile_dir), "TrainConfig.profile_dir", "A9"),
            (t.streaming_finetune, "TrainConfig.streaming_finetune", "A11"),
            (t.streaming_finetune_am, "TrainConfig.streaming_finetune_am", "A11")):
        if on:
            raise NotImplementedError(f"{what}: not yet ported (ROADMAP {item})")


def train(cfg: Config, noisy_manifest: str, clean_manifest: str | None = None,
          max_steps: int = 0, state: TrainState | None = None,
          device: torch.device | str = "cuda") -> tuple[TrainState, list[dict]]:
    """Run ``cfg.train.objective`` on ``device`` (the card by default; without
    a GPU that raises, pass ``"cpu"``).  -> (final state, records)."""
    device = resolve_device(device)
    _check_ported(cfg)
    t = cfg.train
    ds = AudioDataset(noisy_manifest, cfg.audio, cfg.data)
    if t.steps_per_epoch == 0:       # the staircase LR needs the epoch length
        t = dataclasses.replace(t, steps_per_epoch=ds.num_batches(t.batch_size))
        cfg = cfg.replace(train=t)
    clean_stream = None
    if t.objective in ("adversarial", "aas"):
        if not clean_manifest:
            raise ValueError(f"{t.objective} objective needs an unpaired clean manifest")
        clean_stream = UnpairedCleanStream(AudioDataset(clean_manifest, cfg.audio, cfg.data),
                                           t.batch_size, seed=t.seed + 1)
    if state is None:
        state = init_state(cfg, t.seed, device)
    anchor_am = None
    if t.objective == "am" and t.distill_lambda > 0.0:
        # The anchor is the AM exactly as this run started.
        anchor_am = copy.deepcopy(state.am).requires_grad_(False)
    step = make_train_step(cfg, anchor_am=anchor_am)

    records: list[dict] = []
    last_logged = state.step
    t_last = time.perf_counter()
    for epoch in range(t.epochs):
        for i, batch in enumerate(ds.batches(t.batch_size, t.seed, epoch)):
            state, aux = step(state, batch_dict(cfg, batch, clean_stream, device))
            s = state.step
            is_last = bool(max_steps and s >= max_steps) or (
                epoch == t.epochs - 1 and i == t.steps_per_epoch - 1)
            if s % t.log_every == 0 or s == 1 or is_last:
                metrics = {key: float(v) for key, v in aux.items()}     # syncs
                now = time.perf_counter()
                utts_sec = (t.batch_size * (s - last_logged) / max(now - t_last, 1e-9)
                            if s > last_logged + 1 else 0.0)
                t_last = now
                rec = {"step": s, "epoch": epoch, "utts_per_sec": utts_sec, **metrics}
                records.append(rec)
                print(json.dumps(rec), file=sys.stderr, flush=True)
                last_logged = s
            if max_steps and s >= max_steps:
                return state, records
    return state, records
