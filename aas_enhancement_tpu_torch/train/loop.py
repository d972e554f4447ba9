"""The training loop: bucketed batches -> train steps -> metric records,
checkpoints, resume and validation (port of ``aas_enhancement_tpu/train/loop.py``).

Epochs over the noisy dataset's bucketed batches (the JAX package's order,
SortaGrad's shortest-first order on epoch 0 with ``train.sortagrad``); for
``paired`` each batch carries its paired clean rows (``train(paired=True)``
reads the clean manifest in the noisy one's order); for ``adversarial`` /
``aas`` each batch gets an unpaired clean batch of the same padded length;
``am`` trains the AM on the one manifest (typically the clean corpus) and,
with ``distill_lambda`` > 0, anchors it to a frozen copy of the AM as the run
started.  Real rows weigh 1 and the repeat-padded rows of a short batch 0
(``row_weights``; the paired clean rows alike, every unpaired clean row 1).
A producer thread assembles ``train.prefetch`` batches ahead of the step and
moves them to the device (one thread, so the batch order and the clean
stream's draws are those of the synchronous loop).  Every ``log_every``
steps, the first and the last, a record {step, epoch, utts_per_sec,
metrics...} is kept and written by ``utils/metrics.py::MetricsLogger``
(stderr, optionally a JSONL file and TensorBoard).

With a ``checkpoint_dir`` the state is saved every ``checkpoint_every``
steps and at the end (``utils/checkpoint.py``); ``resume`` restores the
newest step and fast-forwards the data to it (batches skipped undecoded, one
clean draw skipped per step taken), so the run continues bit for bit on the
CPU.  With ``data.val_manifest`` greedy WER/CER is measured every
``eval_every`` steps (0: at each epoch's end) and the best step is kept in
``<checkpoint_dir>/best_ckpt`` with ``best.json``.  ``profile_dir`` writes a
``torch.profiler`` Chrome trace of ``profile_steps`` steps.  The grain loader
raises (ROADMAP A9b).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.convert import init_like_flax
from aas_enhancement_tpu_torch.data.dataset import AudioDataset, Batch, UnpairedCleanStream
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.evaluation import (eval_dataset, evaluate_wer,
                                                  make_eval_forward)
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.train.state import TrainState, adam, am_sgd
from aas_enhancement_tpu_torch.train.steps import OBJECTIVES, make_train_step
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt
from aas_enhancement_tpu_torch.utils.metrics import MetricsLogger


def init_state(cfg: Config, seed: int, device: torch.device | str = "cuda",
               g_seed: int | None = None, am_seed: int | None = None) -> TrainState:
    """The networks the objective needs, drawn on the CPU with flax's init
    distributions and moved to ``device``: G from ``g_seed`` (default
    ``seed``), D from ``seed + 1``, the AM from ``am_seed`` (default
    ``seed + 2``).  G is trained (with Adam) for ``paired``, ``adversarial``,
    ``acoustic``, ``aas`` and ``enhance_only``.  The AM is frozen for
    ``acoustic`` / ``aas`` and trained for ``am``, which has no G unless
    ``am_through_enhancer`` puts the frozen enhancer in front of the AM (a G
    that a checkpoint or the CLI supplies is kept frozen beside it all the
    same: ``keep_frozen_g``).  The default device is the card; without a GPU
    that raises (pass ``"cpu"``)."""
    device = resolve_device(device)
    seeds = {"g": seed if g_seed is None else g_seed, "d": seed + 1,
             "am": seed + 2 if am_seed is None else am_seed}
    return _with_optimizers(cfg, _networks(cfg, device, seeds))


def _networks(cfg: Config, device: torch.device, seeds: dict[str, int] | None
              ) -> TrainState:
    """The networks of ``cfg``'s objective in ``init_state``'s modes (trained
    ones in train mode; frozen ones in eval mode, without gradients): each
    drawn on the CPU from ``seeds[name]`` with flax's init distributions and
    moved to ``device``, or, with ``seeds`` None, built on the meta device
    (no draw, no memory) for ``load_state`` to give the saved tensors."""
    objective = cfg.train.objective
    if objective not in OBJECTIVES + ("enhance_only",):
        raise ValueError(f"unknown objective: {objective!r}")
    bins = cfg.audio.num_bins
    nets = {"g": lambda: Enhancer(cfg.enhancer, bins),
            "d": lambda: Discriminator(cfg.discriminator, bins),
            "am": lambda: AcousticModel(cfg.am, bins)}

    def build(name: str) -> torch.nn.Module:
        if seeds is None:
            with torch.device("meta"):
                return nets[name]()
        gen = torch.Generator().manual_seed(seeds[name])
        return init_like_flax(nets[name](), gen).to(device)

    state = TrainState()
    if objective == "am":
        state.am = build("am").train()
        if cfg.train.am_through_enhancer:
            state.g = build("g").eval().requires_grad_(False)
        return state
    state.g = build("g").train()
    if objective in ("adversarial", "aas"):
        state.d = build("d").train()
    if objective in ("acoustic", "aas"):
        state.am = build("am").eval().requires_grad_(False)
    return state


def _with_optimizers(cfg: Config, state: TrainState) -> TrainState:
    """Fresh optimizers for the networks the objective trains: SGD with
    Nesterov momentum for the AM of ``am``, Adam for G and D otherwise."""
    t = cfg.train
    if t.objective == "am":
        if state.am is not None:
            state.am_opt = am_sgd(cfg, state.am.parameters(), t.lr_am)
        return state
    if state.g is not None:
        state.g_opt = adam(cfg, state.g.parameters(), t.lr_g)
    if state.d is not None:
        state.d_opt = adam(cfg, state.d.parameters(), t.lr_d)
    return state


def keep_frozen_g(state: TrainState, cfg: Config, device: torch.device | str,
                  g: torch.nn.Module | None = None) -> torch.nn.Module:
    """The state's G, or, where the objective builds none (``am`` without
    ``am_through_enhancer``), ``g`` (default: a fresh enhancer of ``cfg`` to
    load weights into) kept frozen in the state, so that a checkpoint saves
    it, as the JAX package keeps any G its state was given."""
    if state.g is None:
        state.g = (g if g is not None else init_enhancer(cfg, 0, device)).requires_grad_(False)
    return state.g


def load_state(checkpoint_dir: str, device: torch.device | str = "cuda"
               ) -> tuple[TrainState, Config]:
    """The networks of a train-CLI checkpoint directory (its ``config.json``
    and newest step), on ``device``, for evaluation, enhancement, serving or
    a warm start: ``init_state``'s networks for the checkpoint's config, in
    its modes, holding the saved tensors (built on the meta device and given
    the tensors read onto ``device``: no random draw, no copy), with fresh
    optimizers and the step count set; a network the checkpoint lacks is
    None.  No optimizer state is carried; ``train(resume=True)`` restores
    everything instead."""
    device = resolve_device(device)
    cfg_path = os.path.join(checkpoint_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"{checkpoint_dir}: no config.json — not a train-CLI checkpoint dir")
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    step = ckpt.latest_step(checkpoint_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    blob = ckpt.read(checkpoint_dir, step, device)
    state = _networks(cfg, device, None)
    if "g" in blob and state.g is None:
        with torch.device("meta"):
            g = Enhancer(cfg.enhancer, cfg.audio.num_bins)
        keep_frozen_g(state, cfg, device, g.eval())
    for name in ("g", "d", "am"):
        if name in blob:
            getattr(state, name).load_state_dict(blob[name], assign=True)
        else:
            setattr(state, name, None)
    state.step = int(blob["step"])
    return _with_optimizers(cfg, state), cfg


def batch_dict(cfg: Config, batch: Batch, clean_stream: UnpairedCleanStream | None,
               device: torch.device | str) -> dict[str, torch.Tensor]:
    """A host batch (+ its paired clean rows, or an unpaired clean batch for
    the GAN objectives) with row weights, on ``device``.  Both have
    ``batch_size`` rows (a short batch is repeat-padded by ``epoch_chunks``),
    which ``make_train_step`` requires to be a multiple of ``grad_accum``.
    The paired clean rows weigh as their noisy rows, every unpaired clean row 1."""
    d = {"wav": batch.wav, "wav_lengths": batch.wav_lengths,
         "labels": batch.labels, "label_paddings": batch.label_paddings}
    paired = cfg.train.objective == "paired"
    if paired:
        if batch.clean_wav is None:
            raise ValueError("paired objective needs a paired clean manifest")
        d["clean_wav"] = batch.clean_wav
    if clean_stream is not None:
        cb = clean_stream.next_batch(batch.wav.shape[1])
        d["clean_wav"] = cb.wav
        d["clean_wav_lengths"] = cb.wav_lengths
    rw = np.zeros(batch.wav.shape[0], np.float32)
    rw[: batch.size] = 1.0
    d["row_weights"] = rw
    if "clean_wav" in d:
        d["clean_row_weights"] = rw.copy() if paired else np.ones(d["clean_wav"].shape[0],
                                                                  np.float32)
    return {key: torch.from_numpy(v).to(device) for key, v in d.items()}


def _check_ported(cfg: Config) -> None:
    if cfg.data.use_grain:
        raise NotImplementedError("DataConfig.use_grain (the grain loader): not yet "
                                  "ported (ROADMAP A9b)")


class _Validator:
    """In-training validation: greedy WER/CER on ``cfg.data.val_manifest``.

    The decode AM is the state's own (``am``, ``acoustic``, ``aas``) or the
    decode-only ``eval_am`` (``paired``, ``adversarial``); the generator
    objectives decode the enhancer's output, and all but ``paired`` log
    their noisy-input WER (the AM is frozen), measured once, with every
    eval.  The best WER's state is kept in ``<checkpoint_dir>/best_ckpt``
    (one step) with ``best.json``."""

    def __init__(self, cfg: Config, eval_am, records: list, logger: MetricsLogger,
                 checkpoint_dir: str | None):
        self.cfg = cfg
        self.eval_am = eval_am
        self.records = records
        self.logger = logger
        self.checkpoint_dir = checkpoint_dir
        self.ds = eval_dataset(cfg, cfg.data.val_manifest)
        self.use_enhancer = cfg.train.objective != "am"
        self.log_noisy = self.use_enhancer and cfg.train.objective != "paired"
        self.forward = make_eval_forward(cfg, use_enhancer=self.use_enhancer)
        self.noisy_wer = None
        self.best_wer = float("inf")
        self.last_eval_step = -1

    def run(self, state: TrainState, s: int, epoch: int) -> dict | None:
        self.last_eval_step = s
        am = state.am if state.am is not None else self.eval_am
        if am is None:
            return None      # paired / adversarial without a decode-only AM
        bs = self.cfg.train.eval_batch_size
        res = evaluate_wer(self.cfg, am, self.ds,
                           enhancer=state.g if self.use_enhancer else None,
                           batch_size=bs, forward=self.forward)
        rec = {"step": s, "epoch": epoch, "val_wer": res["wer"], "val_cer": res["cer"]}
        if self.log_noisy:
            if self.noisy_wer is None:
                self.noisy_wer = evaluate_wer(self.cfg, am, self.ds, batch_size=bs)["wer"]
            rec["val_wer_noisy"] = self.noisy_wer
        self.records.append(rec)
        self.logger.log(s, **{k: v for k, v in rec.items() if k != "step"})
        if res["wer"] < self.best_wer:
            self.best_wer = res["wer"]
            if self.checkpoint_dir:
                ckpt.save(os.path.join(self.checkpoint_dir, "best_ckpt"), s, state,
                          max_to_keep=1)
                with open(os.path.join(self.checkpoint_dir, "best.json"), "w") as f:
                    json.dump({"step": s, "val_wer": res["wer"], "val_cer": res["cer"]}, f)
        return rec


def _prefetched(gen, depth: int):
    """Run ``gen`` in a producer thread, ``depth`` items ahead of the
    consumer; ``depth <= 0`` iterates synchronously.  One producer, so the
    items come in ``gen``'s order; an early exit of the consumer stops it."""
    if depth <= 0:
        yield from gen
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err: list[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:       # re-raised in the consumer
            err.append(e)
        finally:
            put(end)

    t = threading.Thread(target=worker, daemon=True, name="aas-input-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        t.join()


class _Profile:
    """A ``torch.profiler`` trace of the steps after the first step >=
    ``profile_start``, ``profile_steps`` of them (or to the end of training),
    written as a Chrome/Perfetto trace into ``profile_dir``."""

    def __init__(self, cfg: Config, device: torch.device):
        self.t = cfg.train
        self.device = device
        self.prof = None
        self.first = 0
        self.done = not self.t.profile_dir

    def after_step(self, s: int) -> None:
        if self.done:
            return
        if self.prof is None and s >= self.t.profile_start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.first = s
        elif self.prof is not None and s >= self.first + self.t.profile_steps:
            self.stop(s)

    def stop(self, s: int) -> None:
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.t.profile_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(
            self.t.profile_dir, f"steps_{self.first + 1}-{s}.pt.trace.json"))
        self.prof = None
        self.done = True


def train(cfg: Config, noisy_manifest: str, clean_manifest: str | None = None,
          max_steps: int = 0, state: TrainState | None = None,
          device: torch.device | str = "cuda", metrics_path: str | None = None,
          tensorboard_dir: str | None = None, checkpoint_dir: str | None = None,
          resume: bool = False, eval_am: torch.nn.Module | None = None,
          paired: bool = False) -> tuple[TrainState, list[dict]]:
    """Run ``cfg.train.objective`` on ``device`` (the card by default; without
    a GPU that raises, pass ``"cpu"``).  -> (final state, records).

    ``paired`` reads ``clean_manifest`` as the noisy one's paired clean
    corpus (same order), the ``paired`` objective's targets; otherwise it is
    the unpaired clean corpus of ``adversarial`` / ``aas``.  ``max_steps``
    counts global steps (a resumed run stops at the same step as an
    uninterrupted one).  ``eval_am`` is the decode-only AM of validation for
    an objective that trains without one (the JAX package's
    ``eval_am_params``)."""
    device = resolve_device(device)
    _check_ported(cfg)
    t = cfg.train
    ds = AudioDataset(noisy_manifest, cfg.audio, cfg.data,
                      paired_manifest=clean_manifest if paired else None)
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
    if checkpoint_dir and resume:
        last = ckpt.latest_step(checkpoint_dir)
        if last is not None:
            ckpt.restore(checkpoint_dir, last, state)
    anchor_am = None
    if t.objective == "am" and t.distill_lambda > 0.0:
        # The anchor is the AM exactly as this run started (after a restore).
        anchor_am = copy.deepcopy(state.am).requires_grad_(False)
    step = make_train_step(cfg, anchor_am=anchor_am)
    logger = MetricsLogger(metrics_path, tensorboard_dir=tensorboard_dir)
    records: list[dict] = []
    validator = (_Validator(cfg, eval_am, records, logger, checkpoint_dir)
                 if cfg.data.val_manifest else None)
    profile = _Profile(cfg, device)

    # Resume: fast-forward the data to the restored step.  The epoch's batch
    # count is order-independent, and the clean stream draws once a step.
    steps_done = state.step
    start_epoch, skip = divmod(steps_done, ds.num_batches(t.batch_size))
    if clean_stream is not None:
        for _ in range(steps_done):
            clean_stream.skip()

    def prepared(epoch: int, offset: int):
        batches = ds.batches(t.batch_size, t.seed, epoch,
                             sorted_order=t.sortagrad and epoch == 0, start=offset)
        for i, batch in enumerate(batches, start=offset):
            yield i, batch_dict(cfg, batch, clean_stream, device)

    last_logged = steps_done         # this process's first step, for utts/s
    t_last = time.perf_counter()
    done = False
    for epoch in range(start_epoch, t.epochs):
        if done:
            break
        offset = skip if epoch == start_epoch else 0
        for i, bd in _prefetched(prepared(epoch, offset), t.prefetch):
            state, aux = step(state, bd)
            s = state.step
            profile.after_step(s)
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
                logger.log(s, **{k: v for k, v in rec.items() if k != "step"})
                last_logged = s
            if checkpoint_dir and s % t.checkpoint_every == 0:
                ckpt.save(checkpoint_dir, s, state)
            if validator and t.eval_every and s % t.eval_every == 0:
                validator.run(state, s, epoch)
            if max_steps and s >= max_steps:
                done = True
                break
        if validator and not t.eval_every:
            validator.run(state, state.step, epoch)

    if validator and state.step != validator.last_eval_step:
        validator.run(state, state.step, t.epochs - 1)
    if checkpoint_dir:
        ckpt.save(checkpoint_dir, state.step, state)
    profile.stop(state.step)          # training ended inside the trace window
    logger.close()
    return state, records
