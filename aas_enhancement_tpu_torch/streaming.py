"""Chunked streaming enhancement (port of ``aas_enhancement_tpu/streaming.py``).

Audio is enhanced in blocks of [history | chunk | lookahead] samples: the
chunk is enhanced with ``history`` seconds of audio already seen (the
BiLSTM's forward direction is warm at the chunk boundary) and ``lookahead``
seconds of the future (the block-bidirectional approximation of the
backward direction), and only the chunk's samples are emitted.  Latency is
chunk + lookahead; history costs compute, not latency.  Each block is
normalized with RUNNING moments of the log-magnitudes carried across the
stream (``enhance.py::make_streaming_enhance_fn``), which converge to the
offline per-utterance moments.  ISTFT edge effects stay inside n_fft
samples, which the history and lookahead margins cover, so the emitted
chunks join without overlap-add.

Each block is one call of the streaming enhance path on ``device`` (the
card by default): STFT, the enhancer's GroupNorm and BiLSTM kernels, ISTFT.
The host keeps the buffers and the running moments, in Python floats (f64)
for ``StreamingEnhancer`` and each slot of ``BatchedStreamingEnhancer``,
handed to the device as f32, as the JAX classes do.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.enhance import make_streaming_enhance_fn
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device


def _run_block(fn, model, device: torch.device, block: np.ndarray, lengths: np.ndarray,
               ss: np.ndarray, se: np.ndarray, run: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """One call of the streaming enhance path on host arrays: block [B, W]
    f32, lengths / ss / se [B] ints, run [3, B] f32 -> (wav [B, W], the
    increments [3, B]) on the host.  Three copies to the device, two back."""
    ints = torch.from_numpy(np.stack([lengths, ss, se]).astype(np.int64)).to(device)
    run_d = torch.from_numpy(run.astype(np.float32)).to(device)
    wav, *inc = fn(model, torch.from_numpy(block).to(device), ints[0], ints[1], ints[2],
                   run_d[0], run_d[1], run_d[2])
    return wav.cpu().numpy(), torch.stack(inc).cpu().numpy()


class StreamingEnhancer:
    """Stateful chunk-wise enhancer: feed samples, receive enhanced samples.

    ``chunk_seconds`` of audio are emitted at a time, each enhanced with
    ``history_seconds`` of past and ``lookahead_seconds`` of future context.
    ``model`` lives on ``device``."""

    def __init__(self, cfg: Config, model: Enhancer, chunk_seconds: float = 1.0,
                 lookahead_seconds: float = 0.2, history_seconds: float = 1.0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        sr = cfg.audio.sample_rate
        self.chunk = int(chunk_seconds * sr)
        self.lookahead = int(lookahead_seconds * sr)
        self.history = int(history_seconds * sr)
        self._fn = make_streaming_enhance_fn(cfg, self.device)
        self._buf = np.zeros(0, np.float32)
        # Left context: synthetic silence at first (the first block's history
        # frames stay out of the running moments through stats_start).
        self._hist = np.zeros(self.history, np.float32)
        self._window = self.history + self.chunk + self.lookahead
        self._sum = 0.0
        self._sumsq = 0.0
        self._count = 0.0

    def feed(self, samples: np.ndarray) -> np.ndarray:
        """Append input samples; returns whatever enhanced samples are ready."""
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)])
        out = []
        while len(self._buf) >= self.chunk + self.lookahead:
            enhanced = self._run(self._buf[: self.chunk + self.lookahead],
                                 consumed=self.chunk)
            out.append(enhanced[self.history: self.history + self.chunk])
            self._roll_history(self._buf[: self.chunk])
            self._buf = self._buf[self.chunk:]
        return np.concatenate(out) if out else np.zeros(0, np.float32)

    def flush(self) -> np.ndarray:
        """Enhance and return the remaining buffered samples."""
        if len(self._buf) == 0:
            return np.zeros(0, np.float32)
        n = len(self._buf)
        enhanced = self._run(self._buf)
        self._roll_history(self._buf)
        self._buf = np.zeros(0, np.float32)
        return enhanced[self.history: self.history + n]

    # ------------------------------------------------------------- internals
    def _roll_history(self, consumed: np.ndarray) -> None:
        if self.history == 0:
            return
        self._hist = np.concatenate([self._hist, consumed])[-self.history:]

    def _run(self, new: np.ndarray, consumed: int | None = None) -> np.ndarray:
        hop = self.cfg.audio.hop_length
        block = np.zeros((1, self._window), np.float32)
        block[0, : self.history] = self._hist
        block[0, self.history: self.history + len(new)] = new
        # The moments' increment covers exactly the samples this call
        # CONSUMES (the chunk in feed, everything in flush): frame f starts
        # near f * hop (center padding shifts it by a sub-frame n_fft // 2).
        consumed = len(new) if consumed is None else consumed
        wav, inc = _run_block(
            self._fn, self.model, self.device, block,
            np.array([self.history + len(new)]), np.array([self.history // hop]),
            np.array([(self.history + consumed) // hop]),
            np.array([[self._sum], [self._sumsq], [self._count]]))
        self._sum += float(inc[0, 0])
        self._sumsq += float(inc[1, 0])
        self._count += float(inc[2, 0])
        return wav[0]


class BatchedStreamingEnhancer:
    """Up to ``max_streams`` concurrent live streams enhanced in ONE call per
    tick over [max_streams, window]: idle slots ride along as rows of length
    0 whose outputs and increments are discarded.  Each slot keeps
    ``StreamingEnhancer``'s state (buffer, history, running moments), so each
    stream's audio is the single-stream engine's.

    Session API:
      slot = eng.open()              # -> slot id; RuntimeError when full
      eng.feed(slot, samples)        # buffer capture audio (no compute)
      eng.end_stream(slot)           # no more input; the partial chunk flushes
      eng.step() -> {slot: samples}  # one batched call over the ready slots
      eng.close(slot)                # free the slot for a new session
    Call ``step()`` until it returns {} to drain (each call advances every
    ready stream by one chunk)."""

    def __init__(self, cfg: Config, model: Enhancer, max_streams: int = 8,
                 chunk_seconds: float = 1.0, lookahead_seconds: float = 0.2,
                 history_seconds: float = 1.0, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        self.max_streams = max_streams
        sr = cfg.audio.sample_rate
        self.chunk = int(chunk_seconds * sr)
        self.lookahead = int(lookahead_seconds * sr)
        self.history = int(history_seconds * sr)
        self._window = self.history + self.chunk + self.lookahead
        self._fn = make_streaming_enhance_fn(cfg, self.device)
        self._slots: list[dict | None] = [None] * max_streams

    def warm(self) -> None:
        """One device call over idle rows (all of length 0), outputs dropped
        and no slot touched: on the card the kernels build and launch in the
        caller's thread, where a failure raises."""
        b = self.max_streams
        idle = np.zeros(b, np.int64)
        _run_block(self._fn, self.model, self.device, np.zeros((b, self._window), np.float32),
                   idle, idle, idle, np.zeros((3, b), np.float32))

    def open(self) -> int:
        for s in range(self.max_streams):
            if self._slots[s] is None:
                self._slots[s] = {
                    "buf": np.zeros(0, np.float32),
                    "hist": np.zeros(self.history, np.float32),
                    "sum": 0.0, "sumsq": 0.0, "count": 0.0,
                    "flush": False, "done": False,
                }
                return s
        raise RuntimeError(f"all {self.max_streams} stream slots in use")

    def close(self, slot: int) -> None:
        self._slots[slot] = None

    def is_done(self, slot: int) -> bool:
        """True once an ended stream's final flush has been emitted."""
        st = self._slots[slot]
        return st is not None and st["done"]

    def feed(self, slot: int, samples: np.ndarray) -> None:
        st = self._slots[slot]
        if st is None or st["flush"]:
            raise RuntimeError(f"slot {slot} is not an open stream")
        st["buf"] = np.concatenate([st["buf"], samples.astype(np.float32)])

    def end_stream(self, slot: int) -> None:
        st = self._slots[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} is not an open stream")
        st["flush"] = True

    def step(self) -> dict[int, np.ndarray]:
        """One batched tick -> {slot: enhanced samples} for every slot that had
        a full chunk buffered (or a final flush pending)."""
        jobs: list[tuple[int, str]] = []
        for s, st in enumerate(self._slots):
            if st is None or st["done"]:
                continue
            if len(st["buf"]) >= self.chunk + self.lookahead:
                jobs.append((s, "feed"))
            elif st["flush"] and len(st["buf"]):
                jobs.append((s, "flush"))
            elif st["flush"]:
                st["done"] = True
        if not jobs:
            return {}

        hop = self.cfg.audio.hop_length
        b = self.max_streams
        block = np.zeros((b, self._window), np.float32)
        lengths = np.zeros(b, np.int64)
        ss = np.zeros(b, np.int64)
        se = np.zeros(b, np.int64)
        run = np.zeros((3, b), np.float32)
        n_new = {}
        for s, mode in jobs:
            st = self._slots[s]
            new = (st["buf"][: self.chunk + self.lookahead]
                   if mode == "feed" else st["buf"])
            consumed = self.chunk if mode == "feed" else len(new)
            block[s, : self.history] = st["hist"]
            block[s, self.history: self.history + len(new)] = new
            lengths[s] = self.history + len(new)
            ss[s] = self.history // hop        # StreamingEnhancer._run's window
            se[s] = (self.history + consumed) // hop
            run[:, s] = st["sum"], st["sumsq"], st["count"]
            n_new[s] = len(new)
        # Idle rows: length 0 and ss == se == 0, so no increment; output dropped.
        wav_out, inc = _run_block(self._fn, self.model, self.device, block, lengths,
                                 ss, se, run)

        out: dict[int, np.ndarray] = {}
        for s, mode in jobs:
            st = self._slots[s]
            st["sum"] += float(inc[0, s])
            st["sumsq"] += float(inc[1, s])
            st["count"] += float(inc[2, s])
            if mode == "feed":
                out[s] = wav_out[s, self.history: self.history + self.chunk]
                consumed_samples = st["buf"][: self.chunk]
                st["buf"] = st["buf"][self.chunk:]
            else:
                out[s] = wav_out[s, self.history: self.history + n_new[s]]
                consumed_samples = st["buf"]
                st["buf"] = np.zeros(0, np.float32)
                st["done"] = True
            if self.history:
                st["hist"] = np.concatenate(
                    [st["hist"], consumed_samples])[-self.history:]
        return out


def enhance_stream(cfg: Config, model: Enhancer, samples: np.ndarray,
                   chunk_seconds: float = 1.0, lookahead_seconds: float = 0.2,
                   history_seconds: float = 1.0, feed_seconds: float = 0.1,
                   device: torch.device | str = "cuda") -> Iterator[np.ndarray]:
    """Stream a whole waveform through ``StreamingEnhancer`` in pushes of
    ``feed_seconds`` (a live capture source), yielding what each push emits."""
    eng = StreamingEnhancer(cfg, model, chunk_seconds, lookahead_seconds,
                            history_seconds, device)
    step = int(feed_seconds * cfg.audio.sample_rate)
    for i in range(0, len(samples), step):
        out = eng.feed(samples[i: i + step])
        if len(out):
            yield out
    tail = eng.flush()
    if len(tail):
        yield tail
