"""Block-streaming recognition: live audio -> (enhancer ->) AM -> greedy CTC
(port of ``aas_enhancement_tpu/streaming_asr.py``).

The block scheme of ``streaming.py`` carried over to recognition: each
[history | chunk | lookahead] window is one call of ``make_streaming_asr_fn``
(STFT, optionally the enhancer, the DeepSpeech2 AM) on ``device``, and
exactly the chunk's AM frames are emitted, so the stitched frames cover the
utterance with no gap or overlap.  Greedy CTC collapses across block
boundaries; the emitted log-probs can be kept for a rescore of the session.
Both normalizations (the enhancer's input, the AM's input) use running
moments carried across blocks.

Frame accounting (hop = audio.hop_length, conv1's time stride 2): local input
frame l of a window is absolute frame P - H + l (P frames consumed so far, H
history frames), and AM frame j centers on input frame 2j, so local AM frames
[H/2, (H + C)/2) are the chunk's absolute AM frames [P/2, (P + C)/2) when H
and C (history and chunk in frames) are EVEN.  ``flush`` always runs a final
block, an empty buffer too, to emit the trailing frames the chunks never
cover.

The host keeps the running moments as f32 numpy arrays, as the JAX classes
do (``streaming.py`` keeps Python floats): over a long stream the two
accumulations round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.dsp import api as dsp_api
from aas_enhancement_tpu_torch.dsp.stft import magnitude
from aas_enhancement_tpu_torch.labels import decode_ids
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer, apply_enhancement
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.ops.masking import running_normalize, time_mask, window_stats


def make_streaming_asr_fn(cfg: Config, use_enhancer: bool, device: torch.device | str):
    """-> fn(am, enhancer, wav [B, n], lengths [B], stats_start, stats_end,
    enh_run [3, B], am_run [3, B]) -> (logits [B, T_am, V], out_lengths [B],
    enh_inc [3, B], am_inc [3, B]) on ``device``.

    The running-moment contract of ``enhance.py::make_streaming_enhance_fn``:
    the enhancer moments normalize the enhancer's input (with
    ``audio.normalize``), the AM moments the AM's input (the log1p of the
    enhanced, or the raw, magnitudes).  Without the enhancer ``enhancer`` is
    not read and ``enh_inc`` is zero."""
    a = cfg.audio
    device = torch.device(device)

    @torch.inference_mode()
    def forward(am: AcousticModel, enhancer: Enhancer | None, wav, lengths, stats_start,
                stats_end, enh_run, am_run):
        wav = torch.as_tensor(wav).to(device=device, dtype=torch.float32)
        lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int64)
        enh_run = torch.as_tensor(enh_run, dtype=torch.float32, device=device)
        am_run = torch.as_tensor(am_run, dtype=torch.float32, device=device)
        re, im = dsp_api.stft(a, wav)
        mag = magnitude(re, im)
        log_mag = torch.log1p(mag)
        frame_lengths = (1 + lengths // a.hop_length if a.center
                         else 1 + (lengths - a.n_fft) // a.hop_length)
        valid = time_mask(frame_lengths, log_mag.shape[1])
        if use_enhancer:
            enh_inc = window_stats(log_mag, valid, stats_start, stats_end)
            net_in = (running_normalize(log_mag, valid, enh_inc, enh_run)
                      if a.normalize else log_mag)
            out = enhancer(net_in, frame_lengths)
            am_log = torch.log1p(apply_enhancement(cfg.enhancer, out, mag))
        else:
            enh_inc = (torch.zeros_like(enh_run[0]),) * 3
            am_log = log_mag
        am_inc = window_stats(am_log, valid, stats_start, stats_end)
        am_in = running_normalize(am_log, valid, am_inc, am_run)
        logits, out_lengths = am(am_in, frame_lengths)
        return logits, out_lengths, torch.stack(enh_inc), torch.stack(am_inc)

    return forward


def _check_even_hops(cfg: Config, chunk: int, history: int) -> None:
    hop = cfg.audio.hop_length
    for name, n in (("chunk", chunk), ("history", history)):
        if n % hop or (n // hop) % 2:
            raise ValueError(
                f"{name} ({n} samples) must be a whole, EVEN number of "
                f"hops (hop_length={hop}) for exact AM frame stitching")


def _run_blocks(fn, am, enhancer, device, block, lengths, ss, se, enh_run, am_run):
    """One call of ``fn`` on host arrays -> host (logits, out_lengths, enh_inc,
    am_inc); three copies to the device, four back."""
    ints = torch.from_numpy(np.stack([lengths, ss, se]).astype(np.int64)).to(device)
    runs = torch.from_numpy(np.stack([enh_run, am_run]).astype(np.float32)).to(device)
    out = fn(am, enhancer, torch.from_numpy(block).to(device), ints[0], ints[1], ints[2],
             runs[0], runs[1])
    return tuple(x.cpu().numpy() for x in out)


class StreamingRecognizer:
    """Stateful live recognizer: feed samples, read the growing transcript.

    With ``enhancer`` each block is enhanced before recognition, the whole
    live AAS serving chain in one call a block.  ``collect_logits=True``
    keeps the emitted frames' log-probs (``log_probs()``) for a rescore of
    the finished session.  The networks live on ``device``."""

    def __init__(self, cfg: Config, am: AcousticModel, enhancer: Enhancer | None = None,
                 chunk_seconds: float = 1.0, lookahead_seconds: float = 0.2,
                 history_seconds: float = 1.0, collect_logits: bool = False,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.am = am
        self.enhancer = enhancer
        self.device = resolve_device(device)
        sr = cfg.audio.sample_rate
        self.chunk = int(chunk_seconds * sr)
        self.lookahead = int(lookahead_seconds * sr)
        self.history = int(history_seconds * sr)
        _check_even_hops(cfg, self.chunk, self.history)
        self._window = self.history + self.chunk + self.lookahead
        self._fn = make_streaming_asr_fn(cfg, enhancer is not None, self.device)
        self._buf = np.zeros(0, np.float32)
        self._hist = np.zeros(self.history, np.float32)
        self._enh_run = np.zeros(3, np.float32)
        self._am_run = np.zeros(3, np.float32)
        self._ids: list[int] = []
        self._log_probs: list[np.ndarray] | None = [] if collect_logits else None
        self._flushed = False

    def feed(self, samples: np.ndarray) -> list[int]:
        """Append capture audio; returns the newly emitted argmax id frames."""
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)])
        new: list[int] = []
        while len(self._buf) >= self.chunk + self.lookahead:
            new.extend(self._run(self._buf[: self.chunk + self.lookahead],
                                 consumed=self.chunk))
            self._hist = np.concatenate(
                [self._hist, self._buf[: self.chunk]])[-self.history:]
            self._buf = self._buf[self.chunk:]
        return new

    def flush(self) -> list[int]:
        """End of stream: emit the trailing frames (always runs one block)."""
        if self._flushed:
            return []
        self._flushed = True
        return self._run(self._buf, consumed=len(self._buf), final=True)

    def transcript(self) -> str:
        """Greedy CTC collapse of everything emitted so far."""
        return _collapse(self._ids)

    def log_probs(self) -> np.ndarray:
        """[T_emitted, V] log-probs of the streamed session; needs
        ``collect_logits=True``."""
        if self._log_probs is None:
            raise RuntimeError("constructed without collect_logits=True")
        return (np.concatenate(self._log_probs) if self._log_probs
                else np.zeros((0, 0), np.float32))

    # ------------------------------------------------------------- internals
    def _run(self, new: np.ndarray, consumed: int, final: bool = False) -> list[int]:
        hop = self.cfg.audio.hop_length
        block = np.zeros((1, self._window), np.float32)
        block[0, : self.history] = self._hist
        block[0, self.history: self.history + len(new)] = new
        se = (self.history + consumed) // hop + (1 if final else 0)
        logits, out_lengths, enh_inc, am_inc = _run_blocks(
            self._fn, self.am, self.enhancer, self.device, block,
            np.array([self.history + len(new)]), np.array([self.history // hop]),
            np.array([se]), self._enh_run[:, None], self._am_run[:, None])
        self._enh_run += enh_inc[:, 0]
        self._am_run += am_inc[:, 0]

        h_am = (self.history // hop) // 2
        if final:               # everything the window produced past the history
            end = int(out_lengths[0])
        else:
            end = (self.history // hop + consumed // hop) // 2
        frames = logits[0, h_am: end]
        if self._log_probs is not None:
            self._log_probs.append(
                torch.log_softmax(torch.from_numpy(frames), dim=-1).numpy())
        ids = np.argmax(frames, axis=-1).astype(int).tolist()
        self._ids.extend(ids)
        return ids


def _collapse(ids) -> str:
    collapsed, prev = [], 0
    for i in ids:
        if i != prev and i != 0:
            collapsed.append(i)
        prev = i
    return decode_ids(np.asarray(collapsed, np.int32))


class BatchedStreamingRecognizer:
    """Up to ``max_streams`` concurrent live sessions, ONE (enhancer ->) AM
    call a tick; every session keeps its own running moments in the batch.
    The slot API of ``streaming.BatchedStreamingEnhancer`` (open / feed /
    end_stream / step / close) plus ``transcript(slot)``; ``step()`` returns
    {slot: newly emitted argmax id frames}.  Each session's output is
    ``StreamingRecognizer``'s."""

    def __init__(self, cfg: Config, am: AcousticModel, enhancer: Enhancer | None = None,
                 max_streams: int = 8, chunk_seconds: float = 1.0,
                 lookahead_seconds: float = 0.5, history_seconds: float = 0.5,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.am = am
        self.enhancer = enhancer
        self.device = resolve_device(device)
        self.max_streams = max_streams
        sr = cfg.audio.sample_rate
        self.chunk = int(chunk_seconds * sr)
        self.lookahead = int(lookahead_seconds * sr)
        self.history = int(history_seconds * sr)
        _check_even_hops(cfg, self.chunk, self.history)
        self._window = self.history + self.chunk + self.lookahead
        self._fn = make_streaming_asr_fn(cfg, enhancer is not None, self.device)
        self._slots: list[dict | None] = [None] * max_streams

    def warm(self) -> None:
        """One device call over idle rows (all of length 0), outputs dropped
        and no slot touched: on the card the kernels build and launch in the
        caller's thread, where a failure raises."""
        b = self.max_streams
        idle, runs = np.zeros(b, np.int64), np.zeros((3, b), np.float32)
        _run_blocks(self._fn, self.am, self.enhancer, self.device,
                    np.zeros((b, self._window), np.float32), idle, idle, idle, runs, runs)

    def open(self) -> int:
        for s in range(self.max_streams):
            if self._slots[s] is None:
                self._slots[s] = {
                    "buf": np.zeros(0, np.float32),
                    "hist": np.zeros(self.history, np.float32),
                    "enh_run": np.zeros(3, np.float32),
                    "am_run": np.zeros(3, np.float32),
                    "ids": [], "flush": False, "done": False,
                }
                return s
        raise RuntimeError(f"all {self.max_streams} stream slots in use")

    def close(self, slot: int) -> None:
        self._slots[slot] = None

    def is_done(self, slot: int) -> bool:
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

    def transcript(self, slot: int) -> str:
        st = self._slots[slot]
        if st is None:
            raise RuntimeError(f"slot {slot} is not an open stream")
        return _collapse(st["ids"])

    def step(self) -> dict[int, list[int]]:
        """One batched tick -> {slot: new argmax id frames} for the ready
        slots.  An ended stream always takes a final block, with an empty
        buffer too, to emit its trailing frames."""
        jobs: list[tuple[int, bool]] = []          # (slot, final)
        for s, st in enumerate(self._slots):
            if st is None or st["done"]:
                continue
            if len(st["buf"]) >= self.chunk + self.lookahead:
                jobs.append((s, False))
            elif st["flush"]:
                jobs.append((s, True))
        if not jobs:
            return {}

        hop = self.cfg.audio.hop_length
        b = self.max_streams
        block = np.zeros((b, self._window), np.float32)
        lengths = np.zeros(b, np.int64)
        ss = np.zeros(b, np.int64)
        se = np.zeros(b, np.int64)
        enh_run = np.zeros((3, b), np.float32)
        am_run = np.zeros((3, b), np.float32)
        for s, final in jobs:
            st = self._slots[s]
            new = st["buf"] if final else st["buf"][: self.chunk + self.lookahead]
            consumed = len(new) if final else self.chunk
            block[s, : self.history] = st["hist"]
            block[s, self.history: self.history + len(new)] = new
            lengths[s] = self.history + len(new)
            ss[s] = self.history // hop
            se[s] = (self.history + consumed) // hop + (1 if final else 0)
            enh_run[:, s] = st["enh_run"]
            am_run[:, s] = st["am_run"]
        logits, out_lengths, enh_inc, am_inc = _run_blocks(
            self._fn, self.am, self.enhancer, self.device, block, lengths, ss, se,
            enh_run, am_run)

        h_am = (self.history // hop) // 2
        out: dict[int, list[int]] = {}
        for s, final in jobs:
            st = self._slots[s]
            st["enh_run"] += enh_inc[:, s]
            st["am_run"] += am_inc[:, s]
            if final:
                end = int(out_lengths[s])
                st["buf"] = np.zeros(0, np.float32)
                st["done"] = True
            else:
                end = (self.history // hop + self.chunk // hop) // 2
                st["hist"] = np.concatenate(
                    [st["hist"], st["buf"][: self.chunk]])[-self.history:]
                st["buf"] = st["buf"][self.chunk:]
            ids = np.argmax(logits[s, h_am: end], axis=-1).astype(int).tolist()
            st["ids"].extend(ids)
            out[s] = ids
        return out
