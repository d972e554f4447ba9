"""Manifests -> bucketed, padded waveform batches (counterpart of
``aas_enhancement_tpu/data/dataset.py``).

The host ships padded waveforms; the STFT runs on the device.  Padded lengths
come from a few duration buckets (whole seconds at quantiles of the corpus'
lengths), batches form within a bucket in a seeded per-epoch order, and a
short last batch is filled by repeating its items (``Batch.size`` counts the
real rows).  Labels pad to one width per dataset (the longest transcript,
rounded up to 8) with {0, 1} ``label_paddings``.  The trainer reads batch
counts (``num_batches``) and the endless unpaired clean stream
(``UnpairedCleanStream``, padded to the noisy batch's length with
``make_batch(bucket_override=)``); ``batches`` and ``epoch_chunks`` also
serve SortaGrad's shortest-first epoch and ``drop_last``, and the resume
fast-forward skips batches (``batches(start=)``) and clean draws
(``UnpairedCleanStream.skip``) without decoding them.

With ``DataConfig.augment`` every unpaired training wav is perturbed
(``data/augment.py``: speed, gain, noise from ``noise_dir``) by a generator
keyed on (epoch, manifest position), so a resumed run, which skips batches
undecoded, sees the audio of an uninterrupted one; the clean stream keys its
draws on their count.  Paired targets stay unaugmented, sample-aligned with
their clean side.  Bucket lengths then allow for speed perturbation's
longest output (x1.12), as the JAX package's do.

Only the Python wav reader is ported: the JAX package's native decoder
(``DataConfig.native_decode``) gives byte-identical batches, so the flag is
ignored here.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator

import numpy as np

from aas_enhancement_tpu_torch.config import AudioConfig, DataConfig
from aas_enhancement_tpu_torch.data.augment import NoiseInjector, augment_wav
from aas_enhancement_tpu_torch.data.manifest import read_manifest, read_transcript
from aas_enhancement_tpu_torch.data.wav import read_wav
from aas_enhancement_tpu_torch.labels import LABELS, encode


@dataclasses.dataclass
class Batch:
    """One padded batch (numpy, host-side)."""

    wav: np.ndarray              # [B, N] float32 (or int16 with feed_dtype="int16")
    wav_lengths: np.ndarray      # [B] int32, valid samples
    labels: np.ndarray           # [B, U] int32
    label_paddings: np.ndarray   # [B, U] float32, 1.0 = padded
    clean_wav: np.ndarray | None = None   # [B, N] paired clean (same padding)
    real_size: int = 0                    # rows before repeat-padding (0 = all real)

    @property
    def size(self) -> int:
        return self.real_size or self.wav.shape[0]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class AudioDataset:
    """Manifest-backed dataset of (wav, transcript) with duration bucketing."""

    def __init__(self, manifest_path: str, audio: AudioConfig, data: DataConfig,
                 labels: str = LABELS, paired_manifest: str | None = None):
        self.audio = audio
        self.data = data
        self.labels = labels
        self.noise = None
        if data.augment and data.noise_dir:
            self.noise = NoiseInjector(data.noise_dir, audio.sample_rate)
        entries = read_manifest(manifest_path)
        paired = read_manifest(paired_manifest) if paired_manifest else None
        if paired is not None and len(paired) != len(entries):
            raise ValueError("paired manifest length mismatch")

        self.items = []
        sr = audio.sample_rate
        # Speed perturbation lengthens a wav by up to 1/0.9: bucket by the
        # longest augmented length, so augmented audio never outgrows its bucket.
        length_margin = 1.12 if data.augment else 1.0
        for i, (wav_path, txt_path) in enumerate(entries):
            n = _wav_num_samples(wav_path)
            dur = n / sr
            if dur < data.min_duration or dur > data.max_duration:
                continue
            self.items.append({
                "idx": i,            # the manifest position: the augmentation's key
                "wav": wav_path,
                "txt": txt_path,
                "clean_wav": paired[i][0] if paired else None,
                "num_samples": int(n * length_margin),
            })
        if not self.items:
            raise ValueError(f"no usable utterances in {manifest_path}")

        max_u = 1
        for it in self.items:
            ids = encode(read_transcript(it["txt"]), self.labels)
            it["label_ids"] = ids
            max_u = max(max_u, len(ids))
        self.max_label_len = _round_up(max_u, 8)

        # Bucket boundaries at quantiles of num_samples, rounded up to whole seconds.
        lens = np.array([it["num_samples"] for it in self.items])
        n_buckets = min(data.num_buckets, len(self.items))
        qs = np.quantile(lens, np.linspace(1.0 / n_buckets, 1.0, n_buckets))
        self.bucket_sizes = sorted({int(_round_up(int(q), sr)) for q in qs})

    def __len__(self) -> int:
        return len(self.items)

    def bucket_of(self, num_samples: int) -> int:
        for b in self.bucket_sizes:
            if num_samples <= b:
                return b
        return self.bucket_sizes[-1]

    def _augment(self, wav: np.ndarray, idx: int, epoch: int) -> np.ndarray:
        """The JAX package's draws: a generator seeded on (epoch, position)."""
        d = self.data
        rng = np.random.default_rng((0xA46, epoch, idx))
        return augment_wav(wav, rng, noise=self.noise, noise_prob=d.noise_prob,
                           snr_range=tuple(d.noise_snr_range), speed=d.augment_speed,
                           gain=d.augment_gain)

    def _read(self, path: str, bucket: int, augment_key: tuple[int, int] | None = None
              ) -> tuple[np.ndarray, int]:
        wav, sr = read_wav(path)
        if sr != self.audio.sample_rate:
            raise ValueError(f"{path}: sample rate {sr} != {self.audio.sample_rate}")
        if augment_key is not None:
            wav = self._augment(wav, *augment_key)
        n = min(len(wav), bucket)
        out = np.zeros(bucket, np.float32)
        out[:n] = wav[:n]
        return out, n

    def make_batch(self, items: list[dict], real_size: int = 0,
                   bucket_override: int = 0, epoch: int = 0) -> Batch:
        bucket = bucket_override or max(self.bucket_of(it["num_samples"])
                                        for it in items)
        u = self.max_label_len
        b = len(items)
        labels = np.zeros((b, u), np.int32)
        label_pad = np.ones((b, u), np.float32)
        for j, it in enumerate(items):
            ids = it["label_ids"][:u]
            labels[j, : len(ids)] = ids
            label_pad[j, : len(ids)] = 0.0

        has_clean = all(it["clean_wav"] for it in items)
        wav = np.zeros((b, bucket), np.float32)
        wav_lengths = np.zeros(b, np.int32)
        clean = np.zeros((b, bucket), np.float32) if has_clean else None
        for j, it in enumerate(items):
            # Only unpaired inputs are augmented: a paired target stays aligned.
            key = (it["idx"], epoch) if self.data.augment and not it["clean_wav"] else None
            wav[j], wav_lengths[j] = self._read(it["wav"], bucket, key)
            if has_clean:
                clean[j] = self._read(it["clean_wav"], bucket)[0]
        if self.data.feed_dtype == "int16":
            # Half the host->device bytes; lossless for PCM16 sources.
            wav = _to_int16(wav)
            if has_clean:
                clean = _to_int16(clean)
        return Batch(wav=wav, wav_lengths=wav_lengths, labels=labels,
                     label_paddings=label_pad, clean_wav=clean,
                     real_size=real_size or len(items))

    def num_batches(self, batch_size: int) -> int:
        """Batches per epoch, from item metadata (no wav decode)."""
        by_bucket: dict[int, int] = {}
        for it in self.items:
            b = self.bucket_of(it["num_samples"])
            by_bucket[b] = by_bucket.get(b, 0) + 1
        return sum(-(-n // batch_size) for n in by_bucket.values())

    def batches(self, batch_size: int, seed: int = 0, epoch: int = 0,
                drop_last: bool = False, sorted_order: bool = False,
                start: int = 0) -> Iterator[Batch]:
        """Epoch iterator: shuffled within duration buckets, then (epoch > 0)
        in shuffled batch order; ``sorted_order`` serves the epoch strictly
        shortest-first (SortaGrad).  ``start`` skips the first batches
        without decoding them (the resume fast-forward)."""
        chunks = epoch_chunks(self, batch_size, seed, epoch,
                              drop_last=drop_last, sorted_order=sorted_order)
        for chunk, orig in chunks[start:]:
            yield self.make_batch(chunk, real_size=orig, epoch=epoch)


def epoch_chunks(dataset: AudioDataset, batch_size: int, seed: int = 0,
                 epoch: int = 0, drop_last: bool = False,
                 sorted_order: bool = False) -> list[tuple[list[dict], int]]:
    """One epoch's batch composition: [(items, real_size)], decode-free.
    The same draws as the JAX package, so both serve identical epochs:
    ``sorted_order`` keeps each bucket in duration order (a stable sort) and
    the buckets in size order; ``drop_last`` drops a short final batch
    instead of repeat-padding it."""
    rng = np.random.default_rng(seed + epoch * 9973)
    by_bucket: dict[int, list[dict]] = {}
    for it in dataset.items:
        by_bucket.setdefault(dataset.bucket_of(it["num_samples"]), []).append(it)

    chunks = []
    for bucket in sorted(by_bucket):
        items = by_bucket[bucket]
        if sorted_order:
            order = np.argsort([it["num_samples"] for it in items], kind="stable")
        else:
            order = rng.permutation(len(items))
        for i in range(0, len(items), batch_size):
            chunk = [items[k] for k in order[i: i + batch_size]]
            if drop_last and len(chunk) < batch_size:
                continue
            # Pad a short final batch by repeating its items (static shapes).
            orig = len(chunk)
            while len(chunk) < batch_size:
                chunk.append(chunk[len(chunk) % orig])
            chunks.append((chunk, orig))
    if epoch > 0 and not sorted_order:
        rng.shuffle(chunks)
    return chunks


class UnpairedCleanStream:
    """Endless stream of clean batches for the discriminator's real side: each
    batch draws ``batch_size`` items uniformly (with replacement) from the
    seeded generator, as the JAX package's stream does."""

    def __init__(self, dataset: AudioDataset, batch_size: int, seed: int = 1):
        self.ds = dataset
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._draws = 0      # batches drawn or skipped: the position the JAX
                             # package keys its clean-side augmentation on

    def next_batch(self, bucket: int) -> Batch:
        """A clean batch padded to ``bucket`` samples (the noisy batch's length)."""
        idx = self.rng.integers(0, len(self.ds.items), size=self.batch_size)
        self._draws += 1
        return self.ds.make_batch([self.ds.items[i] for i in idx], bucket_override=bucket,
                                  epoch=self._draws - 1)

    def skip(self) -> None:
        """Advance the stream by one batch without decoding it: the draws of
        ``next_batch``, so a resumed run sees the clean batches of an
        uninterrupted one."""
        self.rng.integers(0, len(self.ds.items), size=self.batch_size)
        self._draws += 1


def _to_int16(x: np.ndarray) -> np.ndarray:
    y = x * 32768.0
    np.clip(y, -32768.0, 32767.0, out=y)
    np.rint(y, out=y)
    return y.astype(np.int16)


def _wav_num_samples(path: str) -> int:
    """Cheap duration probe: parse RIFF headers without decoding samples."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF":
            raise ValueError(f"{path}: not RIFF")
        bits = 16
        n_ch = 1
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, sz = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                body = f.read(sz + (sz & 1))
                _, n_ch, _, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
            elif cid == b"data":
                return sz // (n_ch * bits // 8)
            else:
                f.seek(sz + (sz & 1), 1)
