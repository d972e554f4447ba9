"""The configuration the ported enhance path reads (counterpart of
``aas_enhancement_tpu/config.py``).

The same dataclasses, fields and defaults as the JAX package's audio and
enhancer sections, plus the train seed that random init draws from.  A config
JSON written by either package loads here: sections and keys the port does
not read yet (the AM, discriminator, mesh, data and the rest of train) are
skipped, as the JAX package's own ``Config.from_dict`` skips unknown keys.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class AudioConfig:
    """STFT / featurization parameters."""

    sample_rate: int = 16000
    window_size: float = 0.02    # seconds -> n_fft = 320 -> 161 freq bins
    window_stride: float = 0.01  # seconds -> hop = 160
    window: str = "hann"         # "hann" | "hamming"
    center: bool = True          # reflect-pad n_fft//2 on both sides
    normalize: bool = True       # per-utterance mean/std normalization of log-mag

    @property
    def n_fft(self) -> int:
        return int(self.sample_rate * self.window_size)

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.window_stride)

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclass(frozen=True)
class EnhancerConfig:
    """Conv + BLSTM enhancement network."""

    conv_channels: int = 32
    conv_layers: int = 2
    rnn_hidden: int = 256
    rnn_layers: int = 2
    mode: str = "mask"           # "mask" (sigmoid mask * noisy mag) | "mapping" (direct mag)
    dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """The part of the train section the port reads: the init seed."""

    seed: int = 0


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    enhancer: EnhancerConfig = field(default_factory=EnhancerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        sections = {}
        for f in dataclasses.fields(cls):
            tp = f.default_factory
            names = {g.name for g in dataclasses.fields(tp)}
            sub = d.get(f.name, {})
            sections[f.name] = tp(**{k: v for k, v in sub.items() if k in names})
        return cls(**sections)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
