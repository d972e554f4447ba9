"""The configuration the ported paths read (counterpart of
``aas_enhancement_tpu/config.py``).

The same dataclasses, fields and defaults as the JAX package's audio, AM,
enhancer, discriminator and data sections, and the fields of its train
section that the port reads.  A config JSON written by either package loads
here as long as the fields the port does not have (``UNPORTED``, empty now
that every field is ported) hold their defaults: a non-default value of one
raises instead of vanishing, naming the ROADMAP item that decides the field's
consumer.  Keys that neither package knows are
skipped, as the JAX package's own ``Config.from_dict`` skips them, and JSON
lists become tuples, as there.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


# Fields of the JAX package's config that the port's dataclasses lack, by
# section: name -> (the JAX default, the ROADMAP item that ports the field's
# consumer).  ``Config.from_dict`` accepts the default and raises on any other
# value.  ``tests/test_torch_cli.py`` holds this table to the JAX dataclasses:
# a field the port drops is listed here or the test fails.
UNPORTED: dict[str, dict[str, tuple[Any, str]]] = {}


@dataclass(frozen=True)
class AudioConfig:
    """STFT / featurization parameters."""

    sample_rate: int = 16000
    window_size: float = 0.02    # seconds -> n_fft = 320 -> 161 freq bins
    window_stride: float = 0.01  # seconds -> hop = 160
    window: str = "hann"         # "hann" | "hamming"
    center: bool = True          # reflect-pad n_fft//2 on both sides
    normalize: bool = True       # per-utterance mean/std normalization of log-mag
    stft_impl: str = "auto"      # the JAX package's choice of STFT route; here every
                                 # value runs the same kernels (dsp/api.py), and
                                 # "pallas" asks n_fft == 2 * hop as there

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
class AMConfig:
    """DeepSpeech2-style acoustic model."""

    rnn_hidden: int = 512
    rnn_layers: int = 4
    rnn_type: str = "gru"        # "gru" | "lstm"
    conv_channels: int = 32
    vocab_size: int = 29         # len(labels.LABELS)
    dtype: str = "float32"       # "float32" | "bfloat16"


@dataclass(frozen=True)
class EnhancerConfig:
    """Conv + BLSTM enhancement network."""

    conv_channels: int = 32
    conv_layers: int = 2
    rnn_hidden: int = 256
    rnn_layers: int = 2
    mode: str = "mask"           # "mask" (sigmoid mask * noisy mag) | "mapping" (direct mag)
    dtype: str = "float32"       # "float32" | "bfloat16"


@dataclass(frozen=True)
class DataConfig:
    """Host-side data pipeline (``data/dataset.py``).

    ``augment=True`` perturbs each unpaired training wav (``data/augment.py``:
    speed, gain, noise from ``noise_dir``).  ``use_grain=True`` makes the trainer
    decode batches in ``grain_workers`` worker processes (``data/grain_loader.py``,
    a ``torch.utils.data.DataLoader``; the name stays the JAX package's, so one
    JSON config loads in both).  ``native_decode`` decodes unaugmented batches
    with the native C++ decoder (``data/native_audio.py``) when it is built.
    """

    train_manifest: str = ""
    clean_manifest: str = ""
    val_manifest: str = ""
    max_duration: float = 16.0   # seconds; longer utterances dropped
    min_duration: float = 0.3
    num_buckets: int = 4         # padded time-shape buckets
    augment: bool = False
    augment_speed: bool = True
    augment_gain: bool = True
    use_grain: bool = False
    grain_workers: int = 2
    noise_dir: str = ""
    noise_prob: float = 0.4
    noise_snr_range: tuple = (0.0, 15.0)
    feed_dtype: str = "float32"  # "int16": batches carry PCM16, converted on device
    native_decode: bool = True


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Spectrogram discriminator."""

    channels: tuple = (32, 64, 128)
    dtype: str = "float32"       # "float32" | "bfloat16"


@dataclass(frozen=True)
class TrainConfig:
    """The train section's fields that the port reads, with the JAX package's
    defaults: the ``paired``, ``aas``, ``adversarial``, ``acoustic`` and
    ``am`` objectives (and ``enhance_only``, ``preset("single_utterance")``'s,
    which builds G and trains nothing) with ``grad_accum``, checkpoints,
    validation, input prefetch, SortaGrad, profiling and streaming
    fine-tuning (``streaming_finetune``, ``streaming_finetune_am`` at the
    ``stream_*_s`` operating point).
    """

    objective: str = "aas"       # "paired" | "adversarial" | "acoustic" | "aas" | "am"
                                 # | "enhance_only"
    batch_size: int = 8
    lr_g: float = 3e-4
    lr_d: float = 3e-4
    lr_am: float = 3e-4
    adam_b1: float = 0.5         # GAN-friendly beta1 for G/D
    adam_b2: float = 0.999
    momentum: float = 0.9        # SGD momentum of AM pre-training
    max_grad_norm: float = 400.0
    lambda_adv: float = 1.0      # weight on the adversarial term of the AAS loss
    lambda_mrstft: float = 0.0   # "paired": weight of the multi-resolution STFT loss
                                 # on the reconstructed waveform (0 = off)
    gan_loss: str = "lsgan"      # "lsgan" | "bce"
    epochs: int = 10
    steps_per_epoch: int = 0     # 0 = derive from the dataset
    lr_anneal: float = 1.0       # lr(epoch) = lr / lr_anneal**epoch
    sortagrad: bool = False      # epoch 0 served strictly shortest-first
    seed: int = 0
    checkpoint_dir: str = "checkpoints"
    checkpoint_every: int = 500
    log_every: int = 10
    eval_every: int = 0          # validate every N steps; 0 = at each epoch end
                                 # (only when data.val_manifest is set)
    eval_batch_size: int = 4     # batch size of in-training validation
    prefetch: int = 2            # batches assembled and moved to the device
                                 # ahead of the step (one thread); 0 = synchronous
    grad_accum: int = 1          # microbatches per optimizer update
    profile_dir: str = ""        # torch.profiler trace of profile_steps steps
    profile_start: int = 10      # from the first step >= profile_start
    profile_steps: int = 3
    spec_augment: bool = False   # SpecAugment on the "am" objective's features
    sa_time_masks: int = 2
    sa_time_width: int = 30      # max frames per time stripe
    sa_freq_masks: int = 2
    sa_freq_width: int = 13      # max bins per frequency stripe
    streaming_finetune: bool = False  # G trains through the blockwise streaming
                                 # forward (models/enhancer.py::blockwise_apply)
    streaming_finetune_am: bool = False  # "am": the AM trains through the block-
                                 # streaming AM forward (models/am.py::am_blockwise_apply)
    am_through_enhancer: bool = False  # "am": the AM reads the FROZEN enhancer's
                                 # output features instead of the raw input
    stream_chunk_s: float = 1.0  # the streaming fine-tuning operating point; it
    stream_lookahead_s: float = 0.2  # should match the served one
    stream_history_s: float = 1.0    # (streaming.StreamingEnhancer)
    distill_lambda: float = 0.0  # "am": weight of the KL term that ties the
                                 # AM's frame posteriors to those of the AM as
                                 # the run started (the anchor)


@dataclass(frozen=True)
class MeshConfig:
    """The data axis (``parallel/mesh.py``): one process a device."""

    data_axis: str = "data"
    num_devices: int = 0         # 0 = every launched process; else must equal
                                 # the world size


@dataclass(frozen=True)
class Config:
    audio: AudioConfig = field(default_factory=AudioConfig)
    am: AMConfig = field(default_factory=AMConfig)
    enhancer: EnhancerConfig = field(default_factory=EnhancerConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        for section, lacking in UNPORTED.items():
            given = d.get(section, {})
            for k in lacking.keys() & given.keys():
                default, item = lacking[k]
                if given[k] != default:
                    raise NotImplementedError(
                        f"config {section}.{k} = {given[k]!r}: the port has no consumer of "
                        f"this field yet (ROADMAP {item}); it loads only at its default "
                        f"{default!r}")
        sections = {}
        for f in dataclasses.fields(cls):
            tp = f.default_factory
            names = {g.name for g in dataclasses.fields(tp)}
            sub = d.get(f.name, {})
            sections[f.name] = tp(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in sub.items() if k in names})
        return cls(**sections)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# The five driver acceptance configs, as the JAX package names them.
def preset(name: str) -> Config:
    """The five graded end-to-end configs, smallest first: ``single_utterance``
    (the ``enhance_only`` objective at batch 1), ``paired``, ``adversarial``,
    ``acoustic`` and ``aas``, each the default ``Config`` with that objective."""
    base = Config()
    objective = {"single_utterance": "enhance_only", "paired": "paired",
                 "adversarial": "adversarial", "acoustic": "acoustic",
                 "aas": "aas"}.get(name)
    if objective is None:
        raise ValueError(f"unknown preset: {name!r}")
    train = dataclasses.replace(base.train, objective=objective)
    if name == "single_utterance":
        train = dataclasses.replace(train, batch_size=1)
    return base.replace(train=train)
