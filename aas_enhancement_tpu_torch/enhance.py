"""The enhancement inference path: wav -> STFT -> enhancer -> ISTFT -> wav
(port of ``aas_enhancement_tpu/enhance.py``).

On a CUDA device the path runs through four hand-written kernels: the STFT
and ISTFT (``csrc/stft.cu``, ``csrc/istft.cu``), masked GroupNorm +
leaky_relu (``csrc/gn.cu``, one cooperative launch) and the BiLSTM recurrence
(``csrc/lstm_tm.cu``).  The convolutions and the dense products are
``F.conv2d`` and ``torch.matmul``.  On the CPU every kernel's plain version
runs instead.  ``EnhancePipeline`` is the path as one module, which
``make_enhance_fn`` runs and ``serving.py`` exports.
``make_streaming_enhance_fn`` is the same path for one block of a stream,
normalized with running moments (``streaming.py`` drives it).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.convert import init_like_flax
from aas_enhancement_tpu_torch.dsp import api as dsp_api
from aas_enhancement_tpu_torch.dsp.stft import magnitude, phase
from aas_enhancement_tpu_torch.models.enhancer import Enhancer, apply_enhancement
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.ops.masking import (masked_normalize, running_normalize,
                                                   time_mask, window_stats)


def init_enhancer(cfg: Config, seed: int,
                  device: torch.device | str = "cuda") -> Enhancer:
    """A randomly initialized ``Enhancer``, drawn on the CPU from ``seed`` and
    then moved to ``device``, so every device gets the same weights.  The
    default is the card; without a GPU that raises (pass ``"cpu"``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_like_flax(Enhancer(cfg.enhancer, cfg.audio.num_bins), gen)
    return model.to(device).eval()


class EnhancePipeline(nn.Module):
    """The enhance path as one module: forward(wav [B, n], lengths [B]) ->
    enhanced wav [B, n] (STFT, log1p, masked normalization, ``model``,
    ``apply_enhancement``, ISTFT with the noisy phase), on the device of its
    inputs and ``model``.  ``make_enhance_fn`` calls it under
    ``torch.inference_mode()``; ``serving.py::export_enhancer`` exports it
    with ``torch.export``, where each kernel is one operator node."""

    def __init__(self, cfg: Config, model: Enhancer):
        super().__init__()
        self.audio = cfg.audio
        self.enh_cfg = cfg.enhancer
        self.model = model

    def forward(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        a = self.audio
        wav = wav.to(torch.float32)
        lengths = lengths.to(torch.int64)
        re, im = dsp_api.stft(a, wav)
        mag = magnitude(re, im)
        ph = phase(re, im)
        log_mag = torch.log1p(mag)
        frame_lengths = (1 + lengths // a.hop_length if a.center
                         else 1 + (lengths - a.n_fft) // a.hop_length)
        net_in = masked_normalize(log_mag, frame_lengths) if a.normalize else log_mag
        out = self.model(net_in, frame_lengths)
        enhanced_mag = apply_enhancement(self.enh_cfg, out, mag)
        return dsp_api.reconstruct(a, enhanced_mag, ph, length=wav.shape[-1])


def make_enhance_fn(cfg: Config, device: torch.device | str):
    """Returns fn(model, wav [B, n], lengths [B]) -> enhanced wav [B, n] on
    ``device`` (the model must already live there): ``EnhancePipeline``
    under ``torch.inference_mode()``."""
    device = torch.device(device)

    @torch.inference_mode()
    def enhance(model: Enhancer, wav: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        return EnhancePipeline(cfg, model)(wav.to(device), lengths.to(device))

    return enhance


def make_streaming_enhance_fn(cfg: Config, device: torch.device | str):
    """The streaming variant of ``make_enhance_fn``, normalized with RUNNING
    moments (JAX ``make_streaming_enhance_fn``):

    fn(model, wav [B, n], lengths [B], stats_start, stats_end, run_sum,
       run_sumsq, run_count) -> (enhanced [B, n], block_sum [B],
       block_sumsq [B], block_count [B]), all on ``device``.

    A streamed block cannot see the whole utterance, so the caller carries
    the moments of the log-magnitudes seen so far, and the block is
    normalized with those plus its own.  Every row is an independent stream:
    the stats window and the running moments are scalars (broadcast) or [B]
    tensors.  The increments returned count only the valid frames t with
    stats_start <= t < stats_end (the frames this block consumes: earlier
    ones are history already counted, later ones lookahead the next block
    owns); the whole block is normalized all the same."""
    a = cfg.audio
    enh_cfg = cfg.enhancer
    device = torch.device(device)

    @torch.inference_mode()
    def enhance(model: Enhancer, wav: torch.Tensor, lengths: torch.Tensor,
                stats_start, stats_end, run_sum, run_sumsq, run_count):
        wav = torch.as_tensor(wav).to(device=device, dtype=torch.float32)
        lengths = torch.as_tensor(lengths).to(device=device, dtype=torch.int64)
        run = tuple(torch.as_tensor(r, dtype=torch.float32, device=device).reshape(-1)
                    for r in (run_sum, run_sumsq, run_count))
        re, im = dsp_api.stft(a, wav)
        mag = magnitude(re, im)
        log_mag = torch.log1p(mag)
        frame_lengths = (1 + lengths // a.hop_length if a.center
                         else 1 + (lengths - a.n_fft) // a.hop_length)
        valid = time_mask(frame_lengths, log_mag.shape[1])
        inc = window_stats(log_mag, valid, stats_start, stats_end)
        net_in = running_normalize(log_mag, valid, inc, run) if a.normalize else log_mag
        out = model(net_in, frame_lengths)
        enhanced_mag = apply_enhancement(enh_cfg, out, mag)
        wav_out = dsp_api.reconstruct(a, enhanced_mag, phase(re, im), length=wav.shape[-1])
        return (wav_out, *inc)

    return enhance


def enhance_utterance(cfg: Config, model: Enhancer, wav: np.ndarray,
                      device: torch.device | str = "cuda") -> np.ndarray:
    """Single-utterance convenience wrapper; ``model`` lives on ``device``
    (the card by default; without a GPU that raises, pass ``"cpu"``)."""
    fn = make_enhance_fn(cfg, resolve_device(device))
    out = fn(model, torch.from_numpy(np.asarray(wav, np.float32))[None],
             torch.tensor([len(wav)]))
    return out[0].cpu().numpy()
