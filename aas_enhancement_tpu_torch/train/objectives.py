"""On-device features and the enhancer forward that the objectives and the
evaluation share (counterpart of ``aas_enhancement_tpu/train/objectives.py``,
features part; the losses come with the training slice, ROADMAP A6)."""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.dsp import api as dsp_api
from aas_enhancement_tpu_torch.dsp.stft import magnitude
from aas_enhancement_tpu_torch.models.enhancer import Enhancer, apply_enhancement
from aas_enhancement_tpu_torch.ops.masking import masked_normalize


def wav_f32(wav: torch.Tensor) -> torch.Tensor:
    """int16 transport (``DataConfig.feed_dtype``) -> f32 in [-1, 1); f32 as is."""
    if not wav.is_floating_point():
        return wav.to(torch.float32) * (1.0 / 32768.0)
    return wav


def device_features(cfg: Config, wav: torch.Tensor, wav_lengths: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded wav [B, N] -> (mag, log_mag [B, T, F], frame_lengths [B]) on
    the wav's device; an int16 feed converts to f32 there."""
    a = cfg.audio
    wav = wav_f32(wav)
    re, im = dsp_api.stft(a, wav)
    mag = magnitude(re, im)
    log_mag = torch.log1p(mag)
    if a.center:
        frame_lengths = 1 + wav_lengths // a.hop_length
    else:
        frame_lengths = 1 + (wav_lengths - a.n_fft) // a.hop_length
    return mag, log_mag, frame_lengths.to(torch.int64)


def enhancer_forward(cfg: Config, enhancer: Enhancer, wav: torch.Tensor,
                     wav_lengths: torch.Tensor, streaming: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noisy wav -> (enhanced_mag, enhanced_log_mag, frame_lengths)."""
    if streaming:
        raise NotImplementedError("streaming=True: the blockwise streaming "
                                  "enhancer is not yet ported (ROADMAP A11)")
    mag, log_mag, fl = device_features(cfg, wav, wav_lengths)
    net_in = masked_normalize(log_mag, fl) if cfg.audio.normalize else log_mag
    enh_mag = apply_enhancement(cfg.enhancer, enhancer(net_in, fl), mag)
    return enh_mag, torch.log1p(enh_mag), fl
