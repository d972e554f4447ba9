"""Loss functions of the generator objectives and of AM pre-training, and
the on-device features and enhancer forward that they and the evaluation
share (port of ``aas_enhancement_tpu/train/objectives.py``).

- paired: L1 between enhanced and clean log-magnitudes, optionally plus
  ``lambda_mrstft`` times the multi-resolution STFT loss (``mr_stft_loss``)
  on the waveform reconstructed with the noisy phase;
- adversarial: LSGAN or BCE on the spectrogram discriminator;
- acoustic: CTC of the frozen AM on the enhanced features;
- AAS: L_G = L_acoustic + lambda * L_adv;
- am: CTC of the trained AM on (typically clean) speech, optionally with
  SpecAugment, the frozen enhancer in front and a KL anchor (``distill_kl``).

``TrainConfig.streaming_finetune`` runs every generator objective's enhancer
(and the ``am`` objective's frozen one) through the blockwise streaming
forward, ``streaming_finetune_am`` the ``am`` objective's AM.

All on the batch's device and padding-masked; repeat-padded rows carry
weight 0 (``row_weights``).  On the card the MR-STFT term's gradient runs
through the STFT's and the ISTFT's VJP kernels (``ops/cuda/stft.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.dsp import api as dsp_api
from aas_enhancement_tpu_torch.dsp.stft import magnitude, phase
from aas_enhancement_tpu_torch.models.am import AcousticModel, am_blockwise_apply
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.models.enhancer import (Enhancer, apply_enhancement,
                                                       blockwise_apply)
from aas_enhancement_tpu_torch.ops.ctc import ctc_loss_mean
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
from aas_enhancement_tpu_torch.ops.masking import masked_normalize, spec_augment, time_mask


def wav_f32(wav: torch.Tensor) -> torch.Tensor:
    """int16 transport (``DataConfig.feed_dtype``) -> f32 in [-1, 1); f32 as is."""
    if not wav.is_floating_point():
        return wav.to(torch.float32) * (1.0 / 32768.0)
    return wav


def _spectral_features(cfg: Config, re: torch.Tensor, im: torch.Tensor,
                       wav_lengths: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """An STFT -> (mag, log_mag, frame_lengths)."""
    a = cfg.audio
    mag = magnitude(re, im)
    if a.center:
        frame_lengths = 1 + wav_lengths // a.hop_length
    else:
        frame_lengths = 1 + (wav_lengths - a.n_fft) // a.hop_length
    return mag, torch.log1p(mag), frame_lengths.to(torch.int64)


def device_features(cfg: Config, wav: torch.Tensor, wav_lengths: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Padded wav [B, N] -> (mag, log_mag [B, T, F], frame_lengths [B]) on
    the wav's device; an int16 feed converts to f32 there."""
    re, im = dsp_api.stft(cfg.audio, wav_f32(wav))
    return _spectral_features(cfg, re, im, wav_lengths)


def stream_frames(cfg: Config, min_chunk: int) -> dict:
    """The streaming fine-tuning operating point in frames: chunk (at least
    ``min_chunk``), lookahead and history of ``TrainConfig.stream_*_s``,
    truncated to whole frames as the JAX objectives do."""
    t = cfg.train
    fps = cfg.audio.sample_rate / cfg.audio.hop_length
    return {"chunk_f": max(min_chunk, int(t.stream_chunk_s * fps)),
            "look_f": int(t.stream_lookahead_s * fps),
            "hist_f": int(t.stream_history_s * fps)}


def _enhance(cfg: Config, enhancer: Enhancer, mag: torch.Tensor, log_mag: torch.Tensor,
             fl: torch.Tensor, streaming: bool) -> torch.Tensor:
    """Noisy (mag, log_mag) -> enhanced magnitude; ``streaming`` runs the
    blockwise forward (``models/enhancer.py::blockwise_apply``)."""
    net_in = masked_normalize(log_mag, fl) if cfg.audio.normalize else log_mag
    if streaming:
        out = blockwise_apply(enhancer, net_in, fl, **stream_frames(cfg, 1))
    else:
        out = enhancer(net_in, fl)
    return apply_enhancement(cfg.enhancer, out, mag)


def enhancer_forward(cfg: Config, enhancer: Enhancer, wav: torch.Tensor,
                     wav_lengths: torch.Tensor, streaming: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Noisy wav -> (enhanced_mag, enhanced_log_mag, frame_lengths)."""
    mag, log_mag, fl = device_features(cfg, wav, wav_lengths)
    enh_mag = _enhance(cfg, enhancer, mag, log_mag, fl, streaming)
    return enh_mag, torch.log1p(enh_mag), fl


def _wmean(x: torch.Tensor, weights: torch.Tensor | None = None,
           denom: torch.Tensor | float | None = None) -> torch.Tensor:
    """Weighted mean over the batch dim (weights None -> plain mean).

    ``denom`` replaces sum(weights): gradient accumulation passes each
    microbatch its SHARE of the global real-row count (W_total / k), so the
    k microbatch values sum to the full-batch weighted mean exactly."""
    if weights is None and denom is None:
        return x.mean()
    w = torch.ones_like(x) if weights is None else weights.to(x.dtype)
    d = w.sum() if denom is None else torch.as_tensor(denom, dtype=x.dtype,
                                                      device=x.device)
    return (x * w).sum() / torch.clamp(d, min=1e-6)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, lengths: torch.Tensor,
              weights=None, denom=None) -> torch.Tensor:
    """Mean |pred - target| over each row's valid frames and all bins, then
    the weighted batch mean."""
    mask = time_mask(lengths, pred.shape[1], pred.dtype)[:, :, None]
    per_ex = ((pred - target).abs() * mask).sum(dim=(1, 2)) / torch.clamp(
        mask.sum(dim=(1, 2)) * pred.shape[2], min=1.0)
    return _wmean(per_ex, weights, denom)


MR_RESOLUTIONS = ((256, 64), (512, 128), (1024, 256))


def mr_stft_loss(est_wav: torch.Tensor, ref_wav: torch.Tensor, wav_lengths: torch.Tensor,
                 weights=None, denom=None, resolutions: tuple = MR_RESOLUTIONS
                 ) -> torch.Tensor:
    """Multi-resolution STFT loss (Parallel WaveGAN): the mean over the
    resolutions (n_fft, hop), Hann window, center pad, of spectral
    convergence plus log-magnitude L1, on each row's valid frames, then the
    weighted batch mean.  Both waves in f32 [-1, 1) scale.  The STFTs are
    the port's kernel on the card; the estimate's gradient takes
    ``stft_vjp``."""
    eps = 1e-7
    total = est_wav.new_zeros((), dtype=torch.float32)
    for n_fft, hop in resolutions:
        mag_e = magnitude(*kstft.stft(est_wav.to(torch.float32), n_fft, hop, "hann", True))
        mag_r = magnitude(*kstft.stft(ref_wav.to(torch.float32), n_fft, hop, "hann", True))
        fm = time_mask(1 + wav_lengths // hop, mag_e.shape[1])[:, :, None]     # [B, T, 1]
        nvalid = torch.clamp(fm.sum(dim=(1, 2)) * mag_e.shape[2], min=1.0)
        diff = torch.sqrt((((mag_r - mag_e) * fm) ** 2).sum(dim=(1, 2)) + eps)
        ref_n = torch.sqrt(((mag_r * fm) ** 2).sum(dim=(1, 2)) + eps)
        logl1 = ((torch.log(mag_r + eps) - torch.log(mag_e + eps)).abs() * fm
                 ).sum(dim=(1, 2)) / nvalid
        total = total + _wmean(diff / ref_n + logl1, weights, denom)
    return total / len(resolutions)


def paired_loss(cfg: Config, enhancer: Enhancer, batch: dict, w_denom=None
                ) -> tuple[torch.Tensor, dict]:
    """Config 2: L1 between enhanced and clean log-magnitudes, optionally plus
    ``lambda_mrstft`` times ``mr_stft_loss`` on the waveform reconstructed
    from the enhanced magnitude and the noisy phase (the inference output).
    The noisy STFT runs once, for the features and the phase."""
    noisy = wav_f32(batch["wav"])
    re, im = dsp_api.stft(cfg.audio, noisy)
    mag, log_mag, fl = _spectral_features(cfg, re, im, batch["wav_lengths"])
    enh_mag = _enhance(cfg, enhancer, mag, log_mag, fl, cfg.train.streaming_finetune)
    _, clean_log, _ = device_features(cfg, batch["clean_wav"], batch["wav_lengths"])
    rw = batch.get("row_weights")
    loss = masked_l1(torch.log1p(enh_mag), clean_log, fl, rw, w_denom)
    aux = {"loss_paired": loss}
    if cfg.train.lambda_mrstft > 0.0:
        enh_wav = dsp_api.reconstruct(cfg.audio, enh_mag, phase(re, im),
                                      length=noisy.shape[1])
        l_mr = mr_stft_loss(enh_wav, wav_f32(batch["clean_wav"]), batch["wav_lengths"],
                            weights=rw, denom=w_denom)
        loss = loss + cfg.train.lambda_mrstft * l_mr
        aux["loss_mrstft"] = l_mr
        aux["loss_paired_total"] = loss
    return loss, aux


def gan_g_loss(cfg: Config, scores_fake: torch.Tensor, weights=None,
               denom=None) -> torch.Tensor:
    if cfg.train.gan_loss == "lsgan":
        return _wmean((scores_fake - 1.0) ** 2, weights, denom)
    return _wmean(F.softplus(-scores_fake), weights, denom)      # BCE: -log sigmoid


def gan_d_loss(cfg: Config, scores_real: torch.Tensor, scores_fake: torch.Tensor,
               w_real=None, w_fake=None, real_denom=None,
               fake_denom=None) -> torch.Tensor:
    if cfg.train.gan_loss == "lsgan":
        return 0.5 * (_wmean((scores_real - 1.0) ** 2, w_real, real_denom)
                      + _wmean(scores_fake ** 2, w_fake, fake_denom))
    return (_wmean(F.softplus(-scores_real), w_real, real_denom)
            + _wmean(F.softplus(scores_fake), w_fake, fake_denom))


def generator_loss(cfg: Config, enhancer: Enhancer, disc: Discriminator | None,
                   am: AcousticModel | None, batch: dict, use_acoustic: bool,
                   use_adv: bool, lam: float, w_denom=None
                   ) -> tuple[torch.Tensor, dict]:
    """The G objective: the enhancer forward runs ONCE, and the CTC and
    adversarial terms are computed on its output as asked.

    The AM is frozen (its parameters are set not to require grad, as the
    JAX package stops its gradient): the CTC gradient flows through it into
    the enhancer only.  Returns aux with ``enh_log`` (detached) and
    ``enh_fl``, so the D update reuses the same enhanced batch."""
    _, enh_log, fl = enhancer_forward(cfg, enhancer, batch["wav"],
                                      batch["wav_lengths"],
                                      streaming=cfg.train.streaming_finetune)
    loss = enh_log.new_zeros(())
    aux: dict = {}
    rw = batch.get("row_weights")

    if use_acoustic:
        am.requires_grad_(False)
        logits, out_lengths = am(masked_normalize(enh_log, fl), fl)
        logit_paddings = 1.0 - time_mask(out_lengths, logits.shape[1])
        l_ctc = ctc_loss_mean(logits, logit_paddings, batch["labels"],
                              batch["label_paddings"], weights=rw, denom=w_denom)
        loss = loss + l_ctc
        aux["loss_ctc"] = l_ctc

    if use_adv:
        scores = disc(enh_log, fl)
        l_adv = gan_g_loss(cfg, scores, rw, w_denom)
        loss = loss + (lam if use_acoustic else 1.0) * l_adv
        aux["loss_adv_g"] = l_adv
        aux["d_score_fake_g"] = _wmean(scores, rw, w_denom)

    aux["loss_g"] = loss
    aux["enh_log"] = enh_log.detach()
    aux["enh_fl"] = fl
    return loss, aux


def discriminator_loss(cfg: Config, disc: Discriminator, enh_log: torch.Tensor,
                       enh_fl: torch.Tensor, clean_log: torch.Tensor,
                       clean_fl: torch.Tensor, w_fake=None, w_real=None,
                       fake_denom=None, real_denom=None) -> tuple[torch.Tensor, dict]:
    """D update: real = the unpaired clean corpus, fake = the detached enhanced batch."""
    s_real = disc(clean_log, clean_fl)
    s_fake = disc(enh_log.detach(), enh_fl)
    loss = gan_d_loss(cfg, s_real, s_fake, w_real=w_real, w_fake=w_fake,
                      real_denom=real_denom, fake_denom=fake_denom)
    return loss, {"loss_d": loss,
                  "d_score_real": _wmean(s_real, w_real, real_denom),
                  "d_score_fake": _wmean(s_fake, w_fake, fake_denom)}


def distill_kl(base_logits: torch.Tensor, logits: torch.Tensor,
               out_lengths: torch.Tensor, weights=None, denom=None) -> torch.Tensor:
    """Posterior-anchor distillation: the masked mean per frame of
    KL(softmax(base) || softmax(adapted)), averaged over the batch with the
    real-row weighting of every other loss.  ``base_logits`` carry no
    gradient (the anchor never trains)."""
    base = base_logits.detach().to(torch.float32)
    log_p = F.log_softmax(base, dim=-1)
    kl = (log_p.exp() * (log_p - F.log_softmax(logits.to(torch.float32), dim=-1))).sum(-1)
    fm = time_mask(out_lengths, kl.shape[1], kl.dtype)
    per_ex = (kl * fm).sum(dim=1) / torch.clamp(fm.sum(dim=1), min=1.0)
    return _wmean(per_ex, weights, denom)


def am_pretrain_loss(cfg: Config, am: AcousticModel, batch: dict, w_denom=None,
                     gen: torch.Generator | None = None,
                     enhancer: Enhancer | None = None,
                     anchor_am: AcousticModel | None = None
                     ) -> tuple[torch.Tensor, dict]:
    """AM pre-training on (typically clean) speech: CTC of ``am`` on the
    normalized log-magnitude features.

    ``gen`` not None enables SpecAugment when ``cfg.train.spec_augment`` (the
    train step only; an evaluation forward passes none).  ``enhancer`` not
    None (``TrainConfig.am_through_enhancer``) feeds the AM the FROZEN
    enhancer's output features instead of the raw input.  ``anchor_am`` not
    None with ``cfg.train.distill_lambda`` > 0 adds the KL term of
    ``distill_kl``: the anchor runs on the same features and the trained
    AM's frame posteriors are pulled toward it.  ``TrainConfig.
    streaming_finetune_am`` trains through the block-streaming AM forward
    (``models/am.py::am_blockwise_apply``); the anchor stays on the offline
    forward, masked to the shorter of the two lengths (they agree)."""
    t = cfg.train
    with torch.no_grad():
        if enhancer is not None:
            _, log_mag, fl = enhancer_forward(cfg, enhancer, batch["wav"],
                                              batch["wav_lengths"],
                                              streaming=t.streaming_finetune)
        else:
            _, log_mag, fl = device_features(cfg, batch["wav"], batch["wav_lengths"])
        am_in = masked_normalize(log_mag, fl)
        if gen is not None and t.spec_augment:
            am_in = spec_augment(gen, am_in, fl, t.sa_time_masks, t.sa_time_width,
                                 t.sa_freq_masks, t.sa_freq_width)
    if t.streaming_finetune_am:
        logits, out_lengths = am_blockwise_apply(am, am_in, fl, **stream_frames(cfg, 2))
    else:
        logits, out_lengths = am(am_in, fl)
    logit_paddings = 1.0 - time_mask(out_lengths, logits.shape[1])
    rw = batch.get("row_weights")
    loss = ctc_loss_mean(logits, logit_paddings, batch["labels"],
                         batch["label_paddings"], weights=rw, denom=w_denom)
    aux = {"loss_ctc_am": loss}
    if anchor_am is not None and t.distill_lambda > 0.0:
        with torch.no_grad():
            base_logits, base_ol = anchor_am(am_in, fl)
        l_kl = distill_kl(base_logits, logits, torch.minimum(out_lengths, base_ol),
                          weights=rw, denom=w_denom)
        loss = loss + t.distill_lambda * l_kl
        aux["loss_distill"] = l_kl
        aux["loss_am_total"] = loss
    return loss, aux
