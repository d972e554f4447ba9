"""Loss functions of the generator objectives and of AM pre-training, and
the on-device features and enhancer forward that they and the evaluation
share (port of ``aas_enhancement_tpu/train/objectives.py``).

- adversarial: LSGAN or BCE on the spectrogram discriminator;
- acoustic: CTC of the frozen AM on the enhanced features;
- AAS: L_G = L_acoustic + lambda * L_adv;
- am: CTC of the trained AM on (typically clean) speech, optionally with
  SpecAugment, the frozen enhancer in front and a KL anchor (``distill_kl``).

All on the batch's device and padding-masked; repeat-padded rows carry
weight 0 (``row_weights``).  The paired objective (``paired_loss``,
``mr_stft_loss``) is not ported yet (ROADMAP A8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.dsp import api as dsp_api
from aas_enhancement_tpu_torch.dsp.stft import magnitude
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.models.enhancer import Enhancer, apply_enhancement
from aas_enhancement_tpu_torch.ops.ctc import ctc_loss_mean
from aas_enhancement_tpu_torch.ops.masking import masked_normalize, spec_augment, time_mask


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
    AM's frame posteriors are pulled toward it."""
    t = cfg.train
    if t.streaming_finetune_am:
        raise NotImplementedError("streaming_finetune_am: the block-streaming AM "
                                  "forward is not yet ported (ROADMAP A11)")
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
