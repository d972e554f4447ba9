"""WER evaluation: the AM with greedy or beam decoding over a manifest, on noisy
or enhanced input, plus SI-SNR and STOI (port of
``aas_enhancement_tpu/evaluation.py``).

The recognition forward is wav -> STFT log-magnitude (or the enhancer's
log1p(enhanced magnitude), with no ISTFT) -> per-utterance masked
normalization (always, whatever ``audio.normalize`` says, as in the JAX
package) -> ``AcousticModel`` -> logits and frame paddings.  On a CUDA device
it runs through the STFT, GroupNorm, LSTM (enhancer) and GRU (AM) kernels.
Decoders: ``greedy``; ``beam``, the host prefix beam (``decode/beam.py``,
native C++ or Python) with char, word or hybrid LM fusion; ``device``, the
batched beam on the logits' device (``decode/device_beam.py``) with char-LM
fusion only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.convert import init_like_flax
from aas_enhancement_tpu_torch.data.dataset import AudioDataset
from aas_enhancement_tpu_torch.data.manifest import read_manifest
from aas_enhancement_tpu_torch.data.wav import read_wav
from aas_enhancement_tpu_torch.decode.beam import beam_decode
from aas_enhancement_tpu_torch.decode.device_beam import device_beam_decode
from aas_enhancement_tpu_torch.decode.greedy import decode_batch
from aas_enhancement_tpu_torch.decode.wer import cer, corpus_wer, corpus_wer_ci, edit_distance
from aas_enhancement_tpu_torch.labels import decode_ids
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.ops.masking import masked_normalize, time_mask
from aas_enhancement_tpu_torch.train.objectives import device_features, enhancer_forward


def init_am(cfg: Config, seed: int, device: torch.device | str = "cuda") -> AcousticModel:
    """A randomly initialized ``AcousticModel``, drawn on the CPU from ``seed``
    and then moved to ``device``, so every device gets the same weights.  The
    default is the card; without a GPU that raises (pass ``"cpu"``)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = init_like_flax(AcousticModel(cfg.am, cfg.audio.num_bins), gen)
    return model.to(device).eval()


def make_eval_forward(cfg: Config, use_enhancer: bool):
    """-> fn(am, enhancer, wav [B, N], wav_lengths [B]) -> (logits [B, T', V],
    logit paddings [B, T'], 1.0 = padded), on the models' device."""

    @torch.inference_mode()
    def forward(am: AcousticModel, enhancer: Enhancer | None, wav: torch.Tensor,
                wav_lengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if use_enhancer:
            _, log_mag, fl = enhancer_forward(cfg, enhancer, wav, wav_lengths)
        else:
            _, log_mag, fl = device_features(cfg, wav, wav_lengths)
        logits, out_lengths = am(masked_normalize(log_mag, fl), fl)
        return logits, 1.0 - time_mask(out_lengths, logits.shape[1])

    return forward


def eval_dataset(cfg: Config, manifest: str) -> AudioDataset:
    """Evaluation scores the WHOLE set, unperturbed: no duration filtering and
    no augmentation, whatever the training data config said."""
    eval_data = dataclasses.replace(cfg.data, augment=False,
                                    min_duration=0.0, max_duration=1e9)
    return AudioDataset(manifest, cfg.audio, eval_data)


def _device_table(lm):
    """The dense char-LM table and its order for ``decoder="device"``."""
    if lm is None:
        return None, 0
    if hasattr(lm, "dense_table"):
        return lm.dense_table(), lm.order
    if isinstance(lm, np.ndarray):
        raise ValueError("decoder='device' needs a CharNGramLM "
                         "(table order unknown from a bare array)")
    raise ValueError("decoder='device' supports char-LM fusion only; "
                     "use decoder='beam'")


def evaluate_wer(cfg: Config, am: AcousticModel, manifest: str | AudioDataset,
                 enhancer: Enhancer | None = None, batch_size: int = 4,
                 decoder: str = "greedy", beam_width: int = 32, lm=None,
                 lm_alpha: float = 0.0, lm_beta: float = 0.0, word_lm=None,
                 word_alpha: float = 0.0, word_beta: float = 0.0, forward=None,
                 per_utt: bool = False) -> dict:
    """Corpus WER (with a bootstrap 95% CI) and mean CER over a manifest,
    decoded by ``decoder`` ("greedy", "beam" or "device"; LM fusion as
    ``decode/beam.py::beam_decode`` takes it), enhancing first if
    ``enhancer`` is given.  ``manifest`` may be a prebuilt ``AudioDataset``
    and ``forward`` a prebuilt ``make_eval_forward`` result.  ``per_utt``
    adds each utterance's word edit count, in the dataset's stable batch
    order."""
    if decoder not in ("greedy", "beam", "device"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if decoder == "device" and word_lm is not None:
        raise ValueError("decoder='device' supports char-LM fusion only; "
                         "use decoder='beam' for word/hybrid")
    table, order = _device_table(lm) if decoder == "device" else (None, 0)
    ds = manifest if isinstance(manifest, AudioDataset) else eval_dataset(cfg, manifest)
    if forward is None:
        forward = make_eval_forward(cfg, use_enhancer=enhancer is not None)
    device = next(am.parameters()).device

    refs, hyps = [], []
    for batch in ds.batches(batch_size, seed=0, epoch=0):
        logits, pads = forward(am, enhancer, torch.from_numpy(batch.wav).to(device),
                               torch.from_numpy(batch.wav_lengths).to(device))
        k = batch.size  # drop repeat-padded rows from the metrics
        if decoder == "greedy":
            hyps.extend(decode_batch(logits, pads)[:k])
        else:
            log_probs = torch.log_softmax(logits, dim=-1)
            lens = (pads < 0.5).sum(1).cpu().numpy().astype(np.int32)
            if decoder == "beam":
                hyps.extend(beam_decode(log_probs.cpu().numpy(), lens,
                                        beam_width=beam_width, lm=lm, lm_alpha=lm_alpha,
                                        lm_beta=lm_beta, word_lm=word_lm,
                                        word_alpha=word_alpha, word_beta=word_beta)[:k])
            else:
                hyps.extend(device_beam_decode(log_probs, lens, beam_width=beam_width,
                                               lm_table=table, lm_order=order,
                                               lm_alpha=lm_alpha, lm_beta=lm_beta)[:k])
        for row, pad_row in zip(batch.labels[:k], batch.label_paddings[:k]):
            refs.append(decode_ids(row[: int(np.sum(pad_row < 0.5))]))

    c = float(np.mean([cer(r, h) for r, h in zip(refs, hyps)])) if refs else 0.0
    _, lo, hi = corpus_wer_ci(refs, hyps)
    out = {"wer": corpus_wer(refs, hyps), "wer_ci95": [lo, hi], "cer": c,
           "utterances": len(refs), "sample_ref": refs[0] if refs else "",
           "sample_hyp": hyps[0] if hyps else ""}
    if per_utt:
        out["per_utt"] = [edit_distance(r.split(), h.split())
                          for r, h in zip(refs, hyps)]
    return out


def si_snr(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SNR (dB) of one estimated waveform vs its reference:
    zero-mean, project est onto ref, 10 log10 of signal over residual power."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n] - est[:n].mean(), ref[:n] - ref[:n].mean()
    denom = np.dot(ref, ref) + 1e-12
    s_t = (np.dot(est, ref) / denom) * ref
    e = est - s_t
    return float(10.0 * np.log10((np.dot(s_t, s_t) + 1e-12)
                                 / (np.dot(e, e) + 1e-12)))


def _third_octave_bands(fs: int, nfft: int, n_bands: int, f_min: float):
    """[n_bands, nfft//2+1] one-zero matrix grouping FFT bins into 1/3-octave
    bands with center frequencies f_min * 2^(k/3)."""
    f = np.linspace(0.0, fs / 2.0, nfft // 2 + 1)
    k = np.arange(n_bands)
    f_lo = f_min * 2.0 ** ((k - 0.5) / 3.0)
    f_hi = f_min * 2.0 ** ((k + 0.5) / 3.0)
    bands = np.zeros((n_bands, len(f)))
    for i in range(n_bands):
        lo = int(np.argmin((f - f_lo[i]) ** 2))
        hi = int(np.argmin((f - f_hi[i]) ** 2))
        bands[i, lo:hi] = 1.0
    return bands


def stoi(est: np.ndarray, ref: np.ndarray, fs: int = 16000) -> float:
    """Short-Time Objective Intelligibility (Taal et al. 2010), in [~0, 1]:
    correlation of 384 ms 1/3-octave-band envelopes of est vs the clean ref
    at 10 kHz, after silent-frame removal and clipping at -15 dB SDR."""
    from scipy.signal import resample_poly

    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(len(est), len(ref))
    est, ref = est[:n], ref[:n]
    fs_stoi, win, hop, nfft, n_bands, f_min, seg_n, beta = (
        10000, 256, 128, 512, 15, 150.0, 30, -15.0)
    if fs != fs_stoi:
        g = np.gcd(int(fs), fs_stoi)
        est = resample_poly(est, fs_stoi // g, fs // g)
        ref = resample_poly(ref, fs_stoi // g, fs // g)

    def frames(x):
        m = 1 + max(0, (len(x) - win) // hop)
        idx = np.arange(win)[None, :] + hop * np.arange(m)[:, None]
        return x[idx] * np.hanning(win)[None, :]

    xf, yf = frames(ref), frames(est)
    if len(xf) < seg_n:
        raise ValueError(f"stoi needs >= {seg_n * hop + win} samples at "
                         f"{fs_stoi} Hz after resampling, got {len(ref)}")
    # Keep frames within 40 dB of the loudest CLEAN frame, in both signals.
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-12)
    keep = e > (e.max() - 40.0)
    xf, yf = xf[keep], yf[keep]
    if len(xf) < seg_n:
        raise ValueError("stoi: fewer than one 384 ms segment of active "
                         "speech after silent-frame removal")

    bands = _third_octave_bands(fs_stoi, nfft, n_bands, f_min)
    xb = np.sqrt(bands @ (np.abs(np.fft.rfft(xf, nfft, axis=1)) ** 2).T)
    yb = np.sqrt(bands @ (np.abs(np.fft.rfft(yf, nfft, axis=1)) ** 2).T)

    # Segments of seg_n frames; per band: scale the degraded envelope to the
    # clean energy, clip at -beta dB SDR, correlate.
    corrs = []
    for m in range(seg_n, xb.shape[1] + 1):
        x_seg = xb[:, m - seg_n:m]
        y_seg = yb[:, m - seg_n:m]
        scale = (np.linalg.norm(x_seg, axis=1, keepdims=True)
                 / (np.linalg.norm(y_seg, axis=1, keepdims=True) + 1e-12))
        y_prime = np.minimum(y_seg * scale,
                             x_seg * (1.0 + 10.0 ** (-beta / 20.0)))
        x_c = x_seg - x_seg.mean(axis=1, keepdims=True)
        y_c = y_prime - y_prime.mean(axis=1, keepdims=True)
        denom = (np.linalg.norm(x_c, axis=1) * np.linalg.norm(y_c, axis=1)
                 + 1e-12)
        corrs.append(np.sum(x_c * y_c, axis=1) / denom)
    return float(np.mean(corrs))


def evaluate_si_snr(cfg: Config, noisy_manifest: str, clean_manifest: str,
                    enhancer: Enhancer | None = None,
                    streamed_manifest: str | None = None) -> dict:
    """Mean SI-SNR and STOI of noisy (and optionally enhanced, or pre-written
    ``streamed_manifest``) wavs vs their paired clean references.  The
    enhancer runs the whole enhance path (STFT -> enhancer -> ISTFT) on its
    device, one utterance at a time, padded to whole seconds."""
    from aas_enhancement_tpu_torch.enhance import make_enhance_fn

    noisy = read_manifest(noisy_manifest)
    clean = read_manifest(clean_manifest)
    if len(noisy) != len(clean):
        raise ValueError("SI-SNR needs paired manifests of equal length")
    streamed = read_manifest(streamed_manifest) if streamed_manifest else None
    if streamed is not None and len(streamed) != len(noisy):
        raise ValueError(
            f"streamed manifest has {len(streamed)} rows, expected "
            f"{len(noisy)} — zip would silently truncate all metrics")
    enh_fn = None
    if enhancer is not None:
        enh_fn = make_enhance_fn(cfg, next(enhancer.parameters()).device)

    sr = cfg.audio.sample_rate
    src = {"noisy": [], "enhanced": [], "streamed": []}
    sto = {"noisy": [], "enhanced": [], "streamed": []}

    def add(kind, wav, clean_wav):
        src[kind].append(si_snr(wav, clean_wav))
        try:
            sto[kind].append(stoi(wav, clean_wav, fs=sr))
        except ValueError:
            pass  # too little active speech for one 384 ms STOI segment

    for i, ((npath, _), (cpath, _)) in enumerate(zip(noisy, clean)):
        nw, _ = read_wav(npath)
        cw, _ = read_wav(cpath)
        add("noisy", nw, cw)
        if enh_fn is not None:
            bucket = max(sr, ((len(nw) + sr - 1) // sr) * sr)
            padded = np.zeros(bucket, np.float32)
            padded[: len(nw)] = nw
            ew = enh_fn(enhancer, torch.from_numpy(padded)[None],
                        torch.tensor([len(nw)]))[0, : len(nw)].cpu().numpy()
            add("enhanced", ew, cw)
        if streamed is not None:
            sw, _ = read_wav(streamed[i][0])
            add("streamed", sw, cw)

    out = {f"si_snr_{k}": float(np.mean(v)) for k, v in src.items() if v}
    out.update({f"stoi_{k}": float(np.mean(v)) for k, v in sto.items() if v})
    if "si_snr_enhanced" in out:
        out["si_snr_improvement"] = out["si_snr_enhanced"] - out["si_snr_noisy"]
    return out
