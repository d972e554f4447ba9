"""LM-fusion weight tuning: grid search of alpha / beta on a dev split (port
of ``aas_enhancement_tpu/decode/tune.py``).

The AM (and optional enhancer) forward runs ONCE over the dev set, on the
models' device; every (alpha, beta) cell then re-decodes the cached
log-probs with the host beam decoder (``decode/beam.py``), so a 5x4 grid
costs one forward pass and 20 host decodes.
"""

from __future__ import annotations

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.decode.beam import beam_decode
from aas_enhancement_tpu_torch.decode.wer import corpus_wer
from aas_enhancement_tpu_torch.labels import decode_ids


def cache_log_probs(cfg: Config, am, manifest, enhancer=None, batch_size: int = 8):
    """-> (refs, [per-utterance [T_i, V] log-prob arrays]) for a manifest:
    the recognition forward and the log-softmax on the models' device."""
    from aas_enhancement_tpu_torch.evaluation import eval_dataset, make_eval_forward

    ds = eval_dataset(cfg, manifest)
    forward = make_eval_forward(cfg, use_enhancer=enhancer is not None)
    device = next(am.parameters()).device
    refs, lps = [], []
    for batch in ds.batches(batch_size, seed=0, epoch=0):
        logits, pads = forward(am, enhancer, torch.from_numpy(batch.wav).to(device),
                               torch.from_numpy(batch.wav_lengths).to(device))
        log_probs = torch.log_softmax(logits, dim=-1).cpu().numpy()
        lens = (pads < 0.5).sum(1).cpu().numpy().astype(np.int32)
        k = batch.size                       # drop repeat-padded rows
        for i in range(k):
            lps.append(log_probs[i, : int(lens[i])])
        for row, pad_row in zip(batch.labels[:k], batch.label_paddings[:k]):
            n = int(np.sum(pad_row < 0.5))
            refs.append(decode_ids(row[:n]))
    return refs, lps


def wer_at(refs, lps, lm, alpha: float, beta: float,
           beam_width: int = 16) -> float:
    hyps = [beam_decode(lp[None], None, beam_width=beam_width, lm=lm,
                        lm_alpha=alpha, lm_beta=beta)[0] for lp in lps]
    return corpus_wer(refs, hyps)


def edge_refine(eval_fn, a0: float, b0: float, w0: float, alphas, betas,
                grid=None, a_key: str = "alpha", b_key: str = "beta",
                max_evals: int = 12):
    """Bounded outward hill-climb for grid-EDGE optima.

    Fixed default grids can clip the true optimum (the JAX package's
    evaluations found a live hybrid's optimum past alpha 1.5 and beta 1.0).
    Instead of hardcoding ever-wider grids, this refines past any boundary
    the coarse search lands on: while the best point sits on the current search
    extremum of an axis, evaluate one more step outward (step = that
    axis's outermost grid spacing); alternating axis extensions reach
    diagonal escapes.  Stops at the first non-improving round or after
    `max_evals` extra decodes.

    -> (best_a, best_b, best_wer); appends evaluated cells to `grid`.
    """
    alphas = sorted(alphas)
    betas = sorted(betas)
    a_hi = alphas[-1]                        # original grid boundaries (fixed)
    b_hi, b_lo = betas[-1], betas[0]
    a_step = alphas[-1] - alphas[-2] if len(alphas) > 1 else 0.5
    b_step = betas[-1] - betas[-2] if len(betas) > 1 else 0.5
    best = (a0, b0, w0)
    seen = set()
    evals = 0
    while evals < max_evals:
        a, b, _ = best
        # Outward steps from the current best along each axis — only in
        # directions that leave the ORIGINAL grid (interior moves were
        # already covered by the coarse search).
        cands = [(ca, cb) for ca, cb in
                 ((round(a + a_step, 6), b),
                  (a, round(b + b_step, 6)),
                  (a, round(b - b_step, 6)))
                 if (ca > a_hi + 1e-9 or cb > b_hi + 1e-9
                     or cb < b_lo - 1e-9) and (ca, cb) not in seen]
        if not cands:
            break
        improved = False
        for ca, cb in cands:
            if evals >= max_evals:
                break
            w = eval_fn(ca, cb)
            evals += 1
            seen.add((ca, cb))
            if grid is not None:
                grid.append({a_key: ca, b_key: cb, "wer": w})
            if w < best[2]:
                best = (ca, cb, w)
                improved = True
        if not improved:
            break
    return best


def grid_search_lm(cfg: Config, am, dev_manifest, lm,
                   alphas=(0.0, 0.3, 0.6, 1.0, 1.5),
                   betas=(-0.5, 0.0, 0.5, 1.0),
                   enhancer=None, batch_size: int = 8,
                   beam_width: int = 16) -> dict:
    """-> {"alpha": best, "beta": best, "wer": best, "wer_no_lm": alpha=0 WER,
           "grid": [{alpha, beta, wer}, ...]}.

    alpha=0 rows collapse to one cell (beta multiplies nothing the ranking
    cares about without an LM; it is still a per-word bonus, so keep beta=0)."""
    refs, lps = cache_log_probs(cfg, am, dev_manifest, enhancer=enhancer,
                                batch_size=batch_size)
    grid = []
    wer_no_lm = wer_at(refs, lps, None, 0.0, 0.0, beam_width)
    grid.append({"alpha": 0.0, "beta": 0.0, "wer": wer_no_lm})
    best = (0.0, 0.0, wer_no_lm)
    for a in alphas:
        if a == 0.0:
            continue
        for b in betas:
            w = wer_at(refs, lps, lm, a, b, beam_width)
            grid.append({"alpha": a, "beta": b, "wer": w})
            if w < best[2]:
                best = (a, b, w)
    if best[0] > 0.0:
        best = edge_refine(
            lambda a, b: wer_at(refs, lps, lm, a, b, beam_width),
            *best, alphas, betas, grid=grid)
    return {"alpha": best[0], "beta": best[1], "wer": best[2],
            "wer_no_lm": wer_no_lm, "grid": grid,
            "utterances": len(refs)}


def wer_at_hybrid(refs, lps, char_lm, ca: float, cb: float, word_lm,
                  wa: float, wb: float, beam_width: int = 16) -> float:
    hyps = [beam_decode(lp[None], None, beam_width=beam_width, lm=char_lm,
                        lm_alpha=ca, lm_beta=cb, word_lm=word_lm,
                        word_alpha=wa, word_beta=wb)[0] for lp in lps]
    return corpus_wer(refs, hyps)


def grid_search_hybrid(cfg: Config, am, dev_manifest, char_lm, word_lm,
                       alphas=(0.0, 0.3, 0.6, 1.0, 1.5),
                       betas=(-0.5, 0.0, 0.5, 1.0),
                       word_alphas=(0.0, 0.3, 0.6, 1.0),
                       word_betas=(0.0, 0.5, 1.0),
                       enhancer=None, batch_size: int = 8,
                       beam_width: int = 16) -> dict:
    """Tune HYBRID char+word fusion by coordinate descent on a dev split:
    first the char grid alone (exactly grid_search_lm's search), then the
    word grid with the char point held fixed.  word_alpha=0 is in the grid,
    so the hybrid point never dev-scores worse than char-only.

    -> {"alpha","beta" (char), "word_alpha","word_beta", "wer",
        "wer_char_only", "wer_no_lm", "grid": [...]} — one AM(+G) forward
    total; every cell is a host re-decode of the cached log-probs."""
    refs, lps = cache_log_probs(cfg, am, dev_manifest, enhancer=enhancer,
                                batch_size=batch_size)
    grid = []
    wer_no_lm = wer_at(refs, lps, None, 0.0, 0.0, beam_width)
    grid.append({"alpha": 0.0, "beta": 0.0, "wer": wer_no_lm})
    best_c = (0.0, 0.0, wer_no_lm)
    for a in alphas:
        if a == 0.0:
            continue
        for b in betas:
            w = wer_at(refs, lps, char_lm, a, b, beam_width)
            grid.append({"alpha": a, "beta": b, "wer": w})
            if w < best_c[2]:
                best_c = (a, b, w)
    if best_c[0] > 0.0:
        best_c = edge_refine(
            lambda a, b: wer_at(refs, lps, char_lm, a, b, beam_width),
            *best_c, alphas, betas, grid=grid)
    ca, cb, wer_char = best_c
    best = (0.0, 0.0, wer_char)
    for wa in word_alphas:
        if wa == 0.0:
            continue
        for wb in word_betas:
            w = wer_at_hybrid(refs, lps, char_lm, ca, cb, word_lm, wa, wb,
                              beam_width)
            grid.append({"alpha": ca, "beta": cb, "word_alpha": wa,
                         "word_beta": wb, "wer": w})
            if w < best[2]:
                best = (wa, wb, w)
    if best[0] > 0.0:
        best = edge_refine(
            lambda wa, wb: wer_at_hybrid(refs, lps, char_lm, ca, cb,
                                         word_lm, wa, wb, beam_width),
            *best, word_alphas, word_betas, grid=grid,
            a_key="word_alpha", b_key="word_beta")
    return {"alpha": ca, "beta": cb, "word_alpha": best[0],
            "word_beta": best[1], "wer": best[2], "wer_char_only": wer_char,
            "wer_no_lm": wer_no_lm, "grid": grid, "utterances": len(refs)}
