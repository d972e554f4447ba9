"""WER / CER via Levenshtein edit distance (copy of
``aas_enhancement_tpu/decode/wer.py``)."""

from __future__ import annotations

import numpy as np


def edit_distance(a: list, b: list) -> int:
    """Levenshtein distance between two sequences (O(len(a)*len(b)) DP)."""
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[-1]


def wer(ref: str, hyp: str) -> float:
    """Word error rate of hyp against ref."""
    ref_words = ref.split()
    if not ref_words:
        return 0.0 if not hyp.split() else 1.0
    return edit_distance(ref_words, hyp.split()) / len(ref_words)


def cer(ref: str, hyp: str) -> float:
    if not ref:
        return 0.0 if not hyp else 1.0
    return edit_distance(list(ref), list(hyp)) / len(ref)


def corpus_wer(refs: list[str], hyps: list[str]) -> float:
    """Corpus-level WER: total word edits / total ref words."""
    edits, words = 0, 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(r.split(), h.split())
        words += len(r.split())
    return edits / max(words, 1)


def corpus_wer_ci(refs: list[str], hyps: list[str], n_boot: int = 2000,
                  confidence: float = 0.95, seed: int = 0
                  ) -> tuple[float, float, float]:
    """-> (wer, ci_low, ci_high): utterance-level bootstrap percentile CI,
    deterministic in ``seed``."""
    per = np.array([[edit_distance(r.split(), h.split()), len(r.split())]
                    for r, h in zip(refs, hyps)], np.float64)
    if not len(per):
        return 0.0, 0.0, 0.0
    point = per[:, 0].sum() / max(per[:, 1].sum(), 1.0)
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(per), size=(n_boot, len(per)))
    edits = per[idx, 0].sum(axis=1)
    words = np.maximum(per[idx, 1].sum(axis=1), 1.0)
    lo, hi = np.quantile(edits / words,
                         [(1 - confidence) / 2, 1 - (1 - confidence) / 2])
    return float(point), float(lo), float(hi)
