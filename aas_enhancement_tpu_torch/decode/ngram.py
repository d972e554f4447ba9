"""Sparse n-gram word-LM store, the word-LM fusion contract (copy of
``aas_enhancement_tpu/decode/ngram.py``, held to it by
``tests/test_torch_lm.py``).

Word LMs of any order over real (5k-50k word) vocabularies are stored as
KenLM stores them in spirit: per-order sorted arrays of 64-bit hashed n-gram
keys with (logp, backoff) payloads, looked up by binary search.  Memory is O(#n-grams) — a
5k-word trigram LM with 1M n-grams is ~16 MB instead of the dense table's
100 MB (50k words: ~10 GB dense, unchanged ~16 MB sparse).

SHARED CONTRACT with native/ctc_beam/ctc_beam.cc (the C++ decoder) and
decode/beam.py's python fallback — all three implement identical hashing,
lookup, and ARPA-backoff arithmetic.  Parity level: decoded ids are EXACT;
beam scores agree to float32 rounding (the per-word LM score itself is
computed in float64 on both sides, but the C++ beam accumulates total beam
scores in float32 while the python fallback accumulates in float64 —
tests/test_ngram.py and test_beam.py assert ids exact, scores to ~1e-5):

Key hashing (splitmix64 chain; both sides implement it identically):
    h = 0
    for id in ngram_ids:  h = mix64(h XOR uint64(id + 1))
`mix64` is the splitmix64 finalizer.  The +1 shift keeps the "invalid id"
sentinel -1 (an out-of-vocabulary context word in a model without <unk>)
hashing as XOR with 0 — stored keys only ever contain valid ids, so lookups
containing invalid ids miss naturally.  Collisions: within-table collisions
are DETECTED at build time (build_export raises); query-side false positives
have probability ~(#ngrams)/2^64 per lookup — negligible, and identical on
both sides of the parity contract since both hash the same way.

Export dict fields (flat arrays handed to C++ via ctypes):
    order           int, the LM's n-gram order (>= 1)
    space_id        char id of the word delimiter
    n_words         number of EMITTABLE lexicon words (charset-expressible)
    word_hash       uint64[n_words], SORTED — hash of each word's char-id
                    sequence (the beam's trailing-segment lookup key)
    word_lm_id      int32[n_words], aligned with word_hash — the word's LM
                    vocabulary id
    vlm             LM vocabulary size (ALL unigrams incl. specials and
                    non-emittable context words)
    uni_logp        float32[vlm]   log P(w), natural log
    uni_backoff     float32[vlm]   unigram backoff weights (ln)
    ngram_keys      uint64, orders 2..k concatenated, sorted within an order
    ngram_logp      float32, aligned
    ngram_backoff   float32, aligned (highest order slice is all zeros)
    ngram_counts    int64[k-1], entries per order 2..k
    bos_id          LM id of <s>, or -1
    unk_id          LM id of <unk>, or -1
    floor_logp      score of a word absent even as a unigram when the model
                    has no <unk> (float, ln)

Scoring (standard ARPA backoff, shared by `score_export` here and
`ScoreNgram` in the C++ decoder — accumulate in float64/double):
    P(w | c_1..c_m):  explicit (c_1..c_m, w) logp if present,
                      else bo(c_1..c_m) + P(w | c_2..c_m)
    bo(ctx) = the ctx n-gram's backoff field if present, else 0
    P(w) at order 1 = uni_logp[w]; w invalid (-1) = floor_logp
OOV words map to unk_id (or -1 when the model has no <unk>) BEFORE scoring;
OOV context words likewise.  The sentence-initial context slot is bos_id.
"""

from __future__ import annotations

import numpy as np

# kMaxOrder in native/ctc_beam/ctc_beam.cc: the C++ decoder's bound on
# stack-allocated context buffers.  build_export enforces it so an
# out-of-range ARPA order fails loudly at build time instead of silently
# demoting every decode to the python fallback.
NATIVE_MAX_ORDER = 8

_M64 = (1 << 64) - 1
_C1 = 0x9E3779B97F4A7C15
_C2 = 0xBF58476D1CE4E5B9
_C3 = 0x94D049BB133111EB


def mix64(x: int) -> int:
    """splitmix64 finalizer on a python int (wrapping at 64 bits)."""
    z = (x + _C1) & _M64
    z = ((z ^ (z >> 30)) * _C2) & _M64
    z = ((z ^ (z >> 27)) * _C3) & _M64
    return z ^ (z >> 31)


def hash_ids(ids) -> int:
    """The contract's chained hash of an id sequence (python ints)."""
    h = 0
    for i in ids:
        h = mix64(h ^ ((int(i) + 1) & _M64))
    return h


def hash_ids_batch(id_matrix: np.ndarray) -> np.ndarray:
    """Vectorized hash_ids over the rows of an int64 [N, n] matrix."""
    m = np.asarray(id_matrix, np.int64)
    if m.ndim != 2:
        raise ValueError("id_matrix must be [N, n]")
    with np.errstate(over="ignore"):
        h = np.zeros(m.shape[0], np.uint64)
        one = np.uint64(1)
        c1, c2, c3 = np.uint64(_C1), np.uint64(_C2), np.uint64(_C3)
        s30, s27, s31 = np.uint64(30), np.uint64(27), np.uint64(31)
        for col in range(m.shape[1]):
            z = (h ^ ((m[:, col].astype(np.uint64) + one))) + c1
            z = (z ^ (z >> s30)) * c2
            z = (z ^ (z >> s27)) * c3
            h = z ^ (z >> s31)
    return h


def build_export(order: int, vocab: list[str], uni_logp, uni_backoff,
                 ngrams: list[dict], labels: str, space_id: int,
                 bos: str = "<s>", unk: str = "<unk>",
                 floor_logp: float = -30.0,
                 specials: tuple = ("<s>", "</s>", "<unk>")) -> dict:
    """Assemble the shared native export dict.

    vocab        LM vocabulary strings (defines lm ids by position)
    uni_logp     [vlm] natural-log unigram probs (floats)
    uni_backoff  [vlm] natural-log unigram backoff weights
    ngrams       per order n = 2..order: {tuple_of_lm_ids: (logp, backoff)}
    labels       the CTC charset (emittable-word filter + char ids)
    """
    if order < 1:
        raise ValueError("order must be >= 1")
    if order > NATIVE_MAX_ORDER:
        # kMaxOrder in native/ctc_beam/ctc_beam.cc bounds the C++ decoder's
        # stack context buffers; beyond it InitWordLm rejects the model and
        # decode would silently drop to the 7-13x slower python path.  ARPA
        # models of order > 8 do not exist in practice — fail loudly instead.
        raise ValueError(
            f"order {order} exceeds the native decoder's maximum "
            f"({NATIVE_MAX_ORDER}, kMaxOrder in native/ctc_beam/ctc_beam.cc)")
    if len(ngrams) != max(order - 1, 0):
        raise ValueError(f"expected {order - 1} n-gram levels, got "
                         f"{len(ngrams)}")
    vlm = len(vocab)
    wid = {w: i for i, w in enumerate(vocab)}
    char_to_id = {c: i for i, c in enumerate(labels)}

    # Emittable lexicon: charset-expressible, non-special vocabulary words.
    words = sorted(w for w in vocab
                   if w and w not in specials
                   and all(c in char_to_id for c in w))
    if not words:
        raise ValueError("LM has no words expressible in the label charset "
                         f"{labels!r}")
    seqs = [tuple(char_to_id[c] for c in w) for w in words]
    whash = np.fromiter((hash_ids(s) for s in seqs), np.uint64, len(seqs))
    if len(np.unique(whash)) != len(whash):
        raise ValueError("64-bit word-hash collision in the lexicon "
                         "(astronomically unlikely; change the corpus)")
    perm = np.argsort(whash)
    word_hash = whash[perm]
    word_lm_id = np.asarray([wid[words[i]] for i in perm], np.int32)

    keys_parts, logp_parts, bo_parts, counts = [], [], [], []
    for n in range(2, order + 1):
        level = ngrams[n - 2]
        if level:
            mat = np.asarray(list(level.keys()), np.int64).reshape(-1, n)
            k = hash_ids_batch(mat)
            if len(np.unique(k)) != len(k):
                raise ValueError(f"64-bit key collision among {n}-grams "
                                 "(astronomically unlikely)")
            vals = list(level.values())
            lp = np.asarray([v[0] for v in vals], np.float32)
            bo = np.asarray([v[1] for v in vals], np.float32)
            p = np.argsort(k)
            keys_parts.append(k[p])
            logp_parts.append(lp[p])
            bo_parts.append(bo[p])
            counts.append(len(k))
        else:
            keys_parts.append(np.empty(0, np.uint64))
            logp_parts.append(np.empty(0, np.float32))
            bo_parts.append(np.empty(0, np.float32))
            counts.append(0)

    return {
        "kind": "sparse",
        "order": int(order),
        "space_id": int(space_id),
        "n_words": len(words),
        "word_hash": word_hash,
        "word_lm_id": word_lm_id,
        "vlm": vlm,
        "uni_logp": np.asarray(uni_logp, np.float32),
        "uni_backoff": np.asarray(uni_backoff, np.float32),
        "ngram_keys": (np.concatenate(keys_parts) if keys_parts
                       else np.empty(0, np.uint64)),
        "ngram_logp": (np.concatenate(logp_parts) if logp_parts
                       else np.empty(0, np.float32)),
        "ngram_backoff": (np.concatenate(bo_parts) if bo_parts
                          else np.empty(0, np.float32)),
        "ngram_counts": np.asarray(counts, np.int64),
        "bos_id": int(wid.get(bos, -1)),
        "unk_id": int(wid.get(unk, -1)),
        "floor_logp": float(floor_logp),
        # python-side helpers (not part of the C ABI):
        "words": words,
        "wid": wid,
        "id_to_lm": {s: wid[w] for s, w in zip(seqs, words)},
    }


def _level_slice(ex: dict, n: int) -> tuple[int, int]:
    """[start, end) of order-n entries (n >= 2) in the concatenated arrays."""
    counts = ex["ngram_counts"]
    start = int(np.sum(counts[: n - 2]))
    return start, start + int(counts[n - 2])


def _find_ngram(ex: dict, ids: tuple) -> int:
    """Index of the n-gram `ids` (lm ids) in the concatenated arrays, or -1."""
    n = len(ids)
    start, end = _level_slice(ex, n)
    if start == end:
        return -1
    key = np.uint64(hash_ids(ids))
    keys = ex["ngram_keys"]
    i = start + int(np.searchsorted(keys[start:end], key))
    if i < end and keys[i] == key:
        return i
    return -1


def score_export(ex: dict, ctx, w_id: int) -> float:
    """log P(w | ctx) through the export arrays (the parity-scoring path).

    ctx: LM ids, OLDEST first, length <= order-1 (longer is trimmed); entries
    may be -1 (unmappable context word in a model without <unk>).
    w_id: LM id, or -1 for an OOV word in a model without <unk>.
    Accumulates in float64 — the C++ scorer uses double identically.
    """
    m = min(len(ctx), ex["order"] - 1)
    ctx = tuple(int(c) for c in ctx[len(ctx) - m:])
    bo = 0.0
    for k in range(m, 0, -1):
        sub = ctx[m - k:]
        if w_id >= 0 and all(c >= 0 for c in sub):
            i = _find_ngram(ex, sub + (int(w_id),))
            if i >= 0:
                return bo + float(ex["ngram_logp"][i])
        # No explicit (sub, w): charge sub's backoff weight and shorten.
        if k == 1:
            if sub[0] >= 0:
                bo += float(ex["uni_backoff"][sub[0]])
        elif all(c >= 0 for c in sub):
            j = _find_ngram(ex, sub)
            if j >= 0:
                bo += float(ex["ngram_backoff"][j])
    if w_id >= 0:
        return bo + float(ex["uni_logp"][int(w_id)])
    return bo + ex["floor_logp"]


def lookup_word(ex: dict, char_ids: tuple) -> int:
    """Trailing-segment lookup: char-id tuple -> LM id, or the model's OOV id
    (unk_id, possibly -1).  Python uses the exact dict; the C++ decoder binary-
    searches word_hash — same result up to 64-bit hash collisions (see module
    docstring)."""
    lm_id = ex["id_to_lm"].get(tuple(int(c) for c in char_ids))
    if lm_id is None:
        return ex["unk_id"]
    return lm_id


def export_nbytes(ex: dict) -> int:
    """Total bytes of the flat arrays."""
    return sum(int(ex[k].nbytes) for k in
               ("word_hash", "word_lm_id", "uni_logp", "uni_backoff",
                "ngram_keys", "ngram_logp", "ngram_backoff", "ngram_counts"))
