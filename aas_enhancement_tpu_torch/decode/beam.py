"""CTC prefix beam search on the host: ctypes binding to the native C++
decoder and its pure-Python reference (port of
``aas_enhancement_tpu/decode/beam.py``).

The native decoder is ``native/ctc_beam/ctc_beam.cc`` (a copy of the JAX
package's), built by ``utils/native_build.py::build`` (or ``build()`` here);
loading never compiles.  Without the library, or with one that reports
another ABI version, the decoders log one warning and run
``beam_search_python``, the same prefix beam search (and the correctness
oracle of the tests).  ``beam_decode.route`` records the path the last call
took: ``"native"`` or ``"python"``.  LM fusion: a char n-gram's dense table
per symbol, a word n-gram (``decode/ngram.py``'s sparse store) per completed
word, or both (hybrid).
"""

from __future__ import annotations

import ctypes
import logging
import math
import os
from collections import defaultdict

import numpy as np

from aas_enhancement_tpu_torch.labels import BLANK_ID, LABELS
from aas_enhancement_tpu_torch.utils import native_build

_log = logging.getLogger(__name__)

_lib = None
_lib_tried = False

# Must equal kAbiVersion in native/ctc_beam/ctc_beam.cc.  _load_lib refuses
# any library reporting a different version (or none at all): binding the
# current argtypes to an .so built from older source would pass the new
# argument layout to old code — silently corrupt decodes or a crash.
_ABI_VERSION = 5


def build(timeout: float = 120.0) -> bool:
    """Build the native libraries; -> whether the decoder loads now."""
    global _lib, _lib_tried
    native_build.build(timeout)
    _lib, _lib_tried = None, False        # a fresh load attempt
    return available()


def available() -> bool:
    return _load_lib() is not None


def _load_lib():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    path = native_build.lib_path("libctcbeam.so")
    if not os.path.exists(path):
        # A warning: the Python decoder is several times slower.
        _log.warning("native beam decoder not built (%s missing): using the "
                     "Python decoder; utils/native_build.py::build() builds it", path)
        return None
    try:
        lib = ctypes.CDLL(path)
        try:
            lib.ctc_beam_abi_version.restype = ctypes.c_int
            abi = int(lib.ctc_beam_abi_version())
        except AttributeError:
            abi = -1  # a library without the version entry point
        if abi != _ABI_VERSION:
            _log.warning(
                "native beam decoder %s reports ABI version %d, this code "
                "needs %d: refusing it (its entry points may take other "
                "arguments); using the Python decoder", path, abi, _ABI_VERSION)
            _lib = None
            return None
        lib.ctc_beam_search.restype = ctypes.c_int
        lib.ctc_beam_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ctc_beam_search_lm.restype = ctypes.c_int
        lib.ctc_beam_search_lm.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        # Sparse word-LM arg block (decode/ngram.py shared contract): the
        # same 15 parameters appear in the wlm and hybrid entry points.
        wlm_args = [
            ctypes.c_int,                                   # space_id
            ctypes.POINTER(ctypes.c_uint64),                # word_hash
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,     # word_lm_id, n
            ctypes.c_int, ctypes.c_int,                     # order, vlm
            ctypes.POINTER(ctypes.c_float),                 # uni_logp
            ctypes.POINTER(ctypes.c_float),                 # uni_backoff
            ctypes.POINTER(ctypes.c_uint64),                # ngram_keys
            ctypes.POINTER(ctypes.c_float),                 # ngram_logp
            ctypes.POINTER(ctypes.c_float),                 # ngram_backoff
            ctypes.POINTER(ctypes.c_int64),                 # ngram_counts
            ctypes.c_int, ctypes.c_int,                     # bos_id, unk_id
            ctypes.c_float,                                 # floor_logp
        ]
        lib.ctc_beam_search_wlm.restype = ctypes.c_int
        lib.ctc_beam_search_wlm.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            *wlm_args,
            ctypes.c_float, ctypes.c_float,                 # alpha, beta
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.ctc_beam_search_hybrid.restype = ctypes.c_int
        lib.ctc_beam_search_hybrid.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,   # char table, order
            ctypes.c_float, ctypes.c_float,                 # char alpha, beta
            *wlm_args,
            ctypes.c_float, ctypes.c_float,                 # word alpha, beta
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
        ]
        try:  # the thread-parallel batch entry point
            lib.ctc_beam_search_batch.restype = ctypes.c_int
            lib.ctc_beam_search_batch.argtypes = [
                ctypes.POINTER(ctypes.c_float),             # [b, t_max, v]
                ctypes.POINTER(ctypes.c_int),               # lens [b]
                ctypes.c_int, ctypes.c_int, ctypes.c_int,   # b, t_max, v
                ctypes.c_int, ctypes.c_int, ctypes.c_int,   # beam, blank, k
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,  # char table
                ctypes.c_float, ctypes.c_float,             # char alpha, beta
                ctypes.c_int,                               # use_wlm
                *wlm_args,
                ctypes.c_float, ctypes.c_float,             # word alpha, beta
                ctypes.c_int,                               # n_threads
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,  # out_ids, max_out
                ctypes.POINTER(ctypes.c_int),               # out_lens [b]
                ctypes.POINTER(ctypes.c_float),             # out_scores [b]
            ]
        except AttributeError:
            pass
        _lib = lib
    except (OSError, AttributeError) as e:
        _log.warning("native beam decoder %s did not load (%s): using the Python "
                     "decoder", path, e)
        _lib = None
    return _lib


def _wlm_native_args(ex: dict):
    """Flatten a sparse export (decode/ngram.py) into the shared 15-parameter
    C arg block.  Returns (args_tuple, keepalive_list) — the caller must hold
    the keepalive until the native call returns."""
    wh = np.ascontiguousarray(ex["word_hash"], np.uint64)
    wl = np.ascontiguousarray(ex["word_lm_id"], np.int32)
    ul = np.ascontiguousarray(ex["uni_logp"], np.float32)
    ub = np.ascontiguousarray(ex["uni_backoff"], np.float32)
    nk = np.ascontiguousarray(ex["ngram_keys"], np.uint64)
    nl = np.ascontiguousarray(ex["ngram_logp"], np.float32)
    nb = np.ascontiguousarray(ex["ngram_backoff"], np.float32)
    nc = np.ascontiguousarray(ex["ngram_counts"], np.int64)
    if nc.size == 0:                      # order-1 model: C++ still reads the
        nc = np.zeros(1, np.int64)        # counts pointer defensively
    args = (
        int(ex["space_id"]),
        wh.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        wl.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), int(ex["n_words"]),
        int(ex["order"]), int(ex["vlm"]),
        ul.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ub.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nl.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(ex["bos_id"]), int(ex["unk_id"]), float(ex["floor_logp"]),
    )
    return args, [wh, wl, ul, ub, nk, nl, nb, nc]


def beam_search_native(log_probs: np.ndarray, beam_width: int = 32,
                       blank: int = BLANK_ID, prune_k: int = 16,
                       lm_table: np.ndarray | None = None, lm_order: int = 0,
                       lm_alpha: float = 0.0, lm_beta: float = 0.0,
                       word_ex: dict | None = None,
                       word_alpha: float = 0.0, word_beta: float = 0.0):
    """[T, V] log-probs -> (ids list, score) via the C++ decoder, or None.

    lm_table+word_ex together run HYBRID fusion (char per symbol + word per
    completed word, separate weights); word_ex alone takes its weights from
    lm_alpha/lm_beta (back-compat single-LM interface)."""
    lib = _load_lib()
    if lib is None:
        return None
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    t, v = lp.shape
    max_out = t + 1
    out = np.zeros(max_out, np.int32)
    score = ctypes.c_float(0.0)
    if word_ex is not None and lm_table is not None:
        wargs, keep = _wlm_native_args(word_ex)
        ctable = np.ascontiguousarray(lm_table, dtype=np.float32)
        if ctable.size != v ** lm_order:
            raise ValueError(f"LM table has {ctable.size} entries, expected "
                             f"{v}^{lm_order} for vocab {v}")
        n = lib.ctc_beam_search_hybrid(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v,
            beam_width, blank, prune_k,
            ctable.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lm_order,
            lm_alpha, lm_beta, *wargs, word_alpha, word_beta,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
            ctypes.byref(score))
        del keep
    elif word_ex is not None:
        if word_alpha == 0.0 and lm_alpha != 0.0:   # back-compat single-LM
            word_alpha, word_beta = lm_alpha, lm_beta
        wargs, keep = _wlm_native_args(word_ex)
        n = lib.ctc_beam_search_wlm(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v,
            beam_width, blank, prune_k, *wargs, word_alpha, word_beta,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
            ctypes.byref(score))
        del keep
    elif lm_table is not None:
        table = np.ascontiguousarray(lm_table, dtype=np.float32)
        if table.size != v ** lm_order:
            raise ValueError(f"LM table has {table.size} entries, expected "
                             f"{v}^{lm_order} for vocab {v}")
        n = lib.ctc_beam_search_lm(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v,
            beam_width, blank, prune_k,
            table.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lm_order,
            lm_alpha, lm_beta,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
            ctypes.byref(score))
    else:
        n = lib.ctc_beam_search(
            lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), t, v,
            beam_width, blank, prune_k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
            ctypes.byref(score))
    if n < 0:
        return None
    return list(out[:n]), float(score.value)


def _dummy_wlm_args():
    """Placeholder 15-parameter word-LM block for use_wlm=0 batch calls
    (the C++ side never dereferences it)."""
    z64 = np.zeros(1, np.uint64)
    zi = np.zeros(1, np.int32)
    zf = np.zeros(1, np.float32)
    zc = np.zeros(1, np.int64)
    args = (0,
            z64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            zi.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), 1,
            1, 1,
            zf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            zf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            z64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            zf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            zf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            zc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            -1, -1, 0.0)
    return args, [z64, zi, zf, zc]


def beam_search_native_batch(log_probs: np.ndarray, lengths,
                             beam_width: int = 32, blank: int = BLANK_ID,
                             prune_k: int = 16,
                             lm_table: np.ndarray | None = None,
                             lm_order: int = 0, lm_alpha: float = 0.0,
                             lm_beta: float = 0.0,
                             word_ex: dict | None = None,
                             word_alpha: float = 0.0, word_beta: float = 0.0,
                             n_threads: int = 0):
    """[B, T, V] log-probs + [B] lengths -> list of (ids, score), or None.

    Thread-parallel over utterances in C++ (`ctc_beam_search_batch`);
    id-exact with per-utterance `beam_search_native` calls — the same
    decoder runs per row.  n_threads <= 0 uses the host's hardware
    concurrency."""
    lib = _load_lib()
    if lib is None or not hasattr(lib, "ctc_beam_search_batch"):
        return None
    lp = np.ascontiguousarray(log_probs, dtype=np.float32)
    if lp.ndim != 3:
        raise ValueError(f"batch decode needs [B, T, V], got {lp.shape}")
    b, t_max, v = lp.shape
    lens = np.ascontiguousarray(lengths, np.int32)
    if lens.shape != (b,):
        raise ValueError(f"lengths shape {lens.shape} != ({b},)")
    if word_ex is not None:
        if word_alpha == 0.0 and lm_table is None and lm_alpha != 0.0:
            word_alpha, word_beta = lm_alpha, lm_beta  # back-compat single-LM
        wargs, keep = _wlm_native_args(word_ex)
        use_wlm = 1
    else:
        wargs, keep = _dummy_wlm_args()
        use_wlm = 0
    if lm_table is not None:
        ctable = np.ascontiguousarray(lm_table, dtype=np.float32)
        if ctable.size != v ** lm_order:
            raise ValueError(f"LM table has {ctable.size} entries, expected "
                             f"{v}^{lm_order} for vocab {v}")
        keep.append(ctable)
        table_ptr = ctable.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        table_ptr, lm_order = None, 0
    max_out = t_max + 1
    out = np.zeros((b, max_out), np.int32)
    out_lens = np.full(b, -1, np.int32)
    out_scores = np.zeros(b, np.float32)
    rc = lib.ctc_beam_search_batch(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        b, t_max, v, beam_width, blank, prune_k,
        table_ptr, lm_order, lm_alpha, lm_beta,
        use_wlm, *wargs, word_alpha, word_beta, int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_out,
        out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out_scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    del keep
    if rc != 0:
        return None
    results = []
    for i in range(b):
        n = int(out_lens[i])
        if n < 0:
            return None
        results.append((list(out[i, :n]), float(out_scores[i])))
    return results


def _trailing_word_and_context(prefix, space: int, max_ctx: int):
    """Trailing (possibly empty) word of a prefix + up to `max_ctx` previous
    NON-EMPTY segments (runs of spaces collapse), oldest first, + whether the
    backward walk reached the prefix start with context slots to spare.
    Shared word-boundary contract with the native decoder (WordBonus)."""
    i = len(prefix) - 1
    while i >= 0 and prefix[i] != space:
        i -= 1
    word = tuple(prefix[i + 1:])
    segs = []                              # newest first
    end = i
    reached_start = i < 0
    while not reached_start and len(segs) < max_ctx:
        j = end - 1
        while j >= 0 and prefix[j] != space:
            j -= 1
        if end - 1 - j > 0:
            segs.append(tuple(prefix[j + 1: end]))
        if j < 0:
            reached_start = True
        end = j
    return word, segs[::-1], reached_start


def word_bonus(prefix, alpha: float, beta: float, ex: dict) -> float:
    """Fusion score for COMPLETING the trailing word of `prefix`
    (alpha * logp(word | up to order-1 previous words) + beta); 0 when the
    trailing segment is empty.  Scores through the sparse export's ARPA
    backoff (decode/ngram.py) — the same float64 per-word arithmetic the C++
    decoder runs (ids exact; total beam scores differ by float32 rounding,
    since the C++ beam accumulates in float).
    When the walk reaches the prefix start with context room left, the oldest
    slot becomes <s> (if the model has one)."""
    from aas_enhancement_tpu_torch.decode import ngram
    word, segs, reached_start = _trailing_word_and_context(
        prefix, ex["space_id"], ex["order"] - 1)
    if not word:
        return 0.0
    w = ngram.lookup_word(ex, word)
    ctx = [ngram.lookup_word(ex, s) for s in segs]
    if reached_start and len(ctx) < ex["order"] - 1 and ex["bos_id"] >= 0:
        ctx.insert(0, ex["bos_id"])
    return alpha * ngram.score_export(ex, ctx, w) + beta


def beam_search_python(log_probs: np.ndarray, beam_width: int = 32,
                       blank: int = BLANK_ID, prune_k: int = 16,
                       lm_table: np.ndarray | None = None, lm_order: int = 0,
                       lm_alpha: float = 0.0, lm_beta: float = 0.0,
                       word_ex: dict | None = None,
                       word_alpha: float = 0.0, word_beta: float = 0.0):
    """Pure-python prefix beam search (reference implementation / fallback).

    LM shallow fusion matches the native decoder exactly.  Char LM
    (lm_table): lm_alpha*lm[ctx, c] + lm_beta applies once per symbol
    appended.  Word LM (word_ex, from WordNGramLM.export_native):
    logp(word|prev) + bonus applies once per COMPLETED word — when a space is
    appended, and to the trailing word when ranking final beams (the
    KenLM-fusion contract); its weights are word_alpha/word_beta when BOTH
    LMs are active (hybrid fusion), or lm_alpha/lm_beta when the word LM is
    alone (back-compat single-LM interface)."""
    t, v = log_probs.shape
    beams: dict[tuple, list] = {(): [0.0, -math.inf]}  # prefix -> [p_b, p_nb]

    if word_ex is not None:
        space = word_ex["space_id"]
        if lm_table is None and word_alpha == 0.0 and lm_alpha != 0.0:
            word_alpha, word_beta = lm_alpha, lm_beta
    if lm_table is not None:
        from aas_enhancement_tpu_torch.decode.lm import context_index
        lm_table = np.asarray(lm_table, np.float32).reshape(-1, v)

    if word_ex is not None and lm_table is not None:
        def bonus(prefix, c):
            s = lm_alpha * float(
                lm_table[context_index(prefix, lm_order, v), c]) + lm_beta
            if c == space:
                s += word_bonus(prefix, word_alpha, word_beta, word_ex)
            return s
    elif word_ex is not None:
        def bonus(prefix, c):
            if c != space:
                return 0.0
            return word_bonus(prefix, word_alpha, word_beta, word_ex)
    elif lm_table is not None:
        def bonus(prefix, c):
            return lm_alpha * float(
                lm_table[context_index(prefix, lm_order, v), c]) + lm_beta
    else:
        def bonus(prefix, c):
            return 0.0

    def lse(a, b):
        if a == -math.inf:
            return b
        if b == -math.inf:
            return a
        m = max(a, b)
        return m + math.log(math.exp(a - m) + math.exp(b - m))

    for step in range(t):
        lp = log_probs[step]
        syms = np.argsort(-lp)[:prune_k] if 0 < prune_k < v else range(v)
        next_beams: dict[tuple, list] = defaultdict(lambda: [-math.inf, -math.inf])
        for prefix, (p_b, p_nb) in beams.items():
            total = lse(p_b, p_nb)
            nb = next_beams[prefix]
            nb[0] = lse(nb[0], total + float(lp[blank]))
            last = prefix[-1] if prefix else None
            for c in syms:
                c = int(c)
                if c == blank:
                    continue
                p = float(lp[c])
                if c == last:
                    nb2 = next_beams[prefix]
                    nb2[1] = lse(nb2[1], p_nb + p)
                    ext = next_beams[prefix + (c,)]
                    ext[1] = lse(ext[1], p_b + p + bonus(prefix, c))
                else:
                    ext = next_beams[prefix + (c,)]
                    ext[1] = lse(ext[1], total + p + bonus(prefix, c))
        ranked = sorted(next_beams.items(), key=lambda kv: -lse(kv[1][0], kv[1][1]))
        beams = dict(ranked[:beam_width])

    if word_ex is not None:
        # Final ranking includes the trailing (utterance-final) word's LM
        # score — otherwise the last word of every sentence escapes the LM.
        def final_score(kv):
            return (lse(kv[1][0], kv[1][1])
                    + word_bonus(kv[0], word_alpha, word_beta, word_ex))
        best, _ = max(beams.items(), key=final_score)
        return list(best), final_score((best, beams[best]))
    best, (p_b, p_nb) = max(beams.items(), key=lambda kv: lse(kv[1][0], kv[1][1]))
    return list(best), lse(p_b, p_nb)


def beam_decode(log_probs: np.ndarray, lengths: np.ndarray | None = None,
                beam_width: int = 32, labels: str = LABELS,
                prune_k: int = 16, lm=None, lm_alpha: float = 0.0,
                lm_beta: float = 0.0, word_lm=None,
                word_alpha: float = 0.0, word_beta: float = 0.0) -> list[str]:
    """Batch [B, T, V] log-probs (+ valid lengths) -> decoded strings.

    Uses the native C++ decoder when available, python fallback otherwise
    (``beam_decode.route`` says which: "python" if any row took it).
    `lm` is a decode.lm.CharNGramLM (or a prebuilt dense table) fused
    per-symbol, or a decode.lm.WordNGramLM fused per completed word (the
    reference ctcdecode+KenLM contract); weight lm_alpha, bonus lm_beta.
    `word_lm` (a WordNGramLM, weights word_alpha/word_beta) may be given IN
    ADDITION to a char `lm` for HYBRID fusion — the measured-best decode mode
    of the JAX package's evaluations: the char LM shapes every symbol, the word LM
    scores completed words.
    """
    if log_probs.ndim == 2:
        log_probs = log_probs[None]
    lm_table, lm_order, word_ex = None, 0, None
    if lm is not None and lm_alpha != 0.0:
        if getattr(lm, "is_word_lm", False):
            word_ex = lm.export_native()
            word_alpha, word_beta = lm_alpha, lm_beta
        elif hasattr(lm, "dense_table"):
            lm_table, lm_order = lm.dense_table(), lm.order
        else:
            lm_table = np.asarray(lm, np.float32)
            v = log_probs.shape[-1]
            lm_order = int(round(math.log(lm_table.size) / math.log(v)))
    if word_lm is not None and word_alpha != 0.0:
        if word_ex is not None:
            raise ValueError("two word LMs given (lm is a WordNGramLM and "
                             "word_lm is set) — pass a char LM as `lm`")
        if not getattr(word_lm, "is_word_lm", False):
            raise ValueError("word_lm must be a decode.lm.WordNGramLM")
        word_ex = word_lm.export_native()
    lm_kw = dict(lm_table=lm_table, lm_order=lm_order,
                 lm_alpha=lm_alpha, lm_beta=lm_beta, word_ex=word_ex,
                 word_alpha=word_alpha, word_beta=word_beta)
    n_b = log_probs.shape[0]
    if n_b > 1:
        # Thread-parallel native batch decode (id-exact with the per-
        # utterance path — same C++ decoder per row); None when the library
        # is absent or predates the batch entry point.
        lens = (np.asarray(lengths, np.int32) if lengths is not None
                else np.full(n_b, log_probs.shape[1], np.int32))
        results = beam_search_native_batch(
            np.asarray(log_probs, np.float32), lens, beam_width,
            prune_k=prune_k, **lm_kw)
        if results is not None:
            beam_decode.route = "native"
            return ["".join(labels[i] for i in ids) for ids, _ in results]
    out = []
    route = "native"
    for b in range(n_b):
        t = int(lengths[b]) if lengths is not None else log_probs.shape[1]
        lp = np.asarray(log_probs[b, :t], np.float32)
        result = beam_search_native(lp, beam_width, prune_k=prune_k, **lm_kw)
        if result is None:
            route = "python"
            result = beam_search_python(lp, beam_width, prune_k=prune_k, **lm_kw)
        ids, _ = result
        out.append("".join(labels[i] for i in ids))
    beam_decode.route = route
    return out


beam_decode.route = None
