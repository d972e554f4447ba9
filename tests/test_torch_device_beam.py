"""Port parity of the batched device beam search (aas_enhancement_tpu_torch.
decode.device_beam) against the JAX package's ``device_beam_decode_raw``, on
the CPU, on the cases of tests/test_device_beam.py.

Contract: ids and lengths equal exactly; scores within 1e-4 (both
accumulate in float32, in the same order, but XLA's and PyTorch's exp / log1p
may round differently).  Ids also equal the port's ``beam_search_python``.
"""

import numpy as np
import pytest
import torch

from aas_enhancement_tpu.decode.device_beam import device_beam_decode_raw as jax_raw
from aas_enhancement_tpu.decode.lm import CharNGramLM as JaxCharNGramLM
from aas_enhancement_tpu_torch.decode import device_beam
from aas_enhancement_tpu_torch.decode.beam import beam_decode, beam_search_python
from aas_enhancement_tpu_torch.decode.device_beam import (device_beam_decode,
                                                          device_beam_decode_raw)
from aas_enhancement_tpu_torch.decode.lm import CharNGramLM
from aas_enhancement_tpu_torch.labels import LABELS

torch.set_num_threads(1)

V = len(LABELS)
TEXTS = ["the cat sat on the mat", "she sells sea shells", "how now brown cow"] * 2


def _batch_log_probs(b, t, seed=0, peaky=2.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, V)).astype(np.float32) * peaky
    return logits - np.log(np.sum(np.exp(logits), axis=-1, keepdims=True))


def _peaky(b, t, seed):
    lp = _batch_log_probs(b, t, seed=seed, peaky=4.0)
    lp[:, ::2, 0] += 6.0  # blank dominates every other frame
    return (lp - np.log(np.sum(np.exp(lp), axis=-1, keepdims=True))).astype(np.float32)


def _char_lm(order):
    return dict(lm_table=CharNGramLM(order=order).fit_texts(TEXTS).dense_table(),
                lm_order=order, lm_alpha=0.7, lm_beta=0.2)


CASES = {
    **{f"seed{s}": (_batch_log_probs(3, 40, s), [40, 25, 33],
                    dict(beam_width=16, prune_k=8)) for s in range(3)},
    "no_prune": (_batch_log_probs(2, 40, 11), [40, 17], dict(beam_width=16, prune_k=0)),
    "peaky": (_peaky(2, 40, 3), [40, 31], dict(beam_width=16, prune_k=8)),
    **{f"char_lm{o}": (_batch_log_probs(2, 40, o), [40, 28],
                       dict(beam_width=16, prune_k=8, **_char_lm(o))) for o in (2, 3)},
    "short": (_batch_log_probs(2, 40, 9), [1, 2], dict(beam_width=16, prune_k=8)),
    "width1": (_peaky(3, 30, 4), [30, 30, 12], dict(beam_width=1, prune_k=8)),
    "width8_lm": (_peaky(3, 30, 5), [30, 7, 22], dict(beam_width=8, prune_k=4,
                                                        **_char_lm(3))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_device_beam_matches_jax(case):
    lp, lens, kw = CASES[case]
    lens = np.asarray(lens, np.int32)
    ids, out_lens, scores = device_beam_decode_raw(lp, lens, device="cpu", **kw)
    ref_ids, ref_lens, ref_scores = jax_raw(lp, lens, **kw)
    assert ids.dtype == np.int32 and out_lens.dtype == np.int32
    np.testing.assert_array_equal(out_lens, ref_lens)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_allclose(scores, ref_scores, rtol=0, atol=1e-4)
    for b in range(lp.shape[0]):
        py_ids, py_score = beam_search_python(
            lp[b, : lens[b]], beam_width=kw["beam_width"], prune_k=kw["prune_k"],
            lm_table=kw.get("lm_table"), lm_order=kw.get("lm_order", 0),
            lm_alpha=kw.get("lm_alpha", 0.0), lm_beta=kw.get("lm_beta", 0.0))
        assert list(ids[b, : out_lens[b]]) == py_ids, f"row {b}"
        assert scores[b] == pytest.approx(py_score, rel=1e-4, abs=1e-4)


def test_jax_lm_table_and_tensor_inputs():
    """The JAX package's dense table decodes alike, and a tensor input stays
    on its device (the CPU here) with lengths given as a tensor."""
    lp, lens, kw = CASES["char_lm3"]
    table = JaxCharNGramLM(order=3).fit_texts(TEXTS).dense_table()
    np.testing.assert_array_equal(table, kw["lm_table"])
    got = device_beam_decode_raw(torch.from_numpy(lp), torch.tensor(lens),
                                 **{**kw, "lm_table": table})
    ref = device_beam_decode_raw(lp, lens, device="cpu", **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_device_strings_match_host_decoder():
    lp = _batch_log_probs(3, 40, seed=5)
    lens = np.array([40, 22, 35], np.int32)
    dev = device_beam_decode(lp, lens, beam_width=16, prune_k=8, device="cpu")
    assert dev == beam_decode(lp, lens, beam_width=16, prune_k=8)
    assert device_beam_decode(lp[0], None, beam_width=16, prune_k=8, device="cpu") == dev[:1]


def test_hash_arithmetic_is_uint32():
    """The int64 split products equal uint32 wrap-around arithmetic."""
    rng = np.random.default_rng(0)
    h = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    c = rng.integers(0, V, size=4096, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (h.astype(np.uint32) ^ (c.astype(np.uint32) + np.uint32(1))) \
            * np.uint32(0x9E3779B1)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x85EBCA6B)
        want = x ^ (x >> np.uint32(13))
    got = device_beam._mix1(torch.from_numpy(h.astype(np.int64)),
                            torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_lm_table_shape_validated_and_cuda_needs_a_gpu(monkeypatch):
    lp = _batch_log_probs(1, 40, seed=0)
    bad = np.zeros((V + 1, V), np.float32)
    with pytest.raises(ValueError, match="contexts"):
        device_beam_decode(lp, None, beam_width=8, lm_table=bad, lm_order=2,
                           lm_alpha=0.5, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_beam_decode(lp, None, beam_width=8)
