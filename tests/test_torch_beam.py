"""Port parity of the host CTC beam search (aas_enhancement_tpu_torch.decode.
beam), its native C++ decoder and utils/native_build.py against the JAX
package, on the CPU.

- ``beam_search_python`` equals the JAX package's: ids exactly, scores to
  1e-9 (the same float64 arithmetic), with no LM, a char LM, a word LM and
  both (hybrid fusion).
- The port's native library (built here with g++ from its copy of
  ``native/``) equals the JAX package's native decoder on the same
  log-probs, ids exactly and float32 scores equal; its batch entry point
  equals its per-row one.  A failed build fails the test.
- The copies under ``aas_enhancement_tpu_torch/native/`` are byte-identical
  to ``native/``.
- A streamed ``StreamingRecognizer`` session, rescored with ``beam_decode``
  and a char LM, gives the JAX package's transcript on the same weights and
  audio (log-probs agree to 1e-5).
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import AMConfig, Config
from aas_enhancement_tpu.decode import beam as jbeam
from aas_enhancement_tpu.decode import lm as jlm
from aas_enhancement_tpu.models.am import AcousticModel as JaxAM
from aas_enhancement_tpu.streaming_asr import StreamingRecognizer as JaxRecognizer
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import am_params_from_flax
from aas_enhancement_tpu_torch.decode import beam, lm
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
from aas_enhancement_tpu_torch.utils import native_build

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 29
TEXTS = ["THE CAT SAT ON THE MAT", "SHE SELLS SEA SHELLS", "HOW NOW BROWN COW",
         "THE COW SAT ON A HAT"] * 2


def _log_probs(b, t, seed, peaky=3.0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, t, V)).astype(np.float32) * peaky
    logits[:, ::2, 0] += 2.0                     # blank-heavy, as CTC output is
    return (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """Both packages' native decoders, built here; a failed build fails."""
    assert beam.build(), "the port's native libraries did not build"
    assert jbeam.build(), "the JAX package's native libraries did not build"


def _lms(mode, pkg_lm):
    """beam_search_* keyword arguments of a fusion mode, from one package."""
    if mode == "none":
        return {}
    char = pkg_lm.CharNGramLM(3).fit_texts(TEXTS)
    word = pkg_lm.WordNGramLM().fit_texts(TEXTS).export_native()
    kw = {"char": dict(lm_table=char.dense_table(), lm_order=3, lm_alpha=0.6,
                       lm_beta=0.3),
          "word": dict(word_ex=word, lm_alpha=0.8, lm_beta=1.0),
          "hybrid": dict(lm_table=char.dense_table(), lm_order=3, lm_alpha=0.5,
                         lm_beta=0.2, word_ex=word, word_alpha=0.7, word_beta=0.5)}
    return kw[mode]


@pytest.mark.parametrize("mode", ["none", "char", "word", "hybrid"])
@pytest.mark.parametrize("seed", [0, 1])
def test_python_beam_matches_jax(mode, seed):
    lp = _log_probs(1, 30, seed)[0]
    got = beam.beam_search_python(lp, 8, prune_k=8, **_lms(mode, lm))
    ref = jbeam.beam_search_python(lp, 8, prune_k=8, **_lms(mode, jlm))
    assert got[0] == ref[0]
    assert got[1] == pytest.approx(ref[1], rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("mode", ["none", "char", "word", "hybrid"])
def test_native_matches_jax_native_and_batch_matches_rows(built, mode):
    lp = _log_probs(3, 40, 7)
    lens = np.array([40, 27, 33], np.int32)
    kw, jkw = _lms(mode, lm), _lms(mode, jlm)
    batch = beam.beam_search_native_batch(lp, lens, 16, prune_k=8, **kw)
    for r in range(3):
        got = beam.beam_search_native(lp[r, : lens[r]], 16, prune_k=8, **kw)
        ref = jbeam.beam_search_native(lp[r, : lens[r]], 16, prune_k=8, **jkw)
        assert got == ref
        assert batch[r][0] == got[0]
        assert batch[r][1] == pytest.approx(got[1], rel=1e-6)
        py = beam.beam_search_python(lp[r, : lens[r]], 16, prune_k=8, **kw)
        assert py[0] == got[0]
        assert py[1] == pytest.approx(got[1], rel=1e-4, abs=1e-4)


def test_beam_decode_routes_and_strings(built, monkeypatch, caplog):
    """``beam_decode`` records its route; without the library it logs one
    warning and the Python decoder gives the same strings."""
    lp = _log_probs(3, 30, 3)
    lens = np.array([30, 12, 21], np.int32)
    char = lm.CharNGramLM(2).fit_texts(TEXTS)
    word = lm.WordNGramLM().fit_texts(TEXTS)
    kw = dict(beam_width=8, lm=char, lm_alpha=0.5, word_lm=word, word_alpha=0.5)
    native = beam.beam_decode(lp, lens, **kw)
    assert beam.beam_decode.route == "native"
    assert native == jbeam.beam_decode(lp, lens, beam_width=8, lm=jlm.CharNGramLM(2).fit_texts(
        TEXTS), lm_alpha=0.5, word_lm=jlm.WordNGramLM().fit_texts(TEXTS), word_alpha=0.5)
    assert beam.beam_decode(lp[:1], None, beam_width=8)[0] == beam.beam_decode(
        lp, None, beam_width=8)[0]

    monkeypatch.setattr(native_build, "BUILD_DIR", os.path.join(REPO, "build", "nowhere"))
    monkeypatch.setattr(beam, "_lib", None)
    monkeypatch.setattr(beam, "_lib_tried", False)
    with caplog.at_level(logging.WARNING, logger=beam.__name__):
        assert beam.beam_decode(lp, lens, **kw) == native
        assert beam.beam_decode(lp, lens, **kw) == native
    assert beam.beam_decode.route == "python"
    assert sum("not built" in r.getMessage() for r in caplog.records) == 1


def test_native_copies_are_byte_identical():
    for rel in ("Makefile", *native_build.SOURCES.values()):
        with open(os.path.join(REPO, "native", rel), "rb") as f:
            ref = f.read()
        with open(os.path.join(native_build.NATIVE_DIR, rel), "rb") as f:
            assert f.read() == ref, rel
    # The library is named after its source: an edit gives another name.
    a = native_build.lib_path("libctcbeam.so")
    assert os.path.basename(a).startswith("libctcbeam-") and a.endswith(".so")
    assert a != native_build.lib_path("libwavbatch.so")
    assert os.path.dirname(a) == os.path.join(REPO, "build", "torch_native")


def test_a_failed_build_reports_false(monkeypatch, tmp_path):
    """A make that fails returns False and leaves no library behind."""
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native_build, "NATIVE_DIR", str(tmp_path / "src"))
    (tmp_path / "src" / "ctc_beam").mkdir(parents=True)
    (tmp_path / "src" / "audio").mkdir()
    (tmp_path / "src" / "Makefile").write_text("all:\n\tfalse\n")
    (tmp_path / "src" / "ctc_beam" / "ctc_beam.cc").write_text("")
    (tmp_path / "src" / "audio" / "wav_batch.cc").write_text("")
    assert native_build.build() is False
    assert os.listdir(tmp_path / "out") == []


def test_streamed_session_rescored_matches_jax(built):
    """The JAX package's "beam + LM rescore of a streamed session": a
    StreamingRecognizer(collect_logits=True) session's log-probs, decoded by
    beam_decode with a char 3-gram, give the JAX package's transcript."""
    cfg = Config(am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8))
    x = jnp.zeros((1, 64, 161), jnp.float32)
    params = JaxAM(cfg.am).init(jax.random.key(0), x, jnp.array([64], jnp.int32))
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.3 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), params)
    am = AcousticModel(TConfig.from_json(cfg.to_json()).am, 161)
    am.load_state_dict(am_params_from_flax(params))
    t = np.arange(12000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 300 * t * (1 + t))
           + 0.05 * np.random.default_rng(1).standard_normal(12000)).astype(np.float32)
    kw = dict(chunk_seconds=0.5, lookahead_seconds=0.2, history_seconds=0.5)
    ref = JaxRecognizer(cfg, params, collect_logits=True, **kw)
    ref.feed(wav)
    ref.flush()
    rec = StreamingRecognizer(TConfig.from_json(cfg.to_json()), am.eval(),
                              collect_logits=True, device="cpu", **kw)
    for k in range(0, len(wav), 1600):
        rec.feed(wav[k: k + 1600])
    rec.flush()
    np.testing.assert_allclose(rec.log_probs(), ref.log_probs(), rtol=0, atol=1e-5)
    got = beam.beam_decode(rec.log_probs()[None], None, beam_width=16,
                           lm=lm.CharNGramLM(3).fit_texts(TEXTS), lm_alpha=0.8)
    want = jbeam.beam_decode(ref.log_probs()[None], None, beam_width=16,
                             lm=jlm.CharNGramLM(3).fit_texts(TEXTS), lm_alpha=0.8)
    assert got == want and got[0]
    assert beam.beam_decode.route == "native"
