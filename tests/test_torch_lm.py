"""Port parity of the n-gram LMs (aas_enhancement_tpu_torch.decode.{lm,ngram,
arpa}) and of cli.train_lm against the JAX package, on the CPU.

Host-only copies: the same texts must give equal dense tables, equal sparse
exports (exact: the same float32 arrays and uint64 keys), equal scores (the
same float64 arithmetic), and LM files that are byte-identical whichever
package wrote them; a file written by either loads in the other.
"""

import json
import os

import numpy as np
import pytest

from aas_enhancement_tpu.cli import train_lm as jax_train_lm
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.decode import arpa as jarpa
from aas_enhancement_tpu.decode import lm as jlm
from aas_enhancement_tpu.decode import ngram as jngram
from aas_enhancement_tpu_torch.cli import train_lm
from aas_enhancement_tpu_torch.decode import arpa, lm, ngram

TEXTS = ["THE CAT SAT ON THE MAT", "SHE SELLS SEA SHELLS", "HOW NOW BROWN COW",
         "THE COW SAT", "A CAT'S MAT IS ON THE COW", ""]


def _same_export(got: dict, ref: dict):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("order", [1, 2, 3])
def test_char_lm_tables_and_scores_match_jax(order):
    got = lm.CharNGramLM(order).fit_texts(TEXTS)
    ref = jlm.CharNGramLM(order).fit_texts(TEXTS)
    assert got.dense_table().dtype == np.float32
    np.testing.assert_array_equal(got.dense_table(), ref.dense_table())
    for ctx in ([], [3], [5, 0, 7], [28, 3]):
        for c in (0, 3, 28):
            assert got.logp(c, ctx) == ref.logp(c, ctx)
            assert lm.context_index(ctx, order, 29) == jlm.context_index(ctx, order, 29)


def test_word_lm_export_and_scores_match_jax():
    got = lm.WordNGramLM().fit_texts(TEXTS)
    ref = jlm.WordNGramLM().fit_texts(TEXTS)
    _same_export(got.export_native(), ref.export_native())
    for word, prev in (("CAT", "THE"), ("COW", None), ("DOG", "THE"), ("THE", "DOG"),
                       ("", "THE")):
        assert got.logp(word, prev) == ref.logp(word, prev)
    assert got.oov_logp == ref.oov_logp


@pytest.mark.parametrize("order", [2, 3, 4])
def test_arpa_fit_export_and_scores_match_jax(order):
    got = arpa.fit_arpa(TEXTS, order=order)
    ref = jarpa.fit_arpa(TEXTS, order=order)
    _same_export(got.export_native(), ref.export_native())
    for word, prev in (("CAT", "THE"), ("SAT", ["THE", "CAT"]), ("MAT", ["ON", "THE"]),
                       ("DOG", None), ("COW", ["XX", "NOW", "BROWN"])):
        assert got.logp(word, prev) == ref.logp(word, prev)
    ex = got.export_native()
    for ctx, w in (([1, 5], 6), ([-1], 4), ([], -1), ([7, 8, 9], 10)):
        assert ngram.score_export(ex, ctx, w) == jngram.score_export(ref.export_native(),
                                                                    ctx, w)


def test_hashes_match_jax():
    rng = np.random.default_rng(0)
    m = rng.integers(-1, 5000, size=(64, 3))
    np.testing.assert_array_equal(ngram.hash_ids_batch(m), jngram.hash_ids_batch(m))
    for row in m[:8]:
        assert ngram.hash_ids(row) == jngram.hash_ids(row) == int(ngram.hash_ids_batch(
            row[None])[0])
        assert ngram.mix64(int(row[0]) & 0xFFFF) == jngram.mix64(int(row[0]) & 0xFFFF)
    with pytest.raises(ValueError, match="exceeds the native decoder"):
        ngram.build_export(ngram.NATIVE_MAX_ORDER + 1, ["A"], [0.0], [0.0],
                           [{}] * ngram.NATIVE_MAX_ORDER, "_A ", 2)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["char", "word", "arpa", "export_arpa"])
def test_lm_files_byte_identical_both_ways(tmp_path, kind):
    """Both packages write the same bytes from the same texts, and a file
    written by either loads in the other (``load_lm`` sniffs the format)
    and writes those bytes again."""
    def fit(mod_lm, mod_arpa):
        if kind == "char":
            return mod_lm.CharNGramLM(3).fit_texts(TEXTS)
        if kind in ("word", "export_arpa"):
            return mod_lm.WordNGramLM().fit_texts(TEXTS)
        return mod_arpa.fit_arpa(TEXTS, order=3)

    def save(model, mod_arpa, path):
        if kind == "arpa":
            model.save_arpa(path)
        elif kind == "export_arpa":
            mod_arpa.export_arpa(model, path)
        else:
            model.save(path)

    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    save(fit(lm, arpa), arpa, ours)
    save(fit(jlm, jarpa), jarpa, theirs)
    assert _bytes(ours) == _bytes(theirs)

    # A file of either package loads in the other as what that package
    # loads from it, and (but for export_arpa's own layout) saves to its bytes.
    for src in (ours, theirs):
        got, ref = lm.load_lm(src), jlm.load_lm(src)
        assert type(got).__name__ == type(ref).__name__
        if kind == "char":
            np.testing.assert_array_equal(got.dense_table(), ref.dense_table())
        else:
            _same_export(got.export_native(), ref.export_native())
        if kind != "export_arpa":
            again = str(tmp_path / "again")
            save(got, arpa, again)
            assert _bytes(again) == _bytes(src)


@pytest.mark.parametrize("argv", [["--level", "char"], ["--level", "char", "--order", "2"],
                                  ["--level", "word", "--arpa", "A"],
                                  ["--level", "word", "--order", "3"]])
def test_train_lm_cli_writes_the_jax_files(tmp_path, capsys, argv):
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=6, seed=2)
    outs = {}
    for name, main in (("jax", jax_train_lm.main), ("torch", train_lm.main)):
        d = tmp_path / name
        d.mkdir()
        args = [a if a != "A" else str(d / "lm.arpa") for a in argv]
        main(["--manifest", corpus["noisy"], "--manifest", corpus["clean"],
              "--out", str(d / "lm.out"), *args])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[name] = (d, line)
    (jd, jline), (td, tline) = outs["jax"], outs["torch"]
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert _bytes(jd / name) == _bytes(td / name), name
    for k in ("out", "arpa"):
        if k in jline and jline[k]:
            jline[k], tline[k] = os.path.basename(jline[k]), os.path.basename(tline[k])
    assert tline == jline
    assert type(lm.load_lm(str(td / "lm.out"))).__name__ == type(
        jlm.load_lm(str(jd / "lm.out"))).__name__
