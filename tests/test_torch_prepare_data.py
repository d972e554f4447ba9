"""The port's data CLI (aas_enhancement_tpu_torch.cli.prepare_data) and its
synthetic corpus (data/synthetic.py, data/manifest.py::write_manifest)
against the JAX package, on the CPU.

Host-only copies: ``data/synthetic.py`` and ``cli/prepare_data.py`` are the
JAX files with the package name replaced in their imports, so the port's
copies of ``tests/test_synthetic.py`` and ``tests/test_prepare_data.py`` run
against the port's functions, and every file that either package writes in
the structured, legacy, ``--from-dir`` and CHiME-4 modes is the other's,
byte for byte (manifests after the output directory's name).
"""

import json
import os
from collections import Counter

import numpy as np
import pytest

from aas_enhancement_tpu.cli import prepare_data as jax_cli
from aas_enhancement_tpu.data import synthetic as jsynth
from aas_enhancement_tpu_torch.cli import prepare_data as cli
from aas_enhancement_tpu_torch.data import write_manifest
from aas_enhancement_tpu_torch.data.manifest import read_manifest
from aas_enhancement_tpu_torch.data.synthetic import (Language, apply_rir,
                                                      default_language,
                                                      generate_corpus, make_noise,
                                                      make_rir, synth_utterance)
from aas_enhancement_tpu_torch.data.wav import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(root: str) -> dict[str, bytes]:
    """Every file under root by its relative path, with root's own name
    replaced in the contents (the manifests hold absolute paths)."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(root.encode(), b"<root>")
    return out


def _same_tree(got: str, ref: str):
    g, r = _tree(got), _tree(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k] == r[k], k


# --------------------------------------------------------------- the sources

@pytest.mark.parametrize("rel", ["data/synthetic.py", "cli/prepare_data.py"])
def test_source_is_the_jax_file_up_to_the_package_name(rel):
    with open(os.path.join(REPO, "aas_enhancement_tpu", rel)) as f:
        ref = f.read()
    with open(os.path.join(REPO, "aas_enhancement_tpu_torch", rel)) as f:
        got = f.read()
    assert ref.count("aas_enhancement_tpu.") == 2
    assert got == ref.replace("aas_enhancement_tpu.", "aas_enhancement_tpu_torch.")


# ------------------------------------- the port's copy of tests/test_synthetic.py

def test_language_deterministic_in_lang_seed():
    a, b = default_language(3), default_language(3)
    assert a.words == b.words
    np.testing.assert_array_equal(a.bigram, b.bigram)
    c = default_language(4)
    assert c.words != a.words


def test_language_bigram_structure():
    lang = default_language(0)
    rng = np.random.default_rng(1)
    train_words, test_words = [], []
    for _ in range(300):
        train_words.extend(lang.sample_sentence(rng, (3, 8)).split())
        test_words.extend(lang.sample_sentence(rng, (3, 8)).split())
    assert set(train_words) <= set(lang.words)

    uni = Counter(train_words)
    bi = Counter(zip(train_words, train_words[1:]))
    n_uni = sum(uni.values())

    def uni_lp(w):
        return np.log((uni.get(w, 0) + 1) / (n_uni + len(lang.words)))

    def bi_lp(prev, w):
        ctx_total = sum(c for (a, _), c in bi.items() if a == prev)
        c = bi.get((prev, w), 0)
        if ctx_total == 0 or c == 0:
            return np.log(0.4) + uni_lp(w)      # stupid backoff
        return np.log(c / ctx_total)

    pairs = list(zip(test_words, test_words[1:]))[:500]
    gap = np.mean([bi_lp(a, b) - uni_lp(b) for a, b in pairs])
    assert gap > 0.5, f"bigram carries no information over unigram: {gap:.3f}"


def test_rate_jitter_changes_durations():
    base = synth_utterance("HELLO WORLD", seed=1)
    same = synth_utterance("HELLO WORLD", seed=1)
    np.testing.assert_array_equal(base, same)
    jit = synth_utterance("HELLO WORLD", seed=1, rate_jitter=0.25)
    assert len(jit) != len(base)
    jit2 = synth_utterance("HELLO WORLD", seed=2, rate_jitter=0.25)
    assert len(jit2) != len(jit)


def test_coarticulation_smooths_formant_transitions():
    a = synth_utterance("ABAB", seed=3, coarticulation=0.0)
    b = synth_utterance("ABAB", seed=3, coarticulation=0.5)
    assert len(a) == len(b)
    assert float(np.max(np.abs(a - b))) > 0.01


def test_rir_properties():
    ir = make_rir(0.3, seed=2)
    assert abs(float(np.sum(ir ** 2)) - 1.0) < 1e-5
    assert np.argmax(np.abs(ir)) == 0
    wav = synth_utterance("HELLO", seed=1)
    out = apply_rir(wav, ir)
    assert out.shape == wav.shape
    assert float(np.max(np.abs(out))) <= 1.0
    assert float(np.max(np.abs(out - wav))) > 1e-3


def test_nonstationary_noise():
    n = make_noise(32000, "nonstat", seed=3)
    assert abs(float(np.std(n)) - 1.0) < 1e-3
    frames = n[: 32000 // 800 * 800].reshape(-1, 800)
    e = np.std(frames, axis=1)
    w = make_noise(32000, "white", seed=3)
    ew = np.std(w[: 32000 // 800 * 800].reshape(-1, 800), axis=1)
    assert float(np.std(e)) > 4 * float(np.std(ew))


def test_generate_corpus_structured(tmp_path):
    m = generate_corpus(str(tmp_path), n_utts=6, seed=5, reverb_prob=0.5)
    lang = default_language(0)
    lex = os.path.join(str(tmp_path), "lexicon.txt")
    assert open(lex).read().splitlines() == lang.words
    for line in open(m["noisy"]).read().splitlines():
        text = open(line.split(",")[1]).read()
        assert all(w in lang.words for w in text.split())


def test_generate_corpus_legacy_unchanged(tmp_path):
    m = generate_corpus(str(tmp_path), n_utts=4, seed=11, vocab_chars=6)
    assert not os.path.exists(os.path.join(str(tmp_path), "lexicon.txt"))
    texts = [open(line.split(",")[1]).read()
             for line in open(m["noisy"]).read().splitlines()]
    allowed = set("ABCDE'")
    assert all(set(t) <= allowed | {" "} for t in texts)


def test_corpora_share_language_but_not_sentences(tmp_path):
    a = generate_corpus(str(tmp_path / "a"), n_utts=8, seed=1)
    b = generate_corpus(str(tmp_path / "b"), n_utts=8, seed=2)
    ta = {open(line.split(",")[1]).read()
          for line in open(a["noisy"]).read().splitlines()}
    tb = {open(line.split(",")[1]).read()
          for line in open(b["noisy"]).read().splitlines()}
    assert len(ta & tb) <= len(ta) // 4, f"too much overlap: {ta & tb}"
    lang = default_language(0)
    for t in ta | tb:
        assert all(w in lang.words for w in t.split())


def test_language_trigram_structure():
    from aas_enhancement_tpu_torch.decode.arpa import fit_arpa

    def tri_gain(tri_classes, lang_seed=5):
        lang = Language(lang_seed=lang_seed, tri_classes=tri_classes)
        rng = np.random.default_rng(2)
        train = [lang.sample_sentence(rng, (4, 9)) for _ in range(500)]
        rng2 = np.random.default_rng(9)
        test = [lang.sample_sentence(rng2, (4, 9)) for _ in range(120)]
        bi = fit_arpa(train, order=2)
        tri = fit_arpa(train, order=3)

        def mean_ll(lm):
            tot, n = 0.0, 0
            for s in test:
                padded = ["<s>"] + s.split()
                for t in range(1, len(padded)):
                    ctx = padded[max(0, t - (lm.order - 1)): t]
                    tot += lm.logp(padded[t], ctx)
                    n += 1
            return tot / n

        return mean_ll(tri) - mean_ll(bi)

    gain_tri = tri_gain(3)
    gain_flat = tri_gain(1)
    assert gain_tri > 0.15, f"trigram language not learnable: {gain_tri:.3f}"
    assert gain_tri > gain_flat + 0.1, (gain_tri, gain_flat)


def test_language_tri_classes_default_unchanged():
    a = default_language(0)
    b = default_language(0, tri_classes=3)
    assert a.words == b.words
    np.testing.assert_array_equal(a.unigram, b.unigram)
    np.testing.assert_array_equal(a.bigram, b.bigram)
    assert a.tri_bigram is None and b.tri_bigram is not None
    assert (a.sample_sentence(np.random.default_rng(0), (2, 2))
            == b.sample_sentence(np.random.default_rng(0), (2, 2)))


# ---------------------------------- the port's copy of tests/test_prepare_data.py

def _fake_chime4(tmp_path):
    root = tmp_path / "CHiME4"
    iso = root / "data" / "audio" / "16kHz" / "isolated" / "dt05_simu"
    trn = root / "data" / "transcriptions" / "dt05_simu"
    iso.mkdir(parents=True)
    trn.mkdir(parents=True)
    for utt in ("F01_050C0101_BUS", "M02_051C0102_CAF"):
        for ch in ("CH1", "CH5"):
            write_wav(str(iso / f"{utt}.{ch}.wav"), np.zeros(1600, np.float32), 16000)
        (trn / f"{utt}.trn").write_text("SOME WORDS")
    return root


def _wav_txt_dir(path):
    path.mkdir()
    for i in range(3):
        write_wav(str(path / f"u{i}.wav"), np.full(1600, 0.01 * i, np.float32), 16000)
        (path / f"u{i}.txt").write_text("HELLO")
    return path


def test_synthetic_mode(tmp_path, capsys):
    cli.main(["--out-dir", str(tmp_path), "--n-utts", "4", "--seed", "3"])
    out = json.loads(capsys.readouterr().out)
    assert out["utterances"] == 4
    assert len(read_manifest(out["noisy"])) == 4


def test_from_dir_mode(tmp_path, capsys):
    src = _wav_txt_dir(tmp_path / "src")
    cli.main(["--out-dir", str(tmp_path / "out"), "--from-dir", str(src)])
    out = json.loads(capsys.readouterr().out)
    assert out["utterances"] == 3


def test_chime4_layout(tmp_path, capsys):
    root = _fake_chime4(tmp_path)
    cli.main(["--out-dir", str(tmp_path / "out"), "--chime4-dir", str(root),
              "--chime4-split", "dt05_simu", "--channel", "CH5"])
    out = json.loads(capsys.readouterr().out)
    assert out["utterances"] == 2
    assert out["missing_transcripts"] == 0
    entries = read_manifest(out["manifest"])
    assert all(".CH5." in w for w, _ in entries)


# ------------------------------------------------ the same files as the JAX package

@pytest.mark.parametrize("kwargs", [
    dict(),                                               # structured
    dict(word_len=(2, 6)),                                # legacy
    dict(vocab_chars=6),                                  # legacy, few characters
    dict(reverb_prob=0.5, tri_classes=3, lexicon_size=40, lang_seed=2,
         noise_kinds=("white", "nonstat", "babble"), snr_range=(-5.0, 5.0)),
], ids=["structured", "legacy", "legacy-vocab", "structured-reverb"])
def test_generate_corpus_writes_the_jax_files(tmp_path, kwargs):
    ref = jsynth.generate_corpus(str(tmp_path / "jax"), n_utts=5, seed=4, **kwargs)
    got = generate_corpus(str(tmp_path / "torch"), n_utts=5, seed=4, **kwargs)
    assert got == {k: v.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
                   for k, v in ref.items()}
    _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"))


@pytest.mark.parametrize("mode", ["synthetic", "legacy", "from-dir", "chime4"])
def test_cli_writes_the_jax_files(tmp_path, capsys, mode):
    if mode == "from-dir":
        args = ["--from-dir", str(_wav_txt_dir(tmp_path / "src"))]
    elif mode == "chime4":
        args = ["--chime4-dir", str(_fake_chime4(tmp_path)), "--chime4-split",
                "dt05_simu", "--channel", "CH5"]
    else:
        args = ["--n-utts", "3", "--seed", "6", "--reverb-prob", "0.5"] + (
            ["--vocab-chars", "8", "--n-words-high", "3"] if mode == "legacy" else
            ["--tri-classes", "2", "--rate-jitter", "0.1"])
    jax_cli.main(["--out-dir", str(tmp_path / "jax"), *args])
    ref = capsys.readouterr().out
    cli.main(["--out-dir", str(tmp_path / "torch"), *args])
    got = capsys.readouterr().out
    assert got == ref.replace(str(tmp_path / "jax"), str(tmp_path / "torch"))
    _same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"))


def test_write_manifest_matches_jax(tmp_path):
    from aas_enhancement_tpu.data.manifest import write_manifest as jax_write
    rows = [("a/x.wav", "a/x.txt"), ("b,c.wav", "b.txt")]
    write_manifest(str(tmp_path / "t" / "m.csv"), rows)
    jax_write(str(tmp_path / "j" / "m.csv"), rows)
    assert (open(tmp_path / "t" / "m.csv", "rb").read()
            == open(tmp_path / "j" / "m.csv", "rb").read())
