"""Port parity of the recognition path: config, labels, WER, greedy decoding,
the dataset, the on-device features, evaluate_wer / evaluate_si_snr and the
evaluate CLI (aas_enhancement_tpu_torch) against the JAX package, on the CPU.

Tiny networks (AM 8 conv channels + 2 x BiGRU-16, enhancer 8 channels +
BiLSTM-16) with the flax parameter trees converted.  Host-side code
(labels, WER, batches, decoding of equal logits) must agree exactly; features
to 1e-5 (f32 STFT sums in another order); greedy hypotheses, WER and CER
exactly on a corpus whose logits agree to ~1e-5; SI-SNR and STOI of the
enhanced waveform to 1e-4 relative (the waveforms agree to ~1e-6).
"""

import contextlib
import dataclasses
import importlib
import io
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu import labels as jax_labels
from aas_enhancement_tpu.cli import evaluate as jax_eval_cli
from aas_enhancement_tpu.cli import train_lm as jax_train_lm
from aas_enhancement_tpu.config import AMConfig, Config, DataConfig, EnhancerConfig
from aas_enhancement_tpu.data.dataset import AudioDataset as JaxAudioDataset
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.decode import beam as jax_beam
from aas_enhancement_tpu.decode import greedy as jax_greedy
from aas_enhancement_tpu.decode import lm as jax_lm
from aas_enhancement_tpu.enhance import init_enhancer as jax_init_enhancer
from aas_enhancement_tpu import evaluation as jax_eval
from aas_enhancement_tpu.models.am import AcousticModel as JaxAcousticModel
from aas_enhancement_tpu.train.objectives import device_features as jax_device_features
from aas_enhancement_tpu_torch import config as tconfig
from aas_enhancement_tpu_torch import evaluation as teval
from aas_enhancement_tpu_torch import labels as tlabels
from aas_enhancement_tpu_torch.cli import evaluate as cli
from aas_enhancement_tpu_torch.convert import am_params_from_flax, enhancer_params_from_flax
from aas_enhancement_tpu_torch.data.dataset import AudioDataset
from aas_enhancement_tpu_torch.decode import beam as tbeam
from aas_enhancement_tpu_torch.decode import greedy as tgreedy
from aas_enhancement_tpu_torch.decode import lm as tlm
from aas_enhancement_tpu_torch.decode import wer as twer
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.train.objectives import device_features, enhancer_forward

# The package exports a function named `wer` that shadows the module.
jax_wer = importlib.import_module("aas_enhancement_tpu.decode.wer")

torch.set_num_threads(1)

SMALL_AM = dict(rnn_hidden=16, rnn_layers=2, conv_channels=8)
SMALL_ENH = dict(conv_channels=8, rnn_hidden=16, rnn_layers=1)


def _cfgs(**data):
    jcfg = Config().replace(am=AMConfig(**SMALL_AM), enhancer=EnhancerConfig(**SMALL_ENH),
                            data=DataConfig(**data))
    return jcfg, tconfig.Config.from_json(jcfg.to_json())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=5, seed=4)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == 2) else np.asarray(a), params)


@pytest.fixture(scope="module")
def nets():
    """Flax params of the tiny AM and enhancer and their torch counterparts."""
    jcfg, tcfg = _cfgs()
    am_p = _perturbed(JaxAcousticModel(jcfg.am).init(
        jax.random.key(0), jnp.zeros((1, 24, 161)), jnp.array([24])), 1)
    g_p = _perturbed(jax_init_enhancer(jcfg, jax.random.key(2), max_t=24), 3)
    am = AcousticModel(tcfg.am, 161)
    am.load_state_dict(am_params_from_flax(am_p))
    enh = Enhancer(tcfg.enhancer, 161)
    enh.load_state_dict(enhancer_params_from_flax(g_p))
    return am_p, g_p, am.eval(), enh.eval()


@pytest.fixture(scope="module")
def jax_results(corpus, nets):
    """The JAX package's evaluate_wer (noisy and enhanced legs) and
    evaluate_si_snr on the corpus, one bucket so each leg compiles once."""
    am_p, g_p, _, _ = nets
    jcfg, _ = _cfgs(num_buckets=1)
    return {"noisy": jax_eval.evaluate_wer(jcfg, am_p, corpus["noisy"], per_utt=True),
            "enhanced": jax_eval.evaluate_wer(jcfg, am_p, corpus["noisy"], g_params=g_p,
                                              per_utt=True),
            "si_snr": jax_eval.evaluate_si_snr(jcfg, corpus["noisy"], corpus["clean"],
                                               g_params=g_p)}


@pytest.mark.parametrize("leg", ["noisy", "enhanced"])
def test_evaluate_wer_matches_jax(corpus, nets, jax_results, leg):
    _, _, am, enh = nets
    _, tcfg = _cfgs(num_buckets=1)
    got = teval.evaluate_wer(tcfg, am, corpus["noisy"],
                             enhancer=enh if leg == "enhanced" else None, per_utt=True)
    ref = jax_results[leg]
    assert set(got) == set(ref)
    assert got["utterances"] == ref["utterances"] == 5
    for k in ("sample_ref", "sample_hyp", "per_utt", "wer", "cer", "wer_ci95"):
        assert got[k] == ref[k], k


@pytest.fixture(scope="module")
def lm_files(corpus, tmp_path_factory):
    """A char 3-gram (json) and a word 3-gram (ARPA) written by the JAX
    package's train_lm CLI from the corpus' transcripts; both native beam
    decoders built."""
    assert tbeam.build() and jax_beam.build()
    d = tmp_path_factory.mktemp("lms")
    with contextlib.redirect_stdout(io.StringIO()):
        jax_train_lm.main(["--manifest", corpus["clean"], "--level", "char",
                           "--out", str(d / "char.json")])
        jax_train_lm.main(["--manifest", corpus["clean"], "--level", "word", "--order", "3",
                           "--out", str(d / "word.arpa")])
    return str(d / "char.json"), str(d / "word.arpa")


@pytest.mark.parametrize("decoder,fusion,leg", [
    ("beam", "none", "noisy"), ("beam", "char", "enhanced"), ("beam", "word", "noisy"),
    ("beam", "hybrid", "noisy"), ("device", "none", "noisy"), ("device", "char", "enhanced")])
def test_evaluate_wer_beam_decoders_match_jax(corpus, nets, lm_files, decoder, fusion, leg):
    """The host beam (any fusion) and the device beam (none or char) give
    the JAX package's hypotheses, hence its WER, CER and per-utterance
    counts exactly, on logits that agree to ~1e-6."""
    am_p, g_p, am, enh = nets
    jcfg, tcfg = _cfgs(num_buckets=1)

    def kw(load):
        k = dict(decoder=decoder, beam_width=8, per_utt=True)
        if fusion in ("char", "hybrid"):
            k.update(lm=load(lm_files[0]), lm_alpha=0.8, lm_beta=0.5)
        if fusion == "word":
            k.update(lm=load(lm_files[1]), lm_alpha=0.8, lm_beta=1.0)
        if fusion == "hybrid":
            k.update(word_lm=load(lm_files[1]), word_alpha=0.6, word_beta=1.0)
        return k

    enhanced = leg == "enhanced"
    ref = jax_eval.evaluate_wer(jcfg, am_p, corpus["noisy"], g_params=g_p if enhanced else None,
                                **kw(jax_lm.load_lm))
    got = teval.evaluate_wer(tcfg, am, corpus["noisy"], enhancer=enh if enhanced else None,
                             **kw(tlm.load_lm))
    assert got == ref
    if decoder == "beam":
        assert tbeam.beam_decode.route == "native"


@pytest.mark.parametrize("argv", [
    ["--decoder", "beam", "--lm", "CHAR", "--word-lm", "WORD", "--tune-lm-manifest", "DEV",
     "--enhancer-checkpoint", "ckpt_g"],
    ["--decoder", "beam", "--lm", "CHAR", "--tune-lm-manifest", "DEV", "--lm-beta", "0.5"],
    ["--decoder", "device", "--lm", "CHAR", "--lm-alpha", "0.8"]])
def test_cli_beam_json_matches_jax(tmp_path, corpus, nets, lm_files, monkeypatch, capsys,
                                   argv):
    """Both evaluate CLIs on the same networks (the flax trees and their
    convert.py counterparts, served by each CLI's load_state) print the same
    JSON line, the LM tuning grid included."""
    am_p, g_p, am, enh = nets
    jcfg, tcfg = _cfgs(num_buckets=1)
    monkeypatch.setattr("aas_enhancement_tpu.utils.jax_cache.enable", lambda *a: None)
    monkeypatch.setattr("aas_enhancement_tpu.train.loop.load_state", lambda d: (
        types.SimpleNamespace(am_params=am_p, g_params=g_p), jcfg))
    monkeypatch.setattr(cli, "load_state", lambda d, device: (
        types.SimpleNamespace(am=am, g=enh), tcfg))
    (tmp_path / "cfg.json").write_text(jcfg.to_json())
    subs = {"CHAR": lm_files[0], "WORD": lm_files[1], "DEV": corpus["clean"]}
    args = ["--manifest", corpus["noisy"], "--am-checkpoint", "ckpt_am", "--beam-width", "8",
            "--config", str(tmp_path / "cfg.json"), *[subs.get(a, a) for a in argv]]
    jax_eval_cli.main(args)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main([*args, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
    assert ("lm_tuning" in got) == ("--tune-lm-manifest" in argv)


def test_evaluate_si_snr_matches_jax(corpus, nets, jax_results):
    _, tcfg = _cfgs()
    got = teval.evaluate_si_snr(tcfg, corpus["noisy"], corpus["clean"], enhancer=nets[3])
    ref = jax_results["si_snr"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k


def test_eval_forward_matches_jax(nets):
    """Logits and paddings of the enhanced leg at ragged lengths (the
    evaluate_wer parity above rests on these)."""
    am_p, g_p, am, enh = nets
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(5)
    wav = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    lengths = np.array([8000, 5000], np.int32)
    wav[1, 5000:] = 0.0
    ref, ref_pads = jax_eval.make_eval_forward(jcfg, use_enhancer=True)(
        am_p, g_p, jnp.asarray(wav), jnp.asarray(lengths))
    got, pads = teval.make_eval_forward(tcfg, use_enhancer=True)(
        am, enh, torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(pads.numpy(), np.asarray(ref_pads))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_greedy_decode_matches_jax():
    rng = np.random.default_rng(0)
    b, t, v = 4, 40, 29
    ids = rng.integers(0, 4, size=(b, t))                 # blanks and repeats
    logits = rng.standard_normal((b, t, v)).astype(np.float32)
    logits[np.arange(b)[:, None], np.arange(t)[None], ids] += 5.0
    logits[0, 3] = 1.0                                    # a tie: the first maximum wins
    pads = (np.arange(t)[None] >= np.array([40, 31, 1, 0])[:, None]).astype(np.float32)
    ref_ids, ref_counts = jax_greedy.greedy_decode(jnp.asarray(logits), jnp.asarray(pads))
    got_ids, got_counts = tgreedy.greedy_decode(torch.from_numpy(logits),
                                                torch.from_numpy(pads))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(ref_counts))
    assert tgreedy.decode_batch(torch.from_numpy(logits), torch.from_numpy(pads)) == \
        jax_greedy.decode_batch(jnp.asarray(logits), jnp.asarray(pads))
    assert got_counts[3] == 0 and got_counts[0] > 0


def test_labels_and_wer_match_jax(tmp_path):
    assert tlabels.LABELS == jax_labels.LABELS and tlabels.BLANK_ID == jax_labels.BLANK_ID
    assert tlabels.label_maps() == jax_labels.label_maps()
    text = "Hello, world's END 42"
    assert tlabels.encode(text) == jax_labels.encode(text)
    ids = jax_labels.encode(text) + [0, 0, 5]
    assert tlabels.decode_ids(ids) == jax_labels.decode_ids(ids)
    (tmp_path / "l.json").write_text(json.dumps(list("_AB ")))
    assert tlabels.load_labels(str(tmp_path / "l.json")) == \
        jax_labels.load_labels(str(tmp_path / "l.json"))
    refs = ["the cat sat", "a b c d", "", "hello"]
    hyps = ["the bat sat on", "a c d", "x", ""]
    for r, h in zip(refs, hyps):
        assert twer.wer(r, h) == jax_wer.wer(r, h)
        assert twer.cer(r, h) == jax_wer.cer(r, h)
        assert twer.edit_distance(list(r), list(h)) == jax_wer.edit_distance(list(r), list(h))
    assert twer.corpus_wer(refs, hyps) == jax_wer.corpus_wer(refs, hyps)
    assert twer.corpus_wer_ci(refs, hyps, n_boot=300, seed=3) == \
        jax_wer.corpus_wer_ci(refs, hyps, n_boot=300, seed=3)


def test_si_snr_and_stoi_match_jax():
    rng = np.random.default_rng(1)
    t = np.arange(24000) / 16000
    clean = (np.sin(2 * np.pi * 300 * t) * (1 + np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    noisy = clean + 0.3 * rng.standard_normal(len(clean)).astype(np.float32)
    assert teval.si_snr(noisy, clean) == jax_eval.si_snr(noisy, clean)
    assert teval.stoi(noisy, clean) == jax_eval.stoi(noisy, clean)
    np.testing.assert_array_equal(teval._third_octave_bands(10000, 512, 15, 150.0),
                                  jax_eval._third_octave_bands(10000, 512, 15, 150.0))
    with pytest.raises(ValueError, match="stoi needs"):
        teval.stoi(noisy[:1000], clean[:1000])


@pytest.mark.parametrize("feed", ["float32", "int16"])
def test_dataset_batches_match_jax(corpus, feed):
    data = DataConfig(native_decode=False, feed_dtype=feed, num_buckets=2)
    jcfg, tcfg = _cfgs()
    ref_ds = JaxAudioDataset(corpus["noisy"], jcfg.audio, data,
                             paired_manifest=corpus["clean"])
    got_ds = AudioDataset(corpus["noisy"], tcfg.audio,
                          tconfig.DataConfig(**dataclasses.asdict(data)),
                          paired_manifest=corpus["clean"])
    assert got_ds.bucket_sizes == ref_ds.bucket_sizes
    assert got_ds.max_label_len == ref_ds.max_label_len
    for epoch in (0, 1):
        ref = list(ref_ds.batches(3, seed=7, epoch=epoch))
        got = list(got_ds.batches(3, seed=7, epoch=epoch))
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert g.size == r.size and g.wav.dtype == r.wav.dtype
            for name in ("wav", "wav_lengths", "labels", "label_paddings", "clean_wav"):
                np.testing.assert_array_equal(getattr(g, name), getattr(r, name), name)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_device_features_match_jax(dtype):
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    wav = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    if dtype == np.int16:
        wav = (wav * 32767).astype(np.int16)
    lengths = np.array([8000, 4321], np.int32)
    ref = jax_device_features(jcfg, jnp.asarray(wav), jnp.asarray(lengths))
    got = device_features(tcfg, torch.from_numpy(wav), torch.from_numpy(lengths))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_config_am_and_data_sections_match_jax():
    jcfg = Config().replace(am=AMConfig(rnn_hidden=64, rnn_type="lstm"),
                            data=DataConfig(num_buckets=2, feed_dtype="int16",
                                            noise_snr_range=(1.0, 2.0)))
    got = tconfig.Config.from_json(jcfg.to_json())
    for section in ("am", "data"):
        assert dataclasses.asdict(getattr(got, section)) == \
            dataclasses.asdict(getattr(jcfg, section)), section
    for section in ("am", "data"):
        assert dataclasses.asdict(getattr(tconfig.Config(), section)) == \
            dataclasses.asdict(getattr(Config(), section)), section
    assert tconfig.Config.from_json(got.to_json()) == got


def test_cli_prints_the_jax_keys(tmp_path, corpus, jax_results, capsys):
    _, tcfg = _cfgs()
    (tmp_path / "cfg.json").write_text(tcfg.to_json())
    cli.main(["--manifest", corpus["noisy"], "--am-checkpoint", "seed:0",
              "--enhancer-checkpoint", "seed:1", "--clean-manifest", corpus["clean"],
              "--config", str(tmp_path / "cfg.json"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"noisy", "enhanced", "wer_delta", "si_snr"}
    ref_keys = set(jax_results["noisy"]) - {"per_utt"}
    assert set(line["noisy"]) == set(line["enhanced"]) == ref_keys
    assert set(line["si_snr"]) == set(jax_results["si_snr"])
    assert line["wer_delta"] == line["enhanced"]["wer"] - line["noisy"]["wer"]
    assert line["noisy"]["utterances"] == 5


@pytest.mark.parametrize("flags,road", [
    (["--lm", "lm.json"], "A10"), (["--word-lm", "w.json"], "A10"),
    (["--tune-lm-manifest", "dev.csv"], "A10"), (["--decoder", "beam"], "A10"),
    (["--decoder", "device"], "A13"), (["--am-checkpoint", "ckpt_am/"], "A9"),
    (["--enhancer-checkpoint", "ckpt_g/"], "A9")])
def test_unported_flags_raise(flags, road, tmp_path):
    """The flags of ROADMAP A9 (checkpoints), A10 (beam, LM fusion and
    tuning) and A13 (the device beam) are ported: each now fails only as the
    JAX CLI fails on the same missing inputs (a directory without
    config.json, a missing LM file, tuning without an LM, a missing
    manifest)."""
    argv = ["--manifest", str(tmp_path / "m.csv"), "--am-checkpoint", "seed:0",
            "--device", "cpu"]
    if road == "A9":
        with pytest.raises(FileNotFoundError, match="no config.json"):
            cli.main([*argv, flags[0], str(tmp_path / flags[1])])
        return
    if flags[0] == "--tune-lm-manifest":
        with pytest.raises(SystemExit, match="requires --lm"):
            cli.main([*argv, *flags])
        return
    missing = "m.csv"
    if flags[0] in ("--lm", "--word-lm"):
        flags, missing = [flags[0], str(tmp_path / flags[1])], flags[1]
    with pytest.raises(FileNotFoundError, match=missing):
        cli.main([*argv, *flags])


def test_unported_options_raise(corpus, nets):
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="unknown decoder"):
        teval.evaluate_wer(tcfg, nets[2], corpus["noisy"], decoder="beams")
    # The device decoder fuses a char LM only, as the JAX package's.
    with pytest.raises(ValueError, match="char-LM"):
        teval.evaluate_wer(tcfg, nets[2], corpus["noisy"], decoder="device",
                           word_lm=object())
    with pytest.raises(ValueError, match="char-LM"):
        teval.evaluate_wer(tcfg, nets[2], corpus["noisy"], decoder="device",
                           lm=tlm.WordNGramLM().fit_texts(["A B"]))
    augmenting = AudioDataset(corpus["noisy"], tcfg.audio, tconfig.DataConfig(augment=True))
    assert augmenting.data.augment and augmenting.noise is None      # no noise_dir
    assert [it["num_samples"] for it in augmenting.items] == [
        int(it["num_samples"] * 1.12) for it in AudioDataset(
            corpus["noisy"], tcfg.audio, tconfig.DataConfig()).items]
    # The streaming forward is ported (ROADMAP A11): JAX's enhancer_forward
    # with streaming=True on the same wav, 2 windows of 100 + 20 + 100 frames.
    wav = (0.1 * np.random.default_rng(9).standard_normal((2, 16800))).astype(np.float32)
    wl = np.array([16800, 9000], np.int32)
    from aas_enhancement_tpu.train.objectives import enhancer_forward as jax_enhancer_forward
    ref = jax_enhancer_forward(_cfgs()[0], nets[1], jnp.asarray(wav), jnp.asarray(wl),
                               streaming=True)
    with torch.no_grad():
        got = enhancer_forward(tcfg, nets[3], torch.from_numpy(wav), torch.from_numpy(wl),
                               streaming=True)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--manifest", "m.csv", "--am-checkpoint", "seed:0"])
