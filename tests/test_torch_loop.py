"""The port's train loop around the step (aas_enhancement_tpu_torch/train/
loop.py, data/dataset.py, utils/metrics.py) and the CLI chain train ->
checkpoint -> evaluate / enhance, on the CPU, at tiny widths (AM 8 conv
channels + BiGRU-16, enhancer 8 channels + BiLSTM-12, D [8, 16], one bucket).

Tolerances: resume is exact on the CPU (4 uninterrupted steps and 2 + save +
resume + 2 give the same records and parameters bit for bit; every draw of
the step is keyed on (seed, step) or the restored optimizer state).  The
dataset's epochs and clean draws equal the JAX package's item for item.
Validation numbers equal the port's ``evaluate_wer`` called directly on the
same networks (the same code on the same inputs: exact).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import (AMConfig, AudioConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig,
                                        TrainConfig)
from aas_enhancement_tpu.data import dataset as jds
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.utils.metrics import MetricsLogger as JaxMetricsLogger
from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
from aas_enhancement_tpu_torch.cli import evaluate as eval_cli
from aas_enhancement_tpu_torch.cli import train as train_cli
from aas_enhancement_tpu_torch.config import AudioConfig as TAudio
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.config import DataConfig as TData
from aas_enhancement_tpu_torch.data import dataset as tds
from aas_enhancement_tpu_torch.evaluation import evaluate_wer
from aas_enhancement_tpu_torch.train import loop
from aas_enhancement_tpu_torch.train.loop import load_state, train
from aas_enhancement_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)


def _cfg(objective="aas", **train_kw):
    kw = dict(objective=objective, batch_size=2, log_every=1, epochs=10,
              checkpoint_every=2)
    kw.update(train_kw)
    return TConfig.from_json(Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(**kw),
        data=DataConfig(num_buckets=1)).to_json())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 utterances: 4 batches of 2 an epoch."""
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=8, seed=2)


@pytest.fixture(scope="module")
def corpus6(tmp_path_factory):
    """6 utterances of another length spread: 3 batches of 2 an epoch."""
    return generate_corpus(str(tmp_path_factory.mktemp("corpus6")), n_utts=6, seed=3)


def _losses(records):
    return {r["step"]: {k: v for k, v in r.items() if k.startswith("loss")}
            for r in records if "utts_per_sec" in r}


def _params(state):
    return {f"{n}.{k}": v for n in ("g", "d", "am") if getattr(state, n) is not None
            for k, v in getattr(state, n).state_dict().items()}


@pytest.mark.parametrize("objective,data,extra", [
    ("aas", "corpus", {}),
    ("am", "corpus", {"spec_augment": True}),
    ("aas", "corpus6", {"lr_anneal": 1.1})])     # resumes at step 2 of 3, crosses into epoch 1
def test_resume_is_exact(objective, data, extra, request, tmp_path):
    """4 uninterrupted steps == 2 steps + save + resume + 2 steps, bit for
    bit: the resumed records' losses and the final parameters (mirrors
    tests/test_checkpoint.py's resume tests of the JAX package)."""
    c = request.getfixturevalue(data)
    cfg = _cfg(objective, **extra)
    manifests = ((c["clean"], None) if objective == "am" else (c["noisy"], c["clean"]))
    full_state, full = train(cfg, *manifests, max_steps=4, device="cpu")
    ck = str(tmp_path / "ck")
    _, first = train(cfg, *manifests, max_steps=2, device="cpu", checkpoint_dir=ck)
    assert sorted(os.listdir(ck)) == ["2"]
    state, resumed = train(cfg, *manifests, max_steps=4, device="cpu",
                           checkpoint_dir=ck, resume=True)
    assert state.step == 4 and sorted(os.listdir(ck)) == ["2", "4"]
    want, got = _losses(full), _losses(first) | _losses(resumed)
    assert sorted(got) == [1, 2, 3, 4] and got == want
    assert [r["epoch"] for r in resumed] == [r["epoch"] for r in full[2:]]
    a, b = _params(full_state), _params(state)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _jax_ds(manifest):
    return jds.AudioDataset(manifest, AudioConfig(), DataConfig(num_buckets=2,
                                                                native_decode=False))


def _port_ds(manifest):
    return tds.AudioDataset(manifest, TAudio(), TData(num_buckets=2))


@pytest.mark.parametrize("epoch,drop_last,sorted_order", [
    (0, False, False), (1, False, False), (0, True, False), (1, True, True),
    (0, False, True)])
def test_epoch_chunks_match_jax(corpus, epoch, drop_last, sorted_order):
    ref = jds.epoch_chunks(_jax_ds(corpus["noisy"]), 3, 5, epoch, drop_last=drop_last,
                           sorted_order=sorted_order)
    got = tds.epoch_chunks(_port_ds(corpus["noisy"]), 3, 5, epoch, drop_last=drop_last,
                           sorted_order=sorted_order)
    assert [([it["wav"] for it in c], n) for c, n in got] == \
           [([it["wav"] for it in c], n) for c, n in ref]


@pytest.mark.parametrize("start", [0, 2])
def test_batches_start_matches_jax(corpus, start):
    """``start`` skips batches of the same epoch, undecoded, as in JAX."""
    ds = _jax_ds(corpus["noisy"])
    ref = list(ds.batches(3, seed=5, epoch=1, start=start))
    got = list(_port_ds(corpus["noisy"]).batches(3, seed=5, epoch=1, start=start))
    assert len(got) == len(ref) == ds.num_batches(3) - start
    for g, r in zip(got, ref):
        assert g.size == r.size
        for name in ("wav", "wav_lengths", "labels", "label_paddings"):
            np.testing.assert_array_equal(getattr(g, name), getattr(r, name), name)


def test_clean_stream_skip_matches_jax(corpus):
    """skip() draws what next_batch draws: after the same mix of skips and
    batches both streams serve the same batch and count the same draws."""
    ref = jds.UnpairedCleanStream(_jax_ds(corpus["clean"]), 3, seed=4)
    got = tds.UnpairedCleanStream(_port_ds(corpus["clean"]), 3, seed=4)
    for op in ("skip", "next", "skip", "skip", "next"):
        if op == "skip":
            ref.skip()
            got.skip()
        else:
            a, b = got.next_batch(48000), ref.next_batch(48000)
            for name in ("wav", "wav_lengths", "labels"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)
    assert got._draws == ref._draws == 5


def test_sortagrad_sorts_epoch_zero_only(corpus, monkeypatch):
    """With sortagrad the loop asks for epoch 0 shortest-first and for epoch
    1 in the shuffled order."""
    asked = []
    real = tds.AudioDataset.batches

    def spy(self, batch_size, seed=0, epoch=0, drop_last=False, sorted_order=False,
            start=0):
        asked.append((epoch, sorted_order))
        return real(self, batch_size, seed, epoch, drop_last, sorted_order, start)

    monkeypatch.setattr(tds.AudioDataset, "batches", spy)
    train(_cfg("am", sortagrad=True, epochs=2), corpus["clean"], max_steps=5, device="cpu")
    assert asked == [(0, True), (1, False)]
    ds = _port_ds(corpus["clean"])
    lens = [it["num_samples"] for c, _ in tds.epoch_chunks(ds, 2, 0, 0, sorted_order=True)
            for it in c]
    assert lens == sorted(lens)


@pytest.mark.parametrize("objective", ["aas", "am"])
def test_prefetch_keeps_the_records(corpus, objective):
    """A producer thread two batches ahead gives the synchronous loop's
    records and parameters."""
    manifests = ((corpus["clean"], None) if objective == "am"
                 else (corpus["noisy"], corpus["clean"]))
    out = []
    for depth in (0, 2):
        state, records = train(_cfg(objective, prefetch=depth), *manifests, max_steps=3,
                               device="cpu")
        out.append((_losses(records), _params(state)))
    assert out[0][0] == out[1][0] and sorted(out[0][0]) == [1, 2, 3]
    for k in out[0][1]:
        assert torch.equal(out[0][1][k], out[1][1][k]), k


def test_prefetched_stops_its_producer_and_reraises():
    made = []

    def gen():
        for i in range(100):
            made.append(i)
            yield i

    it = loop._prefetched(gen(), 2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()                                    # joins the producer
    assert len(made) <= 6

    def bad():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(loop._prefetched(bad(), 2))


@pytest.mark.parametrize("objective", ["aas", "am"])
def test_validator_records_and_best_checkpoint(corpus, objective, tmp_path):
    """Validation every 2 steps: val_wer / val_cer equal evaluate_wer on the
    state's networks (the aas leg enhances; its noisy WER is logged beside),
    the best step's state is kept in best_ckpt/ with best.json."""
    ck = str(tmp_path / "ck")
    cfg = _cfg(objective, eval_every=2, eval_batch_size=3)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, val_manifest=corpus["noisy"]))
    manifests = ((corpus["clean"], None) if objective == "am"
                 else (corpus["noisy"], corpus["clean"]))
    state, records = train(cfg, *manifests, max_steps=3, device="cpu", checkpoint_dir=ck)
    vals = [r for r in records if "val_wer" in r]
    assert [r["step"] for r in vals] == [2, 3]           # every 2 steps and the last
    enh = state.g if objective == "aas" else None
    ref = evaluate_wer(cfg, state.am, corpus["noisy"], enhancer=enh, batch_size=3)
    assert vals[-1]["val_wer"] == ref["wer"] and vals[-1]["val_cer"] == ref["cer"]
    if objective == "aas":
        noisy = evaluate_wer(cfg, state.am, corpus["noisy"], batch_size=3)["wer"]
        assert all(r["val_wer_noisy"] == noisy for r in vals)
    else:
        assert all("val_wer_noisy" not in r for r in vals)
    best = json.load(open(os.path.join(ck, "best.json")))
    assert best["step"] == min(vals, key=lambda r: r["val_wer"])["step"]
    assert best["val_wer"] == min(r["val_wer"] for r in vals)
    assert os.listdir(os.path.join(ck, "best_ckpt")) == [str(best["step"])]


def test_profile_dir_writes_a_trace(corpus, tmp_path):
    prof = str(tmp_path / "prof")
    train(_cfg("am", profile_dir=prof, profile_start=1, profile_steps=2),
          corpus["clean"], max_steps=4, device="cpu")
    (name,) = os.listdir(prof)
    assert name == "steps_2-3.pt.trace.json"
    events = json.load(open(os.path.join(prof, name)))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


def test_profile_stops_when_training_ends_inside_the_window(corpus, tmp_path):
    prof = str(tmp_path / "prof")
    train(_cfg("am", profile_dir=prof, profile_start=2, profile_steps=5),
          corpus["clean"], max_steps=3, device="cpu")
    assert os.listdir(prof) == ["steps_3-3.pt.trace.json"]


def test_metrics_logger_lines_carry_the_jax_keys(tmp_path, capsys, monkeypatch):
    """The same keys and rounding as the JAX logger; --metrics appends the
    lines; without a TensorBoard writer the JSONL stays, with a note."""
    for mod in ("torch.utils.tensorboard", "tensorflow"):
        monkeypatch.setitem(sys.modules, mod, None)
    lines = []
    for cls, name in ((JaxMetricsLogger, "jax.jsonl"), (MetricsLogger, "port.jsonl")):
        lg = cls(str(tmp_path / name), tensorboard_dir=str(tmp_path / "tb"))
        lg.log(3, epoch=1, loss=1.23456789, name="x")
        lg.close()
        lines.append(json.loads(open(tmp_path / name).read()))
    ref, got = lines
    assert list(got) == list(ref) == ["step", "t", "epoch", "loss", "name"]
    assert {k: v for k, v in got.items() if k != "t"} == \
           {k: v for k, v in ref.items() if k != "t"}
    err = capsys.readouterr().err
    assert "JSONL only" in err and json.loads(err.strip().splitlines()[-1])["loss"] == 1.234568


def _write(path, cfg):
    path.write_text(cfg.to_json())
    return str(path)


def test_cli_chain_train_checkpoint_evaluate_enhance(corpus, tmp_path, capsys):
    """cli.train am -> checkpoint dir; cli.train aas --am-checkpoint DIR with
    validation; cli.evaluate with both dirs; cli.enhance --checkpoint.  The
    config sections are grafted as the JAX CLIs graft them: the frozen AM
    keeps its checkpoint's architecture, and evaluate / enhance without
    --config take the checkpoints' sections."""
    am_dir, g_dir = str(tmp_path / "am"), str(tmp_path / "g")
    am_cfg = _cfg("am")
    am_cfg = am_cfg.replace(am=dataclasses.replace(am_cfg.am, rnn_layers=2))
    train_cli.main(["--objective", "am", "--noisy-manifest", corpus["clean"], "--steps", "2",
                    "--config", _write(tmp_path / "am.json", am_cfg), "--checkpoint-dir",
                    am_dir, "--am-checkpoint", "seed:0", "--device", "cpu",
                    "--metrics", str(tmp_path / "am.jsonl")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["final_step"] == 2 and sorted(os.listdir(am_dir)) == ["2", "config.json"]
    assert [json.loads(s)["step"] for s in open(tmp_path / "am.jsonl")] == [1, 2]

    g_cfg = _cfg("aas")                           # its AM section is 1 layer
    train_cli.main(["--objective", "aas", "--noisy-manifest", corpus["noisy"],
                    "--clean-manifest", corpus["clean"], "--steps", "2",
                    "--config", _write(tmp_path / "g.json", g_cfg),
                    "--am-checkpoint", am_dir, "--checkpoint-dir", g_dir,
                    "--val-manifest", corpus["noisy"], "--eval-every", "1",
                    "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert {"val_wer", "val_wer_noisy", "loss_g"} <= set(line) and line["final_step"] == 2
    written = json.load(open(os.path.join(g_dir, "config.json")))
    assert written["am"] == json.loads(am_cfg.to_json())["am"]          # grafted
    assert written["enhancer"] == json.loads(g_cfg.to_json())["enhancer"]
    assert written["data"]["val_manifest"] == corpus["noisy"]
    g_state, _ = load_state(g_dir, "cpu")
    am_state, _ = load_state(am_dir, "cpu")
    for (k, a), b in zip(am_state.am.state_dict().items(), g_state.am.state_dict().values()):
        assert torch.equal(a, b), k                   # the frozen AM is the checkpoint's
    assert {"best.json", "best_ckpt", "2"} <= set(os.listdir(g_dir))

    eval_cli.main(["--manifest", corpus["noisy"], "--am-checkpoint", am_dir,
                   "--enhancer-checkpoint", g_dir, "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"noisy", "enhanced", "wer_delta"}
    cfg = TConfig().replace(am=am_cfg.am, audio=am_cfg.audio, enhancer=g_cfg.enhancer)
    ref = evaluate_wer(cfg, am_state.am, corpus["noisy"], enhancer=g_state.g)
    assert res["enhanced"]["wer"] == ref["wer"] and res["enhanced"]["cer"] == ref["cer"]

    enhance_cli.main(["--manifest", corpus["noisy"], "--out-dir", str(tmp_path / "enh"),
                      "--checkpoint", g_dir, "--device", "cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["utterances"] == 8 and len(os.listdir(tmp_path / "enh")) == 8


def test_cli_g_checkpoint_carries_g_and_d(corpus, tmp_path, capsys):
    """--g-checkpoint DIR warm-starts G and, for aas, D (at lr 0 the run's
    saved networks are the checkpoint's); --continue-from on it resumes."""
    src, dst = str(tmp_path / "src"), str(tmp_path / "dst")
    cfg = _cfg("aas")
    path = _write(tmp_path / "c.json", cfg)
    base = ["--objective", "aas", "--noisy-manifest", corpus["noisy"], "--clean-manifest",
            corpus["clean"], "--device", "cpu"]
    train_cli.main([*base, "--steps", "1", "--config", path, "--checkpoint-dir", src])
    frozen = cfg.replace(train=dataclasses.replace(cfg.train, lr_g=0.0, lr_d=0.0))
    train_cli.main([*base, "--steps", "1", "--config", _write(tmp_path / "z.json", frozen),
                    "--g-checkpoint", src, "--checkpoint-dir", dst])
    capsys.readouterr()
    a, b = load_state(src, "cpu")[0], load_state(dst, "cpu")[0]
    for n in ("g", "d"):
        for (k, x), y in zip(getattr(a, n).state_dict().items(),
                             getattr(b, n).state_dict().values()):
            assert torch.equal(x, y), (n, k)
    train_cli.main([*base, "--steps", "2", "--config", path, "--checkpoint-dir", src,
                    "--continue-from"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_step"] == 2
