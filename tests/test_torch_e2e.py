"""The port's end-to-end quality protocol (aas_enhancement_tpu_torch/cli/e2e.py)
against the JAX repo's scripts/e2e_demo.py, on the CPU.

- The orchestration: both run with the same small argv and every package
  function they call (train, init_state, evaluate_wer, grid_search_lm,
  grid_search_hybrid, enhance_stream, evaluate_si_snr, the LM constructors)
  replaced by a recorder that returns the same stubs on both sides.  The
  calls must come in the same order with the same arguments (configuration
  as a dict, manifests relative to the workdir, steps, batch sizes,
  decoders, beam widths, LM orders, the tuned weights passed on) and the
  results must be equal (exactly: the same stubs combined the same way).
- The trajectory: ``train`` of the ``am`` and ``aas`` objectives for 5 steps
  (an epoch of 4 batches and one more) at small widths on a synthetic
  corpus, the port started from JAX's own initial state
  (``init_state(cfg, jax.random.key(cfg.train.seed))``, carried across with
  convert.py), optimizer state zero on both sides.  Tolerances (f32 on both
  sides; JAX takes its XLA scans and GroupNorm, the port its plain
  versions, so every sum runs in another order and the difference grows
  with each step):
  - every record's losses: rtol 1e-3 (CTC ~100-300 after 5 updates that
    each carry the previous steps' rounding);
  - ``am`` final parameters (SGD + Nesterov: linear in the gradient): atol
    1e-4 of the tensor's largest entry plus 1e-5;
  - ``aas`` final parameters (Adam, b1 0.5): within 1e-2 lr of JAX's (the
    largest measured: 3.4e-3 lr), but for G's conv biases ahead of a
    GroupNorm of one channel a group: the normalization removes them, so
    their true gradient is 0 and both sides' is rounding noise, which Adam
    scales to steps of about lr of either sign.  Those are held to the most
    two Adam runs can part in 5 steps, 2 x sum_t max|update_t| / lr =
    ~12 lr (Cauchy-Schwarz on m against v; eps only shrinks a step); the
    largest measured: 5.7 lr.
- A real tiny run on the CPU (8 / 4 / 4 utterances, 3 AM and 2 AAS steps,
  batch 4, the protocol's widths): every key of the JAX result, the AM
  after AAS equal to the AM after pre-training bit for bit, a checkpoint
  that ``load_state`` opens, ``sweep_state.json`` naming files that exist;
  and ``--device cuda`` without a GPU raises.
"""

import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import (AMConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig,
                                        TrainConfig)
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.decode import lm as jlm
from aas_enhancement_tpu.train import loop as jloop
from aas_enhancement_tpu_torch.cli import e2e
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.decode import lm as tlm
from aas_enhancement_tpu_torch.train import loop as tloop
from aas_enhancement_tpu_torch.train.state import TrainState
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt
from torch_recorder import (REPO, Recorder, adam_travel, cfg_dict, load_jax_script,
                            port_params, port_state, run_jax_script)

torch.set_num_threads(1)

ARGV = ["--n-utts", "6", "--n-dev-utts", "3", "--n-test-utts", "3", "--am-steps", "7",
        "--aas-steps", "5", "--batch-size", "2", "--spec-augment", "--snr-low", "-5",
        "--snr-high", "5", "--lambda-adv", "0.3"]
TINY = ["--n-utts", "8", "--n-dev-utts", "4", "--n-test-utts", "4", "--am-steps", "3",
        "--aas-steps", "2", "--batch-size", "4", "--device", "cpu"]


def _jax_result_keys():
    with open(os.path.join(REPO, "e2e_result_r5.json")) as f:
        return set(json.load(f)) - {"wall_minutes"}


# ---------------------------------------------------------------- orchestration

def _stub_jax(monkeypatch, rec: Recorder):
    from aas_enhancement_tpu import evaluation, streaming
    from aas_enhancement_tpu.decode import tune

    am = rec.tag({"am": np.ones(2, np.float32)}, "am")
    g = rec.tag({"g": np.ones(2, np.float32)}, "g")

    def train(cfg, noisy, clean=None, max_steps=0, state=None, **kw):
        assert not kw
        objective = cfg.train.objective
        rec.add("train", cfg_dict(cfg), rec.rel(noisy), rec.rel(clean), max_steps,
                rec.name(state.am_params) if state is not None else None)
        if objective == "am":
            return types.SimpleNamespace(am_params=am), [{"loss_ctc_am": 200.0},
                                                         {"loss_ctc_am": 0.5}]
        state.g_params = g
        return state, [{"loss_ctc": 30.0}, {"loss_ctc": 0.25}]

    def init_state(cfg, rng, am_params=None):
        seed = int(np.asarray(jax.random.key_data(rng))[-1])
        rec.add("init_state", cfg_dict(cfg), seed)
        return types.SimpleNamespace(am_params=am_params, g_params=None)

    monkeypatch.setattr(jloop, "train", train)
    monkeypatch.setattr(jloop, "init_state", init_state)
    monkeypatch.setattr(evaluation, "evaluate_wer",
                        lambda cfg, am_params, manifest, g_params=None, **kw:
                        rec.evaluate_wer(cfg, am_params, manifest, g_params, kw))
    monkeypatch.setattr(evaluation, "evaluate_si_snr",
                        lambda cfg, noisy, clean, g_params=None, streamed_manifest=None:
                        rec.evaluate_si_snr(cfg, noisy, clean, g_params, streamed_manifest))
    monkeypatch.setattr(tune, "grid_search_lm",
                        lambda cfg, am_params, dev, lm, g_params=None, **kw:
                        rec.grid_search_lm(cfg, am_params, dev, lm, g_params, kw))
    monkeypatch.setattr(tune, "grid_search_hybrid",
                        lambda cfg, am_params, dev, clm, wlm, g_params=None, **kw:
                        rec.grid_search_hybrid(cfg, am_params, dev, clm, wlm, g_params, kw))
    monkeypatch.setattr(streaming, "enhance_stream",
                        lambda cfg, params, samples: rec.enhance_stream(cfg, params, samples))
    monkeypatch.setattr(jlm.WordNGramLM, "from_manifests",
                        classmethod(lambda cls, paths: rec.lm("wlm", paths)))
    monkeypatch.setattr(jlm.CharNGramLM, "from_manifests",
                        classmethod(lambda cls, paths, order=3: rec.lm("clm", paths, order)))


def _stub_port(monkeypatch, rec: Recorder):
    am = rec.tag(torch.nn.Linear(1, 1), "am")
    g = rec.tag(torch.nn.Linear(1, 1), "g")

    def train(cfg, noisy, clean=None, max_steps=0, state=None, device="cuda"):
        assert torch.device(device) == torch.device("cpu")
        objective = cfg.train.objective
        rec.add("train", cfg_dict(cfg), rec.rel(noisy), rec.rel(clean), max_steps,
                rec.name(state.am) if state is not None else None)
        if objective == "am":
            return TrainState(step=max_steps, am=am), [{"loss_ctc_am": 200.0},
                                                       {"loss_ctc_am": 0.5}]
        state.g, state.step = g, max_steps
        return state, [{"loss_ctc": 30.0}, {"loss_ctc": 0.25}]

    def init_state(cfg, seed, device="cuda"):
        rec.add("init_state", cfg_dict(cfg), seed)
        return TrainState(g=torch.nn.Linear(1, 1), d=torch.nn.Linear(1, 1),
                          am=torch.nn.Linear(1, 1))

    monkeypatch.setattr(e2e, "train", train)
    monkeypatch.setattr(e2e, "init_state", init_state)
    monkeypatch.setattr(e2e, "evaluate_wer",
                        lambda cfg, am, manifest, enhancer=None, **kw:
                        rec.evaluate_wer(cfg, am, manifest, enhancer, kw))
    monkeypatch.setattr(e2e, "evaluate_si_snr",
                        lambda cfg, noisy, clean, enhancer=None, streamed_manifest=None:
                        rec.evaluate_si_snr(cfg, noisy, clean, enhancer, streamed_manifest))
    monkeypatch.setattr(e2e, "grid_search_lm",
                        lambda cfg, am, dev, lm, enhancer=None, **kw:
                        rec.grid_search_lm(cfg, am, dev, lm, enhancer, kw))
    monkeypatch.setattr(e2e, "grid_search_hybrid",
                        lambda cfg, am, dev, clm, wlm, enhancer=None, **kw:
                        rec.grid_search_hybrid(cfg, am, dev, clm, wlm, enhancer, kw))
    monkeypatch.setattr(e2e, "enhance_stream",
                        lambda cfg, model, samples, device="cuda":
                        rec.enhance_stream(cfg, model, samples))
    monkeypatch.setattr(tlm.WordNGramLM, "from_manifests",
                        classmethod(lambda cls, paths: rec.lm("wlm", paths)))
    monkeypatch.setattr(tlm.CharNGramLM, "from_manifests",
                        classmethod(lambda cls, paths, order=3: rec.lm("clm", paths, order)))


def _run_jax_script(monkeypatch, tmp_path, argv):
    run_jax_script(monkeypatch, tmp_path, load_jax_script("e2e_demo"), argv)


@pytest.mark.parametrize("argv", [ARGV, ["--n-utts", "4", "--n-dev-utts", "2",
                                         "--n-test-utts", "2", "--ablation", "--am-steps",
                                         "3", "--skip-streaming"]],
                         ids=["flags", "ablation_skip_streaming"])
def test_protocol_matches_jax_script(argv, tmp_path, monkeypatch, capsys):
    """The same calls, configurations, hand-offs and result as the JAX script."""
    jwd, twd = tmp_path / "jax", tmp_path / "port"
    jrec, trec = Recorder(str(jwd)), Recorder(str(twd))
    with monkeypatch.context() as m:
        _stub_jax(m, jrec)
        _run_jax_script(m, tmp_path, [*argv, "--workdir", str(jwd)])
    jax_stdout = capsys.readouterr().out.splitlines()
    with monkeypatch.context() as m:
        _stub_port(m, trec)
        port = e2e.main([*argv, "--workdir", str(twd), "--device", "cpu"])
    port_stdout = capsys.readouterr().out.splitlines()

    assert trec.calls == jrec.calls
    stages = [c[0] for c in trec.calls]
    assert stages[:3] == ["train", "evaluate_wer", "evaluate_wer"]
    assert stages[3:5] == ["init_state", "train"]
    assert trec.calls[4][-1] == "am"                    # AAS ran with the pre-trained AM
    if "--skip-streaming" in argv:
        assert "enhance_stream" not in stages and "evaluate_si_snr" not in stages
    else:
        assert stages.count("enhance_stream") == 3 and stages[-1] == "evaluate_si_snr"
    jax_result = json.loads(jax_stdout[-1])
    assert json.loads(port_stdout[-1]) == port
    assert port.pop("wall_minutes") >= 0 and jax_result.pop("wall_minutes") >= 0
    assert port == jax_result
    if "--ablation" in argv:
        assert port_stdout[:-1] == jax_stdout[:-1]       # the banner
        assert (port["n_utts"], port["am_steps"], port["aas_steps"]) == (4, 3, 300)
    else:
        assert set(port) == _jax_result_keys() | {"spec_augment"}
    for name in ("result.json",):
        with open(twd / name) as f, open(jwd / name) as g:
            a, b = json.load(f), json.load(g)
        assert a.pop("wall_minutes") >= 0 and b.pop("wall_minutes") >= 0 and a == b
    with open(twd / "sweep_state.json") as f, open(jwd / "sweep_state.json") as g:
        a, b = json.load(f), json.load(g)
    assert os.path.relpath(a.pop("checkpoint"), twd) == "checkpoint"
    assert os.path.relpath(b.pop("params_pkl"), jwd) == "trained_params.pkl"
    assert {k: os.path.relpath(v, twd) for k, v in a.items()} == \
           {k: os.path.relpath(v, jwd) for k, v in b.items()}
    if "--skip-streaming" not in argv:
        names = sorted(os.listdir(jwd / "streamed"))
        assert sorted(os.listdir(twd / "streamed")) == names
        for name in names:                       # the wavs cut to length, the manifest
            a, b = ((wd / "streamed" / name).read_bytes().replace(str(wd).encode(), b"WD")
                    for wd in (twd, jwd))
            assert a == b, name


# ---------------------------------------------------------------- trajectory

STEPS = 5


def _smallcfg_dict(objective):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=2, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=2, epochs=100, log_every=1,
                          lr_am=6e-4, lr_g=3e-4, lr_d=3e-4, lambda_adv=0.2),
        data=DataConfig(num_buckets=2))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 utterances of the protocol's language: 4 batches of 2 an epoch."""
    return generate_corpus(str(tmp_path_factory.mktemp("e2e_corpus")), n_utts=8, seed=7,
                           n_words=(3, 8), snr_range=(0.0, 10.0), reverb_prob=0.3)


@pytest.mark.parametrize("objective", ["am", "aas"])
def test_trajectory_matches_jax(objective, corpus):
    cfg = _smallcfg_dict(objective)
    manifests = ((corpus["clean"],) if objective == "am"
                 else (corpus["noisy"], corpus["clean"]))
    start = port_params(jloop.init_state(cfg, jax.random.key(cfg.train.seed)))
    jstate, jrecs = jloop.train(cfg, *manifests, max_steps=STEPS)
    tcfg = TConfig.from_json(cfg.to_json())
    state, recs = tloop.train(tcfg, *manifests, max_steps=STEPS,
                              state=port_state(tcfg, start), device="cpu")

    assert state.step == STEPS
    assert [r["step"] for r in recs] == [r["step"] for r in jrecs] == list(range(1, STEPS + 1))
    for r, j in zip(recs, jrecs):
        losses = {k for k in j if k.startswith("loss")}
        assert losses and losses <= set(r), (losses, r)
        for k in losses:
            assert r[k] == pytest.approx(j[k], rel=1e-3), (r["step"], k)
    end = port_params(jstate)
    assert set(end) == set(start)
    lr = cfg.train.lr_g                     # = lr_d
    travel = 2 * adam_travel(STEPS, cfg.train.adam_b1, cfg.train.adam_b2) * lr
    for name, ref in end.items():
        got = getattr(state, name).state_dict()
        assert set(got) == set(ref)
        for k, r in ref.items():
            g, r = got[k].numpy(), r.numpy()
            if objective == "am" or name == "am":
                np.testing.assert_allclose(g, r, rtol=0,
                                           atol=1e-4 * np.abs(r).max() + 1e-5,
                                           err_msg=f"{name}.{k}")
            elif name == "g" and k.startswith("convs.") and k.endswith(".bias"):
                assert np.abs(g - r).max() <= travel, (name, k)
            else:
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-2 * lr,
                                           err_msg=f"{name}.{k}")
    if objective == "aas":          # the frozen AM did not move on either side
        for k, r in start["am"].items():
            assert torch.equal(state.am.state_dict()[k], r), k


# ---------------------------------------------------------------- a real tiny run

def test_tiny_run_on_cpu(tmp_path, monkeypatch):
    """The whole protocol with the plain versions at the protocol's widths."""
    wd = tmp_path / "wd"
    ams = []
    real_train = e2e.train

    def train(cfg, *a, **kw):
        state, recs = real_train(cfg, *a, **kw)
        ams.append({k: v.clone() for k, v in state.am.state_dict().items()})
        return state, recs

    monkeypatch.setattr(e2e, "train", train)
    result, walls = e2e.run(e2e.parse_args([*TINY, "--workdir", str(wd)]))

    assert set(result) == _jax_result_keys() | {"wall_minutes"}
    assert list(walls) == ["am", "wer_noisy", "aas", "wer_enhanced", "beam_lm",
                           "beam_hybrid", "wer_train", "streamed", "si_snr"]
    for k, v in result.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
    assert 0.0 <= result["wer_clean_test"] and result["am_ctc_first"] > 0
    pre, after = ams                                 # AM after pre-training, after AAS
    assert pre.keys() == after.keys()
    for k in pre:
        assert torch.equal(pre[k], after[k]), k

    with open(wd / "sweep_state.json") as f:
        sweep = json.load(f)
    for key, path in sweep.items():
        assert os.path.exists(path), key
    state, cfg = tloop.load_state(sweep["checkpoint"], "cpu")
    assert state.step == 2 and cfg.train.objective == "aas"
    assert cfg_dict(cfg) == cfg_dict(e2e.cfg_for("aas", 4, 0.2))
    for k, v in state.am.state_dict().items():
        assert torch.equal(v, pre[k]), k
    blob = ckpt.read(sweep["checkpoint"], 2)
    assert {"g", "g_opt", "d", "d_opt", "am"} <= set(blob)
    assert blob["g_opt"]["state"], "the checkpoint carries Adam's moments"
    with open(wd / "result.json") as f:
        assert json.load(f) == json.loads(json.dumps(result))
    streamed = sorted(os.listdir(wd / "streamed"))
    assert len(streamed) == 4 + 1                  # the wavs and their manifest


def test_cuda_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        e2e.main([*TINY[:-2], "--workdir", str(tmp_path), "--device", "cuda"])
    assert not os.path.exists(tmp_path / "corpus")      # raised before any work
