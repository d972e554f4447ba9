"""Port checkpoints (aas_enhancement_tpu_torch/utils/checkpoint.py,
train/loop.py::load_state) and the converter of the JAX package's Orbax
checkpoints (scripts/orbax_to_torch.py), on the CPU, at tiny widths.

Tolerances: a save/load round trip is exact (``torch.equal`` on every tensor
of every network and optimizer state).  The enhance CLIs of both packages on
one converted checkpoint write wavs within one PCM16 step (1/32767: both
round the same f32 output, which agrees to 1e-5, to 16 bits; a sample that
lies near a rounding edge may land on the step beside), and the enhancers
they load give the same output to 1e-5.  A converted checkpoint is held to the
JAX package's ``apply`` on the same parameters to 1e-5 (AM logits, enhancer
output: f32 sums in another order, values O(1)).  The evaluate CLI on a
converted checkpoint prints the JAX CLI's WER and CER exactly (greedy
hypotheses of logits that agree to ~1e-6).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.cli import enhance as jax_enhance_cli
from aas_enhancement_tpu.cli import evaluate as jax_eval_cli
from aas_enhancement_tpu.config import (AMConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig,
                                        TrainConfig)
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.models.am import AcousticModel as JaxAcousticModel
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.loop import train as jax_train
from aas_enhancement_tpu.utils import checkpoint as jckpt
from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
from aas_enhancement_tpu_torch.cli import evaluate as eval_cli
from aas_enhancement_tpu_torch.cli import train as train_cli
from aas_enhancement_tpu_torch.data.wav import read_wav
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.train.loop import init_state, load_state
from aas_enhancement_tpu_torch.train.steps import make_train_step
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "orbax_to_torch", os.path.join(REPO, "scripts", "orbax_to_torch.py"))
orbax_to_torch = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(orbax_to_torch)


def _cfg(objective, **train_kw):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=4, log_every=1, **train_kw),
        data=DataConfig(num_buckets=1))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([4000, 3300, 2500, 4000], np.int32)
    wav = (0.1 * rng.standard_normal((4, 4000))).astype(np.float32)
    wav *= np.arange(4000)[None] < lengths[:, None]
    labels = rng.integers(1, 7, size=(4, 8)).astype(np.int32)
    batch = {"wav": wav, "wav_lengths": lengths, "labels": labels,
             "label_paddings": np.zeros((4, 8), np.float32),
             "clean_wav": (0.1 * rng.standard_normal((4, 4000))).astype(np.float32),
             "clean_wav_lengths": np.array([4000, 4000, 3000, 2000], np.int32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _tensors(obj, prefix=""):
    """Every tensor of a (nested) state_dict, by path."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    items = obj.items() if isinstance(obj, dict) else enumerate(obj) \
        if isinstance(obj, (list, tuple)) else ()
    for k, v in items:
        out.update(_tensors(v, f"{prefix}/{k}"))
    return out


def _parts(state):
    return {n: getattr(state, n).state_dict() for n in ckpt.NETWORKS
            if getattr(state, n) is not None}


@pytest.mark.parametrize("objective", ["aas", "am", "paired"])
def test_save_restore_round_trip(tmp_path, objective):
    """Networks and optimizer states (Adam's moments and step, SGD's momentum
    buffers) come back bit for bit into a state drawn from another seed;
    three steps are kept, no ``.tmp`` directory stays, a step at or below
    the newest is skipped."""
    cfg = TConfig.from_json(_cfg(objective).to_json())
    state = init_state(cfg, 0, "cpu")
    step = make_train_step(cfg)
    for i in range(2):
        step(state, _batch(i))
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    for s in (1, 2, 3, 4, 5):
        state.step = s
        assert ckpt.save(d, s, state)
    assert not ckpt.save(d, 4, state) and not ckpt.save(d, 5, state)
    assert sorted(os.listdir(d)) == ["3", "4", "5"] and ckpt.latest_step(d) == 5
    saved = torch.load(os.path.join(d, "5", "state.pt"), weights_only=True)
    assert set(saved) == {"step"} | set(_parts(state))

    other = init_state(cfg, 9, "cpu")
    ckpt.restore(d, 5, other)
    assert other.step == 5
    want, got = _parts(state), _parts(other)
    for name in want:
        a, b = _tensors(want[name]), _tensors(got[name])
        assert a.keys() == b.keys() and a, name
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)
    opt = getattr(other, "am_opt" if objective == "am" else "g_opt")
    assert len(opt.state) == len(opt.param_groups[0]["params"])


def test_load_state_carries_networks_only(tmp_path):
    cfg = TConfig.from_json(_cfg("aas").to_json())
    state = init_state(cfg, 0, "cpu")
    make_train_step(cfg)(state, _batch())
    d = tmp_path / "ck"
    d.mkdir()
    (d / "config.json").write_text(cfg.to_json())
    ckpt.save(str(d), 1, state)
    got, got_cfg = load_state(str(d), "cpu")
    assert got_cfg == cfg and got.step == 1
    for name in ("g", "d", "am"):
        for (k, a), b in zip(getattr(state, name).state_dict().items(),
                             getattr(got, name).state_dict().values()):
            assert torch.equal(a, b), (name, k)
    assert got.g_opt is not None and not got.g_opt.state      # fresh, as in JAX


@pytest.mark.parametrize("objective,train_kw", [
    ("aas", {}), ("am", {}), ("paired", {}), ("acoustic", {}),
    ("am", {"am_through_enhancer": True})])
def test_load_state_builds_without_a_random_draw(tmp_path, monkeypatch, objective,
                                                 train_kw):
    """``load_state`` gives init_state's networks, modes and frozen flags
    with the saved tensors, fresh optimizers over them, and draws nothing:
    neither ``init_like_flax`` nor a QR runs (each counted), and the
    tensors are the ones read from the checkpoint (no copy)."""
    from aas_enhancement_tpu_torch import convert, enhance, evaluation
    from aas_enhancement_tpu_torch.train import loop

    cfg = TConfig.from_json(_cfg(objective, **train_kw).to_json())
    state = init_state(cfg, 0, "cpu")
    make_train_step(cfg)(state, _batch())
    d = tmp_path / "ck"
    d.mkdir()
    (d / "config.json").write_text(cfg.to_json())
    ckpt.save(str(d), 2, state)
    draws = []
    for mod in (convert, enhance, evaluation, loop):
        real = mod.init_like_flax
        monkeypatch.setattr(mod, "init_like_flax",
                            lambda *a, _r=real: draws.append("init") or _r(*a))
    real_qr = torch.linalg.qr
    monkeypatch.setattr(torch.linalg, "qr", lambda *a, **k: draws.append("qr") or real_qr(*a, **k))
    reads = []
    real_read = ckpt.read
    monkeypatch.setattr(ckpt, "read", lambda *a: reads.append(real_read(*a)) or reads[-1])
    got, _ = load_state(str(d), "cpu")
    assert draws == [] and got.step == 2
    for name in ("g", "d", "am"):
        want, net = getattr(state, name), getattr(got, name)
        assert (want is None) == (net is None), name
        if want is None:
            continue
        assert net.training == want.training, name
        for (k, a), (k2, b) in zip(want.named_parameters(), net.named_parameters()):
            assert k == k2 and torch.equal(a, b) and a.requires_grad == b.requires_grad
            assert b.data_ptr() == reads[0][name][k].data_ptr(), (name, k)
    for name in ("g_opt", "d_opt", "am_opt"):
        opt = getattr(got, name)
        assert (opt is None) == (getattr(state, name) is None), name
        if opt is not None:
            assert not opt.state
            net = getattr(got, name[:-4])
            assert [id(p) for p in opt.param_groups[0]["params"]] == [
                id(p) for p in net.parameters()]


def test_enhance_cli_from_a_checkpoint_draws_nothing(tmp_path, monkeypatch):
    """``cli.enhance --checkpoint``: no ``init_like_flax``, no QR, and the
    output of the saved weights (as before: a fresh enhancer of the config
    given the checkpoint's G)."""
    from aas_enhancement_tpu_torch import convert, enhance, evaluation
    from aas_enhancement_tpu_torch.enhance import make_enhance_fn
    from aas_enhancement_tpu_torch.train import loop

    cfg = TConfig.from_json(_cfg("paired").to_json())
    state = init_state(cfg, 3, "cpu")
    d = tmp_path / "ck"
    d.mkdir()
    (d / "config.json").write_text(cfg.to_json())
    ckpt.save(str(d), 1, state)
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=2, seed=4)
    draws = []
    for mod in (convert, enhance, evaluation, loop):
        real = mod.init_like_flax
        monkeypatch.setattr(mod, "init_like_flax",
                            lambda *a, _r=real: draws.append("init") or _r(*a))
    real_qr = torch.linalg.qr
    monkeypatch.setattr(torch.linalg, "qr", lambda *a, **k: draws.append("qr") or real_qr(*a, **k))
    out = tmp_path / "enh"
    enhance_cli.main(["--manifest", corpus["noisy"], "--out-dir", str(out),
                      "--checkpoint", str(d), "--device", "cpu"])
    assert draws == []
    from aas_enhancement_tpu_torch.data import read_manifest
    wav_path, _ = read_manifest(corpus["noisy"])[0]
    x, sr = read_wav(wav_path)
    y, _ = read_wav(str(out / os.path.basename(wav_path)))
    padded = np.zeros(enhance_cli._bucket_length(len(x), [sr * s for s in (2, 4, 8, 16)]),
                      np.float32)
    padded[:len(x)] = x
    ref = make_enhance_fn(cfg, "cpu")(state.g.eval(), torch.from_numpy(padded)[None],
                                      torch.tensor([len(x)]))[0, :len(x)].numpy()
    assert np.abs(y - ref).max() <= 1.0 / 32767 + 1e-6


def test_a_directory_without_config_or_step_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        load_state(str(tmp_path), "cpu")
    (tmp_path / "config.json").write_text(TConfig().to_json())
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_state(str(tmp_path), "cpu")


def test_an_orbax_directory_raises_naming_the_converter(tmp_path):
    """A JAX package's directory is refused, with the converter's name,
    before anything is loaded."""
    cfg = _cfg("am")
    d = str(tmp_path / "jax_ck")
    mgr = jckpt.make_manager(d)
    jckpt.save(mgr, 3, jax.device_get(jax_init_state(cfg, jax.random.key(0))))
    mgr.wait_until_finished()
    mgr.close()
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg.to_json())
    assert ckpt.latest_step(d) == 3
    with pytest.raises(ValueError, match="scripts/orbax_to_torch.py"):
        load_state(d, "cpu")
    state = init_state(TConfig.from_json(cfg.to_json()), 0, "cpu")
    before = [p.clone() for p in state.am.parameters()]
    with pytest.raises(ValueError, match="orbax_to_torch"):
        ckpt.restore(d, 3, state)
    assert all(torch.equal(a, b) for a, b in zip(before, state.am.parameters()))


def _jax_checkpoint(cfg, d, step, seed=0):
    """A JAX state saved as the JAX train CLI leaves it: Orbax + config.json."""
    jstate = jax_init_state(cfg, jax.random.key(seed))
    jstate = jstate.replace(step=jnp.asarray(step, jnp.int32))
    mgr = jckpt.make_manager(d)
    jckpt.save(mgr, step, jax.device_get(jstate))
    mgr.wait_until_finished()
    mgr.close()
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg.to_json())
    return jstate


@pytest.mark.parametrize("objective", ["am", "aas"])
def test_converted_checkpoint_matches_jax_apply(tmp_path, objective):
    """JAX init_state -> Orbax -> converter -> the port's load_state: the AM's
    logits and the enhancer's output equal JAX's apply to 1e-5, the step
    carries over, and resuming from it raises (no optimizer state)."""
    cfg = _cfg(objective)
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstate = _jax_checkpoint(cfg, src, 7)
    assert orbax_to_torch.convert(src, dst) == 7
    assert json.load(open(os.path.join(dst, "config.json"))) == json.loads(cfg.to_json())
    state, tcfg = load_state(dst, "cpu")
    assert state.step == 7 and tcfg == TConfig.from_json(cfg.to_json())
    assert (state.g is None) == (objective == "am") and (state.d is None) == (objective == "am")

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 30, 161)).astype(np.float32)
    lengths = np.array([30, 21], np.int32)
    ref, ref_len = JaxAcousticModel(cfg.am).apply(jstate.am_params, jnp.asarray(x),
                                                  jnp.asarray(lengths))
    with torch.no_grad():
        got, got_len = state.am(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    if objective == "aas":
        ref = JaxEnhancer(cfg.enhancer).apply(jstate.g_params, jnp.asarray(x),
                                              jnp.asarray(lengths))
        with torch.no_grad():
            got = state.g(torch.from_numpy(x), torch.from_numpy(lengths))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    fresh = init_state(tcfg, 0, "cpu")
    with pytest.raises(ValueError, match="no optimizer state"):
        ckpt.restore(dst, 7, fresh)
    with pytest.raises(FileExistsError):
        orbax_to_torch.convert(src, dst)


def test_jax_trained_checkpoint_evaluates_alike(tmp_path, capsys, monkeypatch):
    """The slice against JAX: two JAX ``am`` steps with a checkpoint dir (the
    JAX CLI's layout), converted; the port's evaluate CLI on the converted
    dir prints the JAX evaluate CLI's WER and CER on the JAX dir."""
    monkeypatch.setattr("aas_enhancement_tpu.utils.jax_cache.enable", lambda *a: None)
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=4, seed=5)
    cfg = _cfg("am", lr_am=0.05)
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstate = jax_init_state(cfg, jax.random.key(0))
    rng = np.random.default_rng(1)      # move the biases off 0: non-blank hypotheses
    jstate = jstate.replace(am_params=jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.3 * rng.standard_normal(a.shape).astype(np.float32)
                                   if a.ndim == 1 else 0.0), jax.device_get(jstate.am_params)))
    os.makedirs(src)
    with open(os.path.join(src, "config.json"), "w") as f:
        f.write(cfg.to_json())
    jax_train(cfg, corpus["clean"], max_steps=2, checkpoint_dir=src, state=jstate)
    assert orbax_to_torch.convert(src, dst) == 2

    jax_eval_cli.main(["--manifest", corpus["noisy"], "--am-checkpoint", src])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    eval_cli.main(["--manifest", corpus["noisy"], "--am-checkpoint", dst, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(ref) == {"noisy"}
    assert got["noisy"]["utterances"] == ref["noisy"]["utterances"] == 4
    for k in ("wer", "cer", "wer_ci95", "sample_ref", "sample_hyp"):
        assert got["noisy"][k] == ref["noisy"][k], k


def _wavs(d):
    return {n: read_wav(os.path.join(d, n))[0] for n in sorted(os.listdir(d))}


def test_jax_am_checkpoint_with_an_enhancer_converts_and_enhances(tmp_path, monkeypatch):
    """A JAX ``am`` state that carries a G (the JAX train CLI grafts a
    ``--g-checkpoint`` into any objective's state) converts with its G kept,
    frozen; the enhance CLIs of both packages on it write the same wavs."""
    monkeypatch.setattr("aas_enhancement_tpu.utils.jax_cache.enable", lambda *a: None)
    cfg = _cfg("am")
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    g_params = jax_init_state(_cfg("aas"), jax.random.key(4)).g_params
    jstate = jax_init_state(cfg, jax.random.key(0)).replace(
        g_params=g_params, step=jnp.asarray(3, jnp.int32))
    mgr = jckpt.make_manager(src)
    jckpt.save(mgr, 3, jax.device_get(jstate))
    mgr.wait_until_finished()
    mgr.close()
    with open(os.path.join(src, "config.json"), "w") as f:
        f.write(cfg.to_json())
    assert orbax_to_torch.convert(src, dst) == 3
    state, _ = load_state(dst, "cpu")
    assert state.am is not None and state.g is not None and state.g_opt is None
    assert not any(p.requires_grad for p in state.g.parameters())
    x = np.random.default_rng(2).standard_normal((2, 30, 161)).astype(np.float32)
    lengths = np.array([30, 17], np.int32)
    ref = JaxEnhancer(cfg.enhancer).apply(g_params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got = state.g(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=3, seed=6)
    jout, tout = str(tmp_path / "enh_jax"), str(tmp_path / "enh_torch")
    jax_enhance_cli.main(["--manifest", corpus["noisy"], "--out-dir", jout,
                          "--checkpoint", src])
    enhance_cli.main(["--manifest", corpus["noisy"], "--out-dir", tout, "--checkpoint", dst,
                      "--device", "cpu"])
    ref, got = _wavs(jout), _wavs(tout)
    assert list(got) == list(ref) and len(got) == 3
    for name in ref:
        assert got[name].shape == ref[name].shape
        assert np.abs(got[name] - ref[name]).max() <= 1.0 / 32767 + 1e-7, name


def test_am_run_with_a_g_checkpoint_saves_the_enhancer(tmp_path, capsys):
    """The port's ``am`` run keeps the ``--g-checkpoint``'s enhancer (without
    ``--am-through-enhancer``: frozen, never read by the step), so its
    checkpoint carries it and ``cli.enhance --checkpoint`` enhances."""
    corpus = generate_corpus(str(tmp_path / "corpus"), n_utts=4, seed=7)
    cfg = TConfig.from_json(_cfg("am").to_json())
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    d = str(tmp_path / "ck")
    train_cli.main(["--objective", "am", "--noisy-manifest", corpus["clean"], "--steps", "2",
                    "--batch-size", "2", "--config", str(path), "--am-checkpoint", "seed:0",
                    "--g-checkpoint", "seed:1", "--checkpoint-dir", d, "--device", "cpu"])
    state, _ = load_state(d, "cpu")
    assert state.step == 2 and state.g is not None
    want = init_enhancer(cfg, 1, "cpu").state_dict()
    assert all(torch.equal(v, state.g.state_dict()[k]) for k, v in want.items())
    out = str(tmp_path / "enh")
    enhance_cli.main(["--manifest", corpus["noisy"], "--out-dir", out, "--checkpoint", d,
                      "--device", "cpu"])
    assert len(os.listdir(out)) == 4
    capsys.readouterr()


def test_converted_paired_checkpoint_matches_jax_apply(tmp_path):
    """A JAX ``paired`` state (G + Adam) converts: the enhancer's output
    equals JAX's apply to 1e-5; the port's own paired state saves G + Adam."""
    cfg = _cfg("paired")
    src, dst = str(tmp_path / "jax"), str(tmp_path / "torch")
    jstate = _jax_checkpoint(cfg, src, 5)
    assert orbax_to_torch.convert(src, dst) == 5
    state, tcfg = load_state(dst, "cpu")
    assert state.step == 5 and state.d is None and state.am is None
    assert state.g_opt is not None and all(p.requires_grad for p in state.g.parameters())
    x = np.random.default_rng(4).standard_normal((2, 30, 161)).astype(np.float32)
    lengths = np.array([30, 12], np.int32)
    ref = JaxEnhancer(cfg.enhancer).apply(jstate.g_params, jnp.asarray(x),
                                          jnp.asarray(lengths))
    with torch.no_grad():
        got = state.g(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    own = init_state(tcfg, 0, "cpu")
    d = str(tmp_path / "own")
    ckpt.save(d, 1, own)
    assert set(torch.load(os.path.join(d, "1", "state.pt"), weights_only=True)) == {
        "step", "g", "g_opt"}
