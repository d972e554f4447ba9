"""Port parity: the generator objectives' train step (aas_enhancement_tpu_torch
.train) against the JAX package's make_train_step on the CPU, from the same
converted parameters and the same batch, and the port's train CLI.

Tolerances (f32 on both sides; the JAX step takes its XLA scans and XLA
GroupNorm on the CPU, the port its plain versions, so every sum runs in
another order):
- metrics: rtol 1e-4 (CTC ~50-150 summed over ~25 frames of log-sum-exp);
- gradients: rtol 1e-4 plus atol 2e-5 * max|g| over the network (G or D):
  the G gradient passes back through CTC's alpha recursion, the AM's BiGRU,
  GroupNorms and convs, then the enhancer's, and differences of near-equal
  terms leave absolute noise at ~1e-6 of the network's largest entry (a conv
  bias in front of a one-channel-per-group GroupNorm has a true gradient of
  0, and both sides give ~1e-7 there);
- updated parameters: the first Adam step moves each entry by
  lr * g / (|g| + 1e-8), +-lr wherever |g| >> 1e-8, so the update is held
  to JAX's with rtol 1e-3 on entries whose JAX gradient exceeds 1e-3 of the
  network's max|g| (elsewhere rounding noise in g may flip its sign), and to
  |update| <= lr everywhere.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import (AMConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig,
                                        TrainConfig)
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch.cli import train as train_cli
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import (am_params_from_flax, disc_params_from_flax,
                                               enhancer_params_from_flax)
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.train.loop import init_state
from aas_enhancement_tpu_torch.train.state import TrainState, adam, clip_by_global_norm
from aas_enhancement_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

METRIC_RTOL = 1e-4
CONVERT = {"g": enhancer_params_from_flax, "d": disc_params_from_flax}


def _cfg(objective, **train_kw):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective=objective, batch_size=4, log_every=1, **train_kw),
        data=DataConfig(num_buckets=1))


def _batch(seed=0, weights=None, clean_weights=None):
    rng = np.random.default_rng(seed)
    b, n = 4, 4000
    lengths = np.array([4000, 3300, 2500, 4000], np.int32)
    wav = (0.1 * rng.standard_normal((b, n))).astype(np.float32)
    wav *= np.arange(n)[None] < lengths[:, None]
    labels = rng.integers(1, 7, size=(b, 8)).astype(np.int32)
    label_pad = np.zeros((b, 8), np.float32)
    label_pad[1, 5:] = 1.0
    label_pad[2, 3:] = 1.0
    batch = {"wav": wav, "wav_lengths": lengths, "labels": labels,
             "label_paddings": label_pad,
             "clean_wav": (0.1 * rng.standard_normal((b, n))).astype(np.float32),
             "clean_wav_lengths": np.array([4000, 4000, 3000, 2000], np.int32)}
    if weights is not None:
        batch["row_weights"] = np.array(weights, np.float32)
        batch["clean_row_weights"] = np.array(clean_weights, np.float32)
    return batch


def _torch_state(cfg, jstate):
    tcfg = TConfig.from_json(cfg.to_json())
    f = tcfg.audio.num_bins
    state = TrainState()
    state.g = Enhancer(tcfg.enhancer, f)
    state.g.load_state_dict(enhancer_params_from_flax(jax.device_get(jstate.g_params)))
    state.g_opt = adam(tcfg, state.g.parameters(), tcfg.train.lr_g)
    if jstate.d_params:
        state.d = Discriminator(tcfg.discriminator, f)
        state.d.load_state_dict(disc_params_from_flax(jax.device_get(jstate.d_params)))
        state.d_opt = adam(tcfg, state.d.parameters(), tcfg.train.lr_d)
    if jstate.am_params:
        state.am = AcousticModel(tcfg.am, f)
        state.am.load_state_dict(am_params_from_flax(jax.device_get(jstate.am_params)))
        state.am.requires_grad_(False)
    return tcfg, state


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _net_scale(grads):
    return max(float(g.abs().max()) for g in grads.values())


def _assert_grads_close(got, ref, what):
    scale = _net_scale(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-4,
                                   atol=2e-5 * scale, err_msg=f"{what} {name}")


@pytest.mark.parametrize("objective", ["aas", "acoustic", "adversarial"])
def test_step_matches_jax(objective):
    cfg = _cfg(objective)
    jstate = jax_init_state(cfg, jax.random.key(0))
    jstep = jax_make_train_step(cfg)
    batch = _batch(seed=1)
    jgrads, jaux = jax.jit(jstep.batch_grads)(jstate, batch)
    jnew, jaux_step = jax.jit(jstep)(jstate, batch)

    tcfg, state = _torch_state(cfg, jstate)
    step = make_train_step(tcfg)
    tbatch = _to_torch(batch)
    grads, aux = step.batch_grads(state, tbatch)
    before = {net: {n: p.detach().clone() for n, p in getattr(state, net).named_parameters()}
              for net in grads}
    am_before = ({n: p.clone() for n, p in state.am.state_dict().items()}
                 if state.am is not None else {})
    state, aux_step = step(state, tbatch)

    assert state.step == 1
    assert set(aux_step) == set(jaux_step)
    for key, ref in jaux_step.items():
        assert float(aux_step[key]) == pytest.approx(float(ref), rel=METRIC_RTOL,
                                                     abs=1e-6), key
    assert set(grads) == set(jgrads)
    for net, jg in jgrads.items():
        ref = {n: torch.as_tensor(v) for n, v in CONVERT[net](jax.device_get(jg)).items()}
        assert set(grads[net]) == set(ref)
        _assert_grads_close(grads[net], ref, net)

        lr = cfg.train.lr_g if net == "g" else cfg.train.lr_d
        jnew_params = CONVERT[net](jax.device_get(getattr(jnew, f"{net}_params")))
        for name, p in getattr(state, net).named_parameters():
            upd = (p.detach() - before[net][name]).numpy()
            ref_upd = jnew_params[name].numpy() - before[net][name].numpy()
            assert np.abs(upd).max() <= lr * (1 + 1e-3), f"{net} {name}"
            sure = np.abs(ref[name].numpy()) > 1e-3 * _net_scale(ref)
            np.testing.assert_allclose(upd[sure], ref_upd[sure], rtol=1e-3,
                                       atol=1e-3 * lr, err_msg=f"{net} {name}")
    for name, v in am_before.items():                 # the frozen AM did not move
        assert torch.equal(state.am.state_dict()[name], v), name


def test_grad_accum_matches_full_batch_with_uneven_rows():
    """k = 2 splits rows {0, 2} / {1, 3}: 2 vs 1 real noisy rows and 1 vs 2
    real clean rows, so the share denominators matter.  The port's k = 2 is
    held to the JAX package's k = 2 (its strided split and averaged metrics)
    and to the port's k = 1."""
    np_batch = _batch(seed=3, weights=[1, 1, 1, 0], clean_weights=[1, 0, 1, 1])
    batch = _to_torch(np_batch)
    results = {}
    for k in (1, 2):
        cfg = _cfg("aas", grad_accum=k)
        jstate = jax_init_state(cfg, jax.random.key(0))
        tcfg, state = _torch_state(cfg, jstate)
        results[k] = make_train_step(tcfg).batch_grads(state, batch)
    jgrads, jaux = jax.jit(jax_make_train_step(cfg).batch_grads)(jstate, np_batch)
    (g1, a1), (g2, a2) = results[1], results[2]
    assert set(a2) == set(jaux)
    for key in a1:
        assert float(a2[key]) == pytest.approx(float(a1[key]), rel=1e-5, abs=1e-6), key
        assert float(a2[key]) == pytest.approx(float(jaux[key]), rel=METRIC_RTOL,
                                               abs=1e-6), key
    for net in g1:
        _assert_grads_close(g2[net], g1[net], f"{net}, k=2 vs k=1")
        ref = {n: torch.as_tensor(v) for n, v in CONVERT[net](jax.device_get(jgrads[net])).items()}
        _assert_grads_close(g2[net], ref, f"{net}, k=2 vs JAX k=2")


def test_clip_by_global_norm_is_optax():
    import optax
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (1.0, 1e3):
        ref, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got, norm = clip_by_global_norm([torch.from_numpy(g) for g in grads], max_norm)
        assert float(norm) == pytest.approx(float(optax.global_norm(grads)), rel=1e-6)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)


def test_init_state_freezes_the_am():
    cfg = TConfig.from_json(_cfg("aas").to_json())
    state = init_state(cfg, seed=0)
    assert state.g is not None and state.d is not None and state.am is not None
    assert not any(p.requires_grad for p in state.am.parameters())
    assert all(p.requires_grad for p in state.g.parameters())
    adv = init_state(cfg.replace(train=dataclasses.replace(cfg.train,
                                                           objective="adversarial")), 0)
    assert adv.am is None and adv.d is not None
    with pytest.raises(NotImplementedError, match="A8"):
        init_state(cfg.replace(train=dataclasses.replace(cfg.train, objective="paired")), 0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4, seed=2,
                           vocab_chars=6)


def _cfg_json(tmp_path, objective="aas"):
    cfg = _cfg(objective)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    return str(path)


def test_cli_trains_three_steps_on_cpu(corpus, tmp_path, capsys):
    train_cli.main(["--objective", "aas", "--noisy-manifest", corpus["noisy"],
                    "--clean-manifest", corpus["clean"], "--steps", "3",
                    "--config", _cfg_json(tmp_path), "--am-checkpoint", "seed:0",
                    "--device", "cpu"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    # The JAX CLI's final line: final_step and the last record's loss_* keys.
    assert set(line) == {"final_step", "loss_ctc", "loss_adv_g", "loss_g", "loss_d"}
    assert line["final_step"] == 3
    assert all(np.isfinite(v) for v in line.values())
    records = [json.loads(s) for s in out.err.strip().splitlines() if s.startswith("{")]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all("utts_per_sec" in r and "g_grad_norm" in r for r in records)


@pytest.mark.parametrize("flags,item", [
    (["--checkpoint-dir", "ck"], "A9"), (["--continue-from"], "A9"),
    (["--val-manifest", "v.csv"], "A9"), (["--eval-every", "5"], "A9"),
    (["--metrics", "m.jsonl"], "A9"),
    (["--tensorboard", "tb"], "A9"), (["--profile-dir", "p"], "A9"),
    (["--sortagrad"], "A9"), (["--spec-augment"], "A8"),
    (["--am-through-enhancer"], "A8"), (["--streaming-finetune"], "A11"),
    (["--stream-chunk", "1.0"], "A11"), (["--streaming-finetune-am"], "A11"),
    (["--objective", "paired"], "A8"), (["--objective", "am"], "A8"),
    (["--am-checkpoint", "ckpt_dir"], "A9")])
def test_unported_flags_raise(flags, item):
    args = ["--objective", "aas", "--noisy-manifest", "n.csv", "--clean-manifest",
            "c.csv", "--device", "cpu", *flags]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        train_cli.main(args)


def test_cuda_device_without_gpu_raises(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--objective", "aas", "--noisy-manifest", corpus["noisy"],
                        "--clean-manifest", corpus["clean"], "--device", "cuda"])


def test_unpaired_clean_stream_matches_jax(corpus):
    """The clean stream draws the JAX package's items and pads them alike."""
    from aas_enhancement_tpu.config import AudioConfig
    from aas_enhancement_tpu.data.dataset import AudioDataset as JaxDataset
    from aas_enhancement_tpu.data.dataset import UnpairedCleanStream as JaxStream
    from aas_enhancement_tpu_torch.config import AudioConfig as TAudio
    from aas_enhancement_tpu_torch.config import DataConfig as TData
    from aas_enhancement_tpu_torch.data.dataset import AudioDataset, UnpairedCleanStream
    ref = JaxStream(JaxDataset(corpus["clean"], AudioConfig(),
                               DataConfig(num_buckets=2, native_decode=False)), 3, seed=4)
    got_ds = AudioDataset(corpus["clean"], TAudio(), TData(num_buckets=2))
    got = UnpairedCleanStream(got_ds, 3, seed=4)
    assert got_ds.num_batches(3) == ref.ds.num_batches(3)
    for bucket in (48000, 16000):
        a, b = got.next_batch(bucket), ref.next_batch(bucket)
        assert a.wav.shape == (3, bucket)
        for field in ("wav", "wav_lengths", "labels", "label_paddings"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), field)


@pytest.mark.parametrize("anneal,spe", [(1.1, 2), (1.0, 2), (1.1, 0)])
def test_lr_schedule_matches_jax(anneal, spe):
    """The per-epoch staircase, indexed by the updates done so far."""
    from aas_enhancement_tpu.train.state import lr_schedule as jax_lr_schedule
    from aas_enhancement_tpu_torch.train.state import lr_schedule
    cfg = _cfg("aas", lr_anneal=anneal, steps_per_epoch=spe)
    ref, got = jax_lr_schedule(cfg, 3e-4), lr_schedule(TConfig.from_json(cfg.to_json()), 3e-4)
    for count in range(6):
        assert got(count) == pytest.approx(float(ref(count)), rel=1e-6), count
