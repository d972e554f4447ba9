"""Port parity: the train step of the generator objectives and of AM
pre-training (aas_enhancement_tpu_torch.train) against the JAX package's
make_train_step on the CPU, from the same converted parameters and the same
batch, the pieces the AM objective adds (SpecAugment, the KL anchor, SGD with
Nesterov momentum), and the port's train CLI.

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
- the ``am`` step: metrics and gradients as above; its SGD update is linear
  in the gradient, so the updated parameters are held to JAX's update with
  rtol 1e-4 plus atol 2e-5 of the network's largest update plus one ulp of
  the tensor's largest parameter (p + u rounds to f32 on each side, and the
  update is recovered here as p_new - p).
"""

import dataclasses
import json
import os

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
from aas_enhancement_tpu_torch.ops import masking as tmasking
from aas_enhancement_tpu_torch.train import objectives as tobj
from aas_enhancement_tpu_torch.train.state import (TrainState, adam, am_sgd, apply_update,
                                                   clip_by_global_norm, lr_schedule)
from aas_enhancement_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

METRIC_RTOL = 1e-4
CONVERT = {"g": enhancer_params_from_flax, "d": disc_params_from_flax,
           "am": am_params_from_flax}


def _cfg(objective, am_layers=1, **train_kw):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=am_layers, conv_channels=8),
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
    if cfg.train.objective == "am":
        state.am = AcousticModel(tcfg.am, f)
        state.am.load_state_dict(am_params_from_flax(jax.device_get(jstate.am_params)))
        state.am_opt = am_sgd(tcfg, state.am.parameters(), tcfg.train.lr_am)
        if jstate.g_params:
            state.g = Enhancer(tcfg.enhancer, f).requires_grad_(False)
            state.g.load_state_dict(
                enhancer_params_from_flax(jax.device_get(jstate.g_params)))
        return tcfg, state
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


@pytest.mark.parametrize("k,anchored,through_g", [(1, False, False), (2, False, False),
                                                  (1, True, False), (1, False, True),
                                                  (2, True, True)])
def test_am_step_matches_jax(k, anchored, through_g):
    """One ``am`` step (2 convs, 2 x BiGRU-16, ragged batch with a weight-0
    row) against the JAX step: metrics, every AM gradient and every updated
    parameter; with grad_accum 2, the KL anchor (another AM's posteriors) and
    the frozen enhancer in front of the AM."""
    cfg = _cfg("am", am_layers=2, grad_accum=k, am_through_enhancer=through_g,
               distill_lambda=0.7 if anchored else 0.0)
    jstate = jax_init_state(cfg, jax.random.key(0))
    anchor = (jax_init_state(cfg, jax.random.key(5)).am_params if anchored else None)
    jstep = jax_make_train_step(cfg, anchor_am_params=anchor)
    batch = {key: v for key, v in _batch(seed=2, weights=[1, 1, 0, 1],
                                         clean_weights=[1, 1, 1, 1]).items()
             if not key.startswith("clean")}
    jgrads, _ = jax.jit(jstep.batch_grads)(jstate, batch)
    jnew, jaux = jax.jit(jstep)(jstate, batch)

    tcfg, state = _torch_state(cfg, jstate)
    anchor_am = None
    if anchored:
        anchor_am = AcousticModel(tcfg.am, tcfg.audio.num_bins).requires_grad_(False)
        anchor_am.load_state_dict(am_params_from_flax(jax.device_get(anchor)))
    step = make_train_step(tcfg, anchor_am=anchor_am)
    tbatch = _to_torch(batch)
    grads, _ = step.batch_grads(state, tbatch)
    before = {n: p.detach().clone() for n, p in state.am.named_parameters()}
    g_before = ({n: p.clone() for n, p in state.g.state_dict().items()} if through_g else {})
    state, aux = step(state, tbatch)

    assert state.step == 1 and set(grads) == set(jgrads) == {"am"}
    assert set(aux) == set(jaux) and "am_grad_norm" in aux
    assert ("loss_distill" in aux) == anchored
    for key, ref in jaux.items():
        assert float(aux[key]) == pytest.approx(float(ref), rel=METRIC_RTOL, abs=1e-6), key
    ref = {n: torch.as_tensor(v) for n, v in
           am_params_from_flax(jax.device_get(jgrads["am"])).items()}
    assert set(grads["am"]) == set(ref)
    _assert_grads_close(grads["am"], ref, "am")
    jnew_params = am_params_from_flax(jax.device_get(jnew.am_params))
    updates = {n: (p.detach() - before[n]).numpy() for n, p in state.am.named_parameters()}
    ref_updates = {n: jnew_params[n].numpy() - before[n].numpy() for n in updates}
    scale = max(np.abs(u).max() for u in ref_updates.values())
    assert scale > 0
    for n, upd in updates.items():
        ulp = 2.0 ** -23 * float(before[n].abs().max())
        np.testing.assert_allclose(upd, ref_updates[n], rtol=1e-4,
                                   atol=2e-5 * scale + ulp, err_msg=n)
    for n, v in g_before.items():                     # the frozen enhancer did not move
        assert torch.equal(state.g.state_dict()[n], v), n
    assert all(p.grad is None for p in state.am.parameters())


def test_spec_augment_matches_jax_on_the_same_stripes():
    """jax.random's streams cannot be drawn in torch, so the stripes are drawn
    here as the JAX spec_augment draws them and handed to the port's masking;
    the outputs are then equal."""
    from aas_enhancement_tpu.ops.masking import spec_augment as jax_spec_augment
    rng = np.random.default_rng(0)
    b, t, f = 4, 50, 21
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    lengths = np.array([50, 31, 6, 1], np.int32)
    key = jax.random.key(3)
    n_time, time_width, n_freq, freq_width = 2, 9, 3, 5
    ref = np.asarray(jax_spec_augment(key, jnp.asarray(x), jnp.asarray(lengths), n_time,
                                      time_width, n_freq, freq_width))
    stripes = []
    keys = jax.random.split(key, 4)
    for kw, ks, n, max_w, limit in ((keys[0], keys[1], n_time, time_width, lengths),
                                    (keys[2], keys[3], n_freq, freq_width,
                                     np.full(b, f, np.int32))):
        w = jax.random.randint(kw, (b, n), 0, max_w + 1)
        hi = jnp.maximum(jnp.asarray(limit)[:, None] - w, 1).astype(jnp.float32)
        start = jnp.floor(jax.random.uniform(ks, (b, n)) * hi).astype(jnp.int32)
        stripes.append((torch.from_numpy(np.array(w)).long(),
                        torch.from_numpy(np.array(start)).long()))
    got = tmasking.apply_spec_augment(torch.from_numpy(x), *stripes)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).any() and (ref != 0).any()


def test_spec_augment_draws_stripes_inside_the_valid_region():
    gen = torch.Generator().manual_seed(1)
    lengths = torch.tensor([40, 12, 3, 1])
    width, start = tmasking.draw_stripes(gen, 3, 10, lengths)
    assert width.shape == start.shape == (4, 3)
    assert int(width.min()) >= 0 and int(width.max()) <= 10 and int(start.min()) >= 0
    # A stripe no wider than the row starts where it still fits inside it.
    fits = width <= lengths[:, None]
    assert torch.all((start + width)[fits] <= lengths[:, None].expand_as(width)[fits])
    assert torch.all(start[~fits] == 0)
    x = torch.ones(4, 40, 21)
    a = tmasking.spec_augment(torch.Generator().manual_seed(7), x, lengths, 2, 10, 2, 5)
    b = tmasking.spec_augment(torch.Generator().manual_seed(7), x, lengths, 2, 10, 2, 5)
    c = tmasking.spec_augment(torch.Generator().manual_seed(8), x, lengths, 2, 10, 2, 5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, 1.0}
    keep = tmasking.stripe_keep(torch.tensor([[2, 0]]), torch.tensor([[1, 3]]), 6)
    assert keep.tolist() == [[True, False, False, True, True, True]]


@pytest.mark.parametrize("weights,denom", [(None, None), ([1.0, 0.0, 1.0], None),
                                           ([1.0, 1.0, 0.0], 1.5)])
def test_distill_kl_matches_jax(weights, denom):
    from aas_enhancement_tpu.train.objectives import distill_kl as jax_distill_kl
    rng = np.random.default_rng(2)
    base = rng.standard_normal((3, 9, 7)).astype(np.float32)
    logits = rng.standard_normal((3, 9, 7)).astype(np.float32)
    out_lengths = np.array([9, 4, 1], np.int32)
    w = None if weights is None else np.array(weights, np.float32)
    ref = jax_distill_kl(jnp.asarray(base), jnp.asarray(logits), jnp.asarray(out_lengths),
                         weights=None if w is None else jnp.asarray(w), denom=denom)
    lt = torch.from_numpy(logits).requires_grad_()
    got = tobj.distill_kl(torch.from_numpy(base).requires_grad_(), lt,
                          torch.from_numpy(out_lengths),
                          weights=None if w is None else torch.from_numpy(w), denom=denom)
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    assert float(tobj.distill_kl(lt, lt, torch.from_numpy(out_lengths)).detach()) == \
        pytest.approx(0.0, abs=1e-7)
    (dl,) = torch.autograd.grad(got, lt)              # the anchor carries no gradient
    jd = jax.grad(lambda l_: jax_distill_kl(jnp.asarray(base), l_, jnp.asarray(out_lengths),
                                            weights=None if w is None else jnp.asarray(w),
                                            denom=denom))(jnp.asarray(logits))
    np.testing.assert_allclose(dl.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("momentum", [0.9, 0.0])
def test_am_optimizer_three_steps_match_optax(momentum):
    """Clip by global norm, then SGD with Nesterov momentum at the staircase
    lr: torch.optim.SGD(nesterov=True) behind apply_update against the JAX
    package's am_optimizer (optax) over three steps, the second one clipped
    and the third at the annealed lr."""
    from aas_enhancement_tpu.train.state import am_optimizer
    cfg = _cfg("am", lr_am=0.05, momentum=momentum, lr_anneal=1.5, steps_per_epoch=2,
               max_grad_norm=3.0)
    tcfg = TConfig.from_json(cfg.to_json())
    rng = np.random.default_rng(6)
    shapes = ((3, 4), (5,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
             for scale in (0.3, 5.0, 0.3)]
    opt = am_optimizer(cfg)
    jp = [jnp.asarray(p) for p in params]
    opt_state = opt.init(jp)
    tp = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    topt = am_sgd(tcfg, tp, tcfg.train.lr_am)
    lr = lr_schedule(tcfg, tcfg.train.lr_am)
    for i, g in enumerate(grads):
        updates, opt_state = opt.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        norm = apply_update(topt, tp, [torch.from_numpy(x) for x in g], lr(i), 3.0)
        assert (float(norm) > 3.0) == (i == 1)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i}")
    assert lr(2) == pytest.approx(0.05 / 1.5)


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
    state = init_state(cfg, seed=0, device="cpu")
    assert state.g is not None and state.d is not None and state.am is not None
    assert not any(p.requires_grad for p in state.am.parameters())
    assert all(p.requires_grad for p in state.g.parameters())
    adv = init_state(cfg.replace(train=dataclasses.replace(cfg.train,
                                                           objective="adversarial")), 0, "cpu")
    assert adv.am is None and adv.d is not None
    am = init_state(cfg.replace(train=dataclasses.replace(cfg.train, objective="am")), 0, "cpu")
    assert am.g is None and am.d is None and am.am_opt is not None
    assert all(p.requires_grad for p in am.am.parameters())
    through = init_state(cfg.replace(train=dataclasses.replace(
        cfg.train, objective="am", am_through_enhancer=True)), 0, "cpu")
    assert through.g_opt is None and not any(p.requires_grad for p in through.g.parameters())
    paired = init_state(cfg.replace(train=dataclasses.replace(cfg.train, objective="paired")),
                        0, "cpu")
    assert paired.g_opt is not None and all(p.requires_grad for p in paired.g.parameters())
    assert paired.d is None and paired.am is None


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
    (["--sortagrad"], "A9"), (["--stream-lookahead", "0.3"], "A11"),
    (["--stream-history", "0.5"], "A11"), (["--streaming-finetune"], "A11"),
    (["--stream-chunk", "0.4"], "A11"), (["--streaming-finetune-am"], "A11"),
    (["--objective", "paired"], "A9"), (["--g-checkpoint", "ckpt_dir"], "A9"),
    (["--am-checkpoint", "ckpt_dir"], "A9")])
def test_unported_flags_raise(flags, item, tmp_path, monkeypatch):
    """The flags of the A9 and A11 items are ported: a checkpoint directory
    without config.json raises as the JAX CLI's load_state does, and every
    other flag reaches the config or the loop (``init_state`` and ``train``
    stubbed here; the loop itself is driven in tests/test_torch_loop.py;
    ``--objective paired`` reaches ``train(paired=True)``; the streaming
    fine-tuning flags (A11) reach ``TrainConfig`` as the JAX CLI maps them)."""
    args = ["--objective", "aas", "--noisy-manifest", "n.csv", "--clean-manifest",
            "c.csv", "--device", "cpu"]
    if flags[0] in ("--g-checkpoint", "--am-checkpoint"):
        with pytest.raises(FileNotFoundError, match="no config.json"):
            train_cli.main([*args, flags[0], str(tmp_path / flags[1])])
        return
    seen = {}

    def fake_train(cfg, *a, **kw):
        seen.update(kw, cfg=cfg)
        return TrainState(step=0), []

    monkeypatch.setattr(train_cli, "init_state", lambda *a, **kw: TrainState())
    monkeypatch.setattr(train_cli, "train", fake_train)
    monkeypatch.chdir(tmp_path)
    train_cli.main([*args, *flags])
    t = seen["cfg"].train
    reached = {"--checkpoint-dir": seen["checkpoint_dir"] == "ck"
               and os.path.exists("ck/config.json"),
               "--continue-from": seen["resume"] is True,
               "--val-manifest": seen["cfg"].data.val_manifest == "v.csv",
               "--eval-every": t.eval_every == 5,
               "--metrics": seen["metrics_path"] == "m.jsonl",
               "--tensorboard": seen["tensorboard_dir"] == "tb",
               "--profile-dir": t.profile_dir == "p",
               "--sortagrad": t.sortagrad is True,
               "--objective": t.objective == "paired" and seen["paired"] is True,
               "--stream-lookahead": t.stream_lookahead_s == 0.3 and t.stream_chunk_s == 1.0,
               "--stream-history": t.stream_history_s == 0.5,
               "--streaming-finetune": t.streaming_finetune and not t.streaming_finetune_am,
               "--stream-chunk": t.stream_chunk_s == 0.4,
               "--streaming-finetune-am": t.streaming_finetune_am}
    assert reached[flags[0]], (flags, seen)


@pytest.mark.parametrize("extra,keys", [
    ([], {"loss_ctc_am"}),
    (["--spec-augment", "--am-through-enhancer", "--g-checkpoint", "seed:1",
      "--grad-accum", "2"], {"loss_ctc_am"}),
    (["--distill", "0.5"], {"loss_ctc_am", "loss_distill", "loss_am_total"})])
def test_cli_am_objective_on_cpu(corpus, tmp_path, capsys, extra, keys):
    """--objective am: the JAX CLI's final line (final_step and the last
    record's loss_* keys); the anchor comes from the config (no CLI flag)."""
    cfg = _cfg("am", am_layers=2)
    if "--distill" in extra:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, distill_lambda=0.5))
        extra = []
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    train_cli.main(["--objective", "am", "--noisy-manifest", corpus["clean"], "--steps", "3",
                    "--config", str(path), "--am-checkpoint", "seed:0", "--device", "cpu",
                    *extra])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == {"final_step"} | keys and line["final_step"] == 3
    assert all(np.isfinite(v) for v in line.values())
    records = [json.loads(s) for s in out.err.strip().splitlines() if s.startswith("{")]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all("am_grad_norm" in r and "g_grad_norm" not in r for r in records)
    if "loss_distill" in keys:         # the anchor is the AM as the run started
        assert records[0]["loss_distill"] == pytest.approx(0.0, abs=1e-6)
        assert records[-1]["loss_distill"] > 0.0


def test_am_through_enhancer_needs_the_am_objective(corpus):
    with pytest.raises(SystemExit):
        train_cli.main(["--objective", "aas", "--noisy-manifest", corpus["noisy"],
                        "--clean-manifest", corpus["clean"], "--am-through-enhancer",
                        "--device", "cpu"])


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
