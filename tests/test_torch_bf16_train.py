"""Training at bfloat16 on the CPU: the plain backward versions of the four
kernels that a bf16 step runs (B1' / B2' with the B7 / B7' VJPs, B3', B6)
against the JAX package at ``dtype="bfloat16"``, the bf16 step apart from
the f32 one, the port's copy of ``tests/test_bf16.py::test_aas_bf16_trains``,
and the train CLI with a bf16 ``--config`` for every objective.  The steps
against the JAX bf16 step are in ``tests/test_torch_bf16_steps.py``.

The JAX side runs what its bf16 models run on a TPU: the recurrences' Pallas
VJPs in interpret mode (f32 parameters rounded through bf16, bf16 gx, dy and
saved state; their time chunk pinned to 4 steps for this file, a tiling of
the sequential grid that changes no value and cuts interpret mode's compile
time), the GroupNorm's XLA route and its autodiff, the Pallas
``conv_dw_same`` in interpret mode on bf16 inputs.

Limits (written into PERF.md first): rtol 2e-2 with atol 2e-2 x max|ref| of
each tensor (the JAX package's bf16 limit, ``tests/test_gn_kernel.py``).
The plain recurrences' autograd reads the f32 state of its forward where the
Pallas VJP reads the bf16 copies of h and c (``ops/cuda/rnn.py``); the rest
rounds where JAX does.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aas_enhancement_tpu.ops.pallas.rnn_kernel as jax_rnn_kernel
from aas_enhancement_tpu.ops.norm import MaskedGroupNorm as JaxGN
from aas_enhancement_tpu.ops.pallas.conv_dw_kernel import conv_dw_same as jax_conv_dw_same
from aas_enhancement_tpu.ops.pallas.rnn_kernel import (gru_scan_pallas, gru_scan_tm,
                                                       lstm_scan_pallas, lstm_scan_tm)
from aas_enhancement_tpu_torch.cli import train as train_cli
from aas_enhancement_tpu_torch.config import (AMConfig, DataConfig, DiscriminatorConfig,
                                              EnhancerConfig, TrainConfig)
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
from aas_enhancement_tpu_torch.ops.cuda import gn as kgn
from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
from aas_enhancement_tpu_torch.ops.masking import time_mask
from aas_enhancement_tpu_torch.train.loop import init_state, train
from aas_enhancement_tpu_torch.train.steps import make_train_step

from test_torch_train import _batch, _cfg, _to_torch

torch.set_num_threads(1)

BF16 = jnp.bfloat16
RTOL, ATOL = 2e-2, 2e-2           # atol x max|ref| of each tensor
DTYPES = ("enhancer", "am", "discriminator")


@pytest.fixture(scope="module", autouse=True)
def short_pallas_chunks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_rnn_kernel, "_pick_chunk", lambda *a, **k: 4)
        yield


def bf16_config(cfg):
    """A config (JAX's or the port's) with all three models at bfloat16."""
    return cfg.replace(**{n: dataclasses.replace(getattr(cfg, n), dtype="bfloat16")
                          for n in DTYPES})


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, ref, what=""):
    got, ref = _f32(got), _f32(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL * float(np.abs(ref).max()),
                               err_msg=what)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(a, BF16).astype(jnp.float32))


# -------------------------------------------- (a) the recurrences' VJPs (B1', B2', B7, B7')

def _scan_data(cell, t, b, h, seed):
    """bf16-valued gx (both directions) and dy, f32 wh and bh rounded through
    bf16 (what the bf16 BiRNN hands the scans), ragged lengths with a 0."""
    g = (4 if cell == "lstm" else 3) * h
    rng = np.random.default_rng(seed)
    gx = _bf16_round((0.6 * rng.standard_normal((2, t, b, g))).astype(np.float32))
    dy = _bf16_round(rng.standard_normal((2, t, b, h)).astype(np.float32))
    wh = _bf16_round((0.3 * rng.standard_normal((2, h, g))).astype(np.float32))
    bh = _bf16_round((0.1 * rng.standard_normal((2, g))).astype(np.float32))
    lengths = np.array([t, t // 2 + 1, 0, t - 3][:b])
    m = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    return gx, dy, m, wh, bh


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cell,h", [("lstm", 16), ("gru", 16), ("gru", 12)])
def test_plain_scan_vjp_matches_pallas(cell, h, stacked):
    """dgx (bf16), dwh and dbh (f32) of the plain scans' autograd at bf16
    against ``jax.vjp`` of the Pallas scans on bf16 gx: time-major (B1', B2')
    and stacked (the B7 / B7' VJPs, direction 1 flipped by the caller)."""
    t, b = 19, 4
    gx, dy, m, wh, bh = _scan_data(cell, t, b, h, seed=h + 3 * stacked)
    if stacked:
        gx_s = np.ascontiguousarray(np.stack([gx[0], gx[1][::-1]], axis=1))
        dy_s = np.ascontiguousarray(np.stack([dy[0], dy[1][::-1]], axis=1))
        m_s = np.ascontiguousarray(np.stack([m, m[::-1]], axis=1))
        pallas = lstm_scan_pallas if cell == "lstm" else gru_scan_pallas
        _, vjp = jax.vjp(lambda x, w, v: pallas(x, jnp.asarray(m_s), w, v, True),
                         jnp.asarray(gx_s, BF16), jnp.asarray(wh), jnp.asarray(bh))
        ref = vjp(jnp.asarray(dy_s, BF16))
        fn = krnn.lstm_scan_stacked if cell == "lstm" else krnn.gru_scan_stacked
        inputs = [torch.from_numpy(gx_s).bfloat16().requires_grad_(),
                  *(torch.from_numpy(a).requires_grad_() for a in (wh, bh))]
        out = fn(inputs[0], torch.from_numpy(m_s), *inputs[1:])
        got = torch.autograd.grad(out, inputs, torch.from_numpy(dy_s).bfloat16())
    else:
        pallas = lstm_scan_tm if cell == "lstm" else gru_scan_tm
        _, vjp = jax.vjp(lambda a, c, w, v: pallas(a, c, jnp.asarray(m), w, v, True),
                         jnp.asarray(gx[0], BF16), jnp.asarray(gx[1], BF16),
                         jnp.asarray(wh), jnp.asarray(bh))
        ref = vjp((jnp.asarray(dy[0], BF16), jnp.asarray(dy[1], BF16)))
        fn = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
        inputs = [torch.from_numpy(gx[0]).bfloat16().requires_grad_(),
                  torch.from_numpy(gx[1]).bfloat16().requires_grad_(),
                  *(torch.from_numpy(a).requires_grad_() for a in (wh, bh))]
        out = fn(inputs[0], inputs[1], torch.from_numpy(m), *inputs[2:])
        got = torch.autograd.grad(out, inputs, tuple(torch.from_numpy(d).bfloat16()
                                                     for d in dy))
    n_gx = 1 if stacked else 2
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == (torch.bfloat16 if i < n_gx else torch.float32)
        assert r.dtype == (BF16 if i < n_gx else jnp.float32)
        _close(a, r, f"{cell} input {i}")
    pad = (slice(None), 0, 2) if stacked else (slice(None), 2)
    assert np.all(_f32(got[0])[pad] == 0)                 # the length-0 row


def test_plain_scan_vjp_rounds_the_gate_gradient():
    """The bf16 backward is not the f32 one on the same values: dgx leaves in
    bf16 and the gate gradient is rounded before the recurrent products."""
    gx, dy, m, wh, bh = _scan_data("lstm", 25, 3, 16, seed=7)

    def grads(dt):
        inputs = [torch.from_numpy(gx[0]).to(dt).requires_grad_(),
                  torch.from_numpy(gx[1]).to(dt).requires_grad_(),
                  torch.from_numpy(wh).requires_grad_()]
        out = krnn.lstm_scan_tm(inputs[0], inputs[1], torch.from_numpy(m), inputs[2],
                                torch.from_numpy(bh))
        return torch.autograd.grad(out, inputs, tuple(torch.from_numpy(d).to(dt) for d in dy))

    g16, g32 = grads(torch.bfloat16), grads(torch.float32)
    assert g16[0].dtype == torch.bfloat16 and g32[0].dtype == torch.float32
    for a, r in zip(g16, g32):
        assert not torch.equal(a.float(), r.to(a.dtype).float())
        _close(a, r)


# ------------------------------------------------------------ (b) the GroupNorm's (B3')

def _gn_data(seed, shape=(3, 17, 9, 16)):
    rng = np.random.default_rng(seed)
    b, t, f, c = shape
    x = _bf16_round((0.5 + 2.0 * rng.standard_normal(shape)).astype(np.float32))
    x = np.where(rng.random(shape) < 0.02, 12.0 * x, x).astype(np.float32)
    dy = _bf16_round(rng.standard_normal(shape).astype(np.float32))
    scale = (3.0 + rng.standard_normal(c)).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    lengths = np.array([t, t - 6, 1][:b], np.int32)
    return x, dy, scale, bias, lengths


@pytest.mark.parametrize("act", ["leaky_relu", "hardtanh"])
def test_plain_gn_backward_matches_jax(act):
    """dx (bf16), dscale and dbias (f32) of the bf16 MaskedGroupNorm: the
    port's autograd through the plain forward (the CPU path) and its closed
    form (the B3' kernel's yardstick) against ``jax.vjp`` of the JAX module at
    bf16 (its XLA route)."""
    x, dy, scale, bias, lengths = _gn_data(seed=4 + len(act))
    gnj = JaxGN(num_groups=8, dtype=BF16, act=act)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    _, vjp = jax.vjp(lambda xx, p: gnj.apply({"params": p}, xx, jnp.asarray(lengths)),
                     jnp.asarray(x, BF16), params)
    rdx, rp = vjp(jnp.asarray(dy, BF16))
    assert rdx.dtype == BF16
    ref = (rdx, rp["scale"], rp["bias"])

    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    st, bt = (torch.from_numpy(a).requires_grad_() for a in (scale, bias))
    lt = torch.from_numpy(lengths)
    y = kgn.masked_group_norm_act(xt, st, bt, lt, num_groups=8, act=act)
    assert y.dtype == torch.bfloat16
    autograd = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(dy).bfloat16())

    b, t, f, c = x.shape
    xm = (xt.detach().float() * time_mask(lt, t)[:, :, None, None]).reshape(b, t, f, 8, c // 8)
    mean, inv = kgn._group_stats(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                                 lt, f, c, 8, 1e-5)
    mean, inv = (v.repeat_interleave(c // 8, dim=1) for v in (mean, inv))
    closed = kgn.masked_group_norm_act_bwd_plain(
        xt.detach(), torch.from_numpy(dy).bfloat16(), st.detach(), bt.detach(), lt,
        mean, inv, num_groups=8, act=act)
    for got in (autograd, closed):
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        for i, (a, r) in enumerate(zip(got, ref)):
            _close(a, r, f"{act} {i}")
    assert np.all(_f32(closed[0])[1, t - 6:] == 0)


# ------------------------------------------------------- (c) the conv weight gradient (B6)

@pytest.mark.parametrize("strides,kt,kf", [((1, 2), 5, 7), ((1, 1), 3, 5)])
def test_plain_conv_dw_matches_pallas_at_bf16(strides, kt, kf):
    """``conv_dw_same_plain`` on bf16 x and dy (f32 products and sums, f32 dW)
    against the Pallas ``conv_dw_same`` in interpret mode on the same bf16
    inputs."""
    rng = np.random.default_rng(kt)
    b, t, f, ci, co = 2, 13, 17, 8, 8
    x = rng.standard_normal((b, t, f, ci)).astype(np.float32)
    dy = rng.standard_normal((b, t, -(-f // strides[1]), co)).astype(np.float32)
    ref = jax_conv_dw_same(jnp.asarray(x, BF16), jnp.asarray(dy, BF16), kt, kf, strides,
                           interpret=True)
    got = kconv.conv_dw_same(torch.from_numpy(x).bfloat16(), torch.from_numpy(dy).bfloat16(),
                             kt, kf, strides)
    assert got.dtype == torch.float32 and got.shape == (kt, kf, ci, co)
    _close(got, ref)
    exact = kconv.conv_dw_same_plain(torch.from_numpy(_bf16_round(x)),
                                     torch.from_numpy(_bf16_round(dy)), kt, kf, strides)
    torch.testing.assert_close(got, exact, rtol=0, atol=0)   # the f32 sums of the bf16 values


# ---------------------------------- (e) the bf16 step is not the f32 one; (f) it trains

def _bf16_batch():
    return _to_torch(_batch(seed=3))


@pytest.mark.parametrize("objective", ["aas", "am"])
def test_bf16_step_gradients_are_apart_from_f32(objective):
    """The same weights and batch at bf16 and at f32: every network's
    gradients part by far more than f32 rounding (1e-3 of its max|g|; f32
    runs in another order part by ~1e-6)."""
    cfg32 = TConfig.from_json(_cfg(objective).to_json())
    cfg16 = bf16_config(cfg32)
    batch = _bf16_batch()
    if objective == "am":
        batch = {k: v for k, v in batch.items() if not k.startswith("clean")}
    g16, aux16 = make_train_step(cfg16).batch_grads(init_state(cfg16, 0, "cpu"), batch)
    state = init_state(cfg32, 0, "cpu")               # the same draws at f32
    g32, aux32 = make_train_step(cfg32).batch_grads(state, batch)
    for net, grads in g16.items():
        scale = max(float(g.abs().max()) for g in g32[net].values())
        apart = max(float((grads[n] - g32[net][n]).abs().max()) for n in grads) / scale
        assert apart > 1e-3, (net, apart)
        assert all(g.dtype == torch.float32 for g in grads.values())
    key = "loss_ctc_am" if objective == "am" else "loss_ctc"
    assert float(aux16[key]) != float(aux32[key])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("c")), n_utts=8, seed=2)


def test_aas_bf16_trains(corpus):
    """The port's copy of the JAX package's ``test_aas_bf16_trains``: ten
    ``aas`` steps of bf16 models, finite losses that fall."""
    cfg = bf16_config(TConfig(
        am=AMConfig(rnn_hidden=32, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=16, rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective="aas", batch_size=4, epochs=100, log_every=1,
                          lr_g=1e-3, lr_d=1e-3),
        data=DataConfig(num_buckets=1)))
    _, recs = train(cfg, corpus["noisy"], corpus["clean"], max_steps=10, device="cpu")
    losses = [r["loss_g"] for r in recs]
    assert len(losses) == 10 and all(np.isfinite(v) for v in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), f"bf16 loss flat: {losses}"


@pytest.mark.parametrize("objective,extra", [
    ("aas", {}), ("adversarial", {}), ("acoustic", {}), ("paired", {"lambda_mrstft": 0.5}),
    ("am", {"distill_lambda": 0.5}), ("am", {"streaming_finetune_am": True,
                                             "stream_chunk_s": 0.2,
                                             "stream_lookahead_s": 0.05,
                                             "stream_history_s": 0.1})])
def test_cli_trains_each_objective_with_a_bf16_config(corpus, tmp_path, capsys, objective,
                                                      extra):
    """``cli.train --config`` with a bf16 config JSON trains two steps of every
    objective on the CPU (the KL anchor and the blockwise AM step among
    them): a final line of finite losses, records with gradient norms."""
    cfg = bf16_config(TConfig.from_json(_cfg(objective).to_json()))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2, **extra))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    noisy = corpus["clean"] if objective == "am" else corpus["noisy"]
    args = ["--objective", objective, "--noisy-manifest", noisy, "--steps", "2",
            "--config", str(path), "--am-checkpoint", "seed:0", "--device", "cpu"]
    if objective != "am":
        args += ["--clean-manifest", corpus["clean"]]
    train_cli.main(args)
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["final_step"] == 2
    assert all(np.isfinite(v) for k, v in line.items() if k.startswith("loss"))
    records = [json.loads(s) for s in out.err.strip().splitlines() if s.startswith("{")]
    norm = "am_grad_norm" if objective == "am" else "g_grad_norm"
    assert [r["step"] for r in records] == [1, 2] and all(norm in r for r in records)
    assert json.loads((tmp_path / "cfg.json").read_text())["am"]["dtype"] == "bfloat16"
