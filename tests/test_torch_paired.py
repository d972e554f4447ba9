"""Port parity: the ``paired`` objective (aas_enhancement_tpu_torch.train:
``masked_l1``, ``mr_stft_loss``, ``paired_loss``, the ``paired`` step, its
validation records), ``config.preset`` and the plain STFT/ISTFT VJPs against
the JAX package on the CPU, from the same converted parameters and the same
numpy-seeded inputs, at tiny widths (enhancer 8 channels + BiLSTM-12).

Tolerances (f32 on both sides, sums in other orders):
- loss values: rtol 1e-5 (L1 means over ~1000 bins, MR-STFT sums over three
  resolutions of ~10^4 bins);
- G gradients: each tensor against its own max|g|, 1e-4 (the gradient runs
  back through log1p, the mask's sigmoid, a BiLSTM and a conv + GroupNorm,
  and with the MR-STFT term through three STFTs and the ISTFT); a tensor
  that is zero to rounding against 1e-5 of the network's max|g|, the rule
  of chip_smoke.py's train phase.  With the MR-STFT term on, 3e-3
  (``MR_GRAD_TOL``): its log-magnitude L1 passes sign(.) / (|X| + 1e-7)
  back from every bin, and the bins of the frames that straddle a row's
  end, where the estimate is ~1e-6, make G's gradient sensitive to f32
  rounding itself: JAX's own ``paired_loss`` gradient, for the step test's
  batch with the noisy wave scaled by 1 + 1e-7, moves by 4.3e-04 of
  ``proj.kernel``'s max (1.5e-04 of ``blstms.0.wx.kernel``'s); the port
  differs from JAX by up to 1.03e-03 there (1.7e-04 for the loss test's
  batch);
- the step: metrics rtol 1e-4 as the other objectives' steps
  (tests/test_torch_train.py), the first Adam update as there;
- the plain VJPs against ``jax.vjp``: 1e-5 of the gradient's max|g|;
- ``mr_stft_loss``'s gradient with respect to the estimated wave: 1e-3 of
  its max|g|, as each log-magnitude term passes sign(.) / (|X| + 1e-7) back,
  and the bins where |X| is near 0 (the padded tail's edges) amplify the two
  sides' rounding of |X| (measured 1.2e-4); the G gradients, which sum
  these over every sample, are held to 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu import config as jconfig
from aas_enhancement_tpu.config import (AMConfig, Config, DataConfig,
                                        DiscriminatorConfig, EnhancerConfig,
                                        TrainConfig)
from aas_enhancement_tpu.data.synthetic import generate_corpus
from aas_enhancement_tpu.dsp.stft import istft as jax_istft, stft as jax_stft
from aas_enhancement_tpu.train import objectives as jobj
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
from aas_enhancement_tpu_torch import config as tconfig
from aas_enhancement_tpu_torch.cli import train as train_cli
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import enhancer_params_from_flax
from aas_enhancement_tpu_torch.evaluation import evaluate_wer, init_am
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
from aas_enhancement_tpu_torch.train import objectives as tobj
from aas_enhancement_tpu_torch.train.loop import init_state, train
from aas_enhancement_tpu_torch.train.state import TrainState, adam
from aas_enhancement_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

METRIC_RTOL = 1e-4
GRAD_TOL = 1e-4
GRAD_ZERO = 1e-5
MR_GRAD_TOL = 3e-3
VJP_PAIRS = [(256, 64), (512, 128), (1024, 256), (320, 160)]


def _cfg(lambda_mrstft=0.0, grad_accum=1):
    return Config(
        am=AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8),
        enhancer=EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=12,
                                rnn_layers=1),
        discriminator=DiscriminatorConfig(channels=(8, 16)),
        train=TrainConfig(objective="paired", batch_size=4, log_every=1,
                          lambda_mrstft=lambda_mrstft, grad_accum=grad_accum),
        data=DataConfig(num_buckets=1))


def _batch(seed=0, weights=(1, 1, 0, 1)):
    """A paired batch: noisy = clean + noise, ragged, one weight-0 row."""
    rng = np.random.default_rng(seed)
    b, n = 4, 4000
    lengths = np.array([4000, 3300, 2500, 3100], np.int32)
    valid = np.arange(n)[None] < lengths[:, None]
    clean = (0.1 * rng.standard_normal((b, n))).astype(np.float32) * valid
    noisy = (clean + 0.05 * rng.standard_normal((b, n)).astype(np.float32)) * valid
    return {"wav": noisy.astype(np.float32), "wav_lengths": lengths,
            "labels": rng.integers(1, 7, size=(b, 8)).astype(np.int32),
            "label_paddings": np.zeros((b, 8), np.float32),
            "clean_wav": clean.astype(np.float32),
            "row_weights": np.array(weights, np.float32),
            "clean_row_weights": np.array(weights, np.float32)}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _enhancer(cfg, g_params):
    tcfg = TConfig.from_json(cfg.to_json())
    g = Enhancer(tcfg.enhancer, tcfg.audio.num_bins)
    g.load_state_dict(enhancer_params_from_flax(jax.device_get(g_params)))
    return tcfg, g


def _assert_per_tensor(got: dict, ref: dict, tol: float, what: str):
    """Each tensor within ``tol`` of its own max|g|; a tensor whose max|g| is
    below GRAD_ZERO of the network's largest |g| is zero to rounding (the
    conv bias in front of a GroupNorm of one channel per group: its true
    gradient is 0) and is held to GRAD_ZERO of the network's max|g|."""
    assert set(got) == set(ref)
    scale = max(np.abs(np.asarray(r)).max() for r in ref.values())
    for name, r in ref.items():
        r = np.asarray(r)
        diff = np.abs(got[name].detach().numpy() - r).max()
        if np.abs(r).max() > GRAD_ZERO * scale:
            assert diff <= tol * np.abs(r).max(), f"{what} {name}: {diff:.3e}"
        else:
            assert diff <= GRAD_ZERO * scale, f"{what} {name} (zero): {diff:.3e}"


def test_masked_l1_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.standard_normal((3, 20, 9)).astype(np.float32)
    target = rng.standard_normal((3, 20, 9)).astype(np.float32)
    lengths = np.array([20, 7, 1], np.int32)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    for weights, denom in ((None, None), (w, None), (w, 1.5)):
        ref = float(jobj.masked_l1(pred, target, lengths, weights, denom))
        got = float(tobj.masked_l1(torch.from_numpy(pred), torch.from_numpy(target),
                                   torch.from_numpy(lengths),
                                   None if weights is None else torch.from_numpy(weights),
                                   denom))
        assert got == pytest.approx(ref, rel=1e-5)


def test_mr_stft_loss_and_its_gradient_match_jax():
    """Value and d loss / d est_wav (the gradient runs back through the three
    resolutions' STFTs) on a ragged, weighted batch."""
    batch = _batch(seed=4)
    est = batch["wav"]
    lengths, w = batch["wav_lengths"], batch["row_weights"]
    ref, ref_g = jax.value_and_grad(
        lambda e: jobj.mr_stft_loss(e, jnp.asarray(batch["clean_wav"]), lengths, w))(
        jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_()
    got = tobj.mr_stft_loss(e, torch.from_numpy(batch["clean_wav"]),
                            torch.from_numpy(lengths), torch.from_numpy(w))
    g, = torch.autograd.grad(got, e)
    assert float(got.detach()) == pytest.approx(float(ref), rel=1e-5)
    ref_g = np.asarray(ref_g)
    assert np.abs(g.numpy() - ref_g).max() <= 1e-3 * np.abs(ref_g).max()


def test_mr_stft_zero_for_identical_waves():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32) * 0.1)
    lengths = torch.tensor([8000, 8000])
    same = float(tobj.mr_stft_loss(w, w, lengths))
    diff = float(tobj.mr_stft_loss(w, torch.flip(w, dims=(1,)), lengths))
    assert same < 1e-3
    assert diff > 10 * max(same, 1e-6)


def test_mr_stft_padding_invariant():
    """The loss of an utterance does not depend on its padded bucket length."""
    rng = np.random.default_rng(1)
    n = 6000
    est = rng.standard_normal(n).astype(np.float32) * 0.1
    ref = est + rng.standard_normal(n).astype(np.float32) * 0.02
    vals = []
    for bucket in (8000, 16000):
        e = np.zeros(bucket, np.float32)
        r = np.zeros(bucket, np.float32)
        e[:n], r[:n] = est, ref
        vals.append(float(tobj.mr_stft_loss(torch.from_numpy(e)[None],
                                            torch.from_numpy(r)[None], torch.tensor([n]))))
    assert abs(vals[0] - vals[1]) < 1e-4, vals


@pytest.mark.parametrize("lam", [0.0, 0.5])
def test_paired_loss_and_g_gradients_match_jax(lam):
    cfg = _cfg(lambda_mrstft=lam)
    jstate = jax_init_state(cfg, jax.random.key(0))
    batch = _batch(seed=5)
    (ref, jaux), jgrads = jax.value_and_grad(
        lambda p: jobj.paired_loss(cfg, p, batch), has_aux=True)(jstate.g_params)
    tcfg, g = _enhancer(cfg, jstate.g_params)
    loss, aux = tobj.paired_loss(tcfg, g, _to_torch(batch))
    assert set(aux) == set(jaux)
    for k, v in jaux.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=1e-5), k
    names, params = zip(*g.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    _assert_per_tensor(grads, enhancer_params_from_flax(jax.device_get(jgrads)),
                       MR_GRAD_TOL if lam else GRAD_TOL, "g")


@pytest.mark.parametrize("lam,k", [(0.0, 1), (0.5, 1), (0.5, 2)])
def test_paired_step_matches_jax(lam, k):
    """One ``paired`` step: metrics, G gradients and the Adam update."""
    cfg = _cfg(lambda_mrstft=lam, grad_accum=k)
    jstate = jax_init_state(cfg, jax.random.key(1))
    jstep = jax_make_train_step(cfg)
    batch = _batch(seed=6)
    jgrads, _ = jax.jit(jstep.batch_grads)(jstate, batch)
    jnew, jaux = jax.jit(jstep)(jstate, batch)

    tcfg, g = _enhancer(cfg, jstate.g_params)
    state = TrainState(g=g, g_opt=adam(tcfg, g.parameters(), tcfg.train.lr_g))
    step = make_train_step(tcfg)
    tbatch = _to_torch(batch)
    grads, _ = step.batch_grads(state, tbatch)
    before = {n: p.detach().clone() for n, p in g.named_parameters()}
    state, aux = step(state, tbatch)

    assert state.step == 1 and set(grads) == {"g"} and set(aux) == set(jaux)
    assert ("loss_mrstft" in aux) == (lam > 0)
    for key, v in jaux.items():
        assert float(aux[key]) == pytest.approx(float(v), rel=METRIC_RTOL, abs=1e-6), key
    ref = {n: np.asarray(v) for n, v in
           enhancer_params_from_flax(jax.device_get(jgrads["g"])).items()}
    _assert_per_tensor(grads["g"], ref, MR_GRAD_TOL if lam else GRAD_TOL, "g")
    scale = max(np.abs(v).max() for v in ref.values())
    lr = cfg.train.lr_g
    jnew_g = enhancer_params_from_flax(jax.device_get(jnew.g_params))
    for name, p in g.named_parameters():
        upd = (p.detach() - before[name]).numpy()
        ref_upd = jnew_g[name].numpy() - before[name].numpy()
        assert np.abs(upd).max() <= lr * (1 + 1e-3), name
        sure = np.abs(ref[name]) > 1e-3 * scale
        np.testing.assert_allclose(upd[sure], ref_upd[sure], rtol=1e-3, atol=1e-3 * lr,
                                   err_msg=name)


def test_paired_grad_accum_equals_one_batch():
    """grad_accum 2 (strided microbatches, each divided by its share of the
    real rows) gives the k = 1 gradients (to 1e-4 of each tensor's max|g|:
    the two sum orders, through the MR-STFT term) and metrics."""
    jstate = jax_init_state(_cfg(0.5), jax.random.key(2))
    batch = _to_torch(_batch(seed=7, weights=(1, 0, 1, 1)))
    out = []
    for k in (1, 2):
        tcfg, g = _enhancer(_cfg(0.5, grad_accum=k), jstate.g_params)
        out.append(make_train_step(tcfg).batch_grads(TrainState(g=g), batch))
    (g1, a1), (g2, a2) = out
    for key in a1:
        assert float(a2[key]) == pytest.approx(float(a1[key]), rel=1e-5), key
    _assert_per_tensor(g2["g"], {n: v.numpy() for n, v in g1["g"].items()}, GRAD_TOL, "g")


@pytest.mark.parametrize("n_fft,hop", VJP_PAIRS)
def test_plain_vjps_match_jax_vjp(n_fft, hop):
    """``stft_vjp_plain`` and ``istft_vjp_plain`` against ``jax.vjp`` of the
    JAX package's ``dsp/stft.py::stft`` / ``istft``, ragged lengths (an
    ``istft`` length that cuts the buffer and one that zero-pads it)."""
    rng = np.random.default_rng(n_fft + hop)
    for n in (4000, 3333):
        x = rng.standard_normal((2, n)).astype(np.float32)
        (re, im), vjp = jax.vjp(lambda v: jax_stft(v, n_fft, hop, "hann", True), x)
        dre = rng.standard_normal(re.shape).astype(np.float32)
        dim = rng.standard_normal(im.shape).astype(np.float32)
        ref, = vjp((dre, dim))
        got = kstft.stft_vjp_plain(torch.from_numpy(dre), torch.from_numpy(dim), n, n_fft, hop)
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
        t = re.shape[1]
        for length in (n, n + 500):
            sre = rng.standard_normal(re.shape).astype(np.float32)
            sim = rng.standard_normal(re.shape).astype(np.float32)
            y, vjp_i = jax.vjp(lambda a, b: jax_istft(a, b, n_fft, hop, "hann", True,
                                                        length), sre, sim)
            dy = rng.standard_normal(y.shape).astype(np.float32)
            ref_re, ref_im = (np.asarray(v) for v in vjp_i(dy))
            got_re, got_im = kstft.istft_vjp_plain(torch.from_numpy(dy), t, n_fft, hop)
            scale = max(np.abs(ref_re).max(), np.abs(ref_im).max())
            assert np.abs(got_re.numpy() - ref_re).max() <= 1e-5 * scale
            assert np.abs(got_im.numpy() - ref_im).max() <= 1e-5 * scale


@pytest.mark.parametrize("n_fft,hop", VJP_PAIRS)
def test_plain_vjps_are_the_autograd_of_the_plain_versions(n_fft, hop):
    """The written-out adjoints give torch.autograd's gradients through
    ``stft_plain`` / ``istft_plain`` (weight 1 on every bin, the reflect pad
    folded back; the trim undone, COLA divided, g_k / n_fft)."""
    gen = torch.Generator().manual_seed(n_fft)
    x = torch.randn(3, 2999, generator=gen).requires_grad_()
    re, im = kstft.stft_plain(x, n_fft, hop)
    dre, dim = torch.randn(re.shape, generator=gen), torch.randn(im.shape, generator=gen)
    ref, = torch.autograd.grad((re * dre).sum() + (im * dim).sum(), x)
    got = kstft.stft_vjp_plain(dre, dim, 2999, n_fft, hop)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    sre = torch.randn(re.shape, generator=gen).requires_grad_()
    sim = torch.randn(re.shape, generator=gen).requires_grad_()
    y = kstft.istft_plain(sre, sim, n_fft, hop, length=2900)
    dy = torch.randn(y.shape, generator=gen)
    ref_re, ref_im = torch.autograd.grad((y * dy).sum(), (sre, sim))
    got_re, got_im = kstft.istft_vjp_plain(dy, re.shape[1], n_fft, hop)
    scale = max(ref_re.abs().max(), ref_im.abs().max())
    assert (got_re - ref_re).abs().max() <= 1e-5 * scale
    assert (got_im - ref_im).abs().max() <= 1e-5 * scale


@pytest.mark.parametrize("name", ["single_utterance", "paired", "adversarial", "acoustic",
                                  "aas"])
def test_preset_matches_jax(name):
    got = tconfig.preset(name)
    assert got == TConfig.from_json(jconfig.preset(name).to_json())
    assert got.train.objective == jconfig.preset(name).train.objective


def test_preset_unknown_raises():
    with pytest.raises(ValueError, match="unknown preset"):
        tconfig.preset("nope")


def test_init_state_builds_g_and_adam_for_enhance_only():
    state = init_state(tconfig.preset("single_utterance"), 0, "cpu")
    assert state.g is not None and state.g_opt is not None
    assert state.d is None and state.am is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return generate_corpus(str(tmp_path_factory.mktemp("corpus")), n_utts=4, seed=2,
                           vocab_chars=6)


def test_paired_validation_records(corpus):
    """``paired`` validates with the decode-only AM and logs no
    ``val_wer_noisy``; without a decode-only AM it logs no validation."""
    cfg = TConfig.from_json(_cfg().to_json())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2, eval_every=1),
                      data=dataclasses.replace(cfg.data, val_manifest=corpus["noisy"]))
    am = init_am(cfg, 3, "cpu")
    state, records = train(cfg, corpus["noisy"], corpus["clean"], paired=True, max_steps=2,
                           device="cpu", eval_am=am)
    vals = [r for r in records if "val_wer" in r]
    assert [r["step"] for r in vals] == [1, 2]
    assert all("val_wer_noisy" not in r for r in vals)
    want = evaluate_wer(cfg, am, corpus["noisy"], enhancer=state.g,
                        batch_size=cfg.train.eval_batch_size)
    assert vals[-1]["val_wer"] == want["wer"]
    _, records = train(cfg, corpus["noisy"], corpus["clean"], paired=True, max_steps=1,
                       device="cpu")
    assert not any("val_wer" in r for r in records)


def test_paired_batches_weigh_the_clean_rows_as_the_noisy_rows(corpus):
    """The paired clean rows' weights are the batch's real rows (a short batch's
    repeat-padded rows weigh 0), as the JAX loop gives them."""
    from aas_enhancement_tpu_torch.data.dataset import AudioDataset
    from aas_enhancement_tpu_torch.parallel.mesh import DataMesh
    from aas_enhancement_tpu_torch.train.loop import batch_dict
    cfg = TConfig.from_json(_cfg().to_json())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=3))
    ds = AudioDataset(corpus["noisy"], cfg.audio, cfg.data, paired_manifest=corpus["clean"])
    short = list(ds.batches(3))[-1]
    assert short.size == 1
    bd = batch_dict(cfg, short, None, DataMesh())
    assert bd["row_weights"].tolist() == bd["clean_row_weights"].tolist() == [1, 0, 0]
    with pytest.raises(ValueError, match="paired clean manifest"):
        batch_dict(cfg, list(AudioDataset(corpus["noisy"], cfg.audio, cfg.data)
                             .batches(3))[0], None, DataMesh())


@pytest.mark.parametrize("lam,keys", [
    (0.0, {"loss_paired"}), (0.5, {"loss_paired", "loss_mrstft", "loss_paired_total"})])
def test_cli_paired_on_cpu(corpus, tmp_path, capsys, lam, keys):
    """--objective paired: the JAX CLI's final line (final_step and the last
    record's loss_* keys)."""
    cfg = _cfg(lambda_mrstft=lam)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    path = tmp_path / "cfg.json"
    path.write_text(cfg.to_json())
    train_cli.main(["--objective", "paired", "--noisy-manifest", corpus["noisy"],
                    "--clean-manifest", corpus["clean"], "--steps", "3", "--config",
                    str(path), "--device", "cpu"])
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert set(line) == {"final_step"} | keys
    assert line["final_step"] == 3 and all(np.isfinite(v) for v in line.values())
    records = [json.loads(s) for s in out.err.strip().splitlines() if s.startswith("{")]
    assert [r["step"] for r in records if "utts_per_sec" in r] == [1, 2, 3]


def test_cli_paired_needs_the_clean_manifest(corpus):
    with pytest.raises(SystemExit):
        train_cli.main(["--objective", "paired", "--noisy-manifest", corpus["noisy"],
                        "--device", "cpu"])
