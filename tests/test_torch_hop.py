"""The paths at the 25 ms / 10 ms framing (n_fft 400, hop 160, 201 bins: a
hop that does not divide n_fft) against the JAX package on the CPU, with the
JAX weights carried by ``convert.py``: the enhance function, a streaming
enhancer chunk call and a whole stream, the recognition forward (enhancer +
AM), the ``paired`` loss with the MR-STFT term and its G gradients, and one
``aas`` step; and the ``aas_torch::istft`` operator's fake shape at hops that
do not divide n_fft.

Small widths (8 channels, one conv layer, H = 12-16).  Tolerances are those
of the 20 ms / 10 ms tests these follow (tests/test_torch_enhancer.py,
test_torch_streaming.py, test_torch_evaluate.py, test_torch_paired.py,
test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu import evaluation as jax_eval
from aas_enhancement_tpu.config import AMConfig, AudioConfig, Config, EnhancerConfig
from aas_enhancement_tpu.enhance import make_enhance_fn as jax_make_enhance_fn
from aas_enhancement_tpu.enhance import make_streaming_enhance_fn as jax_streaming_fn
from aas_enhancement_tpu.models.am import AcousticModel as JaxAcousticModel
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu.streaming import StreamingEnhancer as JaxStreaming
from aas_enhancement_tpu.train import objectives as jobj
from aas_enhancement_tpu.train.loop import init_state as jax_init_state
from aas_enhancement_tpu_torch import evaluation as teval
from aas_enhancement_tpu_torch.config import Config as TConfig
from aas_enhancement_tpu_torch.convert import am_params_from_flax, enhancer_params_from_flax
from aas_enhancement_tpu_torch.enhance import make_enhance_fn, make_streaming_enhance_fn
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
from aas_enhancement_tpu_torch.train import objectives as tobj

from test_torch_paired import MR_GRAD_TOL, _assert_per_tensor
from test_torch_paired import _batch as _paired_batch
from test_torch_paired import _cfg as _paired_cfg
from test_torch_train import CONVERT, METRIC_RTOL, _assert_grads_close, _batch, _cfg
from test_torch_train import _to_torch, _torch_state

torch.set_num_threads(1)

AUDIO = AudioConfig(window_size=0.025, window_stride=0.01)
F_BINS = 201
SMALL = EnhancerConfig(conv_channels=8, conv_layers=1, rnn_hidden=16, rnn_layers=1)
SMALL_AM = AMConfig(rnn_hidden=16, rnn_layers=1, conv_channels=8)
CFG = Config(audio=AUDIO, enhancer=SMALL, am=SMALL_AM)
FWD_ATOL = 1e-5


def _perturbed(params, seed):
    """Non-zero biases and GN affine, so every converted tensor matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), params)


@pytest.fixture(scope="module")
def nets():
    """Flax params of the enhancer and the AM at 201 bins, and the torch
    modules they convert into."""
    g_p = _perturbed(JaxEnhancer(SMALL).init(jax.random.key(0), jnp.zeros((1, 24, F_BINS)),
                                             jnp.array([24], jnp.int32)), 1)
    am_p = _perturbed(JaxAcousticModel(SMALL_AM).init(
        jax.random.key(2), jnp.zeros((1, 24, F_BINS)), jnp.array([24])), 3)
    g = Enhancer(SMALL, F_BINS)
    g.load_state_dict(enhancer_params_from_flax(g_p))
    am = AcousticModel(SMALL_AM, F_BINS)
    am.load_state_dict(am_params_from_flax(am_p))
    return g_p, am_p, g.eval(), am.eval()


def _wav(b, n, lengths, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 330.0 * t)[None]
           + 0.1 * rng.standard_normal((b, n))).astype(np.float32)
    return wav * (np.arange(n)[None] < np.asarray(lengths)[:, None])


def test_config_is_the_25_10_framing():
    a = TConfig.from_json(CFG.to_json()).audio
    assert (a.n_fft, a.hop_length, a.num_bins) == (400, 160, F_BINS)
    assert a.n_fft % a.hop_length


def test_enhance_fn_matches_jax(nets):
    g_p, _, g, _ = nets
    n = 16000
    lengths = np.array([n, 11003], np.int32)
    wav = _wav(2, n, lengths, 4)
    ref = np.asarray(jax_make_enhance_fn(CFG)(g_p, jnp.asarray(wav), jnp.asarray(lengths)))
    got = make_enhance_fn(TConfig.from_json(CFG.to_json()), "cpu")(
        g, torch.from_numpy(wav), torch.from_numpy(lengths)).numpy()
    assert got.shape == ref.shape == (2, n)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_streaming_enhance_fn_matches_jax(nets):
    """One chunk call of the streaming enhance function: [B] stats windows
    and running moments, a ragged row."""
    g_p, _, g, _ = nets
    n = 9600
    lengths = np.array([n, 7000], np.int32)
    wav = _wav(2, n, lengths, 5)
    ss, se = np.array([10, 5], np.int32), np.array([50, 40], np.int32)
    run = (np.array([120.5, -3.0], np.float32), np.array([900.0, 40.0], np.float32),
           np.array([8050.0, 201.0], np.float32))
    ref = jax_streaming_fn(CFG)(g_p, jnp.asarray(wav), jnp.asarray(lengths), jnp.asarray(ss),
                                jnp.asarray(se), *(jnp.asarray(r) for r in run))
    got = make_streaming_enhance_fn(TConfig.from_json(CFG.to_json()), "cpu")(
        g, torch.from_numpy(wav), torch.from_numpy(lengths), torch.as_tensor(ss),
        torch.as_tensor(se), *(torch.as_tensor(r) for r in run))
    assert got[0].shape == (2, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=0, atol=FWD_ATOL)
    for a, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=FWD_ATOL)


@pytest.mark.parametrize("push", [1600, None])
def test_streaming_enhancer_matches_jax(nets, push):
    """A whole stream through StreamingEnhancer (chunk 0.5 s, lookahead
    0.1 s, history 0.5 s), pushed in 0.1 s pieces or at once."""
    g_p, _, g, _ = nets
    wav = _wav(1, 27000, [27000], 6)[0]
    kw = dict(chunk_seconds=0.5, lookahead_seconds=0.1, history_seconds=0.5)
    ref_eng = JaxStreaming(CFG, g_p, **kw)
    ref = np.concatenate([ref_eng.feed(wav), ref_eng.flush()])
    eng = StreamingEnhancer(TConfig.from_json(CFG.to_json()), g, **kw, device="cpu")
    if push is None:
        got = np.concatenate([eng.feed(wav), eng.flush()])
    else:
        got = np.concatenate([eng.feed(wav[i: i + push]) for i in range(0, len(wav), push)]
                             + [eng.flush()])
    assert got.shape == ref.shape == wav.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)


def test_recognition_forward_matches_jax(nets):
    """Logits and paddings of the enhanced leg (STFT at 201 bins, the
    enhancer's log-magnitudes, AM convs 201 -> 101 -> 51 bins, BiGRU) at
    ragged lengths."""
    g_p, am_p, g, am = nets
    lengths = np.array([8000, 5003], np.int32)
    wav = _wav(2, 8000, lengths, 7)
    ref, ref_pads = jax_eval.make_eval_forward(CFG, use_enhancer=True)(
        am_p, g_p, jnp.asarray(wav), jnp.asarray(lengths))
    got, pads = teval.make_eval_forward(TConfig.from_json(CFG.to_json()), use_enhancer=True)(
        am, g, torch.from_numpy(wav), torch.from_numpy(lengths))
    np.testing.assert_array_equal(pads.numpy(), np.asarray(ref_pads))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_paired_loss_with_mr_stft_and_g_gradients_match_jax():
    """The ``paired`` loss with lambda_mrstft 0.5: its gradient runs back
    through the ISTFT at (400, 160) and the three MR-STFT resolutions."""
    cfg = dataclasses.replace(_paired_cfg(lambda_mrstft=0.5), audio=AUDIO)
    jstate = jax_init_state(cfg, jax.random.key(0))
    batch = _paired_batch(seed=5)
    (_, jaux), jgrads = jax.value_and_grad(
        lambda p: jobj.paired_loss(cfg, p, batch), has_aux=True)(jstate.g_params)
    tcfg = TConfig.from_json(cfg.to_json())
    g = Enhancer(tcfg.enhancer, F_BINS)
    g.load_state_dict(enhancer_params_from_flax(jax.device_get(jstate.g_params)))
    loss, aux = tobj.paired_loss(tcfg, g, _to_torch(batch))
    assert set(aux) == set(jaux) and "loss_mrstft" in aux
    for k, v in jaux.items():
        assert float(aux[k]) == pytest.approx(float(v), rel=1e-5), k
    names, params = zip(*g.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    _assert_per_tensor(grads, enhancer_params_from_flax(jax.device_get(jgrads)),
                       MR_GRAD_TOL, "g")


def test_aas_step_matches_jax():
    """One ``aas`` step (G, D, the frozen AM at 201 bins): metrics, G and D
    gradients and the Adam updates."""
    from aas_enhancement_tpu.train.steps import make_train_step as jax_make_train_step
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    cfg = dataclasses.replace(_cfg("aas"), audio=AUDIO)
    jstate = jax_init_state(cfg, jax.random.key(0))
    jstep = jax_make_train_step(cfg)
    batch = _batch(seed=1)
    jgrads, _ = jax.jit(jstep.batch_grads)(jstate, batch)
    jnew, jaux = jax.jit(jstep)(jstate, batch)
    tcfg, state = _torch_state(cfg, jstate)
    step = make_train_step(tcfg)
    tbatch = _to_torch(batch)
    grads, _ = step.batch_grads(state, tbatch)
    before = {net: {n: p.detach().clone() for n, p in getattr(state, net).named_parameters()}
              for net in grads}
    state, aux = step(state, tbatch)
    assert state.step == 1 and set(aux) == set(jaux) and set(grads) == set(jgrads)
    for key, ref in jaux.items():
        assert float(aux[key]) == pytest.approx(float(ref), rel=METRIC_RTOL, abs=1e-6), key
    for net, jg in jgrads.items():
        ref = {n: torch.as_tensor(v) for n, v in CONVERT[net](jax.device_get(jg)).items()}
        _assert_grads_close(grads[net], ref, net)
        lr = cfg.train.lr_g if net == "g" else cfg.train.lr_d
        jnew_params = CONVERT[net](jax.device_get(getattr(jnew, f"{net}_params")))
        scale = max(float(v.abs().max()) for v in ref.values())
        for name, p in getattr(state, net).named_parameters():
            upd = (p.detach() - before[net][name]).numpy()
            ref_upd = jnew_params[name].numpy() - before[net][name].numpy()
            sure = np.abs(ref[name].numpy()) > 1e-3 * scale
            np.testing.assert_allclose(upd[sure], ref_upd[sure], rtol=1e-3, atol=1e-3 * lr,
                                       err_msg=f"{net} {name}")


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (160, 320), (300, 200), (320, 160)])
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length", [None, 3000, 4000, 5000])
def test_istft_operator_fake_shape_is_the_operators(n_fft, hop, center, length):
    """``aas_torch::istft``'s fake gives the shape the operator returns (the
    fallback's output is cut to ``length``, never padded, where hop does not
    divide n_fft); so does ``aas_torch::stft``'s."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x = torch.from_numpy(_wav(2, 4000, [4000, 4000], 8))
    re, im = library.stft(x, n_fft, hop, "hann", center)
    y = library.istft(re, im, n_fft, hop, "hann", center, length)
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(x)
        fre, fim = library.stft(fx, n_fft, hop, "hann", center)
        fy = library.istft(mode.from_tensor(re), mode.from_tensor(im), n_fft, hop, "hann",
                           center, length)
    assert tuple(fre.shape) == tuple(re.shape) and tuple(fim.shape) == tuple(im.shape)
    assert tuple(fy.shape) == tuple(y.shape)
    full = (re.shape[1] - 1) * hop + n_fft - (n_fft // 2 if center else 0)
    assert y.shape[1] == (full if length is None else
                          length if n_fft % hop == 0 else min(length, full))
