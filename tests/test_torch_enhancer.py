"""Port parity: the Enhancer and the whole enhance path
(aas_enhancement_tpu_torch.models.enhancer, .convert, .enhance) against the
JAX package, with the flax parameter tree carried over by convert.py.

Small widths (8 conv channels, BiLSTM-16), f32 on the CPU.  Tolerances:
network outputs in (0, 1) (mask) or log-magnitudes (mapping) agree to 1e-5;
the enhanced waveform to 1e-4 absolute on unit-scale audio, since it goes
through STFT, the network and ISTFT, each summing in its own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import Config, EnhancerConfig
from aas_enhancement_tpu.enhance import init_enhancer as jax_init
from aas_enhancement_tpu.enhance import make_enhance_fn as jax_make_enhance_fn
from aas_enhancement_tpu.models.enhancer import Enhancer as JaxEnhancer
from aas_enhancement_tpu_torch.convert import enhancer_params_from_flax, init_like_flax
from aas_enhancement_tpu_torch.enhance import (
    enhance_utterance, init_enhancer, make_enhance_fn)
from aas_enhancement_tpu_torch.models.enhancer import Enhancer

torch.set_num_threads(1)

SMALL = EnhancerConfig(conv_channels=8, conv_layers=2, rnn_hidden=16, rnn_layers=2)
F_BINS = 161


def _flax_params(cfg, seed=0, t=24):
    params = JaxEnhancer(cfg).init(jax.random.key(seed), jnp.zeros((1, t, F_BINS)),
                                   jnp.array([t], jnp.int32))
    # Non-zero biases and GN affine so every converted tensor matters.
    rng = np.random.default_rng(seed + 100)
    return jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 else np.array(a), params)


def _torch_model(cfg, params):
    model = Enhancer(cfg, F_BINS)
    model.load_state_dict(enhancer_params_from_flax(params))
    return model.eval()


@pytest.mark.parametrize("mode", ["mask", "mapping"])
def test_enhancer_matches_flax(mode):
    cfg = dataclasses.replace(SMALL, mode=mode)
    params = _flax_params(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 30, F_BINS)).astype(np.float32)
    lengths = np.array([30, 17], np.int32)
    ref = np.asarray(JaxEnhancer(cfg).apply(params, jnp.asarray(x), jnp.asarray(lengths)))
    with torch.no_grad():
        got = _torch_model(cfg, params)(torch.from_numpy(x),
                                        torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.all(got[1, 17:] == 0.0)


def test_converter_covers_every_parameter():
    params = _flax_params(SMALL)
    sd = enhancer_params_from_flax(params)
    model = Enhancer(SMALL, F_BINS)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_enhance_fn_matches_jax():
    cfg = Config().replace(enhancer=SMALL)
    params = _flax_params(SMALL, seed=3)
    rng = np.random.default_rng(4)
    n = 16000
    wav = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    lengths = np.array([n, 11000], np.int32)
    wav[1, 11000:] = 0.0
    ref = np.asarray(jax_make_enhance_fn(cfg)(params, jnp.asarray(wav),
                                              jnp.asarray(lengths)))
    got = make_enhance_fn(cfg, "cpu")(_torch_model(SMALL, params),
                                      torch.from_numpy(wav),
                                      torch.from_numpy(lengths)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_enhance_utterance_matches_jax_single_row():
    cfg = Config().replace(enhancer=SMALL)
    params = jax_init(cfg, jax.random.key(5), max_t=24)
    wav = (0.3 * np.random.default_rng(6).standard_normal(8000)).astype(np.float32)
    ref = np.asarray(jax_make_enhance_fn(cfg)(params, jnp.asarray(wav)[None],
                                              jnp.array([8000], jnp.int32)))[0]
    got = enhance_utterance(cfg, _torch_model(SMALL, params), wav, "cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_random_init_follows_flax_distributions():
    """Same shapes as flax, seeded and repeatable, and the flax moments:
    lecun-normal kernels (std sqrt(1/fan_in)), orthogonal wh, zero biases."""
    cfg = Config()
    a = init_enhancer(cfg, seed=0, device="cpu")
    b = init_enhancer(cfg, seed=0, device="cpu")
    assert all(torch.equal(u, v) for u, v in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    w = a.blstms[0].wx.kernel
    assert abs(w.std().item() - (1.0 / w.shape[0]) ** 0.5) < 0.02 * (1.0 / w.shape[0]) ** 0.5
    wh = a.blstms[0].wh.reshape(-1, a.blstms[0].wh.shape[-1])     # [2H, 4H]
    torch.testing.assert_close(wh @ wh.T, torch.eye(wh.shape[0]), rtol=0, atol=1e-5)
    assert torch.all(a.blstms[0].bh == 0) and torch.all(a.gns[0].scale == 1)
    flax_zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: jax_init(cfg, jax.random.key(0), max_t=8)))
    sd = enhancer_params_from_flax(flax_zeros)
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in a.state_dict().items()}


def test_init_like_flax_is_seeded():
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    m1 = init_like_flax(Enhancer(SMALL, F_BINS), g1)
    m2 = init_like_flax(Enhancer(SMALL, F_BINS), g2)
    assert not torch.equal(m1.proj.kernel, m2.proj.kernel)
