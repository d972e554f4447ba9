"""Port parity: the spectrogram discriminator (aas_enhancement_tpu_torch.models
.discriminator) against the JAX Discriminator from converted parameters, and
the GAN losses (train/objectives.py) against JAX's, LSGAN and BCE.

Tolerances: scores rtol/atol 1e-5 (three 5x5 convs of <= 400-term f32 sums
and a mean over valid frames, summed in another order on each side); losses
rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import Config as JaxConfig
from aas_enhancement_tpu.config import DiscriminatorConfig as JaxDiscConfig
from aas_enhancement_tpu.models.discriminator import Discriminator as JaxDiscriminator
from aas_enhancement_tpu.train import objectives as jobj
from aas_enhancement_tpu_torch.config import Config, DiscriminatorConfig
from aas_enhancement_tpu_torch.convert import disc_params_from_flax, init_like_flax
from aas_enhancement_tpu_torch.models.discriminator import Discriminator
from aas_enhancement_tpu_torch.train import objectives as obj

torch.set_num_threads(1)

F_BINS = 33
CHANNELS = (4, 8, 16)


@pytest.fixture(scope="module")
def jax_disc():
    mod = JaxDiscriminator(JaxDiscConfig(channels=CHANNELS))
    params = mod.init(jax.random.key(0), jnp.zeros((1, 24, F_BINS)), jnp.array([24]))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(          # non-zero biases
        lambda a: np.asarray(a) + (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        if a.ndim == 1 else np.asarray(a), params)
    return mod, params


def _torch_disc(params):
    model = Discriminator(DiscriminatorConfig(channels=CHANNELS), F_BINS)
    model.load_state_dict(disc_params_from_flax(params))
    return model


@pytest.mark.parametrize("t,lengths", [(30, [30, 17, 1]), (29, [29, 29, 8])])
def test_scores_match_jax(jax_disc, t, lengths):
    mod, params = jax_disc
    x = np.random.default_rng(t).standard_normal((3, t, F_BINS)).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    ref = np.asarray(mod.apply(params, jnp.asarray(x), jnp.asarray(lengths)))
    with torch.no_grad():
        got = _torch_disc(params)(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_padding_invariance(jax_disc):
    """A zero-padded row scores as its unpadded run (its input, the enhanced
    log-magnitude, is zero on padded frames).  As in the JAX package's own
    test, the lengths keep each layer's parity (24 -> 12 -> 6 and
    40 -> 20 -> 10), since SAME padding puts its odd pad on the high side."""
    model = _torch_disc(jax_disc[1])
    x = np.random.default_rng(1).standard_normal((1, 24, F_BINS)).astype(np.float32)
    padded = np.concatenate([x, np.zeros((1, 16, F_BINS), np.float32)], axis=1)
    with torch.no_grad():
        solo = model(torch.from_numpy(x), torch.tensor([24]))
        pad = model(torch.from_numpy(padded), torch.tensor([24]))
    torch.testing.assert_close(pad, solo, rtol=1e-5, atol=1e-5)


def test_converter_covers_every_parameter(jax_disc):
    sd = disc_params_from_flax(jax_disc[1])
    model = Discriminator(DiscriminatorConfig(channels=CHANNELS), F_BINS)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_default_discriminator_has_the_jax_parameter_count():
    mod = JaxDiscriminator(JaxDiscConfig())
    params = jax.eval_shape(lambda: mod.init(jax.random.key(0), jnp.zeros((1, 64, 161)),
                                             jnp.array([64])))
    n_ref = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    model = Discriminator(DiscriminatorConfig(), 161, device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert model.head.kernel.shape == (21 * 128, 1)


def test_init_like_flax_draws_the_discriminator():
    gen = torch.Generator().manual_seed(0)
    model = init_like_flax(Discriminator(DiscriminatorConfig(), 161), gen)
    w = model.convs[1].weight                          # lecun normal, fan_in 32 * 25
    assert abs(w.std().item() - (1 / 800) ** 0.5) < 0.05 * (1 / 800) ** 0.5
    assert torch.all(model.convs[0].bias == 0) and torch.all(model.head.bias == 0)


def test_unported_dtype_raises():
    with pytest.raises(NotImplementedError, match="float32"):
        Discriminator(DiscriminatorConfig(dtype="bfloat16"), F_BINS)


@pytest.mark.parametrize("gan_loss", ["lsgan", "bce"])
@pytest.mark.parametrize("weights", [None, (1.0, 0.0, 1.0, 1.0)])
def test_gan_losses_match_jax(gan_loss, weights):
    jcfg = JaxConfig()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, gan_loss=gan_loss))
    cfg = Config().replace(train=dataclasses.replace(Config().train, gan_loss=gan_loss))
    rng = np.random.default_rng(3)
    real, fake = (3.0 * rng.standard_normal((2, 4))).astype(np.float32)
    w = None if weights is None else np.array(weights, np.float32)
    tw = None if w is None else torch.from_numpy(w)
    ref_g = jobj.gan_g_loss(jcfg, jnp.asarray(fake), w, 2.5 if w is not None else None)
    got_g = obj.gan_g_loss(cfg, torch.from_numpy(fake), tw, 2.5 if w is not None else None)
    ref_d = jobj.gan_d_loss(jcfg, jnp.asarray(real), jnp.asarray(fake), w_real=w, w_fake=w)
    got_d = obj.gan_d_loss(cfg, torch.from_numpy(real), torch.from_numpy(fake),
                           w_real=tw, w_fake=tw)
    assert float(got_g) == pytest.approx(float(ref_g), rel=1e-6)
    assert float(got_d) == pytest.approx(float(ref_d), rel=1e-6)
