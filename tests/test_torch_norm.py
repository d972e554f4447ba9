"""Port parity: masked GroupNorm + activation (aas_enhancement_tpu_torch.ops.norm,
.ops.cuda.gn plain version) against the JAX MaskedGroupNorm and the Pallas
masked_group_norm_act in interpret mode, on ragged lengths, a length-0 row and
frame counts that are no multiple of the forward kernel's 8-frame items.

Tolerance 1e-5 (rtol and atol): unit-scale activations and gradients, f32
statistics summed over a few thousand elements in a different order on each
side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.ops.norm import MaskedGroupNorm as JaxGN
from aas_enhancement_tpu.ops.pallas.gn_kernel import masked_group_norm_act as gn_pallas
from aas_enhancement_tpu_torch.ops.norm import MaskedGroupNorm
from aas_enhancement_tpu_torch.ops.cuda import gn
from aas_enhancement_tpu_torch.ops.masking import time_mask

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _data(b=2, t=20, f=17, c=16, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    x = (0.5 + rng.standard_normal((b, t, f, c))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    lengths = np.array([t, t - 9][:b] if lengths is None else lengths, np.int32)
    return x, scale, bias, lengths


# (b, t, f, c, lengths): ragged; a length-0 row and T = 21 (items of 8 frames:
# a partial last one); C = 32 at T = 13 with a row past T's last item start.
SHAPES = [(2, 20, 17, 16, None), (3, 21, 5, 16, [21, 0, 9]), (2, 13, 9, 32, [13, 9])]


def _jax_ref(x, scale, bias, lengths, act):
    mod = JaxGN(num_groups=8, act=act, impl="xla")
    return np.asarray(mod.apply({"params": {"scale": scale, "bias": bias}},
                                jnp.asarray(x), jnp.asarray(lengths)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "leaky_relu", "hardtanh"])
def test_module_matches_jax(act, shape):
    *dims, lens = shape
    x, scale, bias, lengths = _data(*dims, seed=1, lengths=lens)
    mod = MaskedGroupNorm(x.shape[-1], num_groups=8, act=act)
    with torch.no_grad():
        mod.scale.copy_(torch.from_numpy(scale))
        mod.bias.copy_(torch.from_numpy(bias))
        got = mod(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, _jax_ref(x, scale, bias, lengths, act), **TOL)
    assert np.all(got[1, lengths[1]:] == 0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape):
    *dims, lens = shape
    x, scale, bias, lengths = _data(*dims, seed=2, lengths=lens)
    got = gn.masked_group_norm_act_plain(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(lengths), num_groups=8, act="leaky_relu").numpy()
    ref = np.asarray(gn_pallas(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                               jnp.asarray(lengths), num_groups=8, act="leaky_relu",
                               interpret=True))
    np.testing.assert_allclose(got, ref, **TOL)


def test_padding_invariance():
    x, scale, bias, lengths = _data(seed=3)
    x2 = x.copy()
    x2[1, lengths[1]:] = 99.0                       # garbage in padded frames
    args = (torch.from_numpy(scale), torch.from_numpy(bias), torch.from_numpy(lengths))
    a = gn.masked_group_norm_act(torch.from_numpy(x), *args, num_groups=8,
                                 act="leaky_relu")
    b = gn.masked_group_norm_act(torch.from_numpy(x2), *args, num_groups=8,
                                 act="leaky_relu")
    assert torch.equal(a, b)


def test_cpu_tensor_takes_plain_version():
    x, scale, bias, lengths = _data(seed=4)
    before = gn.masked_group_norm_act.launches
    args = (torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
            torch.from_numpy(lengths))
    assert torch.equal(gn.masked_group_norm_act(*args, num_groups=8, act="hardtanh"),
                       gn.masked_group_norm_act_plain(*args, num_groups=8,
                                                      act="hardtanh"))
    assert gn.masked_group_norm_act.launches == before


def test_rejects_bad_arguments():
    x = torch.zeros(1, 4, 3, 12)
    with pytest.raises(ValueError):
        gn.masked_group_norm_act(x, torch.ones(12), torch.zeros(12),
                                 torch.tensor([4]), num_groups=8)
    with pytest.raises(ValueError, match="unknown act"):
        gn.masked_group_norm_act(x, torch.ones(12), torch.zeros(12),
                                 torch.tensor([4]), num_groups=4, act="relu")


@pytest.mark.parametrize("act", ["leaky_relu", "hardtanh"])
def test_plain_gradients_match_pallas_interpret(act):
    """dx, dscale, dbias of autograd through the plain version against
    jax.grad through the Pallas masked_group_norm_act (interpret mode): the
    math the backward kernel B3' implements.  A wide x puts some z past
    hardtanh's 20 and many below 0."""
    x, scale, bias, lengths = _data(seed=5)
    x = 4.0 * x
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jax_loss(x_, s_, b_):
        y = gn_pallas(x_, s_, b_, jnp.asarray(lengths), num_groups=8, act=act,
                      interpret=True)
        return jnp.sum(y * jnp.asarray(dy))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                               jnp.asarray(bias))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = gn.masked_group_norm_act(*inputs, torch.from_numpy(lengths), num_groups=8, act=act)
    got = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **TOL)
    assert np.all(got[0].numpy()[1, lengths[1]:] == 0)


# ---------------------------------------------------------------- backward
# masked_group_norm_act_bwd_plain, the closed form the backward kernel B3'
# computes, from the forward's per-(B, C) mean and inv.


def _bwd_data(shape, seed):
    """Inputs of the backward at ``shape``: x with rare spikes and a wide
    scale, so that z = x_hat * scale + bias lies past hardtanh's 20 as well
    as below 0 on valid frames; a cotangent; mean and inv [B, C] from the
    plain forward's group statistics."""
    *dims, lens = shape
    x, scale, bias, lengths = _data(*dims, seed=seed, lengths=lens)
    rng = np.random.default_rng(seed + 100)
    x = np.where(rng.random(x.shape) < 0.01, 30.0 * x, x).astype(np.float32)
    scale = (4.0 * scale).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    b, t, f, c = x.shape
    lt = torch.from_numpy(lengths)
    mask = time_mask(lt, t)[:, :, None, None]
    xm = (torch.from_numpy(x) * mask).reshape(b, t, f, 8, c // 8)
    mean, inv = gn._group_stats(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                                lt, f, c, 8, 1e-5)
    mean, inv = (v.repeat_interleave(c // 8, dim=1) for v in (mean, inv))
    z = (torch.from_numpy(x) * inv[:, None, None] - (mean * inv)[:, None, None]) \
        * torch.from_numpy(scale) + torch.from_numpy(bias)
    valid = z[mask.expand_as(z).bool()]
    assert (valid > 20).any() and (valid < 0).any()
    return x, scale, bias, lengths, dy, mean, inv


def _bwd_plain(x, scale, bias, lengths, dy, mean, inv, act):
    args = [torch.from_numpy(a) for a in (x, dy, scale, bias, lengths)]
    x_t, dy_t, *rest = args
    return gn.masked_group_norm_act_bwd_plain(x_t, dy_t, *rest, mean, inv, num_groups=8,
                                              act=act)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "leaky_relu", "hardtanh"])
def test_bwd_plain_matches_pallas_vjp(act, shape):
    """(dx, dscale, dbias) of the closed form against jax.vjp through the
    Pallas masked_group_norm_act in interpret mode, which runs _gn_bwd."""
    x, scale, bias, lengths, dy, mean, inv = _bwd_data(shape, seed=7)
    fn = lambda x_, s_, b_: gn_pallas(x_, s_, b_, jnp.asarray(lengths),    # noqa: E731
                                      num_groups=8, act=act, interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = vjp(jnp.asarray(dy))
    got = _bwd_plain(x, scale, bias, lengths, dy, mean, inv, act)
    for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("act", ["none", "leaky_relu", "hardtanh"])
def test_bwd_plain_matches_autograd(act, shape):
    """The closed form against autograd through masked_group_norm_act_plain;
    dx exactly 0 on padded frames (a length-0 row among SHAPES)."""
    x, scale, bias, lengths, dy, mean, inv = _bwd_data(shape, seed=8)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    y = gn.masked_group_norm_act_plain(*inputs, torch.from_numpy(lengths), num_groups=8,
                                       act=act)
    ref = torch.autograd.grad(y, inputs, torch.from_numpy(dy))
    got = _bwd_plain(x, scale, bias, lengths, dy, mean, inv, act)
    for name, a, r in zip(("dx", "dscale", "dbias"), got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), err_msg=name, **TOL)
    for i, n in enumerate(lengths):
        assert torch.all(got[0][i, n:] == 0)


def test_bwd_cpu_tensor_takes_plain_version():
    x, scale, bias, lengths, dy, mean, inv = _bwd_data(SHAPES[1], seed=9)
    before = gn.masked_group_norm_act_bwd.launches
    args = [torch.from_numpy(a) for a in (x, dy, scale, bias, lengths)]
    got = gn.masked_group_norm_act_bwd(*args, mean, inv, num_groups=8, act="hardtanh")
    ref = gn.masked_group_norm_act_bwd_plain(*args, mean, inv, num_groups=8, act="hardtanh")
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
    assert gn.masked_group_norm_act_bwd.launches == before
