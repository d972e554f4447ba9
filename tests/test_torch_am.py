"""Port parity: the SAME strided conv and the DeepSpeech2 acoustic model
(aas_enhancement_tpu_torch.ops.conv, .models.am, .convert) against the JAX
package's SpaceToDepthConv / TapDWConv and AcousticModel (BiGRU on its XLA
scan), with the flax parameter tree carried over by convert.py.

Small widths (8 conv channels, 2 x BiGRU-16), f32 on the CPU.  Tolerances:
the convs agree to 1e-5 (O(1) outputs, one f32 sum of up to 11 * 21 * 8
terms, in another order); the AM's logits to 1e-4, since they go through two convs, two GNs,
two BiGRU layers and the FC, each summing in its own order.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.config import AMConfig as JaxAMConfig
from aas_enhancement_tpu.models.am import AcousticModel as JaxAcousticModel
from aas_enhancement_tpu.ops.conv import SpaceToDepthConv, TapDWConv
from aas_enhancement_tpu.ops.masking import masked_mean as jax_masked_mean
from aas_enhancement_tpu_torch.config import AMConfig
from aas_enhancement_tpu_torch.convert import am_params_from_flax, init_like_flax
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.ops.conv import SameConv2d, same_pad
from aas_enhancement_tpu_torch.ops.masking import conv_out_length, masked_mean

torch.set_num_threads(1)

SMALL = dict(rnn_hidden=16, rnn_layers=2, conv_channels=8)
F_AM = 41


def _with_bias(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * (a.ndim == 1), params)


def _conv_from_flax(params, c_in, c_out, k, s):
    conv = SameConv2d(c_in, c_out, k, s)
    p = params["params"]
    conv.load_state_dict({
        "weight": torch.from_numpy(np.asarray(p["kernel"])).permute(3, 2, 0, 1),
        "bias": torch.from_numpy(np.asarray(p["bias"]))})
    return conv


def _nhwc(conv, x):
    with torch.no_grad():
        return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("t,f", [(22, 41), (23, 40), (64, 161), (63, 81)])
def test_same_conv_matches_space_to_depth_conv(t, f):
    x = np.random.default_rng(t).standard_normal((2, t, f, 1)).astype(np.float32)
    mod = SpaceToDepthConv(8, kernel_size=(11, 41))
    params = mod.init(jax.random.key(t), jnp.asarray(x))
    params = _with_bias(params)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    got = _nhwc(_conv_from_flax(params, 1, 8, (11, 41), (2, 2)), x)
    assert got.shape == ref.shape == (2, -(-t // 2), -(-f // 2), 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,f", [(22, 41), (23, 40), (31, 81)])
def test_same_conv_matches_tap_dw_conv(t, f):
    x = np.random.default_rng(t).standard_normal((2, t, f, 8)).astype(np.float32)
    mod = TapDWConv(8, kernel_size=(11, 21), strides=(1, 2), dw_impl="xla",
                    dx_impl="phase_fused")
    params = mod.init(jax.random.key(t), jnp.asarray(x))
    params = _with_bias(params)
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    got = _nhwc(_conv_from_flax(params, 8, 8, (11, 21), (1, 2)), x)
    assert got.shape == ref.shape == (2, t, -(-f // 2), 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,k,s,pad", [(800, 11, 2, (4, 5)), (801, 11, 2, (5, 5)),
                                          (161, 41, 2, (20, 20)), (81, 21, 2, (10, 10)),
                                          (80, 21, 2, (9, 10)), (7, 3, 1, (1, 1))])
def test_same_pad_is_tf_style(size, k, s, pad):
    assert same_pad(size, k, s) == pad
    ref = nn.Conv(1, (k,), strides=(s,), padding="SAME", use_bias=False)
    x = jnp.ones((1, size, 1))
    y = ref.apply({"params": {"kernel": jnp.ones((k, 1, 1))}}, x)
    # Edge output = number of real taps it covers = k - padding on that side.
    assert float(y[0, 0, 0]) == k - pad[0]


@pytest.fixture(scope="module")
def jax_am():
    """One tiny JAX AM with non-zero biases and GN affine, shared by the module."""
    mod = JaxAcousticModel(JaxAMConfig(**SMALL))
    params = mod.init(jax.random.key(0), jnp.zeros((1, 24, F_AM)), jnp.array([24]))
    rng = np.random.default_rng(100)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] == 2) else np.asarray(a), params)
    return mod, params


def _torch_am(params):
    model = AcousticModel(AMConfig(**SMALL), F_AM)
    model.load_state_dict(am_params_from_flax(params))
    return model.eval()


@pytest.mark.parametrize("t,lengths", [(22, [22, 15, 1]), (23, [23, 12, 23])])
def test_am_matches_jax(jax_am, t, lengths):
    mod, params = jax_am
    x = np.random.default_rng(t).standard_normal((3, t, F_AM)).astype(np.float32)
    lengths = np.array(lengths, np.int32)
    ref, ref_len = mod.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    with torch.no_grad():
        got, got_len = _torch_am(params)(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert got.shape == ref.shape == (3, -(-t // 2), 29)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    for i, n in enumerate(got_len.tolist()):
        assert torch.all(got[i, n:] == 0)


def test_am_padding_invariance(jax_am):
    """Valid frames of a zero-padded batch equal an unpadded run (the AM's
    input is masked_normalize's output, which is zero on padded frames)."""
    model = _torch_am(jax_am[1])
    x = np.random.default_rng(3).standard_normal((1, 15, F_AM)).astype(np.float32)
    padded = np.concatenate([x, np.zeros((1, 8, F_AM), np.float32)], axis=1)
    with torch.no_grad():
        solo, n = model(torch.from_numpy(x), torch.tensor([15]))
        pad, n_pad = model(torch.from_numpy(padded), torch.tensor([15]))
    assert n.item() == n_pad.item() == 8
    torch.testing.assert_close(pad[:, :8], solo, rtol=1e-5, atol=1e-5)
    assert torch.all(pad[:, 8:] == 0)


def test_out_lengths():
    lengths = torch.tensor([801, 701, 601, 401, 800, 1, 0])
    torch.testing.assert_close(conv_out_length(lengths, 11, 2),
                               torch.tensor([401, 351, 301, 201, 400, 1, 0]))
    torch.testing.assert_close(conv_out_length(lengths, 11, 2, "VALID"),
                               (lengths - 11) // 2 + 1)


@pytest.mark.parametrize("shape,axis", [((3, 9, 5), (1, 2)), ((3, 9, 4, 2), (1, 2, 3)),
                                        ((3, 9), (1,))])
def test_masked_mean_matches_jax(shape, axis):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32)
    lengths = np.array([9, 4, 0], np.int32)
    ref = jax_masked_mean(jnp.asarray(x), jnp.asarray(lengths), axis=axis)
    got = masked_mean(torch.from_numpy(x), torch.from_numpy(lengths), axis=axis)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_converter_covers_every_parameter(jax_am):
    sd = am_params_from_flax(jax_am[1])
    model = AcousticModel(AMConfig(**SMALL), F_AM)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_default_am_has_the_jax_parameter_count():
    """15,331,133: the JAX package's golden count for AMConfig() at F = 161."""
    model = AcousticModel(AMConfig(), 161, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 15_331_133
    assert [r.wh.shape for r in model.rnns] == [(2, 512, 1536)] * 4
    assert model.rnns[0].wx.kernel.shape == (41 * 32, 2 * 1536)


def test_init_like_flax_draws_the_am():
    gen = torch.Generator().manual_seed(0)
    model = init_like_flax(AcousticModel(AMConfig(**SMALL), F_AM), gen)
    w = model.conv1.weight                       # lecun normal, fan_in 11 * 41
    assert abs(w.std().item() - (1 / 451) ** 0.5) < 0.1 * (1 / 451) ** 0.5
    assert torch.all(model.conv2.bias == 0) and torch.all(model.gn1.scale == 1)
    wh = model.rnns[0].wh.reshape(-1, model.rnns[0].wh.shape[-1])   # [2H, 3H]: orthogonal
    torch.testing.assert_close(wh @ wh.T, torch.eye(wh.shape[0]), rtol=0, atol=1e-5)


def test_unported_am_options_raise():
    with pytest.raises(NotImplementedError, match="float32"):
        AcousticModel(AMConfig(dtype="bfloat16"), F_AM)
    with pytest.raises(ValueError, match="unknown cell"):
        AcousticModel(AMConfig(rnn_type="rnn"), F_AM)
