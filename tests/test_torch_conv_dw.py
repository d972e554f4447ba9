"""Port parity: the conv weight gradient (aas_enhancement_tpu_torch.ops.cuda
.conv_dw plain version, .ops.conv TapDWConv) against the JAX package's
conv_dw_same in Pallas interpret mode, jax.vjp of its SAME conv, and its
TapDWConv(dw_impl="pallas").

Inputs are made with numpy from a seed and go through both sides in f32.
Tolerance 1e-4 of max|dW| (each entry is an f32 sum over up to ~2,400
positions, in the Pallas tiles' order, XLA's and torch's matmul order); the
primal and dx come from the two frameworks' native convs and are held to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.ops.conv import TapDWConv as JaxTapDWConv
from aas_enhancement_tpu.ops.conv import _nhwc_conv
from aas_enhancement_tpu.ops.pallas.conv_dw_kernel import conv_dw_same as jax_conv_dw_same
from aas_enhancement_tpu_torch.ops import conv as tconv
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv

torch.set_num_threads(1)

SHAPES = [
    # b, t, f, ci, co, kt, kf, strides
    (2, 37, 23, 8, 16, 5, 5, (1, 1)),
    (2, 33, 21, 8, 8, 3, 7, (1, 1)),
    (1, 40, 16, 16, 8, 1, 1, (1, 1)),
    (2, 29, 41, 8, 8, 11, 21, (1, 2)),   # the AM's conv2 taps, odd F: pad (10, 10)
    (2, 30, 17, 8, 8, 5, 5, (1, 2)),
    (2, 16, 18, 8, 8, 4, 6, (1, 2)),     # even taps, even F
    (2, 19, 40, 8, 8, 11, 21, (1, 2)),   # 11 x 21 on an even F: pad (9, 10)
    (1, 15, 81, 8, 8, 11, 21, (1, 2)),   # 11 x 21 on the AM's 81 bins
]


def _inputs(shape, seed=0):
    b, t, f, ci, co, kt, kf, strides = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, f, ci)).astype(np.float32)
    w = (0.2 * rng.standard_normal((kt, kf, ci, co))).astype(np.float32)
    dy = rng.standard_normal((b, t, -(-f // strides[1]), co)).astype(np.float32)
    return x, w, dy


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                 / (np.abs(np.asarray(ref)).max() + 1e-9))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_and_xla(shape):
    kt, kf, strides = shape[5], shape[6], shape[7]
    x, w, dy = _inputs(shape)
    got = kconv.conv_dw_same_plain(torch.from_numpy(x), torch.from_numpy(dy), kt, kf,
                                   strides).numpy()
    pallas = jax_conv_dw_same(jnp.asarray(x), jnp.asarray(dy), kt, kf, strides,
                              interpret=True)
    xla = jax.vjp(lambda w_: _nhwc_conv(jnp.asarray(x), w_, strides),
                  jnp.asarray(w))[1](jnp.asarray(dy))[0]
    assert got.shape == w.shape
    assert _rel(got, pallas) < 1e-4
    assert _rel(got, xla) < 1e-4


def test_cpu_tensor_takes_plain_version():
    x, _, dy = _inputs(SHAPES[4], seed=3)
    before = kconv.conv_dw_same.launches
    a = kconv.conv_dw_same(torch.from_numpy(x), torch.from_numpy(dy), 5, 5, (1, 2))
    b = kconv.conv_dw_same_plain(torch.from_numpy(x), torch.from_numpy(dy), 5, 5, (1, 2))
    assert torch.equal(a, b) and kconv.conv_dw_same.launches == before


@pytest.mark.parametrize("strides,dy_shape", [((2, 2), (2, 15, 9, 8)), ((1, 3), (2, 30, 6, 8)),
                                              ((1, 2), (2, 30, 8, 8))])
def test_wrong_strides_and_shapes_raise(strides, dy_shape):
    x, dy = torch.zeros(2, 30, 17, 8), torch.zeros(dy_shape)
    with pytest.raises((NotImplementedError, ValueError), match="conv_dw_same"):
        kconv.conv_dw_same(x, dy, 5, 5, strides)


@pytest.mark.parametrize("kernel,strides,f", [((5, 5), (1, 1), 15), ((5, 7), (1, 2), 17),
                                              ((11, 21), (1, 2), 20)])
@pytest.mark.parametrize("dw_impl", ["kernel", "auto", "cudnn"])
def test_tapdw_conv_matches_jax(kernel, strides, f, dw_impl):
    """Primal, dx, dW and dbias of TapDWConv (NCHW, weight OIHW) against the
    JAX TapDWConv(dw_impl="pallas") (NHWC, kernel HWIO) with the same weights:
    "kernel" takes the plain version of the dW kernel on the CPU, "auto" and
    "cudnn" torch's native conv backward."""
    rng = np.random.default_rng(sum(kernel) + f)
    b, t, ci, co = 2, 19, 8, 8
    x = rng.standard_normal((b, t, f, ci)).astype(np.float32)
    w = (0.2 * rng.standard_normal((*kernel, ci, co))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(co)).astype(np.float32)
    cot = rng.standard_normal((b, t, -(-f // strides[1]), co)).astype(np.float32)

    jmod = JaxTapDWConv(co, kernel_size=kernel, strides=strides, dw_impl="pallas")
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(bias)}}
    y_ref, pull = jax.vjp(lambda p, x_: jmod.apply(p, x_), params, jnp.asarray(x))
    dp_ref, dx_ref = pull(jnp.asarray(cot))

    mod = tconv.TapDWConv(ci, co, kernel, strides, dw_impl=dw_impl)
    mod.load_state_dict({"weight": torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
                         "bias": torch.from_numpy(bias)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = mod(xt)
    dx, dw, db = torch.autograd.grad(y, (xt, mod.weight, mod.bias),
                                     torch.from_numpy(cot).permute(0, 3, 1, 2))
    assert _rel(y.detach().permute(0, 2, 3, 1).numpy(), y_ref) < 1e-5
    assert _rel(dx.permute(0, 2, 3, 1).numpy(), dx_ref) < 1e-5
    assert _rel(dw.permute(2, 3, 1, 0).numpy(), dp_ref["params"]["kernel"]) < 1e-4
    assert _rel(db.numpy(), dp_ref["params"]["bias"]) < 1e-5


def test_tapdw_conv_is_a_same_conv_with_the_same_parameters():
    """Same parameter names, shapes and forward bits as SameConv2d, so every
    state_dict and convert.py stay valid."""
    ref = tconv.SameConv2d(8, 4, (3, 5), (1, 2))
    mod = tconv.TapDWConv(8, 4, (3, 5), (1, 2))
    assert mod.dw_impl == "auto"
    assert [(n, tuple(p.shape)) for n, p in mod.named_parameters()] == \
        [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    mod.load_state_dict(ref.state_dict())
    x = torch.randn(2, 8, 9, 14, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(mod(x), ref(x))
    with pytest.raises(ValueError, match="dw_impl"):
        tconv.TapDWConv(8, 4, (3, 5), (1, 2), dw_impl="pallas")(x)


@pytest.mark.parametrize("ci,strides", [(1, (1, 1)), (8, (2, 2))])
def test_unsupported_shapes_take_the_native_weight_gradient(ci, strides, monkeypatch):
    """ci = 1 (the first convs) and stride (2, 2) never reach conv_dw_same,
    whatever dw_impl says, as in the JAX package; gradients still match it."""
    def refuse(*args, **kw):
        raise AssertionError("conv_dw_same called for an unsupported shape")
    monkeypatch.setattr(tconv, "conv_dw_same", refuse)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, 10, ci)).astype(np.float32)
    w = rng.standard_normal((3, 3, ci, 8)).astype(np.float32)
    assert not tconv.tapdw_supported((8, ci, 3, 3), strides)
    ref = jax.grad(lambda w_: jnp.sum(_nhwc_conv(jnp.asarray(x), w_, strides) ** 2))(
        jnp.asarray(w))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()
    y = tconv.conv2d_tapdw(torch.from_numpy(x).permute(0, 3, 1, 2), wt, None, strides,
                           "kernel")
    (dw,) = torch.autograd.grad((y ** 2).sum(), wt)
    assert _rel(dw.permute(2, 3, 1, 0).numpy(), ref) < 1e-5


def test_frozen_weight_computes_no_weight_gradient(monkeypatch):
    """A conv whose weight does not require grad (the frozen AM of AAS
    training) never calls the dW kernel."""
    def refuse(*args, **kw):
        raise AssertionError("conv_dw_same called for a frozen weight")
    monkeypatch.setattr(tconv, "conv_dw_same", refuse)
    mod = tconv.TapDWConv(8, 8, (3, 3), (1, 1), dw_impl="kernel").requires_grad_(False)
    x = torch.randn(1, 8, 6, 7, generator=torch.Generator().manual_seed(1)).requires_grad_()
    (dx,) = torch.autograd.grad(mod(x).sum(), x)
    assert dx.shape == x.shape and torch.isfinite(dx).all()
