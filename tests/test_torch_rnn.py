"""Port parity: the masked bidirectional LSTM and GRU
(aas_enhancement_tpu_torch.ops.rnn, .ops.cuda.rnn plain versions) against JAX
BiRNN(cell=..., time_major=True) on its XLA scan, and against the Pallas
lstm_scan_tm / gru_scan_tm in interpret mode; the stacked-layout versions
(lstm_scan_stacked / gru_scan_stacked, BiRNN(time_major=False)) against
lstm_scan_pallas / gru_scan_pallas in interpret mode and the JAX batch-major
BiRNN.

Tolerance 1e-5 (rtol and atol): bounded activations, f32 recurrent products
summed in a different order on each side, over at most 24 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.ops.pallas.rnn_kernel import gru_scan_pallas, lstm_scan_pallas
from aas_enhancement_tpu.ops.pallas.rnn_kernel import gru_scan_tm as gru_pallas
from aas_enhancement_tpu.ops.pallas.rnn_kernel import lstm_scan_tm as lstm_pallas
from aas_enhancement_tpu.ops.rnn import BiRNN as JaxBiRNN
from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
from aas_enhancement_tpu_torch.ops.rnn import BiRNN

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_birnn(x, lengths, hidden, cell="lstm"):
    mod = JaxBiRNN(hidden, cell=cell, time_major=True, impl="xla")
    params = mod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lengths))
    # Non-zero biases so bh and the wx bias are exercised too.
    rng = np.random.default_rng(11)
    p = jax.tree_util.tree_map(np.array, params)["params"]
    p["bh"] = (0.1 * rng.standard_normal(p["bh"].shape)).astype(np.float32)
    p["wx"]["bias"] = (0.1 * rng.standard_normal(p["wx"]["bias"].shape)).astype(np.float32)
    y = mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(lengths))
    return p, np.asarray(y)


def _torch_birnn(p, d, hidden, cell="lstm"):
    mod = BiRNN(d, hidden, cell=cell)
    mod.load_state_dict({"wx.kernel": torch.from_numpy(p["wx"]["kernel"]),
                         "wx.bias": torch.from_numpy(p["wx"]["bias"]),
                         "wh": torch.from_numpy(p["wh"]),
                         "bh": torch.from_numpy(p["bh"])})
    return mod


@pytest.mark.parametrize("t,b", [(19, 3), (8, 1)])
def test_birnn_matches_jax(t, b):
    d, hidden = 12, 16
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lengths = np.array([t, t - 7, 3][:b], np.int32)
    p, ref = _jax_birnn(x, lengths, hidden)
    with torch.no_grad():
        got = _torch_birnn(p, d, hidden)(torch.from_numpy(x),
                                         torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    for i in range(b):
        assert np.all(got[lengths[i]:, i] == 0.0)


def test_padding_invariance():
    """Valid frames of a padded batch equal an unpadded per-utterance run, and
    garbage in padded frames changes nothing (backward direction starts at zero)."""
    t, d, hidden = 16, 10, 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((t, 2, d)).astype(np.float32)
    x[11:, 1] = 50.0
    lengths = torch.tensor([t, 11])
    mod = BiRNN(d, hidden)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for prm in mod.parameters():
            prm.copy_(0.3 * torch.randn(prm.shape, generator=gen))
        y = mod(torch.from_numpy(x), lengths)
        y1 = mod(torch.from_numpy(x[:11, 1:2]), torch.tensor([11]))
    torch.testing.assert_close(y[:11, 1:2], y1, rtol=1e-6, atol=1e-6)
    assert torch.all(y[11:, 1] == 0.0)


def test_forget_gate_offset():
    """Zero recurrent weights and a gate input that saturates i, g and o give
    c1 = 1, then c2 = sigmoid(0 + 1.0) * c1 + 1: the +1.0 forget offset."""
    t, b, h = 2, 1, 4
    gxf = torch.zeros(t, b, 4 * h)
    gxf[:, :, : h] = 30.0          # i -> 1
    gxf[:, :, 2 * h: 3 * h] = 30.0  # g -> tanh(30) ~ 1
    gxf[:, :, 3 * h:] = 30.0        # o -> 1
    m = torch.ones(t, b)
    yf, _ = krnn.lstm_scan_tm_plain(gxf, torch.zeros_like(gxf), m,
                                    torch.zeros(2, h, 4 * h), torch.zeros(2, 4 * h))
    c1 = 1.0
    c2 = torch.sigmoid(torch.tensor(1.0)) * c1 + 1.0
    torch.testing.assert_close(yf[1, 0], torch.tanh(c2).expand(h), rtol=1e-6, atol=1e-6)


def test_plain_matches_pallas_interpret():
    t, b, h = 16, 2, 8
    rng = np.random.default_rng(7)
    gxf, gxb = (0.5 * rng.standard_normal((2, t, b, 4 * h))).astype(np.float32)
    wh = (0.3 * rng.standard_normal((2, h, 4 * h))).astype(np.float32)
    bh = (0.1 * rng.standard_normal((2, 4 * h))).astype(np.float32)
    lengths = np.array([t, 10])
    m = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    yf_p, yb_p = lstm_pallas(jnp.asarray(gxf), jnp.asarray(gxb), jnp.asarray(m),
                             jnp.asarray(wh), jnp.asarray(bh), True)
    yf, yb = krnn.lstm_scan_tm(*(torch.from_numpy(a) for a in (gxf, gxb, m, wh, bh)))
    np.testing.assert_allclose(yf.numpy(), np.asarray(yf_p), **TOL)
    np.testing.assert_allclose(yb.numpy(), np.asarray(yb_p), **TOL)


def test_cpu_tensor_takes_plain_version():
    args = [torch.randn(5, 2, 16, generator=torch.Generator().manual_seed(i))
            for i in range(2)] + [torch.ones(5, 2), torch.zeros(2, 4, 16),
                                  torch.zeros(2, 16)]
    before = krnn.lstm_scan_tm.launches
    a = krnn.lstm_scan_tm(*args)
    b = krnn.lstm_scan_tm_plain(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert krnn.lstm_scan_tm.launches == before


def test_unknown_cell_raises():
    with pytest.raises(ValueError, match="unknown cell"):
        BiRNN(4, 4, cell="rnn")


@pytest.mark.parametrize("t,b", [(19, 3), (8, 1)])
def test_gru_birnn_matches_jax(t, b):
    """Non-zero bh and wx bias: bh's n-slice inside r * (...), wx's outside."""
    d, hidden = 12, 16
    rng = np.random.default_rng(t + 50)
    x = rng.standard_normal((t, b, d)).astype(np.float32)
    lengths = np.array([t, t - 7, 3][:b], np.int32)
    p, ref = _jax_birnn(x, lengths, hidden, cell="gru")
    mod = _torch_birnn(p, d, hidden, cell="gru")
    assert mod.wh.shape == (2, hidden, 3 * hidden)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    for i in range(b):
        assert np.all(got[lengths[i]:, i] == 0.0)


def test_gru_plain_matches_pallas_interpret():
    t, b, h = 16, 2, 8
    rng = np.random.default_rng(17)
    gxf, gxb = (0.5 * rng.standard_normal((2, t, b, 3 * h))).astype(np.float32)
    wh = (0.3 * rng.standard_normal((2, h, 3 * h))).astype(np.float32)
    bh = (0.1 * rng.standard_normal((2, 3 * h))).astype(np.float32)
    lengths = np.array([t, 10])
    m = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    yf_p, yb_p = gru_pallas(jnp.asarray(gxf), jnp.asarray(gxb), jnp.asarray(m),
                            jnp.asarray(wh), jnp.asarray(bh), True)
    yf, yb = krnn.gru_scan_tm(*(torch.from_numpy(a) for a in (gxf, gxb, m, wh, bh)))
    np.testing.assert_allclose(yf.numpy(), np.asarray(yf_p), **TOL)
    np.testing.assert_allclose(yb.numpy(), np.asarray(yb_p), **TOL)


def test_gru_padding_invariance():
    t, d, hidden = 16, 10, 8
    rng = np.random.default_rng(4)
    x = rng.standard_normal((t, 2, d)).astype(np.float32)
    x[11:, 1] = 50.0
    lengths = torch.tensor([t, 11])
    mod = BiRNN(d, hidden, cell="gru")
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for prm in mod.parameters():
            prm.copy_(0.3 * torch.randn(prm.shape, generator=gen))
        y = mod(torch.from_numpy(x), lengths)
        y1 = mod(torch.from_numpy(x[:11, 1:2]), torch.tensor([11]))
    torch.testing.assert_close(y[:11, 1:2], y1, rtol=1e-6, atol=1e-6)
    assert torch.all(y[11:, 1] == 0.0)


def test_gru_n_gate_bias_sits_inside_r():
    """Zero weights and h = 0 at the first step: gh = bh.  With xr = -30
    (r -> 0) the n-gate's bias is multiplied away, so h1 = (1 - z) tanh(xn);
    folding b_hn into gx would give (1 - z) tanh(xn + b_hn) instead."""
    h = 4
    gxf = torch.zeros(1, 1, 3 * h)
    gxf[..., :h] = -30.0                  # r -> 0
    gxf[..., 2 * h:] = 0.5                # xn
    bh = torch.zeros(2, 3 * h)
    bh[:, 2 * h:] = 2.0                   # b_hn, inside r * (...)
    bh[:, h: 2 * h] = 0.3                 # b_hz: z = sigmoid(0.3)
    yf, _ = krnn.gru_scan_tm_plain(gxf, torch.zeros_like(gxf), torch.ones(1, 1),
                                   torch.zeros(2, h, 3 * h), bh)
    z = torch.sigmoid(torch.tensor(0.3))
    torch.testing.assert_close(yf[0, 0], ((1 - z) * torch.tanh(torch.tensor(0.5))).expand(h),
                               rtol=1e-6, atol=1e-6)


def test_gru_cpu_tensor_takes_plain_version():
    args = [torch.randn(5, 2, 24, generator=torch.Generator().manual_seed(i))
            for i in range(2)] + [torch.ones(5, 2), torch.zeros(2, 8, 24),
                                  torch.zeros(2, 24)]
    before = krnn.gru_scan_tm.launches
    a = krnn.gru_scan_tm(*args)
    b = krnn.gru_scan_tm_plain(*args)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert krnn.gru_scan_tm.launches == before


@pytest.mark.parametrize("h", [8, 16, 64])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_plain_gradients_match_pallas_vjp_interpret(cell, h):
    """dgxf, dgxb, dwh, dbh of autograd through the plain version against
    jax.vjp of the Pallas lstm_scan_tm / gru_scan_tm (interpret mode), with a
    ragged mask and non-zero bh: the math the backward kernels B1' / B2'
    implement, and that the card tests hold them to, at widths one block
    (8, 16) and a cluster of two blocks (64) hold on the card.  wh shrinks
    as 1 / sqrt(H), so every width keeps the gates out of saturation."""
    t, b = 12, 3
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(23 + g)
    gxf, gxb = (0.5 * rng.standard_normal((2, t, b, g * h))).astype(np.float32)
    wh = (0.3 * (8 / h) ** 0.5 * rng.standard_normal((2, h, g * h))).astype(np.float32)
    bh = (0.1 * rng.standard_normal((2, g * h))).astype(np.float32)
    lengths = np.array([t, 7, 2])
    m = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    dyf, dyb = rng.standard_normal((2, t, b, h)).astype(np.float32)
    pallas = lstm_pallas if cell == "lstm" else gru_pallas
    _, vjp = jax.vjp(lambda a, c, w, v: pallas(a, c, jnp.asarray(m), w, v, True),
                     *(jnp.asarray(x) for x in (gxf, gxb, wh, bh)))
    ref = vjp((jnp.asarray(dyf), jnp.asarray(dyb)))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (gxf, gxb, wh, bh)]
    scan = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
    yf, yb = scan(inputs[0], inputs[1], torch.from_numpy(m), inputs[2], inputs[3])
    got = torch.autograd.grad((yf, yb), inputs,
                              (torch.from_numpy(dyf), torch.from_numpy(dyb)))
    for name, a, r in zip(("dgxf", "dgxb", "dwh", "dbh"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **TOL)
    assert np.all(got[0].numpy()[7:, 1] == 0) and np.all(got[1].numpy()[2:, 2] == 0)


def _stacked_inputs(cell, t, b, h, seed):
    """gx [T, 2, B, G*H], m [T, 2, B] with direction 1 flipped (left-padded),
    wh (0.3 at H = 8, shrinking as 1 / sqrt(H)), non-zero bh."""
    g = 4 if cell == "lstm" else 3
    rng = np.random.default_rng(seed)
    gx = (0.5 * rng.standard_normal((t, 2, b, g * h))).astype(np.float32)
    wh = (0.3 * (8 / max(h, 8)) ** 0.5 * rng.standard_normal((2, h, g * h))).astype(np.float32)
    bh = (0.1 * rng.standard_normal((2, g * h))).astype(np.float32)
    lengths = np.array([t, 7, 2, t - 1][:b])
    m0 = (np.arange(t)[:, None] < lengths[None]).astype(np.float32)
    return gx, np.stack([m0, m0[::-1]], axis=1), wh, bh


@pytest.mark.parametrize("h", [8, 16, 64])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stacked_plain_matches_pallas_interpret(cell, h):
    """Values and all gradients (dgx, dwh, dbh) of the stacked plain versions
    against lstm_scan_pallas / gru_scan_pallas and their VJPs in interpret
    mode: ragged lengths, direction 1 left-padded, non-zero bh.  The math
    that the stacked kernels implement and the card tests hold them to."""
    t, b = 12, 3
    gx, m, wh, bh = _stacked_inputs(cell, t, b, h, seed=31)
    cot = np.random.default_rng(5).standard_normal((t, 2, b, h)).astype(np.float32)
    pallas = lstm_scan_pallas if cell == "lstm" else gru_scan_pallas
    y_ref, vjp = jax.vjp(lambda a, w, v: pallas(a, jnp.asarray(m), w, v, True),
                         *(jnp.asarray(x) for x in (gx, wh, bh)))
    ref = vjp(jnp.asarray(cot))
    inputs = [torch.from_numpy(x).requires_grad_() for x in (gx, wh, bh)]
    scan = krnn.lstm_scan_stacked if cell == "lstm" else krnn.gru_scan_stacked
    y = scan(inputs[0], torch.from_numpy(m), inputs[1], inputs[2])
    got = torch.autograd.grad(y, inputs, torch.from_numpy(cot))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), **TOL)
    for name, a, r in zip(("dgx", "dwh", "dbh"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=name, **TOL)
    assert np.all(y.detach().numpy()[7:, 0, 1] == 0)          # direction 0: right padding
    assert np.all(y.detach().numpy()[:t - 7, 1, 1] == 0)      # direction 1: left padding
    assert np.all(got[0].numpy()[:t - 2, 1, 2] == 0)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_stacked_cpu_tensor_takes_plain_version(cell):
    gx, m, wh, bh = (torch.from_numpy(a) for a in _stacked_inputs(cell, 6, 2, 4, seed=2))
    scan, plain = ((krnn.lstm_scan_stacked, krnn.lstm_scan_stacked_plain) if cell == "lstm"
                   else (krnn.gru_scan_stacked, krnn.gru_scan_stacked_plain))
    before = scan.launches
    assert torch.equal(scan(gx, m, wh, bh), plain(gx, m, wh, bh))
    assert scan.launches == before
    # The time-major plain version is the stacked one on direction 1 flipped.
    tm_plain = krnn.lstm_scan_tm_plain if cell == "lstm" else krnn.gru_scan_tm_plain
    yf, yb = tm_plain(gx[:, 0], gx[:, 1].flip(0), m[:, 0], wh, bh)
    ys = plain(gx, torch.stack([m[:, 0], m[:, 0].flip(0)], 1), wh, bh)
    assert torch.equal(yf, ys[:, 0]) and torch.equal(yb, ys[:, 1].flip(0))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_batch_major_birnn_matches_jax(cell, impl):
    """BiRNN(time_major=False) against the JAX module's batch-major route
    (its XLA scan, and the Pallas stacked kernels in interpret mode) with
    converted weights, and against the port's time-major route."""
    b, t, d, hidden = 3, 14, 10, 8
    rng = np.random.default_rng(41)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.array([t, 9, 2], np.int32)
    mod = JaxBiRNN(hidden, cell=cell, time_major=False, impl=impl)
    params = mod.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(lengths))
    p = jax.tree_util.tree_map(np.array, params)["params"]
    p["bh"] = (0.1 * rng.standard_normal(p["bh"].shape)).astype(np.float32)
    p["wx"]["bias"] = (0.1 * rng.standard_normal(p["wx"]["bias"].shape)).astype(np.float32)
    ref = np.asarray(mod.apply({"params": p}, jnp.asarray(x), jnp.asarray(lengths)))

    bm = BiRNN(d, hidden, cell=cell, time_major=False)
    bm.load_state_dict(_torch_birnn(p, d, hidden, cell).state_dict())
    tm = _torch_birnn(p, d, hidden, cell)
    assert tm.time_major and not bm.time_major
    xt, lt = torch.from_numpy(x), torch.from_numpy(lengths)
    with torch.no_grad():
        got = bm(xt, lt)
        got_tm = tm(xt.transpose(0, 1), lt).transpose(0, 1)
    assert got.shape == (b, t, hidden)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    torch.testing.assert_close(got, got_tm, rtol=1e-6, atol=1e-6)
    for i in range(b):
        assert np.all(got.numpy()[i, lengths[i]:] == 0.0)


@pytest.mark.parametrize("h,cluster", [(16, 1), (32, 1), (48, 2), (64, 2), (128, 4), (192, 8),
                                       (256, 8), (512, 0), (250, 0), (33, 0), (320, 0),
                                       (1024, 0)])
def test_lstm_route_follows_the_width(h, cluster):
    """The LSTM forward's route is a rule on H alone: the smallest cluster of
    1, 2, 4, 8 blocks that divides H into an even number of at most 32 hidden
    units a block whose slice of wh[d] plus state fits a block's 227 KB; 0
    (streaming) for 512 and 320 (more than 32 units a block even in a cluster
    of 8), for 250 (125 units in a cluster of 2: too many, and odd) and for
    33 (no cluster size divides it into an even number)."""
    assert krnn.lstm_resident_cluster(h) == cluster
    if cluster:
        u, chunks = h // cluster, -(-h // 16)
        assert h % cluster == 0 and u % 2 == 0 and u <= 32
        assert 16 * (u * chunks * 16 + 2 * 16 * chunks + 1) <= 232448
        for smaller in (c for c in (1, 2, 4) if c < cluster and h % c == 0):
            assert h // smaller > 32 or (h // smaller) % 2


def test_lstm_route_is_recorded_only_on_the_card():
    """On the CPU the wrappers run the plain version: no launch, no route."""
    t, b, h = 5, 2, 8
    rng = np.random.default_rng(0)
    gx = torch.from_numpy(rng.standard_normal((t, b, 8 * h)).astype(np.float32))
    before = (krnn.lstm_scan_tm.launches, krnn.lstm_scan_tm.route)
    krnn.lstm_scan_tm(gx[..., :4 * h], gx[..., 4 * h:], torch.ones(t, b),
                      torch.zeros(2, h, 4 * h), torch.zeros(2, 4 * h))
    assert (krnn.lstm_scan_tm.launches, krnn.lstm_scan_tm.route) == before


@pytest.mark.parametrize("h,cluster", [(8, 1), (16, 1), (32, 1), (64, 2), (128, 4), (250, 0),
                                       (256, 8), (320, 16), (512, 16), (1024, 0)])
def test_gru_route_follows_the_width(h, cluster):
    """The GRU forward's route is a rule on H alone: the smallest cluster of
    1, 2, 4, 8, 16 blocks that divides H into an even number of at most 32
    hidden units a block whose slice of wh[d] (12 bytes per unit and input, H
    padded to 64 inputs) plus h twice and two mbarriers fits a block's 227 KB;
    0 (streaming) for 1024 (64 units a block even in a cluster of 16) and for
    250 (125 units in a cluster of 2: too many, and odd).  The AM's 512 takes
    clusters of 16 blocks of 192 KB + 16 KB + 16 bytes."""
    assert krnn.gru_resident_cluster(h) == cluster
    if cluster:
        u, padded = h // cluster, 64 * -(-h // 64)
        assert h % cluster == 0 and u % 2 == 0 and u <= 32
        assert 12 * u * padded + 32 * padded + 16 <= 232448
        for smaller in (c for c in (1, 2, 4, 8) if c < cluster and h % c == 0):
            assert h // smaller > 32 or (h // smaller) % 2
    if h == 512:
        assert 12 * 32 * 512 + 32 * 512 + 16 == 213008


def test_gru_route_is_recorded_only_on_the_card():
    """On the CPU the wrappers run the plain version: no launch, no route."""
    t, b, h = 5, 2, 8
    rng = np.random.default_rng(0)
    gx = torch.from_numpy(rng.standard_normal((t, b, 6 * h)).astype(np.float32))
    for fn, args in ((krnn.gru_scan_tm, (gx[..., :3 * h], gx[..., 3 * h:], torch.ones(t, b))),
                     (krnn.gru_scan_stacked,
                      (gx.reshape(t, b, 2, 3 * h).transpose(1, 2).contiguous(),
                       torch.ones(t, 2, b)))):
        before = (fn.launches, fn.route)
        fn(*args, torch.zeros(2, h, 3 * h), torch.zeros(2, 3 * h))
        assert (fn.launches, fn.route) == before and fn.route is None


LSTM_WIDTHS = [16, 32, 48, 64, 128, 192, 256, 512, 250, 33, 320, 1024]
GRU_WIDTHS = [8, 16, 32, 64, 128, 250, 256, 320, 512, 1024]


@pytest.mark.parametrize("cell,h", [("lstm", h) for h in LSTM_WIDTHS]
                         + [("gru", h) for h in GRU_WIDTHS])
def test_backward_route_follows_the_width(cell, h):
    """The backward's route is a rule on H alone: the forward's cluster at
    the same width, and the resident backward's own arithmetic holds there.
    A block has one thread per input of dh (LSTM) or per two (GRU), whole
    warps, at least 128 (4 rows x 32 slots of the cell backward) and at most
    256, so that each keeps its weights, 128 (LSTM) or 192 (GRU) floats, in
    registers: 256 threads x 255 registers fit the SM's 65,536.  Its shared
    memory holds the partials of dh and the gate gradients twice: 18 KB at
    the AM's 512.  The LSTM at 512 and both cells at 1024 stream."""
    fwd = (krnn.lstm_resident_cluster if cell == "lstm" else krnn.gru_resident_cluster)(h)
    route = krnn.bwd_resident_cluster(cell, h)
    assert route == fwd
    gates, outputs = (4, 1) if cell == "lstm" else (3, 2)
    # csrc/rnn_cluster.cuh::res_bwd_threads, ::res_bwd_smem
    threads = max(128, 32 * -(-h // (32 * outputs)))
    smem = 16 * (2 * h + 2 * gates * 32) + 16
    if route:
        assert h % route == 0 and h // route <= 32
        assert threads % 32 == 0 and 128 <= threads <= 256 and threads * outputs >= h
        assert threads * 255 <= 65536 and outputs * gates * 32 <= 192
        assert smem <= 232448
    if (cell, h) in (("gru", 512), ("lstm", 256)):
        assert (route, threads) == (16 if cell == "gru" else 8, 256)
    if (cell, h) == ("gru", 512):
        assert smem == 19472
    if (cell, h) in (("lstm", 512), ("lstm", 1024), ("gru", 1024)):
        assert route == 0 and threads > 256        # the streaming backward


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_backward_wrappers_launch_nothing_on_the_cpu(cell, stacked):
    """On the CPU autograd differentiates the plain version: the backward
    wrappers launch nothing and record no route, and the gradients are the
    plain version's."""
    t, b, h = 6, 2, 8
    gx, m, wh, bh = (torch.from_numpy(a) for a in _stacked_inputs(cell, t, b, h, seed=3))
    gx.requires_grad_()
    wh.requires_grad_()
    if stacked:
        scan = krnn.lstm_scan_stacked if cell == "lstm" else krnn.gru_scan_stacked
        bwd = krnn.lstm_scan_stacked_bwd if cell == "lstm" else krnn.gru_scan_stacked_bwd
        run = lambda f: f(gx, m, wh, bh)                                  # noqa: E731
        plain = krnn.lstm_scan_stacked_plain if cell == "lstm" else krnn.gru_scan_stacked_plain
    else:
        scan = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
        bwd = krnn.lstm_scan_tm_bwd if cell == "lstm" else krnn.gru_scan_tm_bwd
        run = lambda f: sum(f(gx[:, 0], gx[:, 1], m[:, 0], wh, bh))       # noqa: E731
        plain = krnn.lstm_scan_tm_plain if cell == "lstm" else krnn.gru_scan_tm_plain
    before = (bwd.launches, bwd.route)
    got = torch.autograd.grad(run(scan).sum(), (gx, wh))
    ref = torch.autograd.grad(run(plain).sum(), (gx, wh))
    assert (bwd.launches, bwd.route) == before and bwd.route is None
    assert all(torch.equal(a, r) for a, r in zip(got, ref))
