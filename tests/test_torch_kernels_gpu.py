"""The port's kernels on the card against their plain versions (marked `gpu`).

They skip where there is no CUDA device.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances are f32 sum-order tolerances (each kernel sums in its own order):
STFT 1e-4 abs on |X| up to ~30, ISTFT 2e-5 abs + 1e-5 rel on unit-scale
audio, GroupNorm 1e-5, LSTM and GRU 1e-5 on |y| < 1 over 40-60 steps, the
recognition forward's logits 1e-4 (STFT, enhancer and AM sums compound).
Gradients of the backward kernels against autograd through the plain
versions: 1e-5 of the largest |gradient| of each tensor plus rtol 1e-4
(dh carried back through 40-60 steps of G-term f32 dot products; dWh sums
T * B outer products).
"""

import pytest
import torch

from aas_enhancement_tpu_torch.config import AMConfig, Config, EnhancerConfig
from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward
from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
from aas_enhancement_tpu_torch.ops.triton import gn

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(*shape, seed=0, scale=1.0):
    return scale * torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n,center", [(16000, True), (16001, True), (8000, False)])
def test_stft_kernel(cuda, n, center):
    x = _randn(3, n, seed=n, scale=0.3).to(cuda)
    before = kstft.stft.launches
    re, im = kstft.stft(x, 320, 160, center=center)
    re_p, im_p = kstft.stft_plain(x, 320, 160, center=center)
    torch.cuda.synchronize()
    assert kstft.stft.launches == before + 1
    torch.testing.assert_close(re, re_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(im, im_p, rtol=0, atol=1e-4)


@pytest.mark.parametrize("length", [16000, 15000, 17000, None])
def test_istft_kernel(cuda, length):
    re = _randn(2, 101, 161, seed=1).to(cuda)
    im = _randn(2, 101, 161, seed=2).to(cuda)
    y = kstft.istft(re, im, 320, 160, length=length)
    y_p = kstft.istft_plain(re, im, 320, 160, length=length)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("act", ["none", "leaky_relu", "hardtanh"])
def test_gn_kernel(cuda, act):
    x = (0.5 + _randn(3, 45, 17, 16, seed=3)).to(cuda)
    scale, bias = (1 + _randn(16, seed=4, scale=0.1)).to(cuda), _randn(16, seed=5).to(cuda)
    lengths = torch.tensor([45, 30, 1], device=cuda)
    y = gn.masked_group_norm_act(x, scale, bias, lengths, num_groups=8, act=act)
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=8, act=act)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    assert torch.all(y[1, 30:] == 0)


def test_lstm_kernel(cuda):
    t, b, h = 40, 5, 32                      # b = 5: one full and one partial row tile
    gates = _randn(t, b, 8 * h, seed=6, scale=0.5).to(cuda)
    gxf, gxb = gates[..., :4 * h], gates[..., 4 * h:]   # strided halves
    wh = _randn(2, h, 4 * h, seed=7, scale=0.2).to(cuda)
    bh = _randn(2, 4 * h, seed=8, scale=0.1).to(cuda)
    lengths = torch.tensor([40, 25, 3, 40, 1], device=cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    yf, yb = krnn.lstm_scan_tm(gxf, gxb, m, wh, bh)
    yf_p, yb_p = krnn.lstm_scan_tm_plain(gxf, gxb, m, wh, bh)
    torch.cuda.synchronize()
    torch.testing.assert_close(yf, yf_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yb, yb_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,b,h", [(40, 5, 32), (60, 4, 512)])
def test_gru_kernel(cuda, t, b, h):
    """b = 5: one full and one partial row tile; H = 512: the AM's width."""
    gates = _randn(t, b, 6 * h, seed=h, scale=0.5).to(cuda)
    gxf, gxb = gates[..., :3 * h], gates[..., 3 * h:]   # strided halves
    wh = _randn(2, h, 3 * h, seed=h + 1, scale=1.0 / h ** 0.5).to(cuda)
    bh = _randn(2, 3 * h, seed=h + 2, scale=0.1).to(cuda)
    lengths = torch.tensor([t, t // 2 + 3, 3, t, 1][:b], device=cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    before = krnn.gru_scan_tm.launches
    yf, yb = krnn.gru_scan_tm(gxf, gxb, m, wh, bh)
    yf_p, yb_p = krnn.gru_scan_tm_plain(gxf, gxb, m, wh, bh)
    torch.cuda.synchronize()
    assert krnn.gru_scan_tm.launches == before + 1
    torch.testing.assert_close(yf, yf_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yb, yb_p, rtol=1e-5, atol=1e-5)
    assert torch.all(yf[3:, 2] == 0) and torch.all(yb[3:, 2] == 0)


@pytest.mark.parametrize("f", [81, 41])
def test_gn_hardtanh_at_am_shapes(cuda, f):
    x = (0.5 + 3.0 * _randn(4, 401, f, 32, seed=f)).to(cuda)
    scale, bias = (1 + _randn(32, seed=1, scale=0.1)).to(cuda), _randn(32, seed=2).to(cuda)
    lengths = torch.tensor([401, 351, 301, 201], device=cuda)
    y = gn.masked_group_norm_act(x, scale, bias, lengths, num_groups=8, act="hardtanh")
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=8,
                                         act="hardtanh")
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    assert torch.all(y[3, 201:] == 0) and y.min() >= 0 and y.max() <= 20


def test_gru_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    t, b, h = 3, 2, 8
    g = torch.zeros(t, b, 3 * h, device=cuda)
    m = torch.ones(t, b, device=cuda)
    wh, bh = torch.zeros(2, h, 3 * h, device=cuda), torch.zeros(2, 3 * h, device=cuda)
    with pytest.raises(ValueError, match="shapes"):
        krnn.gru_scan_tm(g, g, m, torch.zeros(2, h, 4 * h, device=cuda), bh)
    with pytest.raises(ValueError, match="stride"):
        gt = torch.zeros(t, 3 * h, b, device=cuda).transpose(1, 2)
        krnn.gru_scan_tm(gt, gt, m, wh, bh)
    with pytest.raises(TypeError, match="float32"):
        krnn.gru_scan_tm(g.double(), g.double(), m, wh, bh)
    with pytest.raises(ValueError, match="H % 4"):
        g6 = torch.zeros(t, b, 18, device=cuda)
        krnn.gru_scan_tm(g6, g6, m, torch.zeros(2, 6, 18, device=cuda),
                         torch.zeros(2, 18, device=cuda))
    with pytest.raises(ValueError, match="H % 4"):      # the backward's float4 whT
        g6 = torch.zeros(t, b, 24, device=cuda)
        krnn.lstm_scan_tm(g6, g6, m, torch.zeros(2, 6, 24, device=cuda,
                                                 requires_grad=True),
                          torch.zeros(2, 24, device=cuda))[0].sum().backward()


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        kstft.stft(torch.zeros(1, 4000, dtype=torch.float64, device=cuda), 320, 160)
    x = torch.zeros(1, 4000, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A8"):   # STFT has no backward kernel
        kstft.stft(x, 320, 160)


def _grads(outs, inputs, seed):
    """autograd.grad of sum(out * fixed random weights) w.r.t. inputs."""
    ws = [_randn(*o.shape, seed=seed + i).to(o.device) for i, o in enumerate(outs)]
    return torch.autograd.grad(outs, inputs, ws)


def _assert_grads_close(got, ref):
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize("cell,t,b,h", [("lstm", 40, 5, 32), ("gru", 40, 5, 32),
                                        ("gru", 60, 4, 512)])
def test_rnn_backward_kernels(cuda, cell, t, b, h):
    """dgxf, dgxb, dwh, dbh of the kernel Function against autograd through
    the plain version; ragged lengths and non-zero bh catch a swapped
    direction or time order."""
    g = 4 if cell == "lstm" else 3
    fn, plain = ((krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain) if cell == "lstm"
                 else (krnn.gru_scan_tm, krnn.gru_scan_tm_plain))
    bwd = krnn.lstm_scan_tm_bwd if cell == "lstm" else krnn.gru_scan_tm_bwd
    gates = _randn(t, b, 2 * g * h, seed=h + 3, scale=0.5).to(cuda).requires_grad_()
    wh = _randn(2, h, g * h, seed=h + 4, scale=1.0 / h ** 0.5).to(cuda).requires_grad_()
    bh = _randn(2, g * h, seed=h + 5, scale=0.1).to(cuda).requires_grad_()
    lengths = torch.tensor([t, t // 2 + 3, 3, t, 1][:b], device=cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    inputs = (gates, wh, bh)
    before = (fn.launches, bwd.launches)
    got = _grads(fn(gates[..., :g * h], gates[..., g * h:], m, wh, bh), inputs, 7)
    ref = _grads(plain(gates[..., :g * h], gates[..., g * h:], m, wh, bh), inputs, 7)
    torch.cuda.synchronize()
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    _assert_grads_close(got, ref)
    assert torch.all(got[0][3:, 2] == 0)                  # padded frames get no gradient


def test_frozen_gru_skips_the_weight_gradient(cuda):
    t, b, h = 20, 2, 32
    gates = _randn(t, b, 6 * h, seed=1, scale=0.5).to(cuda).requires_grad_()
    wh = _randn(2, h, 3 * h, seed=2, scale=0.2).to(cuda)
    bh = _randn(2, 3 * h, seed=3, scale=0.1).to(cuda)
    m = torch.ones(t, b, device=cuda)
    yf, yb = krnn.gru_scan_tm(gates[..., :3 * h], gates[..., 3 * h:], m, wh, bh)
    (dg,) = torch.autograd.grad((yf + yb).sum(), gates)
    yf, yb = krnn.gru_scan_tm_plain(gates[..., :3 * h], gates[..., 3 * h:], m, wh, bh)
    (dg_p,) = torch.autograd.grad((yf + yb).sum(), gates)
    torch.cuda.synchronize()
    _assert_grads_close((dg,), (dg_p,))
    assert wh.grad is None and bh.grad is None


@pytest.mark.parametrize("act,shape", [("leaky_relu", (3, 45, 17, 16)),
                                       ("hardtanh", (3, 45, 17, 16)),
                                       ("none", (2, 33, 5, 16)),
                                       ("hardtanh", (4, 401, 41, 32))])
def test_gn_backward_kernel(cuda, act, shape):
    b, t, f, c = shape
    x = (0.5 + 3.0 * _randn(*shape, seed=t)).to(cuda).requires_grad_()
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda).requires_grad_()
    bias = _randn(c, seed=5).to(cuda).requires_grad_()
    lengths = torch.tensor([t, t - 10, 1, t // 2][:b], device=cuda)
    kw = dict(num_groups=8, act=act)
    before = gn.masked_group_norm_act_bwd.launches
    got = _grads((gn.masked_group_norm_act(x, scale, bias, lengths, **kw),),
                 (x, scale, bias), 11)
    ref = _grads((gn.masked_group_norm_act_plain(x, scale, bias, lengths, **kw),),
                 (x, scale, bias), 11)
    torch.cuda.synchronize()
    assert gn.masked_group_norm_act_bwd.launches == before + 1
    _assert_grads_close(got, ref)
    assert torch.all(got[0][1, t - 10:] == 0)


def test_enhance_on_card_matches_cpu(cuda):
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16))
    model = init_enhancer(cfg, seed=0)
    wav = _randn(2, 16000, seed=9, scale=0.3)
    lengths = torch.tensor([16000, 9000])
    wav[1, 9000:] = 0
    y_cpu = make_enhance_fn(cfg, "cpu")(model, wav, lengths)
    y_gpu = make_enhance_fn(cfg, cuda)(model.to(cuda), wav, lengths).cpu()
    torch.testing.assert_close(y_gpu, y_cpu, rtol=0, atol=1e-4)


@pytest.mark.parametrize("use_enhancer", [False, True])
def test_recognition_forward_on_card_matches_cpu(cuda, use_enhancer):
    cfg = Config().replace(am=AMConfig(rnn_hidden=32, rnn_layers=2, conv_channels=8),
                           enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16))
    am, enh = init_am(cfg, seed=0), init_enhancer(cfg, seed=1)
    wav = _randn(2, 16000, seed=10, scale=0.3)
    lengths = torch.tensor([16000, 9000])
    wav[1, 9000:] = 0
    fwd = make_eval_forward(cfg, use_enhancer)
    logits_cpu, pads_cpu = fwd(am, enh, wav, lengths)
    before = krnn.gru_scan_tm.launches
    logits, pads = fwd(am.to(cuda), enh.to(cuda), wav.to(cuda), lengths.to(cuda))
    assert krnn.gru_scan_tm.launches == before + 2
    torch.testing.assert_close(pads.cpu(), pads_cpu, rtol=0, atol=0)
    torch.testing.assert_close(logits.cpu(), logits_cpu, rtol=0, atol=1e-4)
