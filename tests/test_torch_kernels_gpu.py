"""The port's kernels on the card against their plain versions (marked `gpu`).

They skip where there is no CUDA device.  This file imports no JAX, so on a
machine without JAX run it without the suite's conftest:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py

Tolerances are f32 sum-order tolerances (each kernel sums in its own order):
STFT 1e-4 abs on |X| up to ~30, ISTFT 2e-5 abs + 1e-5 rel on unit-scale
audio (rel for the untrimmed edges, where the COLA divisor nears 0), GroupNorm
1e-5, LSTM and GRU 1e-5 on |y| < 1 over 20-60 steps, the
recognition forward's logits 1e-4 (STFT, enhancer and AM sums compound).
Gradients of the backward kernels against autograd through the plain
versions: 1e-5 of the largest |gradient| of each tensor plus rtol 1e-4
(dh carried back through 40-60 steps of G-term f32 dot products; dWh sums
T * B outer products), and so the GroupNorm backward kernel alone against its
plain closed form; the resident and the streaming backward against each
other: 1e-4 of the largest |gradient| (each sums dh in its own order).
conv_dw: 1e-4 of max|dW| (f32 sums over up to ~1e5 positions, in the
kernel's slice order and the plain version's).
"""

import numpy as np
import pytest
import torch

from aas_enhancement_tpu_torch.config import AMConfig, Config, EnhancerConfig
from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward
from aas_enhancement_tpu_torch.ops import conv as tconv
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
from aas_enhancement_tpu_torch.ops.cuda import gn
from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
from aas_enhancement_tpu_torch.utils.profiling import kernel_names_in_fresh_process

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


@pytest.mark.parametrize("n,center,n_fft,hop,route", [
    (16000, True, 320, 160, (32, 10)), (16001, True, 320, 160, (32, 10)),
    (8000, False, 320, 160, (32, 10)), (16000, True, 320, 80, (32, 10)),
    (6000, True, 96, 48, (16, 6)), (4000, True, 75, 25, (15, 5)),   # odd n_fft, odd factors
    (5000, True, 97, 97, (0, 0)),                                   # a prime: the direct sum
    (200, True, 320, 160, (32, 10))])               # both edges mirrored inside one frame
def test_stft_kernel(cuda, n, center, n_fft, hop, route):
    x = _randn(3, n, seed=n, scale=0.3).to(cuda)
    before = kstft.stft.launches
    re, im = kstft.stft(x, n_fft, hop, center=center)
    re_p, im_p = kstft.stft_plain(x, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert kstft.stft.launches == before + 1 and kstft.stft.route == route
    torch.testing.assert_close(re, re_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(im, im_p, rtol=0, atol=1e-4)
    re_f, im_f = kstft.stft_factorised_plain(x, n_fft, hop, center=center)
    torch.testing.assert_close(re, re_f, rtol=0, atol=1e-4)
    torch.testing.assert_close(im, im_f, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,route", [(256, 64, (32, 8)), (512, 128, (32, 16)),
                                            (1024, 256, (64, 16))])
def test_stft_kernel_at_the_mr_stft_resolutions(cuda, n_fft, hop, route):
    """The MR-STFT loss's resolutions: n_fft = 4 hop, up to 1024 (the
    factorised kernel's largest shared memory, 104 KB), ragged rows."""
    x = _randn(8, 48000, seed=n_fft, scale=0.3).to(cuda)
    x[3, 30001:] = 0
    re, im = kstft.stft(x, n_fft, hop)
    re_p, im_p = kstft.stft_plain(x, n_fft, hop)
    torch.cuda.synchronize()
    assert kstft.stft.route == route
    torch.testing.assert_close(re, re_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(im, im_p, rtol=0, atol=1e-4)


# The STFT's and the ISTFT's VJP kernels against their plain versions: the
# MR-STFT resolutions and the enhancer's, ragged lengths, the direct routes
# (a prime n_fft; more than 8 frames over a sample for stft_vjp), no center
# pad.  Limit: 1e-4 of the gradient's max|g| (f32 sums of up to n_fft terms
# in the kernels' order and the plain version's matmul order).
VJP_CASES = [(256, 64, True, 8000), (512, 128, True, 7777), (1024, 256, True, 9000),
             (320, 160, True, 16000), (320, 160, False, 16001), (37, 37, True, 3000),
             (2048, 128, True, 12000)]


def _vjp_err(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((g - r).abs().max()) for g, r in zip(got, ref)) / scale


@pytest.mark.parametrize("n_fft,hop,center,n", VJP_CASES)
def test_stft_vjp_kernel(cuda, n_fft, hop, center, n):
    t = 1 + (n // hop if center else (n - n_fft) // hop)
    dre = _randn(3, t, n_fft // 2 + 1, seed=n).to(cuda)
    dim = _randn(3, t, n_fft // 2 + 1, seed=n + 1).to(cuda)
    before = kstft.stft_vjp.launches
    dx = kstft.stft_vjp(dre, dim, n, n_fft, hop, center=center)
    again = kstft.stft_vjp(dre, dim, n, n_fft, hop, center=center)
    ref = kstft.stft_vjp_plain(dre, dim, n, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert kstft.stft_vjp.launches == before + 2
    assert kstft.stft_vjp.route == kstft.istft_route(n_fft, hop)
    assert dx.shape == (3, n) and torch.equal(dx, again)
    assert _vjp_err((dx,), (ref,)) <= 1e-4


@pytest.mark.parametrize("n_fft,hop,center,n", VJP_CASES)
def test_istft_vjp_kernel(cuda, n_fft, hop, center, n):
    t = 1 + (n // hop if center else (n - n_fft) // hop)
    for length in (n, n - 3 * hop - 1, n + 2 * hop):      # cut, exact, zero-padded
        dy = _randn(3, length, seed=length).to(cuda)
        before = kstft.istft_vjp.launches
        got = kstft.istft_vjp(dy, t, n_fft, hop, center=center)
        again = kstft.istft_vjp(dy, t, n_fft, hop, center=center)
        ref = kstft.istft_vjp_plain(dy, t, n_fft, hop, center=center)
        torch.cuda.synchronize()
        assert kstft.istft_vjp.launches == before + 2
        assert kstft.istft_vjp.route == kstft.stft_factors(n_fft)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        assert _vjp_err(got, ref) <= 1e-4


def test_stft_refuses_too_few_samples(cuda):
    with pytest.raises(ValueError, match="too few"):
        kstft.stft(torch.zeros(1, 160, device=cuda), 320, 160)


@pytest.mark.parametrize("length", [16000, 15000, 17000, None])
def test_istft_kernel(cuda, length):
    re = _randn(2, 101, 161, seed=1).to(cuda)
    im = _randn(2, 101, 161, seed=2).to(cuda)
    y = kstft.istft(re, im, 320, 160, length=length)
    y_p = kstft.istft_plain(re, im, 320, 160, length=length)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("n_fft,hop,center,length,route", [
    (320, 80, True, 16000, (32, 10)), (320, 80, True, None, (32, 10)),
    (320, 160, False, None, (32, 10)), (320, 160, False, 20000, (32, 10)),
    (96, 48, True, 9000, (16, 6)), (75, 25, True, None, (15, 5)),
    (320, 64, True, 16000, (32, 10)),               # 5 frames a sample: 16 a block
    (97, 97, True, 5000, (0, 0)), (320, 32, True, 16000, (0, 0))])   # direct sums
def test_istft_kernel_routes(cuda, n_fft, hop, center, length, route):
    """The route the shape gives (recorded in istft.route), the trimmed output
    written by the kernel (a contiguous [B, length] tensor), against the plain
    version and the factorised plain version; the same bits on two calls."""
    t = 1 + 16000 // hop
    re = _randn(3, t, n_fft // 2 + 1, seed=hop).to(cuda)
    im = _randn(3, t, n_fft // 2 + 1, seed=hop + 1).to(cuda)
    before = kstft.istft.launches
    y = kstft.istft(re, im, n_fft, hop, center=center, length=length)
    again = kstft.istft(re, im, n_fft, hop, center=center, length=length)
    y_p = kstft.istft_plain(re, im, n_fft, hop, center=center, length=length)
    y_f = kstft.istft_factorised_plain(re, im, n_fft, hop, center=center, length=length)
    torch.cuda.synchronize()
    assert kstft.istft.launches == before + 2 and kstft.istft.route == route
    assert y.is_contiguous() and y.shape == y_p.shape
    assert torch.equal(y, again)
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=2e-5)
    torch.testing.assert_close(y, y_f, rtol=1e-4, atol=2e-5)


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
    with pytest.raises(ValueError, match="H % 4"):      # the streaming backward's float4 whT
        g6, wh6 = torch.zeros(t, b, 24, device=cuda), torch.zeros(2, 6, 24, device=cuda)
        ys, saved = krnn._forward("lstm_scan_tm", (g6, g6), m, wh6,
                                  torch.zeros(2, 24, device=cuda), save=True)
        krnn._backward("lstm_scan_tm", m, wh6, saved, ys, True, route=0)


# (b, t, f, c, groups, lengths): a length-0 row and T = 45 (a partial last item
# of 8 frames); lanes F*C = 68 and 272, no multiple of a block's 256 threads x
# 4 lanes; C = 12 in 4 groups (a thread's 4 channels span two groups); C = 32
# with int64 lengths past T.
GN_EDGE = [(3, 45, 17, 4, 2, [45, 0, 13]), (2, 19, 17, 16, 8, [19, 7]),
           (3, 33, 5, 12, 4, [1, 33, 20]), (2, 9, 3, 32, 8, [40, 9])]


@pytest.mark.parametrize("b,t,f,c,groups,lens", GN_EDGE)
@pytest.mark.parametrize("act", ["leaky_relu", "hardtanh"])
def test_gn_kernel_edge_shapes(cuda, b, t, f, c, groups, lens, act):
    """The cooperative forward against the plain version (1e-5) on edge
    shapes, lengths as int32 and int64; padded frames 0; the same bits on two
    calls; the per-(B, C) mean and inv it saves for the backward against the
    plain version's group statistics."""
    x = (0.5 + 2.0 * _randn(b, t, f, c, seed=t + c)).to(cuda)
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda)
    bias = _randn(c, seed=5).to(cuda)
    kw = dict(num_groups=groups, act=act)
    for dtype in (torch.int32, torch.int64):
        lengths = torch.tensor(lens, dtype=dtype, device=cuda)
        y = gn.masked_group_norm_act(x, scale, bias, lengths, **kw)
        again = gn.masked_group_norm_act(x, scale, bias, lengths, **kw)
        y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, **kw)
        mean, inv = gn._stats(gn.gn_kernel(x, scale, bias, lengths, groups, 1e-5, act,
                                           0.2)[1], b, c)
        torch.cuda.synchronize()
        assert torch.equal(y, again)
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
        for i, n in enumerate(lens):
            assert torch.all(y[i, n:] == 0)
        mask = (torch.arange(t, device=cuda)[None] < lengths[:, None]).float()
        xm = (x * mask[:, :, None, None]).reshape(b, t, f, groups, c // groups)
        mean_p, inv_p = gn._group_stats(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                                        lengths, f, c, groups, 1e-5)
        rep = c // groups
        torch.testing.assert_close(mean, mean_p.repeat_interleave(rep, 1), rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(inv, inv_p.repeat_interleave(rep, 1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("grad", [False, True])
def test_gn_forward_is_one_device_kernel(cuda, grad):
    """One GN forward call, at the enhancer's width, launches one device
    kernel (the cooperative one), with or without autograd's Function
    (profiled in a fresh process, as the backward below)."""
    names, = kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import gn
x = torch.randn(2, 101, 161, 32, device="cuda").requires_grad_({grad})
scale, bias = torch.ones(32, device="cuda"), torch.zeros(32, device="cuda")
lengths = torch.tensor([101, 60], device="cuda")
calls = [lambda: gn.masked_group_norm_act(x, scale, bias, lengths, num_groups=8,
                                          act="leaky_relu")]
""")
    names = [n for n, k in names.items() for _ in range(k)
             if "Memcpy" not in n and "Memset" not in n]
    assert len(names) == 1 and "gn_act_fwd_kernel" in names[0], names


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    with pytest.raises(TypeError):
        kstft.stft(torch.zeros(1, 4000, dtype=torch.float64, device=cuda), 320, 160)
    # A wanted gradient differentiates through the VJP kernels, never a plain version.
    x = _randn(2, 4000, seed=3).to(cuda).requires_grad_()
    before = (kstft.stft_vjp.launches, kstft.istft_vjp.launches)
    re, im = kstft.stft(x, 320, 160)
    y = kstft.istft(re * 0.5, im, 320, 160, length=4000)
    dy = _randn(2, 4000, seed=4).to(cuda)
    gx, = torch.autograd.grad(y, x, dy)
    assert (kstft.stft_vjp.launches, kstft.istft_vjp.launches) == (before[0] + 1,
                                                                    before[1] + 1)
    x_p = x.detach().cpu().requires_grad_()
    re_p, im_p = kstft.stft_plain(x_p, 320, 160)
    ref, = torch.autograd.grad(kstft.istft_plain(re_p * 0.5, im_p, 320, 160, length=4000),
                               x_p, dy.cpu())
    assert _vjp_err((gx.cpu(),), (ref,)) <= 1e-4


def _grads(outs, inputs, seed):
    """autograd.grad of sum(out * fixed random weights) w.r.t. inputs."""
    ws = [_randn(*o.shape, seed=seed + i).to(o.device) for i, o in enumerate(outs)]
    return torch.autograd.grad(outs, inputs, ws)


def _assert_grads_close(got, ref):
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * float(b.abs().max()))


LSTM_ROUTES = [(40, 5, 32, 1),      # one block holds wh[d]; a partial row tile
               (30, 4, 256, 8),     # the enhancer's width: clusters of 8
               (25, 9, 64, 2),      # three row tiles, the last with one row
               (24, 6, 128, 4),     # clusters of 4
               (18, 2, 48, 2),      # 24 units a block, H no multiple of 32
               (20, 3, 512, 0)]     # 64 units a block even in a cluster of 8: streaming


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("t,b,h,route", LSTM_ROUTES)
def test_lstm_forward_routes(cuda, t, b, h, route, stacked):
    """The LSTM forward on the route its H gives it, inference and training
    variants, both layouts: y against the plain version (1e-5), gradients
    through the backward kernel against autograd through the plain version."""
    assert krnn.lstm_resident_cluster(h) == route
    wh = _randn(2, h, 4 * h, seed=h + 4, scale=1.0 / h ** 0.5).to(cuda).requires_grad_()
    bh = _randn(2, 4 * h, seed=h + 5, scale=0.1).to(cuda).requires_grad_()
    lengths = torch.tensor([t, t // 2 + 3, 3, t, 1, t - 1, 2, t, t // 3][:b], device=cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    if stacked:
        gx = _randn(t, 2, b, 4 * h, seed=h + 6, scale=0.5).to(cuda).requires_grad_()
        m = torch.stack([m, m.flip(0)], dim=1).contiguous()
        fn, plain = krnn.lstm_scan_stacked, krnn.lstm_scan_stacked_plain
        run = lambda f: (f(gx, m, wh, bh),)                             # noqa: E731
    else:
        gx = _randn(t, b, 8 * h, seed=h + 6, scale=0.5).to(cuda).requires_grad_()
        fn, plain = krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain
        run = lambda f: f(gx[..., :4 * h], gx[..., 4 * h:], m, wh, bh)  # noqa: E731
    with torch.no_grad():
        y_inf = run(fn)                                         # the inference variant
    assert fn.route == route
    fn.route = None
    ys, ys_p = run(fn), run(plain)                              # the training variant
    got, ref = _grads(ys, (gx, wh, bh), 9), _grads(ys_p, (gx, wh, bh), 9)
    torch.cuda.synchronize()
    bwd = krnn.lstm_scan_stacked_bwd if stacked else krnn.lstm_scan_tm_bwd
    assert fn.route == route and bwd.route == route       # H = 512: both passes stream
    for y, y_i, y_p in zip(ys, y_inf, ys_p):
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
        assert torch.equal(y_i, y.detach())
    _assert_grads_close(got, ref)


def test_lstm_routes_agree_and_a_refused_route_raises(cuda):
    """The private route argument: at H = 64 the streaming kernel and the
    resident one on clusters of 2, 4 or 8 agree to rounding; a cluster that
    does not divide H, or that leaves a block more than 32 units, raises."""
    t, b, h = 12, 5, 64
    gates = _randn(t, b, 8 * h, seed=1, scale=0.5).to(cuda)
    gx = (gates[..., :4 * h], gates[..., 4 * h:])
    wh = _randn(2, h, 4 * h, seed=2, scale=0.1).to(cuda)
    bh = _randn(2, 4 * h, seed=3, scale=0.1).to(cuda)
    m = torch.ones(t, b, device=cuda)
    outs = {r: krnn._forward("lstm_scan_tm", gx, m, wh, bh, save=False, route=r)[0]
            for r in (0, 2, 4, 8)}
    torch.cuda.synchronize()
    for r in (2, 4, 8):
        torch.testing.assert_close(outs[r][0], outs[0][0], rtol=0, atol=1e-6)
        torch.testing.assert_close(outs[r][1], outs[0][1], rtol=0, atol=1e-6)
    for refused in (3, 1):
        with pytest.raises(RuntimeError, match=f"resident, clusters of {refused}"):
            krnn._forward("lstm_scan_tm", gx, m, wh, bh, save=False, route=refused)
    h = 512
    gates = torch.zeros(2, 1, 8 * h, device=cuda)
    with pytest.raises(RuntimeError, match="resident, clusters of 8"):
        krnn._forward("lstm_scan_tm", (gates[..., :4 * h], gates[..., 4 * h:]),
                      torch.ones(2, 1, device=cuda), torch.zeros(2, h, 4 * h, device=cuda),
                      torch.zeros(2, 4 * h, device=cuda), save=False, route=8)


GRU_ROUTE = {16: 1, 64: 2, 128: 4, 256: 8, 512: 16}
GRU_SHAPES = [(1, 1, 16), (2, 4, 16), (50, 6, 16),          # one block holds wh[d]
              (3, 6, 64), (50, 8, 64), (401, 1, 64),        # clusters of 2
              (3, 1, 128), (50, 6, 128), (2, 8, 128),       # clusters of 4
              (50, 4, 256), (2, 8, 256), (401, 6, 256),     # clusters of 8; all of wh in registers
              (401, 4, 512), (401, 8, 512), (50, 6, 512),   # the AM's width: clusters of 16
              (1, 8, 512), (2, 1, 512), (3, 4, 512)]        # the double buffer's edges


def _gru_inputs(cuda, t, b, h, stacked):
    """gx (time-major: [T, B, 6H], the kernel reads its strided halves),
    ragged right-padded masks with one all-padded row where b > 2, wh, bh."""
    wh = _randn(2, h, 3 * h, seed=h + 4, scale=1.0 / h ** 0.5).to(cuda).requires_grad_()
    bh = _randn(2, 3 * h, seed=h + 5, scale=0.1).to(cuda).requires_grad_()
    lengths = torch.tensor([t, t // 2 + 1, 0, t, 1, t - 1, 2, t][:b], device=cuda).clamp(max=t)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    if stacked:
        gx = _randn(t, 2, b, 3 * h, seed=h + 6, scale=0.5).to(cuda).requires_grad_()
        m = torch.stack([m, m.flip(0)], dim=1).contiguous()
    else:
        gx = _randn(t, b, 6 * h, seed=h + 6, scale=0.5).to(cuda).requires_grad_()
    return gx, m, wh, bh


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("t,b,h", GRU_SHAPES)
def test_gru_forward_routes(cuda, t, b, h, stacked):
    """The GRU forward on the route its H gives it, inference and training
    variants, both layouts: y against the plain version (1e-5), the same bits
    on a second run, gradients through the resident training forward and the
    backward kernel against autograd through the plain version."""
    route = GRU_ROUTE[h]
    assert krnn.gru_resident_cluster(h) == route
    gx, m, wh, bh = _gru_inputs(cuda, t, b, h, stacked)
    if stacked:
        fn, plain = krnn.gru_scan_stacked, krnn.gru_scan_stacked_plain
        run = lambda f: (f(gx, m, wh, bh),)                             # noqa: E731
    else:
        fn, plain = krnn.gru_scan_tm, krnn.gru_scan_tm_plain
        run = lambda f: f(gx[..., :3 * h], gx[..., 3 * h:], m, wh, bh)  # noqa: E731
    with torch.no_grad():
        before = fn.launches
        y_inf, y_again = run(fn), run(fn)                       # the inference variant
    assert fn.route == route and fn.launches == before + 2
    fn.route = None
    ys, ys_p = run(fn), run(plain)                              # the training variant
    got, ref = _grads(ys, (gx, wh, bh), 9), _grads(ys_p, (gx, wh, bh), 9)
    torch.cuda.synchronize()
    bwd = krnn.gru_scan_stacked_bwd if stacked else krnn.gru_scan_tm_bwd
    assert fn.route == route and bwd.route == route
    for y, y_i, y_a, y_p in zip(ys, y_inf, y_again, ys_p):
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
        assert torch.equal(y_i, y.detach()) and torch.equal(y_i, y_a)
    _assert_grads_close(got, ref)
    if b > 2:                                                   # the all-padded row
        row = (slice(None), slice(None), 2) if stacked else (slice(None), 2)
        assert all(torch.all(y[row] == 0) for y in ys) and torch.all(got[0][row] == 0)


@pytest.mark.parametrize("t,b,h", [(50, 6, 64), (3, 8, 128), (50, 5, 256), (401, 4, 512),
                                   (2, 3, 512)])
def test_gru_resident_matches_streaming_on_both_layouts(cuda, t, b, h):
    """The resident and the streaming kernel on the same inputs: y and every
    tensor the training variant saves (h, r, z, n, ghn) within 1e-5; the
    stacked entry gives the time-major entry's bits, saved tensors included."""
    gx, m, wh, bh = (x.detach() for x in _gru_inputs(cuda, t, b, h, False))
    halves = (gx[..., :3 * h], gx[..., 3 * h:])
    (yf, yb), (hp, act) = krnn._forward("gru_scan_tm", halves, m, wh, bh, save=True)
    assert krnn.gru_scan_tm.route == GRU_ROUTE[h]
    (yf_s, yb_s), (hp_s, act_s) = krnn._forward("gru_scan_tm", halves, m, wh, bh, save=True,
                                                route=0)
    assert krnn.gru_scan_tm.route == 0
    torch.cuda.synchronize()
    for name, a, ref in (("yf", yf, yf_s), ("yb", yb, yb_s), ("h", hp, hp_s),
                         *((g, act[..., i * h:(i + 1) * h], act_s[..., i * h:(i + 1) * h])
                           for i, g in enumerate(("r", "z", "n", "ghn")))):
        assert torch.isfinite(a).all(), name
        torch.testing.assert_close(a, ref, rtol=0, atol=1e-5, msg=lambda s, n=name: f"{n}: {s}")
    gx_st, m_st = (x.contiguous() for x in krnn.to_stacked(*halves, m))
    (y_st,), (hp_st, act_st) = krnn._forward("gru_scan_stacked", (gx_st,), m_st, wh, bh,
                                             save=True)
    assert krnn.gru_scan_stacked.route == GRU_ROUTE[h]
    assert torch.equal(y_st[:, 0], yf) and torch.equal(y_st[:, 1].flip(0), yb)
    assert torch.equal(hp_st[0], hp[0]) and torch.equal(hp_st[1].flip(0), hp[1])
    assert torch.equal(act_st[0], act[0]) and torch.equal(act_st[1].flip(0), act[1])


def test_gru_refused_route_raises_and_the_card_holds_a_cluster_of_16(cuda):
    """The private route argument: a cluster that does not divide H, one above
    16 blocks, and one that leaves a block more than 32 units are refused by
    the launcher and the wrapper raises; nothing gives way to the streaming
    kernel.  The occupancy calculator finds room for at least one cluster of
    16 blocks at H = 512, for both variants."""
    t, b, h = 6, 5, 64
    gx, m, wh, bh = (x.detach() for x in _gru_inputs(cuda, t, b, h, False))
    halves = (gx[..., :3 * h], gx[..., 3 * h:])
    outs = {r: krnn._forward("gru_scan_tm", halves, m, wh, bh, save=False, route=r)[0]
            for r in (0, 2, 4, 8, 16)}
    torch.cuda.synchronize()
    for r in (2, 4, 8, 16):
        torch.testing.assert_close(outs[r][0], outs[0][0], rtol=0, atol=1e-6)
        torch.testing.assert_close(outs[r][1], outs[0][1], rtol=0, atol=1e-6)
    before = krnn.gru_scan_tm.launches
    for refused in (3, 32, 1):
        with pytest.raises(RuntimeError, match=f"resident, clusters of {refused}"):
            krnn._forward("gru_scan_tm", halves, m, wh, bh, save=False, route=refused)
    h = 512
    gates = torch.zeros(2, 1, 6 * h, device=cuda)
    with pytest.raises(RuntimeError, match="resident, clusters of 8"):
        krnn._forward("gru_scan_tm", (gates[..., :3 * h], gates[..., 3 * h:]),
                      torch.ones(2, 1, device=cuda), torch.zeros(2, h, 3 * h, device=cuda),
                      torch.zeros(2, 3 * h, device=cuda), save=False, route=8)
    assert krnn.gru_scan_tm.launches == before
    assert krnn.resident_clusters_at_once("gru", 512) >= 1
    assert krnn.resident_clusters_at_once("gru", 512, save=True) >= 1
    assert krnn.resident_clusters_at_once("lstm", 256) >= 1
    for cell in ("gru", "lstm"):                 # 64 units a block; no resident route
        with pytest.raises(RuntimeError, match="clusters of 8"):
            krnn.resident_clusters_at_once(cell, 512, cluster=8)
        with pytest.raises(RuntimeError, match="clusters of 0"):
            krnn.resident_clusters_at_once(cell, 1024)


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


@pytest.mark.parametrize("cell,t,b,h", [("lstm", 40, 5, 32), ("gru", 40, 5, 32),
                                        ("lstm", 30, 4, 256), ("gru", 60, 4, 512)])
def test_stacked_rnn_kernels(cuda, cell, t, b, h):
    """y and dgx, dwh, dbh of the stacked-layout entries against the plain
    version; direction 1 is left-padded (its mask flipped), bh non-zero."""
    g = 4 if cell == "lstm" else 3
    fn, plain, bwd = ((krnn.lstm_scan_stacked, krnn.lstm_scan_stacked_plain,
                       krnn.lstm_scan_stacked_bwd) if cell == "lstm" else
                      (krnn.gru_scan_stacked, krnn.gru_scan_stacked_plain,
                       krnn.gru_scan_stacked_bwd))
    gx = _randn(t, 2, b, g * h, seed=h + 13, scale=0.5).to(cuda).requires_grad_()
    wh = _randn(2, h, g * h, seed=h + 14, scale=1.0 / h ** 0.5).to(cuda).requires_grad_()
    bh = _randn(2, g * h, seed=h + 15, scale=0.1).to(cuda).requires_grad_()
    lengths = torch.tensor([t, t // 2 + 3, 3, t, 1][:b], device=cuda)
    m0 = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    m = torch.stack([m0, m0.flip(0)], dim=1).contiguous()
    with torch.no_grad():
        before = fn.launches
        y_inf = fn(gx, m, wh, bh)                              # the inference kernel
        assert fn.launches == before + 1
    before = (fn.launches, bwd.launches)
    y = fn(gx, m, wh, bh)
    y_p = plain(gx, m, wh, bh)
    got, ref = _grads((y,), (gx, wh, bh), 9), _grads((y_p,), (gx, wh, bh), 9)
    torch.cuda.synchronize()
    assert (fn.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(y_inf, y.detach())
    _assert_grads_close(got, ref)
    assert torch.all(got[0][3:, 0, 2] == 0) and torch.all(got[0][:t - 3, 1, 2] == 0)


BWD_CLUSTER = {64: 2, 128: 4, 256: 8, 512: 16}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("b", [5, 32])
@pytest.mark.parametrize("cell,h", [("gru", 64), ("gru", 128), ("gru", 256), ("gru", 512),
                                    ("lstm", 64), ("lstm", 128), ("lstm", 256)])
def test_resident_backward(cuda, cell, h, b, stacked):
    """The resident backward at every cluster size, on what the training
    forward saved: dgx, dwh, dbh against autograd through the plain version
    (ragged lengths with an all-padded row, non-zero bh; B = 5 leaves a tile
    with padded rows, B = 32 runs 8 tiles a direction, in waves at H = 512);
    two calls give the same bits; without the weight gradient (a frozen GRU:
    no dgh) dgx keeps its bits; the streaming backward (route 0) agrees
    within 1e-4 of max|grad|."""
    g, t = (4 if cell == "lstm" else 3), 37
    name = f"{cell}_scan_{'stacked' if stacked else 'tm'}"
    route = krnn.bwd_resident_cluster(cell, h)
    assert route == BWD_CLUSTER[h]
    wh = _randn(2, h, g * h, seed=h + 21, scale=h ** -0.5).to(cuda)
    bh = _randn(2, g * h, seed=h + 22, scale=0.1).to(cuda)
    lengths = torch.tensor([t, t // 2 + 1, 0, t, 1, t - 1, 2, t] * 4, device=cuda)[:b]
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    if stacked:
        gx = (_randn(t, 2, b, g * h, seed=h + 23, scale=0.5).to(cuda),)
        m = torch.stack([m, m.flip(0)], dim=1).contiguous()
        plain = krnn.lstm_scan_stacked_plain if cell == "lstm" else krnn.gru_scan_stacked_plain
        run_plain = lambda x, w, v: (plain(*x, m, w, v),)                     # noqa: E731
    else:
        full = _randn(t, b, 2 * g * h, seed=h + 23, scale=0.5).to(cuda)
        gx = (full[..., :g * h], full[..., g * h:])
        plain = krnn.lstm_scan_tm_plain if cell == "lstm" else krnn.gru_scan_tm_plain
        run_plain = lambda x, w, v: plain(*x, m, w, v)                        # noqa: E731
    ys, saved = krnn._forward(name, gx, m, wh, bh, save=True)
    dys = tuple(_randn(*y.shape, seed=h + 24 + i).to(cuda) for i, y in enumerate(ys))
    bwd = krnn._BACKWARD[name]
    before = bwd.launches
    got = krnn._backward(name, m, wh, saved, dys, True)
    assert bwd.route == route
    again = krnn._backward(name, m, wh, saved, dys, True)
    frozen = krnn._backward(name, m, wh, saved, dys, False)
    stream = krnn._backward(name, m, wh, saved, dys, True, route=0)
    assert bwd.route == 0 and bwd.launches == before + 4
    inputs = [x.detach().clone().requires_grad_() for x in (*gx, wh, bh)]
    ref = torch.autograd.grad(run_plain(inputs[:-2], *inputs[-2:]), inputs, dys)
    torch.cuda.synchronize()

    def flat(out):
        return (*out[0], out[1], out[2])

    _assert_grads_close(flat(got), ref)
    assert all(torch.equal(x, y) for x, y in zip(flat(got), flat(again)))
    assert frozen[1] is None and frozen[2] is None
    assert all(torch.equal(x, y) for x, y in zip(frozen[0], got[0]))
    for x, y in zip(flat(stream), flat(got)):
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4 * float(y.abs().max()))
    row = (slice(None), slice(None), 2) if stacked else (slice(None), 2)
    assert all(torch.all(x[row] == 0) for x in got[0])        # the all-padded row


def test_backward_refused_route_raises(cuda):
    """The backward's private route argument: a cluster that does not divide
    H, one that leaves a block more than 32 units, and the LSTM at H = 512 on
    clusters of 16 (512 threads of 128 weights: more registers than an SM
    has) are refused by the launcher and the wrapper raises, launching
    nothing.  The occupancy calculator finds room for the AM's and the
    enhancer's resident backward."""
    t, b = 4, 3
    for cell, h, refused in (("gru", 64, 3), ("gru", 64, 1), ("lstm", 64, 3),
                             ("lstm", 512, 16)):
        g = 4 if cell == "lstm" else 3
        name = f"{cell}_scan_tm"
        gx = _randn(t, b, 2 * g * h, seed=1, scale=0.5).to(cuda)
        m = torch.ones(t, b, device=cuda)
        wh = _randn(2, h, g * h, seed=2, scale=h ** -0.5).to(cuda)
        ys, saved = krnn._forward(name, (gx[..., :g * h], gx[..., g * h:]), m, wh,
                                  torch.zeros(2, g * h, device=cuda), save=True)
        before = krnn._BACKWARD[name].launches
        with pytest.raises(RuntimeError, match=f"resident, clusters of {refused}"):
            krnn._backward(name, m, wh, saved, ys, True, route=refused)
        assert krnn._BACKWARD[name].launches == before
    assert krnn.resident_clusters_at_once("gru", 512, backward=True) >= 1
    assert krnn.resident_clusters_at_once("lstm", 256, backward=True) >= 1
    with pytest.raises(RuntimeError, match="clusters of 16"):
        krnn.resident_clusters_at_once("lstm", 512, cluster=16, backward=True)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_batch_major_birnn_matches_time_major(cuda, cell):
    from aas_enhancement_tpu_torch.convert import init_like_flax
    from aas_enhancement_tpu_torch.ops.rnn import BiRNN
    gen = torch.Generator().manual_seed(5)
    tm = init_like_flax(BiRNN(24, 32, cell=cell), gen).to(cuda)
    bm = BiRNN(24, 32, cell=cell, time_major=False).to(cuda)
    bm.load_state_dict(tm.state_dict())
    x = _randn(6, 50, 24, seed=8).to(cuda)
    lengths = torch.tensor([50, 31, 7, 50, 1, 20], device=cuda)
    with torch.no_grad():
        y_tm = tm(x.transpose(0, 1), lengths).transpose(0, 1)
        y_bm = bm(x, lengths)
    torch.testing.assert_close(y_bm, y_tm, rtol=1e-5, atol=1e-5)
    assert torch.all(y_bm[2, 7:] == 0)


CONV_DW_SHAPES = [
    # b, t, f, ci, co, kt, kf, strides
    (2, 37, 23, 8, 16, 5, 5, (1, 1)),
    (2, 33, 21, 8, 8, 3, 7, (1, 1)),
    (1, 40, 16, 16, 8, 1, 1, (1, 1)),
    (2, 29, 41, 8, 8, 11, 21, (1, 2)),
    (2, 30, 17, 8, 8, 5, 5, (1, 2)),
    (2, 16, 18, 8, 8, 4, 6, (1, 2)),
    (2, 29, 80, 32, 32, 11, 21, (1, 2)),     # even F: pad (9, 10)
    (3, 50, 81, 32, 32, 11, 21, (1, 2)),     # the AM's conv2, odd F: pad (10, 10)
    (2, 40, 33, 32, 32, 5, 5, (1, 1)),       # the enhancer's convs
    (2, 21, 19, 10, 6, 3, 5, (1, 1)),        # channels not multiples of 4: scalar loads
    (1, 18, 20, 64, 64, 3, 13, (1, 2)),      # one tile per block, two chunks over grid z
]


@pytest.mark.parametrize("shape", CONV_DW_SHAPES)
def test_conv_dw_kernel(cuda, shape):
    b, t, f, ci, co, kt, kf, strides = shape
    x = _randn(b, t, f, ci, seed=1).to(cuda)
    dy = _randn(b, t, -(-f // strides[1]), co, seed=2).to(cuda)
    before = kconv.conv_dw_same.launches
    got = kconv.conv_dw_same(x, dy, kt, kf, strides)
    again = kconv.conv_dw_same(x, dy, kt, kf, strides)
    ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides)
    torch.cuda.synchronize()
    assert kconv.conv_dw_same.launches == before + 2
    assert got.shape == (kt, kf, ci, co) and torch.equal(got, again)   # same bits twice
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_conv_dw_reads_channels_last_views_in_place(cuda):
    """An NCHW tensor with channels-last memory, and a dy that is a strided
    slice, need no copy; a channel stride other than 1 raises."""
    x = _randn(2, 8, 20, 15, seed=3).to(cuda).contiguous(memory_format=torch.channels_last)
    dy = _randn(2, 20, 8, 24, seed=4).to(cuda)[..., 4:20]           # [B, T, Fo, 16]
    got = kconv.conv_dw_same(x.permute(0, 2, 3, 1), dy, 3, 5, (1, 2))
    ref = kconv.conv_dw_same_plain(x.permute(0, 2, 3, 1), dy, 3, 5, (1, 2))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="unit channel stride"):
        kconv.conv_dw_same(_randn(2, 8, 20, 15).to(cuda).permute(0, 2, 3, 1), dy,
                           3, 5, (1, 2))
    with pytest.raises(ValueError, match="does not take"):
        kconv.conv_dw_same(_randn(1, 4, 4, 128).to(cuda), _randn(1, 4, 4, 64).to(cuda),
                           3, 3)


@pytest.mark.parametrize("dw_impl,launches", [("kernel", 1), ("auto", 1), ("cudnn", 0)])
def test_tapdw_conv_on_card(cuda, dw_impl, launches):
    """TapDWConv against SameConv2d with the same weights: primal and dx are
    cuDNN's on both sides, dW comes from the kernel unless dw_impl is cudnn."""
    ref = tconv.SameConv2d(8, 16, (5, 7), (1, 2)).to(cuda)
    mod = tconv.TapDWConv(8, 16, (5, 7), (1, 2), dw_impl=dw_impl).to(cuda)
    mod.load_state_dict(ref.state_dict())
    x = _randn(2, 8, 30, 21, seed=6).to(cuda).requires_grad_()
    cot = _randn(2, 16, 30, 11, seed=7).to(cuda)
    before = kconv.conv_dw_same.launches
    y = mod(x)
    got = torch.autograd.grad(y, (x, mod.weight, mod.bias), cot)
    y_ref = ref(x)
    want = torch.autograd.grad(y_ref, (x, ref.weight, ref.bias), cot)
    torch.cuda.synchronize()
    assert kconv.conv_dw_same.launches == before + launches
    assert torch.equal(y, y_ref)
    _assert_grads_close(got, want)
    frozen = tconv.TapDWConv(8, 16, (5, 7), (1, 2), dw_impl=dw_impl).to(cuda)
    frozen.requires_grad_(False)
    before = kconv.conv_dw_same.launches
    torch.autograd.grad(frozen(x).sum(), x)
    assert kconv.conv_dw_same.launches == before          # a frozen conv needs no dW


def test_tapdw_auto_takes_cudnn_where_the_kernel_refuses(cuda):
    """128 -> 128 channels is a 32 x 32 register tiling, more than a block:
    "auto" asks the wrapper and takes cuDNN, "kernel" raises."""
    x = _randn(1, 128, 6, 9, seed=1).to(cuda)
    assert kconv.kernel_slices(x.permute(0, 2, 3, 1), 128, 3, 3, (1, 1)) == 0
    assert kconv.kernel_slices(x.permute(0, 2, 3, 1), 32, 3, 3, (1, 1)) > 0
    assert kconv.kernel_slices(x.permute(0, 2, 3, 1), 32, 3, 3, (2, 1)) == 0
    ref = tconv.SameConv2d(128, 128, (3, 3)).to(cuda)
    cot = _randn(1, 128, 6, 9, seed=2).to(cuda)
    (want,) = torch.autograd.grad(ref(x), ref.weight, cot)
    mod = tconv.TapDWConv(128, 128, (3, 3), dw_impl="auto").to(cuda)
    mod.load_state_dict(ref.state_dict())
    before = kconv.conv_dw_same.launches
    (got,) = torch.autograd.grad(mod(x), mod.weight, cot)
    assert kconv.conv_dw_same.launches == before
    _assert_grads_close((got,), (want,))
    mod.dw_impl = "kernel"
    with pytest.raises(ValueError, match="does not take"):
        torch.autograd.grad(mod(x), mod.weight, cot)


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


# (b, t, f, c, groups, lengths): partial last items of 8 frames (T = 21, 13),
# length-0 rows, a length past T; C = 16, 32 and 64 in 4, 8 and 32 groups.
GN_BWD_EDGE = [(3, 21, 5, 16, 4, [21, 0, 9]), (2, 13, 9, 32, 8, [13, 9]),
               (2, 13, 7, 64, 32, [20, 5]), (3, 21, 17, 32, 32, [0, 21, 1])]


@pytest.mark.parametrize("b,t,f,c,groups,lens", GN_BWD_EDGE)
@pytest.mark.parametrize("act", ["none", "leaky_relu", "hardtanh"])
def test_gn_backward_kernel_edge_shapes(cuda, b, t, f, c, groups, lens, act):
    """The backward kernel alone, fed the forward kernel's own saved mean and
    inv, against the plain closed form, lengths as int32 and int64: dx 0 on
    padded frames, the same bits for dx, dscale and dbias on two calls."""
    x = (0.5 + 3.0 * _randn(b, t, f, c, seed=t + c)).to(cuda)
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda)
    bias = _randn(c, seed=5).to(cuda)
    dy = _randn(b, t, f, c, seed=6).to(cuda)
    kw = dict(num_groups=groups, act=act)
    for dtype in (torch.int32, torch.int64):
        lengths = torch.tensor(lens, dtype=dtype, device=cuda)
        mean, inv = gn._stats(gn.gn_kernel(x, scale, bias, lengths, groups, 1e-5, act,
                                           0.2)[1], b, c)
        before = gn.masked_group_norm_act_bwd.launches
        got = gn.masked_group_norm_act_bwd(x, dy, scale, bias, lengths, mean, inv, **kw)
        again = gn.masked_group_norm_act_bwd(x, dy, scale, bias, lengths, mean, inv, **kw)
        ref = gn.masked_group_norm_act_bwd_plain(x, dy, scale, bias, lengths, mean, inv, **kw)
        torch.cuda.synchronize()
        assert gn.masked_group_norm_act_bwd.launches == before + 2
        assert all(torch.equal(a, r) for a, r in zip(got, again))
        _assert_grads_close(got, ref)
        for i, n in enumerate(lens):
            assert torch.all(got[0][i, n:] == 0)


def test_gn_backward_dy_layouts_and_refusals(cuda):
    """A dy 4 bytes off 16-byte alignment, and a non-contiguous one, give the
    bits of the same values in a fresh tensor; a wrong scale shape, and more
    groups than the kernel takes, raise."""
    shape = (2, 19, 9, 32)
    x = (0.5 + _randn(*shape, seed=1)).to(cuda)
    scale, bias = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    lengths = torch.tensor([19, 11], device=cuda)
    mean, inv = gn._stats(gn.gn_kernel(x, scale, bias, lengths, 8, 1e-5, "none", 0.2)[1],
                          2, 32)
    dy = _randn(*shape, seed=2).to(cuda)
    flat = torch.empty(dy.numel() + 1, device=cuda)
    flat[1:] = dy.flatten()
    odd = [flat[1:].view(shape), dy.transpose(1, 2).contiguous().transpose(1, 2)]
    assert odd[0].data_ptr() % 16 and not odd[1].is_contiguous()
    call = lambda d: gn.masked_group_norm_act_bwd(x, d, scale, bias, lengths,  # noqa: E731
                                                  mean, inv, num_groups=8)
    want = call(dy)
    for d in odd:
        assert all(torch.equal(a, r) for a, r in zip(call(d), want))
    with pytest.raises(ValueError, match="scale and bias"):
        gn.masked_group_norm_act_bwd(x, dy, scale[:16], bias, lengths, mean, inv,
                                     num_groups=8)
    with pytest.raises(RuntimeError, match="aas_gn_act_bwd"):      # 33 groups: the kernel's
        gn.masked_group_norm_act_bwd(x, dy, scale, bias, lengths, mean, inv,  # refusal
                                     num_groups=33)


@pytest.mark.parametrize("frozen", [False, True])
def test_gn_backward_is_one_device_kernel(cuda, frozen):
    """The backward pass through one GN call, at the enhancer's width, runs
    one device kernel (the cooperative one), whether scale and bias want a
    gradient or are frozen (the AAS step's AM).  Profiled in a fresh process:
    late in this file's process the profiler has left the backward kernel's
    record out of a session (on an H100, with the session's other records
    present), and in a fresh process it has not."""
    names, = kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import gn
frozen = {frozen}
x = torch.randn(2, 101, 161, 32, device="cuda").requires_grad_()
scale = torch.ones(32, device="cuda", requires_grad=not frozen)
bias = torch.zeros(32, device="cuda", requires_grad=not frozen)
y = gn.masked_group_norm_act(x, scale, bias, torch.tensor([101, 60], device="cuda"),
                             num_groups=8, act="leaky_relu")
dy = torch.randn_like(y)
inputs = (x,) if frozen else (x, scale, bias)
calls = [lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)]
""")
    assert sum(names.values()) == 1 and "gn_act_bwd_kernel" in next(iter(names)), names


def test_enhance_on_card_matches_cpu(cuda):
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16))
    model = init_enhancer(cfg, seed=0, device="cpu")
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
    am, enh = init_am(cfg, seed=0, device="cpu"), init_enhancer(cfg, seed=1, device="cpu")
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


# The streaming paths' shapes (blockwise fine-tuning, batched serving): B * nb
# windows of 220 input frames (the enhancer's LSTM-256) or 110 AM frames (the
# AM's GRU-512), the trailing windows of the short rows at length 0, and more
# tiles of 4 rows than the card runs clusters at once (waves).
STREAM_RNN = [("lstm", 220, 72, 256), ("gru", 110, 72, 512), ("gru", 110, 40, 512)]


def _stream_lengths(b, t, cuda):
    """9 windows a row: full, then a ragged last window and length-0 ones."""
    per_row = [t] * 5 + [t // 2 + 3, 1, 0, 0]
    return torch.tensor((per_row * -(-b // 9))[:b], device=cuda)


@pytest.mark.parametrize("cell,t,b,h", STREAM_RNN)
def test_resident_rnn_at_the_streaming_shapes(cuda, cell, t, b, h):
    """The resident forward (inference and training variants) and backward
    through the wrappers, at the streaming windows' shapes, against the
    plain versions: y to 1e-5, the gradients of gx, wh and bh as the other
    backward tests; rows of length 0 give y = 0 and dgx = 0; the tiles run in
    more than one wave."""
    g = 4 if cell == "lstm" else 3
    scan = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
    plain = krnn.lstm_scan_tm_plain if cell == "lstm" else krnn.gru_scan_tm_plain
    bwd = krnn.lstm_scan_tm_bwd if cell == "lstm" else krnn.gru_scan_tm_bwd
    lengths = _stream_lengths(b, t, cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    full = _randn(t, b, 2 * g * h, seed=h + 31, scale=0.5).to(cuda).requires_grad_()
    wh = _randn(2, h, g * h, seed=h + 32, scale=h ** -0.5).to(cuda).requires_grad_()
    bh = _randn(2, g * h, seed=h + 33, scale=0.1).to(cuda).requires_grad_()
    cluster = krnn.bwd_resident_cluster(cell, h)
    tiles = 2 * -(-b // 4)
    assert tiles > krnn.resident_clusters_at_once(cell, h, save=True)
    assert tiles > krnn.resident_clusters_at_once(cell, h, backward=True)
    with torch.no_grad():
        y_inf = scan(full[..., :g * h], full[..., g * h:], m, wh, bh)
    assert scan.route == cluster
    ys = scan(full[..., :g * h], full[..., g * h:], m, wh, bh)
    before = bwd.launches
    got = _grads(ys, (full, wh, bh), 41)
    assert scan.route == cluster and bwd.route == cluster and bwd.launches == before + 1
    inputs = [x.detach().clone().requires_grad_() for x in (full, wh, bh)]
    ys_p = plain(inputs[0][..., :g * h], inputs[0][..., g * h:], m, *inputs[1:])
    ref = _grads(ys_p, inputs, 41)
    torch.cuda.synchronize()
    for y, y_p, y_i in zip(ys, ys_p, y_inf):
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
        assert torch.equal(y, y_i)
    _assert_grads_close(got, ref)
    zero = lengths == 0
    assert zero.any()
    assert all(torch.all(y[:, zero] == 0) for y in ys)
    assert torch.all(got[0][:, zero] == 0)


@pytest.mark.parametrize("act,shape", [("leaky_relu", (18, 220, 161, 32)),
                                       ("hardtanh", (72, 110, 81, 32)),
                                       ("hardtanh", (72, 110, 41, 32))])
def test_gn_at_the_streaming_shapes(cuda, act, shape):
    """The GroupNorm forward and backward kernels on the streaming windows'
    shapes (the enhancer's GN over 220 frames, the AM's two over 110 AM
    frames), rows of length 0 among them: y against the plain version to
    1e-5; the backward (through autograd's Function) against the plain
    closed form on the forward kernel's saved mean and inv, as the other
    backward tests hold it, and bit for bit against the backward wrapper
    alone.  (Autograd through the plain forward computes z = x * inv_c +
    off_c in another order than the closed form's x_hat * scale + bias: over
    20M entries one z lies within rounding of 0, where leaky_relu' is 1 on
    one side and 0.2 on the other.)  Length-0 rows give y = 0 and dx = 0."""
    b, t, f, c = shape
    x = (0.5 + 2.0 * _randn(*shape, seed=b + f)).to(cuda).requires_grad_()
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda).requires_grad_()
    bias = _randn(c, seed=5).to(cuda).requires_grad_()
    dy = _randn(*shape, seed=51).to(cuda)
    lengths = _stream_lengths(b, t, cuda)
    kw = dict(num_groups=8, act=act)
    before = (gn.masked_group_norm_act.launches, gn.masked_group_norm_act_bwd.launches)
    y = gn.masked_group_norm_act(x, scale, bias, lengths, **kw)
    got = torch.autograd.grad(y, (x, scale, bias), dy)
    mean, inv = gn._stats(gn.gn_kernel(x.detach(), scale.detach(), bias.detach(), lengths,
                                       8, 1e-5, act, 0.2)[1], b, c)
    args = (x.detach(), dy, scale.detach(), bias.detach(), lengths, mean, inv)
    alone = gn.masked_group_norm_act_bwd(*args, **kw)
    ref = gn.masked_group_norm_act_bwd_plain(*args, **kw)
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, **kw)
    torch.cuda.synchronize()
    # Forward: the wrapper's launch and the launcher's own (the saved stats).
    assert (gn.masked_group_norm_act.launches, gn.masked_group_norm_act_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, r) for a, r in zip(got, alone))
    _assert_grads_close(got, ref)
    zero = lengths == 0
    assert torch.all(y[zero] == 0) and torch.all(got[0][zero] == 0)


def test_streaming_paths_on_card_match_cpu(cuda):
    """A small streaming enhancer and recognizer (one stream, 0.5 s chunks)
    and their batched engines with an idle slot, card against CPU: the
    emitted samples to 1e-4, the recognizer's log-probs to 1e-4."""
    from aas_enhancement_tpu_torch.streaming import (BatchedStreamingEnhancer,
                                                     StreamingEnhancer)
    from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
    cfg = Config().replace(am=AMConfig(rnn_hidden=32, rnn_layers=2, conv_channels=8),
                           enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16))
    am, enh = init_am(cfg, seed=0, device="cpu"), init_enhancer(cfg, seed=1, device="cpu")
    am_d, enh_d = init_am(cfg, seed=0, device=cuda), init_enhancer(cfg, seed=1, device=cuda)
    kw = dict(chunk_seconds=0.5, lookahead_seconds=0.1, history_seconds=0.5)
    wav = _randn(21000, seed=12, scale=0.3).numpy()
    out = {}
    for dev, g, a in (("cpu", enh, am), (cuda, enh_d, am_d)):
        eng = StreamingEnhancer(cfg, g, device=dev, **kw)
        batched = BatchedStreamingEnhancer(cfg, g, max_streams=2, device=dev, **kw)
        slot = batched.open()
        batched.feed(slot, wav)
        batched.end_stream(slot)
        pieces = []
        got = batched.step()
        while got:
            pieces.append(got[slot])
            got = batched.step()
        rec = StreamingRecognizer(cfg, a, g, collect_logits=True, device=dev, **kw)
        rec.feed(wav)
        rec.flush()
        out[str(dev)] = (eng.feed(wav), eng.flush(), np.concatenate(pieces), rec.log_probs())
    for c_arr, g_arr in zip(out["cpu"], out[str(cuda)]):
        assert c_arr.shape == g_arr.shape
        np.testing.assert_allclose(g_arr, c_arr, rtol=0, atol=1e-4)


def _operator_cases(cuda):
    """Per operator of ``ops/library.py``: (operator, its args on the card, the
    wrapper's gradient-free kernel call, the launch counter)."""
    from aas_enhancement_tpu_torch.ops import library
    x = _randn(3, 16000, seed=20, scale=0.3).to(cuda)
    re, im = kstft.stft_plain(x, 320, 160)
    xg = _randn(2, 41, 33, 16, seed=21).to(cuda)
    scale, bias = (1 + 0.1 * _randn(16, seed=22)).to(cuda), (0.1 * _randn(16, seed=23)).to(cuda)
    lengths = torch.tensor([41, 17], device=cuda)
    m = (torch.arange(23)[:, None] < torch.tensor([23, 9, 1])[None]).float().to(cuda)
    gl = _randn(23, 3, 8 * 64, seed=24).to(cuda)
    gg = _randn(23, 3, 6 * 64, seed=25).to(cuda)
    wl, bl = (0.2 * _randn(2, 64, 256, seed=26)).to(cuda), (0.1 * _randn(2, 256, seed=27)).to(cuda)
    wg, bg = (0.2 * _randn(2, 64, 192, seed=28)).to(cuda), (0.1 * _randn(2, 192, seed=29)).to(cuda)
    return {
        "stft": (library.stft, (x, 320, 160, "hann", True),
                 lambda: kstft.stft_kernel(x, 320, 160, "hann", True), kstft.stft),
        "istft": (library.istft, (re.to(cuda), im.to(cuda), 320, 160, "hann", True, 16000),
                  lambda: kstft.istft_kernel(re.to(cuda), im.to(cuda), 320, 160, "hann", True,
                                             16000), kstft.istft),
        "masked_group_norm_act": (
            library.masked_group_norm_act, (xg, scale, bias, lengths, 8, 1e-5, "leaky_relu", 0.2),
            lambda: gn.gn_kernel(xg, scale, bias, lengths, 8, 1e-5, "leaky_relu", 0.2)[0],
            gn.masked_group_norm_act),
        "lstm_scan_tm": (library.lstm_scan_tm, (gl[..., :256], gl[..., 256:], m, wl, bl),
                         lambda: krnn.scan_kernel("lstm_scan_tm", (gl[..., :256], gl[..., 256:]),
                                                  m, wl, bl), krnn.lstm_scan_tm),
        "gru_scan_tm": (library.gru_scan_tm, (gg[..., :192], gg[..., 192:], m, wg, bg),
                        lambda: krnn.scan_kernel("gru_scan_tm", (gg[..., :192], gg[..., 192:]),
                                                 m, wg, bg), krnn.gru_scan_tm),
    }


@pytest.mark.parametrize("name", ["stft", "istft", "masked_group_norm_act", "lstm_scan_tm",
                                  "gru_scan_tm"])
def test_operator_is_the_kernel(cuda, name):
    """Each operator on the card is its kernel: one launch, counted, and the
    bits of the wrapper's gradient-free kernel call on the same inputs."""
    op, args, kernel, counter = _operator_cases(cuda)[name]
    before = counter.launches
    got = op(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = kernel()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert a.device.type == "cuda" and a.shape == b.shape and torch.equal(a, b)


def test_exported_enhancer_runs_the_kernels(cuda, tmp_path):
    """A small enhancer exported on the card and loaded back: the live
    path's bits, and each call launches STFT 1, ISTFT 1, GN 1 and LSTM 1
    (one conv layer, one BiLSTM)."""
    from aas_enhancement_tpu_torch.serving import export_enhancer, load_enhancer
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, conv_layers=1,
                                                   rnn_hidden=16, rnn_layers=1))
    model = init_enhancer(cfg, seed=3, device=cuda)
    export_enhancer(cfg, model, str(tmp_path), batch_sizes=(2,), seconds=(1.0,), device=cuda)
    served = load_enhancer(str(tmp_path), cuda)
    wav = _randn(2, 12000, seed=30, scale=0.3).numpy()
    counters = (kstft.stft, kstft.istft, gn.masked_group_norm_act, krnn.lstm_scan_tm)
    before = [c.launches for c in counters]
    got = served.enhance(wav, np.array([12000, 7000]))
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    pad = torch.zeros(2, 16000)
    pad[:, :12000] = torch.from_numpy(wav)
    live = make_enhance_fn(cfg, cuda)(model, pad, torch.tensor([12000, 7000]))
    np.testing.assert_array_equal(got, live[:, :12000].cpu().numpy())
