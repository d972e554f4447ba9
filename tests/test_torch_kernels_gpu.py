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
kernel's slice order and the plain version's); at f32 against the plain
version's f64 sums at the AM's conv2, the split route within 1.5e-6 of
max|dW| (a product left out misses by more: tests/test_torch_conv_dw_plan.py),
the FMA route within 1e-5.
bf16 streams (the forwards of the bf16 models): the GroupNorm
within 2^-7 x max|plain| (one bf16 ulp at the top: f32 z rounded apart where
the sums' order differs), the LSTM and GRU within 2^-6 x max|plain| (a
rounded h that parts fed back T times); the bf16 enhance path card vs CPU
5e-2 x max|wave| (cuBLAS / cuDNN bf16 products against the CPU's).
The backward kernels on bf16 streams (training at bf16): the recurrences'
dgx, dwh, dbh within 2e-2 x max|plain| of each tensor (the kernels read
the bf16 copies of h and c that the Pallas VJP reads, the plain autograd its
f32 state), the resident and the streaming route within 2e-2 x max of each
other; the GroupNorm's dx within 2^-7 x max|plain| (one bf16 ulp at the
top), dscale and dbias 1e-4 x max (f32 sums of the same products); conv_dw
1e-4 x max|dW| (f32 sums of the same bf16 values).
"""

import itertools
import re

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
from aas_enhancement_tpu_torch.utils import kernel_build
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


# The STFT's and the ISTFT's VJP kernels (csrc/stft_vjp.cu) against their
# plain versions: the MR-STFT resolutions and the enhancer's, ragged lengths,
# no center pad, hop n_fft/4 at 320; T < K, a row one run covers whole (its
# head and tail fold in one block), a length one sample past a run boundary,
# and many runs a row; the direct routes (a prime n_fft; 2048, past the radix
# route's largest n_fft/2).  Limit: 1e-4 of the gradient's max|g| (f32 sums
# of up to n_fft terms in the kernels' order and the plain version's matmul
# order).
VJP_CASES = [(256, 64, True, 8000), (512, 128, True, 7777), (1024, 256, True, 9000),
             (320, 160, True, 16000), (320, 160, False, 16001), (320, 80, True, 5000),
             (256, 64, True, 150), (1024, 256, True, 700), (256, 64, True, 64 * 64 + 1),
             (256, 64, True, 64 * 64 * 8), (512, 128, False, 20000), (37, 37, True, 3000),
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
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    dx = kstft.stft_vjp(dre, dim, n, n_fft, hop, center=center, frames_done=counter)
    again = kstft.stft_vjp(dre, dim, n, n_fft, hop, center=center)
    ref = kstft.stft_vjp_plain(dre, dim, n, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert kstft.stft_vjp.launches == before + 2
    assert kstft.stft_vjp.route == kstft.vjp_plan(n_fft, hop)
    # the radix kernel transforms each frame once (the direct sums count none)
    assert int(counter) == (3 * t if kstft.vjp_plan(n_fft, hop).radices else 0)
    assert dx.shape == (3, n) and torch.equal(dx, again)
    assert _vjp_err((dx,), (ref,)) <= 1e-4


@pytest.mark.parametrize("n_fft,hop,center,n", VJP_CASES)
def test_istft_vjp_kernel(cuda, n_fft, hop, center, n):
    t = 1 + (n // hop if center else (n - n_fft) // hop)
    for length in (n, max(1, n - 3 * hop - 1), n + 2 * hop):   # cut, exact, zero-padded
        dy = _randn(3, length, seed=length).to(cuda)
        before = kstft.istft_vjp.launches
        counter = torch.zeros(1, dtype=torch.int32, device=cuda)
        got = kstft.istft_vjp(dy, t, n_fft, hop, center=center, frames_done=counter)
        again = kstft.istft_vjp(dy, t, n_fft, hop, center=center)
        ref = kstft.istft_vjp_plain(dy, t, n_fft, hop, center=center)
        torch.cuda.synchronize()
        assert kstft.istft_vjp.launches == before + 2
        assert kstft.istft_vjp.route == kstft.vjp_plan(n_fft, hop)
        assert int(counter) == (3 * t if kstft.vjp_plan(n_fft, hop).radices else 0)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
        assert _vjp_err(got, ref) <= 1e-4


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (1024, 256), (320, 160)])
def test_vjp_kernels_launch_one_device_kernel(cuda, n_fft, hop):
    """A call of either VJP wrapper is one device kernel (profiled in a fresh
    process): no fold launch, no buffer copy."""
    names = kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
n = 16000
t = 1 + n // {hop}
dre = torch.randn(2, t, {n_fft} // 2 + 1, device="cuda")
dim = torch.randn(2, t, {n_fft} // 2 + 1, device="cuda")
dy = torch.randn(2, n, device="cuda")
calls = [lambda: kstft.stft_vjp(dre, dim, n, {n_fft}, {hop}),
         lambda: kstft.istft_vjp(dy, t, {n_fft}, {hop})]
""")
    for got, want in zip(names, ("stft_vjp_kernel", "istft_vjp_kernel")):
        got = [n for n, k in got.items() for _ in range(k)
               if "Memcpy" not in n and "Memset" not in n]
        assert len(got) == 1 and re.search(rf"(?<!\w){want}\b", got[0]), got


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


# Any hop (csrc/stft.cu, istft.cu, stft_vjp.cu): the enhancer's (320, 160)
# beside three hops that do not divide n_fft, 25 ms / 10 ms (400, 160), 1.5
# frames of overlap (300, 200) and a hop longer than the frame (160, 320),
# center on and off, ragged rows.  The ISTFT is held to 2e-5 abs + 1e-5 rel
# where the COLA divisor is at least 0.5 (every sample the enhance path
# keeps) and, on the overlap-add sums before the divide, 2e-5 abs everywhere
# (at an untrimmed edge the divisor nears 0 and multiplies the sum-order
# noise by up to 1e8).
ANY_HOPS = [(320, 160), (400, 160), (300, 200), (160, 320)]


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
def test_stft_and_istft_kernels_at_any_hop(cuda, n_fft, hop, center):
    n = 16003
    x = _randn(3, n, seed=n_fft + hop, scale=0.3)
    x[1, 9001:] = 0
    x = x.to(cuda)
    before = (kstft.stft.launches, kstft.istft.launches)
    re, im = kstft.stft(x, n_fft, hop, center=center)
    re_p, im_p = kstft.stft_plain(x, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert kstft.stft.route == kstft.stft_factors(n_fft) != (0, 0)
    assert re.shape == re_p.shape
    torch.testing.assert_close(re, re_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(im, im_p, rtol=0, atol=1e-4)
    t = re.shape[1]
    gain = torch.rand(re.shape, generator=torch.Generator().manual_seed(hop)).to(cuda)
    for length in (n, n - 1000, n + 1000, None):
        y = kstft.istft(re * gain, im * gain, n_fft, hop, center=center, length=length)
        again = kstft.istft(re * gain, im * gain, n_fft, hop, center=center, length=length)
        y_p = kstft.istft_plain(re * gain, im * gain, n_fft, hop, center=center,
                                length=length)
        torch.cuda.synchronize()
        assert kstft.istft.route == kstft.istft_route(n_fft, hop) != (0, 0)
        assert y.shape == y_p.shape == (3, kstft.istft_length(t, n_fft, hop, center, length))
        assert torch.equal(y, again)
        div = kstft.trim(torch.from_numpy(kstft.cola_norm(t, n_fft, hop, "hann"))[None],
                         n_fft, center, length, pad=n_fft % hop == 0)[0]
        div = torch.nn.functional.pad(div, (0, y.shape[1] - div.shape[0])).to(cuda)
        inner = div >= 0.5
        torch.testing.assert_close(y[:, inner], y_p[:, inner], rtol=1e-5, atol=2e-5)
        clamped = div.clamp(min=1e-8)
        torch.testing.assert_close(y * clamped, y_p * clamped, rtol=0, atol=2e-5)
    assert (kstft.stft.launches, kstft.istft.launches) == (before[0] + 1, before[1] + 8)


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
def test_vjp_kernels_at_any_hop(cuda, n_fft, hop, center):
    """stft_vjp (runs of a row as the card's residency splits them, and one
    run a row) and istft_vjp (lengths that cut the output, end at the
    signal, and ask past the buffer) against their plain versions; each
    frame transformed once."""
    n = 16003
    t = kstft.stft_frames(n, n_fft, hop, center)
    dre = _randn(3, t, n_fft // 2 + 1, seed=n_fft).to(cuda)
    dim = _randn(3, t, n_fft // 2 + 1, seed=hop).to(cuda)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    dx = kstft.stft_vjp(dre, dim, n, n_fft, hop, center=center, frames_done=counter)
    ref = kstft.stft_vjp_plain(dre, dim, n, n_fft, hop, center=center)
    torch.cuda.synchronize()
    assert kstft.stft_vjp.route == kstft.vjp_plan(n_fft, hop) and kstft.stft_vjp.route.radices
    assert int(counter) == 3 * t and dx.shape == (3, n)
    assert _vjp_err((dx,), (ref,)) <= 1e-4
    one = kstft.stft_vjp(dre[:1], dim[:1], n, n_fft, hop, center=center)
    assert _vjp_err((one,), (ref[:1],)) <= 1e-4
    for length in (n - 1000, kstft.istft_length(t, n_fft, hop, center, n), n + 1000):
        dy = _randn(3, length, seed=length).to(cuda)
        counter.zero_()
        got = kstft.istft_vjp(dy, t, n_fft, hop, center=center, frames_done=counter)
        ref = kstft.istft_vjp_plain(dy, t, n_fft, hop, center=center)
        torch.cuda.synchronize()
        assert kstft.istft_vjp.route == kstft.vjp_plan(n_fft, hop)
        assert int(counter) == 3 * t
        assert _vjp_err(got, ref) <= 1e-4


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_kernel_where_the_variance_cancels(cuda, dtype):
    """Groups whose |mean| is ~30 times their spread, as over a streaming
    window's silent history: the kernel's float64 statistics give the plain
    version's mean and inv to float32 rounding (float32 sums in two orders
    parted by up to 4.5e-4 of a unit output), so y agrees to 1e-5 (bf16: to
    one bf16 ulp of the top)."""
    x = (3.0 + 0.1 * _randn(3, 45, 161, 32, seed=6)).to(cuda).to(dtype)
    scale, bias = (1 + _randn(32, seed=7, scale=0.1)).to(cuda), _randn(32, seed=8).to(cuda)
    lengths = torch.tensor([45, 30, 9], device=cuda)
    y, scratch = gn.gn_kernel(x, scale, bias, lengths, 8, 1e-5, "leaky_relu", 0.2)
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=8,
                                         act="leaky_relu")
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(y, y_p, rtol=0, atol=1e-5)
    else:
        assert (y.float() - y_p.float()).abs().max() <= 2.0 ** -7 * y_p.float().abs().max()
    xm = (x.float() * (torch.arange(45, device=cuda)[None] < lengths[:, None])[..., None, None]
          ).reshape(3, 45, 161, 8, 4).double()
    mean, inv = gn._group_stats(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                                lengths, 161, 32, 8, 1e-5)
    k_mean, k_inv = gn._stats(scratch, 3, 32)
    torch.testing.assert_close(k_mean, mean.repeat_interleave(4, dim=1), rtol=1e-6, atol=0)
    torch.testing.assert_close(k_inv, inv.repeat_interleave(4, dim=1), rtol=1e-6, atol=0)


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


def _f32_route(cuda, shape) -> str:
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    return kconv.conv_dw_plan(torch.float32, *shape, sms).route


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
    assert kconv.conv_dw_same.route == _f32_route(cuda, shape) == "bf16x3"
    assert got.shape == (kt, kf, ci, co) and torch.equal(got, again)   # same bits twice
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


# The end-to-end protocol's widths (cli/e2e.py::cfg_for: 16 channels, GN in
# 8 groups) at its batch of 16 in the flagship corpus's long bucket (6 s,
# 601 frames; the rows 301-542 frames, ragged): the enhancer's
# [16, 601, 161, 16] and the AM's [16, 301, 81 | 41, 16] (conv1 halves the
# frames, ceil).
E2E_LENGTHS = [542, 512, 503, 480, 460, 440, 420, 400, 380, 360, 350, 340, 330, 320, 310,
               302]
E2E_GN = [("leaky_relu", (16, 601, 161, 16)), ("hardtanh", (16, 301, 81, 16)),
          ("hardtanh", (16, 301, 41, 16))]


@pytest.mark.parametrize("act,shape", E2E_GN)
def test_gn_kernels_at_the_e2e_widths(cuda, act, shape):
    """B3 and B3' at 16 channels, forward and backward, against the plain
    version."""
    b, t, f, c = shape
    x = (0.5 + 3.0 * _randn(*shape, seed=f)).to(cuda).requires_grad_()
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda).requires_grad_()
    bias = _randn(c, seed=5).to(cuda).requires_grad_()
    lengths = torch.tensor([n if t == 601 else -(-n // 2) for n in E2E_LENGTHS], device=cuda)
    kw = dict(num_groups=8, act=act)
    # At the activation's kinks (leaky_relu 0, hardtanh +-1) a pre-activation
    # within rounding of the kink may take either slope, both valid: the
    # cotangent is 0 there (a few elements in 10^7 here; one at 6e-08 from 0
    # took the other slope on the card), so no gradient depends on the side.
    z = gn.masked_group_norm_act_plain(x.detach(), scale.detach(), bias.detach(), lengths,
                                       num_groups=8)
    valid = torch.arange(t, device=cuda)[None, :, None, None] < lengths[:, None, None, None]
    kink = ((z.abs() if act == "leaky_relu" else (z.abs() - 1).abs()) < 1e-5) & valid
    assert int(kink.sum()) <= 1e-5 * z.numel()
    w = _randn(*shape, seed=11).to(cuda).masked_fill(kink, 0)
    before = gn.masked_group_norm_act_bwd.launches
    y = gn.masked_group_norm_act(x, scale, bias, lengths, **kw)
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, **kw)
    got = torch.autograd.grad(y, (x, scale, bias), w)
    ref = torch.autograd.grad(y_p, (x, scale, bias), w)
    torch.cuda.synchronize()
    assert gn.masked_group_norm_act_bwd.launches == before + 1
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    _assert_grads_close(got, ref)
    assert torch.all(y[-1, int(lengths[-1]):] == 0) and torch.all(got[0][-1, int(lengths[-1]):] == 0)


def test_conv_dw_kernel_at_the_e2e_am_conv2(cuda):
    """B6 on the f32 route the plan gives ("bf16x3") at ci = co = 16: the
    e2e AM's conv2 (11 x 21, stride (1, 2)) at its batch, x [16, 301, 81,
    16], the padded rows zero as the GroupNorm below leaves them."""
    x = _randn(16, 301, 81, 16, seed=1)
    dy = _randn(16, 301, 41, 16, seed=2)
    for i, n in enumerate(E2E_LENGTHS):
        x[i, -(-n // 2):] = 0
        dy[i, -(-n // 2):] = 0
    x, dy = x.to(cuda), dy.to(cuda)
    before = kconv.conv_dw_same.launches
    got = kconv.conv_dw_same(x, dy, 11, 21, (1, 2))
    ref = kconv.conv_dw_same_plain(x, dy, 11, 21, (1, 2))
    torch.cuda.synchronize()
    assert kconv.conv_dw_same.launches == before + 1
    assert kconv.conv_dw_same.route == _f32_route(cuda, (16, 301, 81, 16, 16, 11, 21, (1, 2)))
    assert kconv.conv_dw_same.route == "bf16x3"
    assert got.shape == (11, 21, 16, 16)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("route", ["bf16x3", "fma"])
def test_conv_dw_f32_routes_against_f64(cuda, route):
    """Both f32 routes at the AM's conv2, B = 8 (dy zero past each row's
    frames, as the GroupNorm's mask leaves it), against the plain version's
    tap loop in float64: the split route within 1.5e-6 of max|dW|, the FMA
    route (f32 FMA sums over up to 1.03M positions) within 1e-5."""
    x = _randn(8, 401, 81, 32, seed=5).to(cuda)
    dy = _randn(8, 401, 41, 32, seed=6)
    for i, n in enumerate([401, 351, 301, 201, 401, 376, 251, 151]):
        dy[i, n:] = 0
    dy = dy.to(cuda)
    if route == "fma":
        got = kconv.conv_dw_fma(x, dy, 11, 21, (1, 2))
    else:
        before = kconv.conv_dw_same.launches
        got = kconv.conv_dw_same(x, dy, 11, 21, (1, 2))
        assert kconv.conv_dw_same.launches == before + 1
        assert kconv.conv_dw_same.route == route
    ref = kconv.conv_dw_same_plain(x, dy, 11, 21, (1, 2), torch.float64)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (11, 21, 32, 32)
    tol = {"bf16x3": 1.5e-6, "fma": 1e-5}[route]
    assert float((got.double() - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("dtype,lo", [(torch.float32, 4), (torch.bfloat16, 4),
                                      (torch.bfloat16, 8)])
def test_conv_dw_reads_channels_last_views_in_place(cuda, dtype, lo):
    """An NCHW tensor with channels-last memory, and a dy that is a strided
    slice, need no copy (at bf16 a slice from channel 4 starts 8 bytes past
    a 16-byte boundary: scalar loads; from channel 8 on one); a channel
    stride other than 1 raises."""
    x = _randn(2, 8, 20, 15, seed=3).to(cuda).to(dtype).contiguous(
        memory_format=torch.channels_last)
    dy = _randn(2, 20, 8, 24, seed=4).to(cuda).to(dtype)[..., lo:lo + 16]   # [B, T, Fo, 16]
    got = kconv.conv_dw_same(x.permute(0, 2, 3, 1), dy, 3, 5, (1, 2))
    assert kconv.conv_dw_same.route == ("mma" if dtype == torch.bfloat16 else "bf16x3")
    ref = kconv.conv_dw_same_plain(x.permute(0, 2, 3, 1), dy, 3, 5, (1, 2))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="unit channel stride"):
        kconv.conv_dw_same(_randn(2, 8, 20, 15).to(cuda).to(dtype).permute(0, 2, 3, 1), dy,
                           3, 5, (1, 2))
    with pytest.raises(ValueError, match="does not take"):
        kconv.conv_dw_same(_randn(1, 4, 4, 128).to(cuda).to(dtype),
                           _randn(1, 4, 4, 64).to(cuda).to(dtype), 3, 3)


def test_conv_dw_plan_f32_matches_the_library(cuda):
    """The FMA route's plan (``_fma_plan``, which ``conv_dw_plan`` gives f32
    shapes the split route does not take) has ``aas_conv_dw_slices``'s
    slices (the C plan that the FMA launch reads) over a grid of shapes, 0
    included."""
    lib = kernel_build.load_library()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    zero = 0
    for ci, co, (kt, kf), f, sf, rows in itertools.product(
            (1, 8, 10, 32, 64, 128), (6, 8, 32, 64), ((1, 1), (5, 5), (11, 21), (3, 13)),
            (1, 81, 161, 1200), (1, 2), (1, 18, 3208)):
        want = lib.aas_conv_dw_slices(rows, -(-f // sf), kt, kf, ci, co, sf, sms)
        plan = kconv._fma_plan(rows, -(-f // sf), kt, kf, ci, co, sf, sms)
        assert (plan.route, plan.slices) == ("fma", want), (rows, f, ci, co, kt, kf, sf)
        zero += want == 0
    assert zero > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dw_impl,launches", [("kernel", 1), ("auto", 1), ("cudnn", 0)])
def test_tapdw_conv_on_card(cuda, dw_impl, launches, dtype):
    """TapDWConv against SameConv2d with the same weights: primal and dx are
    cuDNN's on both sides, dW comes from the kernel unless dw_impl is cudnn.
    At bf16 (the AM's conv2 when a bf16 AM trains) the kernel takes the
    tensor-core route and its f32 dW leaves in bf16, as cuDNN's does: the two
    agree within one bf16 ulp at the top (2^-7 x max of each gradient)."""
    ref = tconv.SameConv2d(8, 16, (5, 7), (1, 2), compute_dtype=dtype).to(cuda)
    mod = tconv.TapDWConv(8, 16, (5, 7), (1, 2), dw_impl=dw_impl, compute_dtype=dtype).to(cuda)
    mod.load_state_dict(ref.state_dict())
    x = _randn(2, 8, 30, 21, seed=6).to(cuda).requires_grad_()
    cot = _randn(2, 16, 30, 11, seed=7).to(cuda).to(dtype)
    before = kconv.conv_dw_same.launches
    y = mod(x)
    got = torch.autograd.grad(y, (x, mod.weight, mod.bias), cot)
    y_ref = ref(x)
    want = torch.autograd.grad(y_ref, (x, ref.weight, ref.bias), cot)
    torch.cuda.synchronize()
    assert kconv.conv_dw_same.launches == before + launches
    assert torch.equal(y, y_ref) and y.dtype == dtype
    if launches:
        assert kconv.conv_dw_same.dtype == dtype
        assert kconv.conv_dw_same.route == ("mma" if dtype == torch.bfloat16 else "bf16x3")
    if dtype == torch.float32:
        _assert_grads_close(got, want)
    else:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=2.0 ** -7 * float(b.abs().max()))
    frozen = tconv.TapDWConv(8, 16, (5, 7), (1, 2), dw_impl=dw_impl,
                             compute_dtype=dtype).to(cuda)
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


@pytest.mark.parametrize("with_lm", [False, True])
def test_device_beam_on_card_matches_cpu(cuda, with_lm):
    """The batched device beam (decode/device_beam.py, PyTorch tensor code,
    no hand kernel) on the card against its own CPU run on the same
    log-probs: ids and lengths equal, scores within 1e-3 (f32 sums of up to
    120 frames' log-probs, exp / log1p rounded by each device's library)."""
    from aas_enhancement_tpu_torch.decode.device_beam import device_beam_decode_raw
    from aas_enhancement_tpu_torch.decode.lm import CharNGramLM

    logits = _randn(4, 120, 29, seed=5, scale=3.0)
    logits[:, ::2, 0] += 3.0
    lp = torch.log_softmax(logits, -1)
    lens = torch.tensor([120, 97, 64, 1])
    kw = dict(beam_width=32, prune_k=16)
    if with_lm:
        table = CharNGramLM(3).fit_texts(["THE CAT SAT ON THE MAT", "HOW NOW COW"] * 3)
        kw.update(lm_table=table.dense_table(), lm_order=3, lm_alpha=0.6, lm_beta=0.3)
    ids, out_lens, scores = device_beam_decode_raw(lp.to(cuda), lens, **kw)
    ref = device_beam_decode_raw(lp, lens, device="cpu", **kw)
    np.testing.assert_array_equal(ids, ref[0])
    np.testing.assert_array_equal(out_lens, ref[1])
    np.testing.assert_allclose(scores, ref[2], rtol=0, atol=1e-3)


# ------------------------------------------------- bf16 streams (inference forwards)

def _bf16_close(got, ref, frac):
    assert got.dtype == ref.dtype == torch.bfloat16
    ref = ref.float()
    torch.testing.assert_close(got.float(), ref, rtol=0, atol=frac * float(ref.abs().max()))


@pytest.mark.parametrize("act,shape", [("leaky_relu", (3, 45, 17, 16)),
                                       ("hardtanh", (3, 45, 17, 16)),
                                       ("leaky_relu", (4, 801, 161, 32)),
                                       ("hardtanh", (4, 401, 41, 32))])
def test_gn_kernel_bf16(cuda, act, shape):
    b, t = shape[:2]
    x = (0.5 + 2.0 * _randn(*shape, seed=t)).to(cuda).bfloat16()
    c = shape[-1]
    scale, bias = (1 + _randn(c, seed=4, scale=0.1)).to(cuda), _randn(c, seed=5).to(cuda)
    lengths = torch.tensor([t, t - 14, 0, t // 2][:b], device=cuda)
    before = gn.masked_group_norm_act.launches
    y = gn.masked_group_norm_act(x, scale, bias, lengths, num_groups=8, act=act)
    y_p = gn.masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=8, act=act)
    torch.cuda.synchronize()
    assert gn.masked_group_norm_act.launches == before + 1
    assert gn.masked_group_norm_act.dtype == torch.bfloat16
    _bf16_close(y, y_p, 2.0 ** -7)
    assert torch.all(y[2] == 0) and torch.all(y[1, t - 14:] == 0)


def _bf16_scan_inputs(cuda, cell, t, b, h, stacked, seed):
    g = (4 if cell == "lstm" else 3) * h
    wh = _randn(2, h, g, seed=seed, scale=1.0 / h ** 0.5).bfloat16().float().to(cuda)
    bh = _randn(2, g, seed=seed + 1, scale=0.1).bfloat16().float().to(cuda)
    lengths = torch.tensor([t, t // 2 + 1, 0, t - 1, 1, 2, t, t - 3][:b], device=cuda)
    m = (torch.arange(t, device=cuda)[:, None] < lengths[None]).float()
    if stacked:
        gx = _randn(t, 2, b, g, seed=seed + 2, scale=0.5).to(cuda).bfloat16()
        return (gx,), torch.stack([m, m.flip(0)], dim=1).contiguous(), wh, bh
    gates = _randn(t, b, 2 * g, seed=seed + 2, scale=0.5).to(cuda).bfloat16()
    return (gates[..., :g], gates[..., g:]), m, wh, bh          # strided halves


BF16_SCANS = [("lstm", 801, 4, 256, None), ("lstm", 60, 5, 32, None),
              ("lstm", 40, 4, 512, None), ("lstm", 60, 4, 256, 0),
              ("gru", 401, 4, 512, None), ("gru", 60, 5, 64, None),
              ("gru", 60, 4, 512, 0)]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cell,t,b,h,route", BF16_SCANS)
def test_rnn_forward_kernels_bf16(cuda, cell, t, b, h, route, stacked):
    """B1 / B2 (time-major) and B7 / B7' (stacked) on bf16 streams, on the
    route the width gives (resident, or streaming at the LSTM's H = 512) and
    on the streaming route forced (route 0), against the plain version."""
    gx, m, wh, bh = _bf16_scan_inputs(cuda, cell, t, b, h, stacked, seed=h + t)
    name = f"{cell}_scan_{'stacked' if stacked else 'tm'}"
    fn = getattr(krnn, name)
    plain = getattr(krnn, f"{name}_plain")
    before = fn.launches
    ys, _ = krnn._forward(name, gx, m, wh, bh, save=False, route=route)
    ys_p = plain(*gx, m, wh, bh)
    ys_p = (ys_p,) if stacked else ys_p
    torch.cuda.synchronize()
    expect = route if route is not None else (
        krnn.lstm_resident_cluster(h) if cell == "lstm" else krnn.gru_resident_cluster(h))
    assert fn.launches == before + 1 and fn.route == expect and fn.dtype == torch.bfloat16
    for y, y_p in zip(ys, ys_p):
        _bf16_close(y, y_p, 2.0 ** -6)
        row = (slice(None), slice(None), 2) if stacked else (slice(None), 2)
        assert torch.all(y[row] == 0)


def test_rnn_wrappers_at_bf16_take_inference_only(cuda):
    """The wrappers launch the bf16 inference kernel without a wanted
    gradient, and with one the bf16 training forward and the bf16 backward
    kernel (dgx in gx's dtype, one launch each); the GroupNorm's autograd
    Function takes bf16 too; parameters stay float32, and a misaligned bf16 x
    still raises."""
    gx, m, wh, bh = _bf16_scan_inputs(cuda, "gru", 20, 4, 64, False, seed=3)
    with torch.no_grad():
        yf, yb = krnn.gru_scan_tm(*gx, m, wh, bh)
    assert yf.dtype == torch.bfloat16 and krnn.gru_scan_tm.dtype == torch.bfloat16
    g = gx[0].shape[-1]
    gates = torch.cat(gx, dim=-1).requires_grad_()
    before = (krnn.gru_scan_tm.launches, krnn.gru_scan_tm_bwd.launches)
    ys = krnn.gru_scan_tm(gates[..., :g], gates[..., g:], m, wh.clone().requires_grad_(), bh)
    (dgates,) = torch.autograd.grad(ys, gates, [torch.ones_like(y) for y in ys])
    assert (krnn.gru_scan_tm.launches, krnn.gru_scan_tm_bwd.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert dgates.dtype == torch.bfloat16 and krnn.gru_scan_tm_bwd.dtype == torch.bfloat16
    with pytest.raises(TypeError, match="float32"):
        krnn.gru_scan_tm(*gx, m, wh.bfloat16(), bh)
    x = torch.ones(2, 8, 5, 16, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    scale = torch.ones(16, device=cuda, requires_grad=True)
    y = gn.masked_group_norm_act(x, scale, torch.zeros(16, device=cuda), torch.tensor([8, 3]),
                                 num_groups=8, act="leaky_relu")
    dx, dscale = torch.autograd.grad(y.float().sum(), (x, scale))
    assert dx.dtype == torch.bfloat16 and dscale.dtype == torch.float32
    assert gn.masked_group_norm_act_bwd.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="8-byte aligned"):
        flat = torch.zeros(2 * 8 * 5 * 16 + 1, device=cuda, dtype=torch.bfloat16)
        gn.masked_group_norm_act(flat[1:].view(2, 8, 5, 16), torch.ones(16, device=cuda),
                                 torch.zeros(16, device=cuda), torch.tensor([8, 3]),
                                 num_groups=8)


BF16_BWD = [("lstm", 60, 5, 32), ("lstm", 40, 8, 256), ("lstm", 30, 4, 512),
            ("gru", 60, 5, 64), ("gru", 40, 8, 512)]


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("cell,t,b,h", BF16_BWD)
def test_rnn_backward_kernels_bf16(cuda, cell, t, b, h, stacked):
    """B1' / B2' (time-major) and the B7 / B7' VJPs (stacked) on bf16 streams,
    on the training forward's saved state: dgx (bf16), dwh, dbh (f32) of the
    width's route against autograd through the plain version, the forced
    streaming route against it, and without the weight gradient dgx keeps its
    bits; ragged lengths with an all-padded row."""
    gx, m, wh, bh = _bf16_scan_inputs(cuda, cell, t, b, h, stacked, seed=h + t + 7)
    name = f"{cell}_scan_{'stacked' if stacked else 'tm'}"
    fwd, bwd = getattr(krnn, name), krnn._BACKWARD[name]
    route = krnn.bwd_resident_cluster(cell, h)
    ys, saved = krnn._forward(name, gx, m, wh, bh, save=True)
    assert fwd.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in saved[:-1]) and saved[-1].dtype == torch.float32
    dys = tuple(_randn(*y.shape, seed=h + 31 + i).to(cuda).bfloat16() for i, y in enumerate(ys))
    before = bwd.launches
    got = krnn._backward(name, m, wh, saved, dys, True)
    assert bwd.launches == before + 1 and bwd.route == route and bwd.dtype == torch.bfloat16
    frozen = krnn._backward(name, m, wh, saved, dys, False)
    stream = krnn._backward(name, m, wh, saved, dys, True, route=0) if route else got
    assert bwd.launches == before + (3 if route else 2)
    plain = getattr(krnn, f"{name}_plain")
    inputs = [x.detach().clone().requires_grad_() for x in (*gx, wh, bh)]
    out = plain(*inputs[:-2], m, *inputs[-2:])
    ref = torch.autograd.grad((out,) if stacked else out, inputs, dys)
    torch.cuda.synchronize()

    def flat(res):
        return (*res[0], res[1], res[2])

    for x, r in zip(flat(got), ref):
        assert x.dtype == r.dtype
        torch.testing.assert_close(x.float(), r.float(), rtol=0,
                                   atol=2e-2 * float(r.float().abs().max()))
    assert all(x.dtype == torch.bfloat16 for x in got[0])
    assert got[1].dtype == got[2].dtype == torch.float32
    assert all(torch.equal(x, y) for x, y in zip(frozen[0], got[0]))
    for x, y in zip(flat(stream), flat(got)):
        torch.testing.assert_close(x.float(), y.float(), rtol=0,
                                   atol=2e-2 * float(y.float().abs().max()))
    row = (slice(None), slice(None), 2) if stacked else (slice(None), 2)
    assert all(torch.all(x[row] == 0) for x in got[0])        # the all-padded row


@pytest.mark.parametrize("act,shape", [("leaky_relu", (3, 45, 17, 16)),
                                       ("hardtanh", (3, 45, 17, 16)),
                                       ("leaky_relu", (8, 801, 161, 32)),
                                       ("hardtanh", (8, 401, 81, 32)),
                                       ("hardtanh", (8, 401, 41, 32))])
def test_gn_backward_kernel_bf16(cuda, act, shape):
    """B3' on bf16 x and dy (the enhancer's and the AM's shapes at B = 8)
    against the plain closed form on the same bf16 inputs, from the bf16
    forward kernel's saved statistics: dx bf16, dscale and dbias f32, one
    launch."""
    b, t, f, c = shape
    x = (0.5 + 2.0 * _randn(*shape, seed=t + 1)).to(cuda).bfloat16()
    dy = _randn(*shape, seed=t + 2).to(cuda).bfloat16()
    scale = (1 + _randn(c, seed=4, scale=0.1)).to(cuda)
    bias = _randn(c, seed=5).to(cuda)
    lengths = torch.tensor([t, t - 14, 0, t // 2, 1, t, t - 1, 3][:b], device=cuda)
    _, scratch = gn.gn_kernel(x, scale, bias, lengths, 8, 1e-5, act, 0.2)
    mean, inv = gn._stats(scratch, b, c)
    args = (x, dy, scale, bias, lengths, mean, inv)
    before = gn.masked_group_norm_act_bwd.launches
    got = gn.masked_group_norm_act_bwd(*args, num_groups=8, act=act)
    ref = gn.masked_group_norm_act_bwd_plain(*args, num_groups=8, act=act)
    torch.cuda.synchronize()
    assert gn.masked_group_norm_act_bwd.launches == before + 1
    assert gn.masked_group_norm_act_bwd.dtype == torch.bfloat16
    assert got[0].dtype == ref[0].dtype == torch.bfloat16
    assert got[1].dtype == got[2].dtype == torch.float32
    _bf16_close(got[0], ref[0], 2.0 ** -7)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=0, atol=1e-4 * float(r.abs().max()))
    assert torch.all(got[0][1, t - 14:] == 0) and (b < 3 or torch.all(got[0][2] == 0))


@pytest.mark.parametrize("shape", CONV_DW_SHAPES + [
    (8, 401, 81, 32, 32, 11, 21, (1, 2)),      # the AM's conv2 at B=8
    (32, 401, 81, 32, 32, 11, 21, (1, 2))])    # and at B=32
def test_conv_dw_kernel_bf16(cuda, shape):
    """B6 on bf16 x and dy against the plain version on the same values:
    the tensor-core route, f32 dW, one launch, the same bits twice."""
    b, t, f, ci, co, kt, kf, strides = shape
    x = _randn(b, t, f, ci, seed=3).to(cuda).bfloat16()
    dy = _randn(b, t, -(-f // strides[1]), co, seed=4).to(cuda).bfloat16()
    before = kconv.conv_dw_same.launches
    got = kconv.conv_dw_same(x, dy, kt, kf, strides)
    assert kconv.conv_dw_same.launches == before + 1
    assert kconv.conv_dw_same.dtype == torch.bfloat16
    assert kconv.conv_dw_same.route == "mma"
    again = kconv.conv_dw_same(x, dy, kt, kf, strides)
    ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype == torch.float32 and torch.equal(got, again)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))
    with pytest.raises(TypeError, match="streams"):
        kconv.conv_dw_same(x, dy.float(), kt, kf, strides)


def test_conv_dw_bf16_runs_the_tensor_core_kernel_alone(cuda):
    """One bf16 call at the AM's conv2 runs the tensor-core kernel and the
    slice reduction, once each, and no library kernel (fresh process)."""
    names, = kernel_names_in_fresh_process("""
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
x = torch.randn(8, 401, 81, 32, device="cuda").bfloat16()
dy = torch.randn(8, 401, 41, 32, device="cuda").bfloat16()
calls = [lambda: kconv.conv_dw_same(x, dy, 11, 21, (1, 2))]
""")
    assert sorted(names.values()) == [1, 1], names
    assert any("conv_dw_mma_kernel" in n for n in names), names
    assert any("conv_dw_reduce_kernel" in n for n in names), names


def test_conv_dw_f32_runs_the_split_kernel_alone(cuda):
    """One f32 call at the AM's conv2 runs the tensor-core kernel at three
    planes (``conv_dw_mma_kernel<4, 4, 3>``) and the slice reduction, once
    each, and no library kernel (fresh process)."""
    names, = kernel_names_in_fresh_process("""
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
x = torch.randn(8, 401, 81, 32, device="cuda")
dy = torch.randn(8, 401, 41, 32, device="cuda")
calls = [lambda: kconv.conv_dw_same(x, dy, 11, 21, (1, 2))]
""")
    assert sorted(names.values()) == [1, 1], names
    assert any(re.search(r"conv_dw_mma_kernel<4, ?4, ?3>", n) for n in names), names
    assert any("conv_dw_reduce_kernel" in n for n in names), names


def test_bf16_enhance_on_card_matches_cpu(cuda):
    cfg = Config().replace(enhancer=EnhancerConfig(conv_channels=8, rnn_hidden=16,
                                                   dtype="bfloat16"))
    model = init_enhancer(cfg, seed=0, device="cpu")
    wav = _randn(2, 16000, seed=9, scale=0.3)
    lengths = torch.tensor([16000, 9000])
    wav[1, 9000:] = 0
    y_cpu = make_enhance_fn(cfg, "cpu")(model, wav, lengths)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    counters = (gn.masked_group_norm_act, krnn.lstm_scan_tm)
    before = [c.launches for c in counters]
    y_gpu = make_enhance_fn(cfg, cuda)(model.to(cuda), wav, lengths).cpu()
    assert [c.launches - n for c, n in zip(counters, before)] == [2, 2]
    assert all(c.dtype == torch.bfloat16 for c in counters)
    torch.testing.assert_close(y_gpu, y_cpu, rtol=0, atol=5e-2 * float(y_cpu.abs().max()))
