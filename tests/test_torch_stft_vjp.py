"""The VJP kernels' arithmetic on the CPU (``ops/cuda/stft.py``): the plan
(``vjp_plan``), the radix real transforms (``rfft_radix_plain``,
``irfft_radix_plain``), the run-tiled STFT VJP (``stft_vjp_runs_plain``) and
the ISTFT VJP with the COLA table (``istft_vjp_radix_plain``), against
``torch.fft``, the written-out adjoints (``stft_vjp_plain``,
``istft_vjp_plain``) and ``jax.vjp`` of the JAX package's
``dsp/stft.py::stft`` / ``::istft``, on inputs made with numpy from a seed.

Shapes: the MR-STFT loss's (256, 64), (512, 128), (1024, 256), the
enhancer's (320, 160), hop 80 at 320, and the direct routes (2048, 128) and
(37, 37); lengths ragged, center off, T < K, a row that one run covers whole
(its head and tail fold in one work item), a length one sample past a run
boundary, many runs a row.  Tolerance: 1e-5 of the gradient's (or the
transform's) max|value| (f32 sums of up to n_fft terms in the FFT's order
against matmul order or float64).
"""

import jax
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.dsp.stft import istft as jax_istft, stft as jax_stft
from aas_enhancement_tpu_torch.dsp.stft import num_frames
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft

TOL = 1e-5
PATH_SHAPES = [(256, 64), (512, 128), (1024, 256), (320, 160)]
RADIX_SHAPES = PATH_SHAPES + [(320, 80), (96, 48), (64, 32)]
DIRECT_SHAPES = [(2048, 128), (37, 37), (75, 25), (98, 49), (34, 34)]

# (n_fft, hop, center, n samples)
CASES = [
    (256, 64, True, 8000), (512, 128, True, 7777), (1024, 256, True, 9000),
    (320, 160, True, 16000), (320, 160, False, 16001), (320, 80, True, 5000),
    (2048, 128, True, 6000), (37, 37, True, 3000),
    (1024, 256, True, 600),            # T = 3 < K = 4
    (256, 64, False, 300),             # center off, T = 1 < K
    (256, 64, True, 1500),             # one run covers the row: both folds in one item
    (256, 64, True, 64 * 64 + 1),      # one sample past a run boundary: 65 frames, 2 runs
    (256, 64, True, 64 * 64 * 6),      # 385 frames, 7 to 77 runs
    (512, 128, False, 20000),
]


def _rel(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
    return max(float(np.abs(np.asarray(g) - np.asarray(r)).max())
               for g, r in zip(got, ref)) / scale


def _frames(n, n_fft, hop, center):
    return num_frames(n, n_fft, hop, center)


@pytest.mark.parametrize("n_fft,hop", RADIX_SHAPES + DIRECT_SHAPES)
def test_vjp_plan_is_a_pure_function_of_the_shape(n_fft, hop):
    plan = kstft.vjp_plan(n_fft, hop)
    kstft.vjp_plan.cache_clear()
    assert kstft.vjp_plan(n_fft, hop) == plan
    if (n_fft, hop) in DIRECT_SHAPES:
        # odd, prime, 2 x a prime, or past the largest n_fft/2: the direct sums
        assert plan == kstft.DIRECT_PLAN
        return
    k = n_fft // hop
    assert int(np.prod(plan.radices)) == n_fft // 2 and len(plan.radices) >= 2
    assert set(plan.radices) <= set(kstft.VJP_RADICES)
    assert plan.lanes * plan.frames == kstft.VJP_THREADS
    assert plan.run >= 2 * k + 2 and plan.run % plan.frames == 0
    m = n_fft // 2
    last = m - 1 + ((m - 1) >> plan.pad_shift if plan.pad_shift else 0)
    assert plan.frame_stride > last


def test_vjp_plans_of_the_path_shapes():
    """The radices the kernels run at the paths' shapes, and a bank model
    that finds the chosen exchange layout no worse than the unpadded one."""
    assert kstft.vjp_plan(256, 64).radices == (16, 8)
    assert kstft.vjp_plan(512, 128).radices == (16, 16)
    assert kstft.vjp_plan(1024, 256).radices == (8, 8, 8)
    assert kstft.vjp_plan(320, 160).radices == (5, 8, 4)
    for n_fft, hop in PATH_SHAPES:
        p = kstft.vjp_plan(n_fft, hop)
        m = n_fft // 2
        chosen = kstft._wavefronts(m, p.radices, p.lanes, p.pad_shift, p.frame_stride)
        plain = kstft._wavefronts(m, p.radices, p.lanes, 0, m)
        assert chosen <= plain


@pytest.mark.parametrize("n_fft,hop", RADIX_SHAPES)
def test_radix_transforms_match_the_dft(n_fft, hop):
    """``rfft_radix_plain`` equals torch.fft.rfft (float64) and
    ``irfft_radix_plain`` the weighted adjoint sum_k re_k cos - im_k sin
    (float64), to 1e-5 of max."""
    rng = np.random.default_rng(n_fft + hop)
    radices = kstft.vjp_plan(n_fft, hop).radices
    x = rng.standard_normal((3, 5, n_fft)).astype(np.float32)
    re, im = kstft.rfft_radix_plain(torch.from_numpy(x), radices)
    ref = np.fft.rfft(x.astype(np.float64))
    assert _rel((re.numpy(), im.numpy()), (ref.real, ref.imag)) <= TOL
    dre = rng.standard_normal((3, 5, n_fft // 2 + 1)).astype(np.float32)
    dim = rng.standard_normal((3, 5, n_fft // 2 + 1)).astype(np.float32)
    got = kstft.irfft_radix_plain(torch.from_numpy(dre), torch.from_numpy(dim), radices)
    ang = 2 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    want = dre.astype(np.float64) @ np.cos(ang).T - dim.astype(np.float64) @ np.sin(ang).T
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("n_fft,hop,center,n", CASES)
def test_vjp_runs_cover_each_frame_once(n_fft, hop, center, n):
    """Whatever the card holds (``per_row``), a row's runs tile its frames
    exactly (each frame transformed once: halo share 0), hold at most
    ``run`` frames, and K + 1 or more each where a row has more than one (so
    the reflect folds stay inside a row's first and last run)."""
    plan = kstft.vjp_plan(n_fft, hop)
    t = _frames(n, n_fft, hop, center)
    for per_row in (0, 1, 7, 66, 10 ** 6):
        bounds = kstft.vjp_runs(t, kstft.vjp_run_count(t, n_fft, hop, per_row))
        lens = np.diff(bounds)
        assert bounds[0] == 0 and bounds[-1] == t and lens.sum() == t
        if plan.run:
            assert lens.max() <= plan.run
            if len(lens) > 1:
                assert lens.min() >= n_fft // hop + 1
        else:
            assert len(lens) == 1


@pytest.mark.parametrize("n_fft,hop,center,n", CASES)
def test_run_tiled_stft_vjp_matches_the_adjoint_and_jax(n_fft, hop, center, n):
    rng = np.random.default_rng(n + n_fft)
    x = rng.standard_normal((2, n)).astype(np.float32)
    (re, im), vjp = jax.vjp(lambda v: jax_stft(v, n_fft, hop, "hann", center), x)
    dre = rng.standard_normal(re.shape).astype(np.float32)
    dim = rng.standard_normal(im.shape).astype(np.float32)
    ref, = vjp((dre, dim))
    dre_t, dim_t = torch.from_numpy(dre), torch.from_numpy(dim)
    plain = kstft.stft_vjp_plain(dre_t, dim_t, n, n_fft, hop, center=center)
    for per_row in (0, 10 ** 6):                  # the fewest runs a row, the most
        runs = kstft.vjp_run_count(re.shape[1], n_fft, hop, per_row)
        got = kstft.stft_vjp_runs_plain(dre_t, dim_t, n, n_fft, hop, center=center, runs=runs)
        assert got.shape == (2, n)
        assert _rel(got.numpy(), np.asarray(ref)) <= TOL
        assert _rel(got.numpy(), plain.numpy()) <= TOL


@pytest.mark.parametrize("n_fft,hop,center,n", CASES)
def test_radix_istft_vjp_matches_the_adjoint_and_jax(n_fft, hop, center, n):
    """Lengths that cut the buffer, end exactly at the signal, and zero-pad."""
    rng = np.random.default_rng(n + n_fft + 1)
    t = _frames(n, n_fft, hop, center)
    f = n_fft // 2 + 1
    for length in (max(1, n - 3 * hop - 1), n, n + 2 * hop):
        sre = rng.standard_normal((2, t, f)).astype(np.float32)
        sim = rng.standard_normal((2, t, f)).astype(np.float32)
        y, vjp = jax.vjp(lambda a, b: jax_istft(a, b, n_fft, hop, "hann", center, length),
                         sre, sim)
        dy = rng.standard_normal(y.shape).astype(np.float32)
        ref = tuple(np.asarray(v) for v in vjp(dy))
        got = kstft.istft_vjp_radix_plain(torch.from_numpy(dy), t, n_fft, hop, center=center)
        assert got[0].shape == (2, t, f)
        assert _rel((got[0].numpy(), got[1].numpy()), ref) <= TOL
        plain = kstft.istft_vjp_plain(torch.from_numpy(dy), t, n_fft, hop, center=center)
        assert _rel((got[0].numpy(), got[1].numpy()),
                    (plain[0].numpy(), plain[1].numpy())) <= TOL


@pytest.mark.parametrize("n_fft,hop", PATH_SHAPES)
def test_cpu_tensors_keep_the_written_out_adjoints(n_fft, hop):
    """On the CPU the wrappers run ``stft_vjp_plain`` / ``istft_vjp_plain``
    (bit for bit) and launch nothing."""
    gen = torch.Generator().manual_seed(n_fft)
    n = 4000
    t = _frames(n, n_fft, hop, True)
    dre = torch.randn(2, t, n_fft // 2 + 1, generator=gen)
    dim = torch.randn(2, t, n_fft // 2 + 1, generator=gen)
    dy = torch.randn(2, n, generator=gen)
    before = (kstft.stft_vjp.launches, kstft.istft_vjp.launches)
    assert torch.equal(kstft.stft_vjp(dre, dim, n, n_fft, hop),
                       kstft.stft_vjp_plain(dre, dim, n, n_fft, hop))
    got, want = kstft.istft_vjp(dy, t, n_fft, hop), kstft.istft_vjp_plain(dy, t, n_fft, hop)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (kstft.stft_vjp.launches, kstft.istft_vjp.launches) == before


# Hops that do not divide n_fft (the JAX fallback's gather/scatter framing):
# 25 ms / 10 ms, 1.5 frames of overlap, a hop longer than the frame; and the
# enhancer's (320, 160) beside them.  K = ceil(n_fft / hop).
ANY_HOPS = [(400, 160), (300, 200), (160, 320), (320, 160)]
ANY_HOP_RADICES = {(400, 160): (5, 5, 8), (300, 200): (5, 5, 3, 2), (160, 320): (5, 16),
                   (320, 160): (5, 8, 4)}
ANY_HOP_N = 4000


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
def test_vjp_plan_at_any_hop(n_fft, hop):
    """The radix plan of n_fft/2 does not depend on the hop; the runs hold
    2K + 2 frames or more with K = ceil(n_fft / hop)."""
    plan = kstft.vjp_plan(n_fft, hop)
    assert plan.radices == ANY_HOP_RADICES[(n_fft, hop)]
    assert plan.run >= 2 * (-(-n_fft // hop)) + 2 and plan.run % plan.frames == 0


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
def test_vjp_runs_cover_each_frame_once_at_any_hop(n_fft, hop, center):
    t = _frames(4 * ANY_HOP_N, n_fft, hop, center)
    k = -(-n_fft // hop)
    for per_row in (0, 1, 7, 66, 10 ** 6):
        lens = np.diff(kstft.vjp_runs(t, kstft.vjp_run_count(t, n_fft, hop, per_row)))
        assert lens.sum() == t and lens.max() <= kstft.vjp_plan(n_fft, hop).run
        if len(lens) > 1:
            assert lens.min() >= k + 1


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
def test_stft_vjps_match_jax_at_any_hop(n_fft, hop, center):
    """The STFT's VJP, written out (``stft_vjp_plain``) and run-tiled as the
    kernel does it (the fewest runs a row and the most: run boundaries
    inside frames, the reflect fold over hop-rows that 200 = 1.25 x 160
    does not line up with), against ``jax.vjp`` of the JAX fallback."""
    n = ANY_HOP_N + 7
    rng = np.random.default_rng(n_fft + hop)
    x = rng.standard_normal((2, n)).astype(np.float32)
    (re, im), vjp = jax.vjp(lambda v: jax_stft(v, n_fft, hop, "hann", center), x)
    dre = rng.standard_normal(re.shape).astype(np.float32)
    dim = rng.standard_normal(im.shape).astype(np.float32)
    ref, = vjp((dre, dim))
    dre_t, dim_t = torch.from_numpy(dre), torch.from_numpy(dim)
    plain = kstft.stft_vjp_plain(dre_t, dim_t, n, n_fft, hop, center=center)
    assert plain.shape == (2, n) and _rel(plain.numpy(), np.asarray(ref)) <= TOL
    for per_row in (0, 10 ** 6):
        runs = kstft.vjp_run_count(re.shape[1], n_fft, hop, per_row)
        got = kstft.stft_vjp_runs_plain(dre_t, dim_t, n, n_fft, hop, center=center, runs=runs)
        assert got.shape == (2, n)
        assert _rel(got.numpy(), np.asarray(ref)) <= TOL


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length", [ANY_HOP_N, ANY_HOP_N - 1000, ANY_HOP_N + 1000, None])
def test_istft_vjps_match_jax_at_any_hop(n_fft, hop, center, length):
    """The ISTFT's VJP, written out and as the kernel computes it (the COLA
    table over the frames that can cover a sample), against ``jax.vjp`` of
    the JAX fallback, whose output is cut to ``length`` and never padded."""
    rng = np.random.default_rng(n_fft + hop + 1)
    t = _frames(ANY_HOP_N, n_fft, hop, center)
    f = n_fft // 2 + 1
    sre = rng.standard_normal((2, t, f)).astype(np.float32)
    sim = rng.standard_normal((2, t, f)).astype(np.float32)
    y, vjp = jax.vjp(lambda a, b: jax_istft(a, b, n_fft, hop, "hann", center, length),
                     sre, sim)
    dy = rng.standard_normal(y.shape).astype(np.float32)
    ref = tuple(np.asarray(v) for v in vjp(dy))
    for fn in (kstft.istft_vjp_plain, kstft.istft_vjp_radix_plain):
        got = fn(torch.from_numpy(dy), t, n_fft, hop, center=center)
        assert got[0].shape == got[1].shape == (2, t, f)
        assert _rel((got[0].numpy(), got[1].numpy()), ref) <= TOL
