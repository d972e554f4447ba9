"""Port parity: masking and STFT/ISTFT (aas_enhancement_tpu_torch.ops.masking,
.dsp, .ops.cuda.stft and its kernels' factorised plain versions) against the
JAX package on the CPU.

Inputs come from numpy seeds and go through both.  Tolerances are f32
tolerances: both sides sum 160-sample segment products in float32, in
different orders, on signals with |X| up to ~30, so STFT values agree to
about 1e-5 relative; waveforms (unit scale) to about 1e-5 absolute.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aas_enhancement_tpu.ops import masking as jmask
from aas_enhancement_tpu.ops.pallas.stft_kernel import istft_pallas, stft_pallas
from aas_enhancement_tpu_torch.dsp import stft as tstft
from aas_enhancement_tpu_torch.ops import masking as tmask
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft

# dsp/__init__ re-exports the stft function under the module's name.
jstft = importlib.import_module("aas_enhancement_tpu.dsp.stft")

torch.set_num_threads(1)

N_FFT, HOP = 320, 160
STFT_TOL = dict(rtol=1e-5, atol=1e-4)     # |X| up to ~30: f32 sum-order noise
# Unit-scale waveforms; rtol covers the untrimmed tail, where the COLA divisor
# (window^2 summed) approaches 0 and amplifies values to ~400.
WAV_TOL = dict(rtol=1e-5, atol=2e-5)


def _signal(b, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.4 * np.sin(2 * np.pi * 523 * t)[None]
            + 0.2 * rng.standard_normal((b, n))).astype(np.float32)


def test_time_mask_and_apply():
    lengths = np.array([5, 2, 0], np.int64)
    x = np.random.default_rng(1).standard_normal((3, 6, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tmask.time_mask(torch.from_numpy(lengths), 6).numpy(),
        np.asarray(jmask.time_mask(jnp.asarray(lengths), 6)))
    np.testing.assert_array_equal(
        tmask.apply_time_mask(torch.from_numpy(x), torch.from_numpy(lengths)).numpy(),
        np.asarray(jmask.apply_time_mask(jnp.asarray(x), jnp.asarray(lengths))))


def test_masked_normalize_matches_jax():
    rng = np.random.default_rng(2)
    x = (3.0 + 2.0 * rng.standard_normal((3, 40, 17))).astype(np.float32)
    lengths = np.array([40, 23, 1], np.int32)
    got = tmask.masked_normalize(torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    ref = np.asarray(jmask.masked_normalize(jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert np.all(got[1, 23:] == 0.0) and np.all(got[2, 1:] == 0.0)


def test_window_matches_jax():
    for name in ("hann", "hamming"):
        np.testing.assert_array_equal(tstft.get_window(name, N_FFT),
                                      jstft.get_window(name, N_FFT))


@pytest.mark.parametrize("n,center", [(16000, True), (16001, True), (8000, False)])
def test_stft_matches_jax(n, center):
    x = _signal(2, n)
    re_t, im_t = tstft.stft(torch.from_numpy(x), N_FFT, HOP, center=center)
    re_j, im_j = jstft.stft(jnp.asarray(x), N_FFT, HOP, center=center)
    assert re_t.shape == re_j.shape
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), **STFT_TOL)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), **STFT_TOL)
    mag_t = tstft.magnitude(re_t, im_t).numpy()
    mag_j = np.asarray(jstft.magnitude(re_j, im_j))
    np.testing.assert_allclose(mag_t, mag_j, **STFT_TOL)


def test_phase_matches_jax():
    rng = np.random.default_rng(3)
    re, im = rng.standard_normal((2, 50, 161)).astype(np.float32)
    np.testing.assert_allclose(
        tstft.phase(torch.from_numpy(re), torch.from_numpy(im)).numpy(),
        np.asarray(jstft.phase(jnp.asarray(re), jnp.asarray(im))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("length", [16000, 15000, 17000, None])
def test_istft_matches_jax(length):
    rng = np.random.default_rng(5)
    re, im = rng.standard_normal((2, 2, 101, N_FFT // 2 + 1)).astype(np.float32)
    y_t = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), N_FFT, HOP,
                      length=length).numpy()
    y_j = np.asarray(jstft.istft(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP,
                                 length=length))
    assert y_t.shape == y_j.shape
    np.testing.assert_allclose(y_t, y_j, **WAV_TOL)


def test_reconstruct_matches_jax_and_is_perfect():
    x = _signal(2, 16000, seed=4)
    re, im = tstft.stft(torch.from_numpy(x), N_FFT, HOP)
    mag, ph = tstft.magnitude(re, im), tstft.phase(re, im)
    y_t = tstft.reconstruct(mag, ph, N_FFT, HOP, length=16000).numpy()
    y_j = np.asarray(jstft.reconstruct(jnp.asarray(mag.numpy()), jnp.asarray(ph.numpy()),
                                       N_FFT, HOP, length=16000))
    np.testing.assert_allclose(y_t, y_j, **WAV_TOL)
    np.testing.assert_allclose(y_t, x, rtol=0, atol=1e-4)   # perfect reconstruction


def test_plain_stft_matches_pallas_interpret():
    x = _signal(2, 16000, seed=6)
    re_t, im_t = tstft.stft(torch.from_numpy(x), N_FFT, HOP)
    re_p, im_p = stft_pallas(jnp.asarray(x), N_FFT, HOP, interpret=True)
    np.testing.assert_allclose(re_t.numpy(), np.asarray(re_p), **STFT_TOL)
    np.testing.assert_allclose(im_t.numpy(), np.asarray(im_p), **STFT_TOL)


def test_plain_istft_matches_pallas_interpret():
    rng = np.random.default_rng(7)
    re, im = rng.standard_normal((2, 2, 101, N_FFT // 2 + 1)).astype(np.float32)
    y_t = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), N_FFT, HOP,
                      length=16000).numpy()
    y_p = np.asarray(istft_pallas(jnp.asarray(re), jnp.asarray(im), N_FFT, HOP,
                                  length=16000, interpret=True))
    np.testing.assert_allclose(y_t, y_p, **WAV_TOL)


# n_fft, hop, samples, center, (n1, n2): 320 at both hops and uncentered,
# another composite, an odd n_fft with odd factors, and a prime (direct sum).
FACTORISED_CASES = [(320, 160, 8000, True, (32, 10)), (320, 80, 8000, True, (32, 10)),
                    (320, 160, 4000, False, (32, 10)), (96, 48, 3000, True, (16, 6)),
                    (75, 25, 2000, True, (15, 5)), (97, 97, 3000, True, (0, 0))]


@pytest.mark.parametrize("n_fft,hop,n,center,factors", FACTORISED_CASES)
def test_factorised_stft_matches_plain_and_jax(n_fft, hop, n, center, factors):
    """The STFT kernel's arithmetic, step by step in plain PyTorch (two-stage
    transform with twiddles, real-input symmetry, mirrored indices), against
    the plain segment DFT and the JAX stft: 1e-4 abs on unit-scale audio
    (|X| up to ~30, f32 sums in three different orders)."""
    assert kstft.stft_factors(n_fft) == factors
    x = _signal(2, n, seed=n_fft)
    re_f, im_f = kstft.stft_factorised_plain(torch.from_numpy(x), n_fft, hop, center=center)
    re_p, im_p = tstft.stft(torch.from_numpy(x), n_fft, hop, center=center)
    re_j, im_j = jstft.stft(jnp.asarray(x), n_fft, hop, center=center)
    assert re_f.shape == re_p.shape == re_j.shape
    for got, plain, ref in ((re_f, re_p, re_j), (im_f, im_p, im_j)):
        np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


# n_fft, hop, center, length, route: 320 at both hops with a length shorter
# than, equal to and longer than the 16000-sample signal and none, uncentered,
# another composite, and n_ffts whose route is the direct sum (a prime; more
# than 8 frames over a sample).
ISTFT_CASES = [(320, 160, True, 16000, (32, 10)), (320, 160, True, 15000, (32, 10)),
               (320, 160, True, 17000, (32, 10)), (320, 160, True, None, (32, 10)),
               (320, 80, True, 16000, (32, 10)), (320, 80, True, 17000, (32, 10)),
               (320, 160, False, None, (32, 10)), (320, 80, False, 15000, (32, 10)),
               (96, 48, True, None, (16, 6)), (97, 97, True, 3000, (0, 0)),
               (320, 32, True, 16000, (0, 0))]


@pytest.mark.parametrize("n_fft,hop,center,length,route", ISTFT_CASES)
def test_factorised_istft_matches_plain_and_jax(n_fft, hop, center, length, route):
    """The ISTFT kernel's arithmetic, step by step in plain PyTorch (inverse
    two-stage transform of the conjugate-extended spectrum, row weights,
    gather overlap-add, trim), against the plain segment DFT, the JAX istft
    and, where n_fft = 2 hop, the Pallas istft_pallas in interpret mode:
    1e-5 abs on unit-scale samples (f32 sums of 161 terms in different
    orders) wherever the COLA divisor (the sum of window^2 over the frames) is
    at least 0.5, which is every sample the enhance path keeps; 1e-4
    relative at an untrimmed edge, where the divisor nears 0 and amplifies
    the sum-order noise of these random spectra's samples (up to ~1e3)."""
    assert kstft.istft_route(n_fft, hop) == route
    rng = np.random.default_rng(n_fft + hop)
    t = 1 + 16000 // hop
    re, im = rng.standard_normal((2, 2, t, n_fft // 2 + 1)).astype(np.float32)
    got = kstft.istft_factorised_plain(torch.from_numpy(re), torch.from_numpy(im), n_fft,
                                       hop, center=center, length=length).numpy()
    refs = [tstft.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                        center=center, length=length).numpy(),
            np.asarray(jstft.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop,
                                   center=center, length=length))]
    if n_fft == 2 * hop:
        refs.append(np.asarray(istft_pallas(jnp.asarray(re), jnp.asarray(im), n_fft, hop,
                                            center=center, length=length, interpret=True)))
    divisor = tstft.trim(torch.from_numpy(tstft.cola_norm(t, n_fft, hop, "hann"))[None],
                         n_fft, center, length)[0].numpy()
    inner = divisor >= 0.5
    assert inner.any()
    for ref in refs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got[..., inner], ref[..., inner], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n_fft,factors", [(320, (32, 10)), (512, (32, 16)), (400, (25, 16)),
                                           (64, (16, 4)), (14, (7, 2)), (97, (0, 0)),
                                           (8, (0, 0)), (2, (0, 0))])
def test_stft_factors_save_operations(n_fft, factors):
    """The pair multiplies to n_fft and costs fewer FMAs than the direct sum;
    (0, 0), the direct sum, where no pair does."""
    n1, n2 = kstft.stft_factors(n_fft)
    assert (n1, n2) == factors
    direct = (n_fft // 2 + 1) * n_fft * 2
    if n1:
        k1 = n1 // 2 + 1
        assert n1 * n2 == n_fft and n2 * k1 * n1 * 2 + k1 * n2 * n2 * 4 < direct
    else:
        for a in range(2, n_fft // 2 + 1):
            if n_fft % a == 0:
                b, k1 = n_fft // a, a // 2 + 1
                assert b * k1 * a * 2 + k1 * b * b * 4 >= direct


@pytest.mark.parametrize("n,n_fft", [(50, 16), (200, 320), (161, 320), (1000, 75)])
def test_mirrored_indices_match_center_pad(n, n_fft):
    """The reflect pad as index arithmetic (what the kernel's loads do)
    against F.pad's reflect mode."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal((2, n)).astype(np.float32))
    pos = torch.arange(-(n_fft // 2), n + n_fft // 2)
    idx = kstft.reflect_index(pos, n)
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert torch.equal(x[:, idx], tstft.center_pad(x, n_fft))


def test_dft_table_is_exact_to_f32_rounding():
    tab = kstft.dft_table(320)
    m = np.arange(320)
    assert tab.dtype == np.float32 and tab.shape == (320, 2)
    np.testing.assert_array_equal(tab[:, 0], np.cos(2 * np.pi * m / 320).astype(np.float32))
    np.testing.assert_array_equal(tab[:, 1], (-np.sin(2 * np.pi * m / 320)).astype(np.float32))
    wc, ws = tstft._dft_bases_np(320)           # the plain version's bases: W^(n k mod N)
    n, k = 7, 93
    assert abs(tab[(n * k) % 320, 0] - wc[n, k]) < 1e-6
    assert abs(tab[(n * k) % 320, 1] - ws[n, k]) < 1e-6


def test_wrappers_route_cpu_tensors_to_plain_versions():
    x = torch.from_numpy(_signal(2, 4000, seed=8))
    before = (kstft.stft.launches, kstft.istft.launches)
    re_k, im_k = kstft.stft(x, N_FFT, HOP)
    re_p, im_p = tstft.stft(x, N_FFT, HOP)
    assert torch.equal(re_k, re_p) and torch.equal(im_k, im_p)
    y = kstft.istft(re_k, im_k, N_FFT, HOP, length=4000)
    assert torch.equal(y, tstft.istft(re_p, im_p, N_FFT, HOP, length=4000))
    assert (kstft.stft.launches, kstft.istft.launches) == before


# The framings of the hop-generic STFT and ISTFT: the enhancer's 20 ms / 10 ms
# (hop | n_fft, the segment route) and three where hop does not divide n_fft,
# the JAX package's gather/scatter fallback: 25 ms / 10 ms (400, 160), 1.5
# frames of overlap (300, 200) and a hop longer than the frame (160, 320:
# samples between frames that no frame covers).
ANY_HOPS = [(320, 160), (400, 160), (300, 200), (160, 320)]
ANY_HOP_N = 4000
ANY_HOP_LENGTHS = [ANY_HOP_N, ANY_HOP_N - 1000, ANY_HOP_N + 1000, None]


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
def test_stft_frame_signal_and_features_match_jax_at_any_hop(n_fft, hop, center):
    """``stft``, the kernel's factorised arithmetic, ``frame_signal`` and
    ``log_magnitude_features`` (both normalizations) against the JAX
    functions, shapes included."""
    x = _signal(2, ANY_HOP_N, seed=n_fft + hop)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    re_j, im_j = jstft.stft(xj, n_fft, hop, center=center)
    for re_t, im_t in (tstft.stft(xt, n_fft, hop, center=center),
                       kstft.stft_factorised_plain(xt, n_fft, hop, center=center)):
        assert re_t.shape == re_j.shape == (2, tstft.stft_frames(ANY_HOP_N, n_fft, hop, center),
                                            n_fft // 2 + 1)
        np.testing.assert_allclose(re_t.numpy(), np.asarray(re_j), **STFT_TOL)
        np.testing.assert_allclose(im_t.numpy(), np.asarray(im_j), **STFT_TOL)
    fr_t = tstft.frame_signal(xt, n_fft, hop, center)
    fr_j = np.asarray(jstft.frame_signal(xj, n_fft, hop, center))
    assert fr_t.shape == fr_j.shape
    np.testing.assert_array_equal(fr_t.numpy(), fr_j)
    for normalize in (True, False):
        got = tstft.log_magnitude_features(xt, n_fft, hop, center=center, normalize=normalize)
        ref = jstft.log_magnitude_features(xj, n_fft, hop, center=center, normalize=normalize)
        for g, r in zip(got, ref):
            assert g.shape == r.shape
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), **STFT_TOL)
        # the phase, as an angle (+pi and -pi are one), where the bin is not
        # ~0 (atan2 of rounding noise is any angle)
        sure = np.asarray(ref[1]) > 1e-3
        turn = np.angle(np.exp(1j * (got[2].numpy() - np.asarray(ref[2]))))
        assert np.abs(turn[sure]).max() <= 1e-3


@pytest.mark.parametrize("n_fft,hop", ANY_HOPS)
@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("length", ANY_HOP_LENGTHS)
def test_istft_and_reconstruct_match_jax_at_any_hop(n_fft, hop, center, length):
    """``istft`` (plain and the kernel's factorised arithmetic) on random
    spectra and ``reconstruct`` of a signal's magnitude and phase against
    the JAX functions, shapes included: where hop does not divide n_fft the
    output is the buffer cut to ``length`` and never zero-padded (JAX
    fallback), so n + 1000 gives fewer samples than asked.  WAV_TOL wherever
    the COLA divisor is at least 0.5 (every sample the enhance path keeps),
    and WAV_TOL on the overlap-add sums before the divide everywhere: at an
    untrimmed edge the divisor nears 0 and multiplies the f32 sum-order
    noise of two different transforms (the fallback's FFT, a matmul here)
    by up to 1e8."""
    rng = np.random.default_rng(n_fft + 7 * hop)
    t = tstft.stft_frames(ANY_HOP_N, n_fft, hop, center)
    re, im = rng.standard_normal((2, 2, t, n_fft // 2 + 1)).astype(np.float32)
    ref = np.asarray(jstft.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, center=center,
                                 length=length))
    want = tstft.istft_length(t, n_fft, hop, center, length)
    assert ref.shape == (2, want)
    divisor = tstft.trim(torch.from_numpy(tstft.cola_norm(t, n_fft, hop, "hann"))[None],
                         n_fft, center, length, pad=n_fft % hop == 0)[0].numpy()
    divisor = np.pad(divisor, (0, want - divisor.shape[0]))
    inner = divisor >= 0.5
    clamped = np.maximum(divisor, 1e-8)
    assert inner.any()
    for got in (tstft.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop,
                            center=center, length=length),
                kstft.istft_factorised_plain(torch.from_numpy(re), torch.from_numpy(im),
                                             n_fft, hop, center=center, length=length)):
        got = got.numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got[..., inner], ref[..., inner], **WAV_TOL)
        np.testing.assert_allclose(got * clamped, ref * clamped, **WAV_TOL)
    x = _signal(2, ANY_HOP_N, seed=n_fft)
    re_t, im_t = tstft.stft(torch.from_numpy(x), n_fft, hop, center=center)
    mag, ph = tstft.magnitude(re_t, im_t), tstft.phase(re_t, im_t)
    y_t = tstft.reconstruct(mag, ph, n_fft, hop, center=center, length=length).numpy()
    y_j = np.asarray(jstft.reconstruct(jnp.asarray(mag.numpy()), jnp.asarray(ph.numpy()),
                                       n_fft, hop, center=center, length=length))
    assert y_t.shape == y_j.shape == (2, want)
    np.testing.assert_allclose(y_t[..., inner], y_j[..., inner], **WAV_TOL)
    np.testing.assert_allclose(y_t * clamped, y_j * clamped, **WAV_TOL)


@pytest.mark.parametrize("n_fft,hop,route", [(400, 160, (25, 16)), (300, 200, (25, 12)),
                                             (160, 320, (20, 8)), (400, 40, (0, 0))])
def test_istft_route_counts_the_frames_over_a_sample_at_any_hop(n_fft, hop, route):
    """ceil(n_fft / hop) frames can cover a sample: the factorised route up
    to 8 of them (400 / 160: 3; 160 / 320: 1), the direct sum above (400 /
    40: 10)."""
    assert kstft.istft_route(n_fft, hop) == route
    assert tstft.overlap(n_fft, hop) == -(-n_fft // hop)


def test_gaps_between_frames_are_zero_as_in_jax():
    """A hop longer than the frame (160, 320): the samples no frame covers
    have a COLA divisor of exactly 0 and come out 0 on both sides, and the
    output ends where the last frame does (the JAX fallback cuts, never
    pads)."""
    n_fft, hop = 160, 320
    rng = np.random.default_rng(11)
    re, im = rng.standard_normal((2, 1, 13, 81)).astype(np.float32)
    y_t = tstft.istft(torch.from_numpy(re), torch.from_numpy(im), n_fft, hop, center=False,
                      length=4000).numpy()
    y_j = np.asarray(jstft.istft(jnp.asarray(re), jnp.asarray(im), n_fft, hop, center=False,
                                 length=4000))
    assert y_t.shape == y_j.shape == (1, 12 * hop + n_fft)
    gap = (np.arange(y_t.shape[1]) % hop) >= n_fft
    assert np.all(y_t[:, gap] == 0.0) and np.all(y_j[:, gap] == 0.0)
    assert tstft.cola_norm(13, n_fft, hop, "hann")[gap].max() == 0.0
