"""The conv weight-gradient kernel's plan (``ops/cuda/conv_dw.py::conv_dw_plan``)
on the CPU: which route each dtype takes, that the bf16 tensor-core route
takes every shape the f32 route takes within a block's shared memory, and the
tensor-core kernel's arithmetic step by step (its windows, staged rows and
gathered positions, in numpy) against the plain version.

The step-by-step sums run in float64 on bf16-valued inputs and are held to
1e-6 of max|dW| against the plain version's float32 sums (sum order only).
"""

import itertools

import numpy as np
import pytest
import torch

from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv

H100_SMS = 132

CONV_DW_SHAPES = [
    # b, t, f, ci, co, kt, kf, strides (those of tests/test_torch_kernels_gpu.py)
    (2, 37, 23, 8, 16, 5, 5, (1, 1)),
    (2, 33, 21, 8, 8, 3, 7, (1, 1)),
    (1, 40, 16, 16, 8, 1, 1, (1, 1)),
    (2, 29, 41, 8, 8, 11, 21, (1, 2)),
    (2, 30, 17, 8, 8, 5, 5, (1, 2)),
    (2, 16, 18, 8, 8, 4, 6, (1, 2)),
    (2, 29, 80, 32, 32, 11, 21, (1, 2)),
    (3, 50, 81, 32, 32, 11, 21, (1, 2)),
    (2, 40, 33, 32, 32, 5, 5, (1, 1)),
    (2, 21, 19, 10, 6, 3, 5, (1, 1)),
    (1, 18, 20, 64, 64, 3, 13, (1, 2)),
]
AM_CONV2 = [(b, 401, 81, 32, 32, 11, 21, (1, 2)) for b in (8, 32, 128)]


def _plan(dtype, shape, sms=H100_SMS):
    return kconv.conv_dw_plan(dtype, *shape, sms)


def _check_mma(plan, shape):
    """The invariants ``aas_conv_dw_mma`` checks before it launches."""
    _, _, f, _, _, kt, kf, strides = shape
    fo, ntaps = -(-f // strides[1]), kt * kf
    assert plan.route == "mma" and plan.slices >= 1
    assert plan.smem <= kconv.MAX_SMEM
    assert plan.smem == kconv.mma_smem(plan.cx, plan.cd, plan.win, plan.ndt, fo, kf,
                                       strides[1])
    assert plan.per_block <= kconv.MMA_WARPS * kconv._units(plan.cx, plan.cd)
    assert (plan.groups - 1) * plan.per_block < ntaps <= plan.groups * plan.per_block
    assert kconv._tap_span(kt, kf, plan.per_block) <= plan.ndt


@pytest.mark.parametrize("shape", CONV_DW_SHAPES + AM_CONV2)
def test_bf16_plan_takes_the_shapes_on_tensor_cores(shape):
    _check_mma(_plan(torch.bfloat16, shape), shape)
    f32 = _plan(torch.float32, shape)
    assert f32.route == "fma" and f32.slices >= 1


def test_am_conv2_plan():
    """conv2 at B = 8: one 32 x 32 channel tile, 8 groups of 29 taps (4 a
    warp), windows of 8 dy rows, 16 slices (128 blocks on 132 SMs); the f32
    route as csrc/conv_dw.cu's make_plan splits it: 7 frequency taps a
    thread, 11 blocks of one time tap, 24 slices."""
    plan = _plan(torch.bfloat16, AM_CONV2[0])
    assert (plan.cx, plan.cd, plan.groups, plan.per_block, plan.win, plan.ndt) == \
        (4, 4, 8, 29, 8, 3)
    assert (plan.blocks, plan.slices, plan.smem) == (8, 16, 191248)
    f32 = _plan(torch.float32, AM_CONV2[0])
    assert (f32.taps, f32.ndt, f32.ndfb, f32.blocks, f32.slices) == (7, 1, 3, 11, 24)
    enh = _plan(torch.float32, (8, 801, 161, 32, 32, 5, 5, (1, 1)))
    assert (enh.taps, enh.ndt, enh.blocks, enh.slices, enh.smem) == (5, 3, 2, 132, 167936)


@pytest.mark.parametrize("shape", [
    (1, 4, 4, 128, 64, 3, 3, (1, 1)),       # a 32 x 16 register tiling: more than a block
    (2, 30, 17, 8, 8, 5, 5, (2, 1)),        # time stride 2
    (2, 30, 17, 8, 8, 5, 5, (1, 3)),        # frequency stride 3
    (1, 4, 3000, 64, 64, 11, 21, (1, 1)),   # f32 rows beyond a block's shared memory
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_out_of_scope_gives_no_slices(shape, dtype):
    """Both dtypes refuse the same shapes, so ``TapDWConv(dw_impl="auto")``
    routes them to cuDNN at bf16 as at f32."""
    assert _plan(dtype, shape).slices == 0


def test_bf16_takes_the_shapes_the_f32_route_takes():
    """Over a grid of channels, taps, widths and strides: wherever the f32
    plan gives slices within 180 KB of shared memory a block, the bf16 plan
    gives slices too.  Past that the bf16 staging (16-channel rows, a window's
    x tail for the prefetch) can need more than a block has: in this grid
    only shapes of 1200 bins or more, one time tap and at most 8 output
    channels or 3 input channels, which no model has."""
    taken = missed = 0
    for ci, co, (kt, kf), f, sf in itertools.product(
            (1, 3, 8, 10, 16, 20, 24, 32, 48, 64), (1, 6, 8, 12, 16, 32, 40, 64, 128),
            ((1, 1), (3, 5), (5, 5), (11, 21), (11, 41), (3, 13), (1, 7)),
            (1, 16, 81, 161, 400, 1200, 2500, 4000), (1, 2)):
        shape = (2, 9, f, ci, co, kt, kf, (1, sf))
        f32 = _plan(torch.float32, shape)
        if not f32.slices:
            continue
        if f32.smem <= 180 * 1024:
            _check_mma(_plan(torch.bfloat16, shape), shape)
            taken += 1
        elif _plan(torch.bfloat16, shape).slices:
            _check_mma(_plan(torch.bfloat16, shape), shape)
        else:
            assert f >= 1200 and kt == 1 and (co <= 8 or ci <= 3), shape
            missed += 1
    assert taken > 4000 and missed < 40


def _mma_steps(x: np.ndarray, dy: np.ndarray, kt: int, kf: int, strides, plan) -> np.ndarray:
    """``conv_dw_mma_kernel``'s arithmetic in float64: per row slice and
    block (channel chunk pair, tap group), windows of at most ``win`` dy rows
    of one utterance; dy staged as positions k = i Fo + f up to ceil16(n Fo)
    (zero past n Fo), x as n + ndt - 1 phase-split time slots of xp rows and
    a tail; tap (dt, df) reads staged x row i xp + f + off(dt, df) for position
    k; the sums flushed every 128 dy rows or so, the slices added in order."""
    b, t, f, ci = x.shape
    fo, co = dy.shape[2], dy.shape[3]
    sf = strides[1]
    pt0, pf0 = kconv.same_pad(t, kt, 1)[0], kconv.same_pad(f, kf, sf)[0]
    half, xp, tail = kconv.mma_geometry(fo, kf, sf)
    cm, cn = 8 * plan.cx, 8 * plan.cd
    nci, nco = -(-ci // cm), -(-co // cn)
    xp_ = np.zeros((b, t, f, nci * cm))
    xp_[..., :ci] = x
    dyp = np.zeros((b, t, fo, nco * cn))
    dyp[..., :co] = dy
    ntaps, rows = kt * kf, b * t
    per_slice = -(-rows // plan.slices)
    part = np.zeros((plan.slices, ntaps, nci * cm, nco * cn))
    q = np.arange(xp)
    ph, jj = q // half, q % half
    f_in = sf * jj + ph - pf0
    ok = (q < sf * half) & (f_in >= 0) & (f_in < f)
    for s, pair, g in itertools.product(range(plan.slices), range(nci * nco),
                                        range(plan.groups)):
        ci0, co0 = (pair // nco) * cm, (pair % nco) * cn
        taps = range(g * plan.per_block, min(ntaps, (g + 1) * plan.per_block))
        dt_min = taps[0] // kf
        acc = np.zeros((len(taps), cm, cn))
        r, r1, since = s * per_slice, min(rows, (s + 1) * per_slice), 0
        while r < r1:
            n = min(plan.win, r1 - r, t - r % t)
            bb, t0 = divmod(r, t)
            kn = n * fo
            k_end = -(-kn // 16) * 16
            dy_s = np.zeros((k_end, cn))
            dy_s[:kn] = dyp[bb, t0:t0 + n, :, co0:co0 + cn].reshape(kn, cn)
            x_s = np.zeros((n + plan.ndt - 1 + -(-tail // xp), xp, cm))
            for j in range(len(x_s)):
                t_in = t0 + dt_min - pt0 + j
                if 0 <= t_in < t:
                    x_s[j, ok] = xp_[bb, t_in, f_in[ok], ci0:ci0 + cm]
            x_s = x_s.reshape(-1, cm)[:(n + plan.ndt - 1) * xp + tail]
            k = np.arange(k_end)
            base = (k // fo) * xp + k % fo
            for v, tap in enumerate(taps):
                dt, df = divmod(tap, kf)
                off = (dt - dt_min) * xp + (df % sf) * half + df // sf
                acc[v] += x_s[base + off].T @ dy_s
            since += n
            r += n
            if since >= 128 or r >= r1:
                part[s, taps.start:taps.stop, ci0:ci0 + cm, co0:co0 + cn] += acc
                acc[:] = 0
                since = 0
    dw = np.zeros(part.shape[1:])
    for s in range(plan.slices):
        dw += part[s]
    return dw[:, :ci, :co].reshape(kt, kf, ci, co)


@pytest.mark.parametrize("shape", CONV_DW_SHAPES)
def test_mma_arithmetic_matches_plain(shape):
    b, t, f, ci, co, kt, kf, strides = shape
    rng = np.random.default_rng(sum(shape[:7]))
    x = torch.from_numpy(rng.standard_normal((b, t, f, ci)).astype(np.float32)).bfloat16()
    dy = torch.from_numpy(rng.standard_normal(
        (b, t, -(-f // strides[1]), co)).astype(np.float32)).bfloat16()
    plan = _plan(torch.bfloat16, shape)
    got = _mma_steps(x.double().numpy(), dy.double().numpy(), kt, kf, strides, plan)
    ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
