"""The conv weight-gradient kernel's plan (``ops/cuda/conv_dw.py::conv_dw_plan``)
on the CPU: which route each dtype takes, that the bf16 tensor-core route
takes every shape the FMA route takes within a block's shared memory, which
f32 shapes the split route ("bf16x3") leaves to the FMA route, the split
(``split3_bf16``), and the tensor-core kernel's arithmetic step by step (its
windows, staged rows and planes, gathered positions and flushes, in numpy)
against the plain version, at one plane (bf16 inputs) and at three (f32).

The step-by-step sums run in float64 on bf16-valued planes and are held to
1e-6 of max|dW| against the plain version's float32 sums: the sum order, and
at three planes the three products left out (order 2^-24 of each product).
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
E2E_CONV2 = (16, 301, 81, 16, 16, 11, 21, (1, 2))      # cli/e2e.py's AM at its batch
ENHANCER = (8, 801, 161, 32, 32, 5, 5, (1, 1))         # no model path


def _plan(dtype, shape, sms=H100_SMS):
    return kconv.conv_dw_plan(dtype, *shape, sms)


def _fma(shape, sms=H100_SMS):
    b, t, f, ci, co, kt, kf, strides = shape
    return kconv._fma_plan(b * t, -(-f // strides[1]), kt, kf, ci, co, strides[1], sms)


def _check_mma(plan, shape, route="mma"):
    """The invariants ``aas_conv_dw_mma`` checks before it launches."""
    _, _, f, _, _, kt, kf, strides = shape
    fo, ntaps = -(-f // strides[1]), kt * kf
    assert plan.route == route and plan.slices >= 1
    assert plan.planes == {"mma": 1, "bf16x3": 3}[route]
    assert plan.smem <= kconv.MAX_SMEM
    assert plan.smem == kconv.mma_smem(plan.planes, plan.cx, plan.cd, plan.win, plan.ndt, fo,
                                       kf, strides[1])
    assert plan.per_block <= kconv.MMA_WARPS * kconv._units(plan.planes, plan.cx, plan.cd)
    assert (plan.groups - 1) * plan.per_block < ntaps <= plan.groups * plan.per_block
    assert kconv._tap_span(kt, kf, plan.per_block) <= plan.ndt


@pytest.mark.parametrize("shape", CONV_DW_SHAPES + AM_CONV2)
def test_bf16_plan_takes_the_shapes_on_tensor_cores(shape):
    _check_mma(_plan(torch.bfloat16, shape), shape)
    assert _fma(shape).slices >= 1


@pytest.mark.parametrize("shape", CONV_DW_SHAPES + AM_CONV2 + [E2E_CONV2, ENHANCER])
def test_f32_plan_takes_the_split_route(shape):
    """f32 x and dy take "bf16x3" at every shape of the GPU tests, the AM's
    conv2 at B = 8, 32, 128, the e2e protocol's conv2 and the enhancer's 5 x 5,
    within 227 KB and with the launch's invariants."""
    _check_mma(_plan(torch.float32, shape), shape, "bf16x3")


def test_am_conv2_plan():
    """conv2 at B = 8: one 32 x 32 channel tile, 8 groups of 29 taps (4 a
    warp), windows of 8 dy rows, 16 slices (128 blocks on 132 SMs); at f32
    the split route, 2 taps a warp: 15 groups of 16 taps spanning 2 time
    taps, windows of 3 dy rows (three planes of each), 8 slices (120
    blocks); the FMA route as csrc/conv_dw.cu's make_plan splits it: 7
    frequency taps a thread, 11 blocks of one time tap, 24 slices.  The e2e
    widths (16 channels): 4 groups of 58 taps, windows of 5 rows, 33 slices;
    the enhancer's 5 x 5: 5 groups of 5 taps, windows of one row."""
    plan = _plan(torch.bfloat16, AM_CONV2[0])
    assert (plan.cx, plan.cd, plan.groups, plan.per_block, plan.win, plan.ndt) == \
        (4, 4, 8, 29, 8, 3)
    assert (plan.blocks, plan.slices, plan.smem) == (8, 16, 191248)
    f32 = _plan(torch.float32, AM_CONV2[0])
    assert (f32.route, f32.planes, f32.cx, f32.cd, f32.groups, f32.per_block, f32.win,
            f32.ndt) == ("bf16x3", 3, 4, 4, 15, 16, 3, 2)
    assert (f32.blocks, f32.slices, f32.smem) == (15, 8, 222224)
    fma = _fma(AM_CONV2[0])
    assert (fma.taps, fma.ndt, fma.ndfb, fma.blocks, fma.slices) == (7, 1, 3, 11, 24)
    e2e = _plan(torch.float32, E2E_CONV2)
    assert (e2e.route, e2e.cx, e2e.cd, e2e.groups, e2e.per_block, e2e.win, e2e.ndt,
            e2e.slices) == ("bf16x3", 2, 2, 4, 58, 5, 4, 33)
    enh = _plan(torch.float32, ENHANCER)
    assert (enh.route, enh.groups, enh.per_block, enh.win, enh.ndt, enh.slices) == \
        ("bf16x3", 5, 5, 1, 1, 26)
    fma = _fma(ENHANCER)
    assert (fma.taps, fma.ndt, fma.blocks, fma.slices, fma.smem) == (5, 3, 2, 132, 167936)


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
    """Over a grid of channels, taps, widths and strides: wherever the FMA
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
        f32 = _fma(shape)
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


def test_f32_plan_leaves_to_fma_only_wide_windows():
    """Over the grid above at f32: every shape the FMA route takes with at
    most 161 bins (the models' 41, 81 and 161 among them) takes "bf16x3",
    but one bin under a kernel 21 or more wide (a window's x tail of 30 time
    slots); the shapes left on "fma" are those, and shapes of 200 bins or
    more whose two stages of three planes exceed a block's shared memory."""
    split = fma = 0
    for ci, co, (kt, kf), f, sf in itertools.product(
            (1, 3, 8, 10, 16, 20, 24, 32, 48, 64), (1, 6, 8, 12, 16, 32, 40, 64, 128),
            ((1, 1), (3, 5), (5, 5), (11, 21), (11, 41), (3, 13), (1, 7)),
            (1, 16, 81, 161, 400, 1200, 2500, 4000), (1, 2)):
        shape = (2, 9, f, ci, co, kt, kf, (1, sf))
        if not _fma(shape).slices:
            assert _plan(torch.float32, shape).slices == 0
            continue
        plan, fo = _plan(torch.float32, shape), -(-f // sf)
        if plan.route == "bf16x3":
            _check_mma(plan, shape, "bf16x3")
            split += 1
        else:
            assert plan == _fma(shape), shape
            assert fo >= 200 or (fo == 1 and kf >= 21), shape
            fma += 1
    assert split > 5000 and fma < 600


@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "subnormal", "zeros", "mixed"])
def test_split3_bf16_reconstructs_f32(kind):
    """v0 + v1 + v2 (summed in float64) gives back every f32 input exactly
    where the planes stay above bf16's subnormals (|v| > 2^-100 here); below
    that within 2^-24 |v| or bf16's subnormal half-step, 2^-134.  Each plane
    is its remainder rounded to bf16 (round to nearest even)."""
    rng = np.random.default_rng(7)
    v = {"normal": rng.standard_normal(4096),
         "tiny": np.concatenate([s * 1e-30 * (1 + rng.random(512)) for s in (1, -1)]),
         "huge": np.concatenate([s * 1e30 * (1 + rng.random(512)) for s in (1, -1)]),
         "subnormal": np.concatenate([s * 2.0 ** -149 * rng.integers(1, 2 ** 23, 512)
                                      for s in (1, -1)]),
         "zeros": np.zeros(64),
         "mixed": rng.standard_normal(4096) * 2.0 ** rng.integers(-126, 127, 4096)}[kind]
    t = torch.from_numpy(v.astype(np.float32))
    planes = kconv.split3_bf16(t)
    assert all(p.dtype == torch.bfloat16 and p.shape == t.shape for p in planes)
    got = sum(p.double() for p in planes)
    ref = t.double()
    err = (got - ref).abs()
    normal = ref.abs() > 2.0 ** -100
    assert torch.all(err[normal] == 0)
    assert torch.all(err <= torch.maximum(2.0 ** -24 * ref.abs(), torch.tensor(2.0 ** -134)))
    r = t
    for p in planes:
        assert torch.equal(p, r.bfloat16())
        r = r - p.float()
    assert torch.all(planes[0][t == 0] == 0) and torch.all(planes[2][t == 0] == 0)


def _mma_steps(x, dy, kt: int, kf: int, strides, plan) -> np.ndarray:
    """``conv_dw_mma_kernel``'s arithmetic in float64, x and dy given as
    lists of ``plan.planes`` planes: per row slice and block (channel chunk
    pair, tap group), windows of at most ``win`` dy rows of one utterance; dy
    staged as positions k = i Fo + f up to ceil16(n Fo) (zero past n Fo), x
    as n + ndt - 1 phase-split time slots of xp rows and a tail, each plane
    alike; tap (dt, df) reads staged x row i xp + f + off(dt, df) for
    position k; the products of each (x plane, dy plane) pair the kernel
    keeps (one; or x0 d2, x1 d1, x2 d0, x0 d1, x1 d0, x0 d0); the sums
    flushed every ``FLUSH_ROWS`` dy rows or so, the slices added in order."""
    pairs = [(0, 0)] if plan.planes == 1 else [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
    b, t, f, ci = x[0].shape
    fo, co = dy[0].shape[2], dy[0].shape[3]
    sf = strides[1]
    pt0, pf0 = kconv.same_pad(t, kt, 1)[0], kconv.same_pad(f, kf, sf)[0]
    half, xp, tail = kconv.mma_geometry(fo, kf, sf)
    cm, cn = 8 * plan.cx, 8 * plan.cd
    nci, nco = -(-ci // cm), -(-co // cn)
    xp_ = np.zeros((len(x), b, t, f, nci * cm))
    xp_[..., :ci] = np.stack(x)
    dyp = np.zeros((len(dy), b, t, fo, nco * cn))
    dyp[..., :co] = np.stack(dy)
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
            dy_s = np.zeros((len(dy), k_end, cn))
            dy_s[:, :kn] = dyp[:, bb, t0:t0 + n, :, co0:co0 + cn].reshape(-1, kn, cn)
            x_s = np.zeros((len(x), n + plan.ndt - 1 + -(-tail // xp), xp, cm))
            for j in range(x_s.shape[1]):
                t_in = t0 + dt_min - pt0 + j
                if 0 <= t_in < t:
                    x_s[:, j, ok] = xp_[:, bb, t_in, f_in[ok], ci0:ci0 + cm]
            x_s = x_s.reshape(len(x), -1, cm)[:, :(n + plan.ndt - 1) * xp + tail]
            k = np.arange(k_end)
            base = (k // fo) * xp + k % fo
            for v, tap in enumerate(taps):
                dt, df = divmod(tap, kf)
                off = (dt - dt_min) * xp + (df % sf) * half + df // sf
                for qx, qd in pairs:
                    acc[v] += x_s[qx, base + off].T @ dy_s[qd]
            since += n
            r += n
            if since >= kconv.FLUSH_ROWS or r >= r1:
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
    got = _mma_steps([x.double().numpy()], [dy.double().numpy()], kt, kf, strides, plan)
    ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("shape", CONV_DW_SHAPES)
def test_split_arithmetic_matches_plain(shape):
    """The f32 route ("bf16x3") step by step: x and dy split as the staging
    warps split them, the six products a step and tap over the plan's
    windows and flushes, against the plain version's f32 sums."""
    b, t, f, ci, co, kt, kf, strides = shape
    rng = np.random.default_rng(sum(shape[:7]) + 1)
    x = torch.from_numpy(rng.standard_normal((b, t, f, ci)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((b, t, -(-f // strides[1]), co)).astype(np.float32))
    plan = _plan(torch.float32, shape)
    assert plan.route == "bf16x3"
    got = _mma_steps([p.double().numpy() for p in kconv.split3_bf16(x)],
                     [p.double().numpy() for p in kconv.split3_bf16(dy)], kt, kf, strides, plan)
    ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


SPLIT_F64_TOL = 1.5e-6     # the split route against f64 (chip_smoke.py's F64_TOL)
FAULT_SHAPES = [
    (1, 101, 81, 32, 32, 11, 21, (1, 2)),      # the AM's conv2, time cut
    (2, 61, 81, 16, 16, 11, 21, (1, 2)),       # the e2e widths, time cut
    (1, 101, 161, 32, 32, 5, 5, (1, 1)),       # the enhancer's 5 x 5, time cut
    CONV_DW_SHAPES[7], CONV_DW_SHAPES[8], CONV_DW_SHAPES[3],
]
FAULTS = {"the 2^-16 products": [(0, 2), (1, 1), (2, 0)], "x2 d0": [(2, 0)], "x0 d2": [(0, 2)],
          "x1 d1": [(1, 1)]}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("shape", FAULT_SHAPES)
def test_split_f64_limit_catches_a_dropped_product(shape, fault):
    """The split route's limit against f64 (1.5e-6 of max|dW|; the card's
    sound readings are below 8e-7) sits under the error of the route with a
    product left out: x0 d2, x1 d1 or x2 d0 alone misses f64 by more than
    the limit, the three together by more than twice it.  The six products
    kept are exact, so the arithmetic alone misses by the three 2^-24
    products, 1/100 of the limit at most."""
    b, t, f, ci, co, kt, kf, strides = shape
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, f, ci, generator=gen)
    dy = torch.randn(b, t, -(-f // strides[1]), co, generator=gen)
    xs, ds = kconv.split3_bf16(x), kconv.split3_bf16(dy)

    def dw(pairs):
        return sum(kconv.conv_dw_same_plain(xs[a].double(), ds[c].double(), kt, kf, strides,
                                            torch.float64) for a, c in pairs)

    ref = kconv.conv_dw_same_plain(x.double(), dy.double(), kt, kf, strides, torch.float64)
    top = float(ref.abs().max())
    kept = [(0, 2), (1, 1), (2, 0), (0, 1), (1, 0), (0, 0)]
    assert float((dw(kept) - ref).abs().max()) <= SPLIT_F64_TOL / 100 * top
    faulty = [pair for pair in kept if pair not in FAULTS[fault]]
    err = float((dw(faulty) - ref).abs().max()) / top
    assert err > (2 if len(FAULTS[fault]) == 3 else 1) * SPLIT_F64_TOL, err
