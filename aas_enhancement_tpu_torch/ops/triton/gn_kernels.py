"""Triton bodies of the masked GroupNorm backward kernels (launched by ``gn.py``).

This module imports ``triton`` at its top, so ``gn.py`` imports it only
inside the launching function: everything else imports where Triton is absent.
"""

import triton
import triton.language as tl


@triton.jit
def _bwd_tile(x_ptr, dy_ptr, len_ptr, inv_ptr, muinv_ptr, sc_ptr, bi_ptr, T, FC,
              slope, ACT: tl.constexpr, BT: tl.constexpr, BFC: tl.constexpr):
    """One tile's x_hat = x * inv - mean * inv and dz = dy * act'(z) with
    z = x_hat * scale + bias (0 on padded frames), and where it lies."""
    b = tl.program_id(0)
    tt = tl.program_id(1)
    fb = tl.program_id(2)
    length = tl.load(len_ptr + b)
    rows = tt * BT + tl.arange(0, BT)
    cols = fb * BFC + tl.arange(0, BFC)
    inside = (rows[:, None] < T) & (cols[None, :] < FC)
    valid = inside & (rows[:, None] < length)
    offs = b.to(tl.int64) * T * FC + rows[:, None] * FC + cols[None, :]
    x = tl.load(x_ptr + offs, mask=valid, other=0.0)
    dy = tl.load(dy_ptr + offs, mask=valid, other=0.0)
    inv = tl.load(inv_ptr + b * FC + cols, mask=cols < FC, other=0.0)
    muinv = tl.load(muinv_ptr + b * FC + cols, mask=cols < FC, other=0.0)
    sc = tl.load(sc_ptr + cols, mask=cols < FC, other=0.0)
    bi = tl.load(bi_ptr + cols, mask=cols < FC, other=0.0)
    xhat = x * inv[None, :] - muinv[None, :]
    z = xhat * sc[None, :] + bi[None, :]
    if ACT == 1:
        dz = tl.where(z >= 0, dy, slope * dy)
    elif ACT == 2:
        dz = tl.where((z >= 0) & (z <= 20.0), dy, 0.0)
    else:
        dz = dy
    return xhat, tl.where(valid, dz, 0.0), offs, inside, valid


@triton.jit
def bwd_stats_kernel(x_ptr, dy_ptr, len_ptr, inv_ptr, muinv_ptr, sc_ptr, bi_ptr,
                     sdz_ptr, sdzx_ptr, T, FC, n_tiles, slope, ACT: tl.constexpr,
                     BT: tl.constexpr, BFC: tl.constexpr):
    """Per-lane sums of dz and dz * x_hat over the valid frames of one time tile."""
    xhat, dz, _, _, _ = _bwd_tile(x_ptr, dy_ptr, len_ptr, inv_ptr, muinv_ptr, sc_ptr,
                                  bi_ptr, T, FC, slope, ACT, BT, BFC)
    cols = tl.program_id(2) * BFC + tl.arange(0, BFC)
    out = (tl.program_id(0).to(tl.int64) * n_tiles + tl.program_id(1)) * FC + cols
    tl.store(sdz_ptr + out, tl.sum(dz, axis=0), mask=cols < FC)
    tl.store(sdzx_ptr + out, tl.sum(dz * xhat, axis=0), mask=cols < FC)


@triton.jit
def dx_kernel(x_ptr, dy_ptr, dx_ptr, len_ptr, inv_ptr, muinv_ptr, sc_ptr, bi_ptr,
              a_ptr, s1_ptr, s2_ptr, T, FC, slope, ACT: tl.constexpr,
              BT: tl.constexpr, BFC: tl.constexpr):
    """dx = a * dz - (s1 + x_hat * s2) on valid frames, 0 on padded frames."""
    xhat, dz, offs, inside, valid = _bwd_tile(
        x_ptr, dy_ptr, len_ptr, inv_ptr, muinv_ptr, sc_ptr, bi_ptr, T, FC, slope,
        ACT, BT, BFC)
    row = tl.program_id(0) * FC + tl.program_id(2) * BFC + tl.arange(0, BFC)
    ok = tl.program_id(2) * BFC + tl.arange(0, BFC) < FC
    a = tl.load(a_ptr + row, mask=ok, other=0.0)
    s1 = tl.load(s1_ptr + row, mask=ok, other=0.0)
    s2 = tl.load(s2_ptr + row, mask=ok, other=0.0)
    dx = a[None, :] * dz - (s1[None, :] + xhat * s2[None, :])
    tl.store(dx_ptr + offs, tl.where(valid, dx, 0.0), mask=inside)
