"""Triton bodies of the masked GroupNorm kernels (launched by ``gn.py``).

This module imports ``triton`` at its top, so ``gn.py`` imports it only
inside the launching function: everything else imports where Triton is absent.
"""

import triton
import triton.language as tl


@triton.jit
def stats_kernel(x_ptr, len_ptr, sum_ptr, sq_ptr, T, FC, n_tiles,
                 BT: tl.constexpr, BFC: tl.constexpr):
    """Per-lane sums of x and x^2 over the valid frames of one time tile."""
    b = tl.program_id(0)
    tt = tl.program_id(1)
    fb = tl.program_id(2)
    length = tl.load(len_ptr + b)
    rows = tt * BT + tl.arange(0, BT)
    cols = fb * BFC + tl.arange(0, BFC)
    ok = (rows[:, None] < length) & (rows[:, None] < T) & (cols[None, :] < FC)
    base = b.to(tl.int64) * T * FC
    x = tl.load(x_ptr + base + rows[:, None] * FC + cols[None, :], mask=ok, other=0.0)
    out = (b.to(tl.int64) * n_tiles + tt) * FC + cols
    tl.store(sum_ptr + out, tl.sum(x, axis=0), mask=cols < FC)
    tl.store(sq_ptr + out, tl.sum(x * x, axis=0), mask=cols < FC)


@triton.jit
def apply_kernel(x_ptr, y_ptr, len_ptr, inv_ptr, off_ptr, T, FC, slope,
                 ACT: tl.constexpr, BT: tl.constexpr, BFC: tl.constexpr):
    """y = act(x * inv + off) on valid frames, 0 on padded frames."""
    b = tl.program_id(0)
    tt = tl.program_id(1)
    fb = tl.program_id(2)
    length = tl.load(len_ptr + b)
    rows = tt * BT + tl.arange(0, BT)
    cols = fb * BFC + tl.arange(0, BFC)
    inside = (rows[:, None] < T) & (cols[None, :] < FC)
    valid = rows[:, None] < length
    offs = b.to(tl.int64) * T * FC + rows[:, None] * FC + cols[None, :]
    x = tl.load(x_ptr + offs, mask=inside & valid, other=0.0)
    inv = tl.load(inv_ptr + b * FC + cols, mask=cols < FC, other=0.0)
    off = tl.load(off_ptr + b * FC + cols, mask=cols < FC, other=0.0)
    z = x * inv[None, :] + off[None, :]
    if ACT == 1:
        z = tl.where(z >= 0, z, slope * z)
    elif ACT == 2:
        z = tl.minimum(tl.maximum(z, 0.0), 20.0)
    tl.store(y_ptr + offs, tl.where(valid, z, 0.0), mask=inside)
