"""Masked GroupNorm + activation, forward: Triton kernels and the plain version.

Replaces ``aas_enhancement_tpu/ops/pallas/gn_kernel.py::masked_group_norm_act``
forward (``_lane_stats``/``_stats_kernel``, ``_finalize_stats``,
``_apply``/``_make_apply_kernel``), with the same three steps:

1. a stats kernel: per-lane partial sums of x and x^2 over the VALID frames
   of one time tile ([B, n_tiles, F*C]); rows past a row's length are masked
   out of the load, so padding costs no bandwidth;
2. a tiny finalize in torch: lanes -> per-(batch, group) mean and variance
   (E[x^2] - mean^2, clamped at 0, eps 1e-5, analytic count
   lengths * F * C/G), folded with scale and bias into one per-channel
   affine (inv, off);
3. an apply kernel: y = act(x * inv + off) on valid frames, 0 on padded ones,
   with act leaky_relu(slope) or hardtanh(0, 20) fused in.

Bound on the H100: memory.  There is no matrix product; the stats pass reads x
once and the apply pass reads x and writes y once (3 passes over the
[B, T, F, C] activation), against the plain version's separate mask,
reduce, affine, mask and activation passes with f32 intermediates.

Layout: x [B, T, F, C] contiguous (the conv output in channels-last memory,
viewed as [B, T, F*C] lanes), f32.  The Triton bodies live in
``gn_kernels.py``, imported inside the launching function, so this module
imports where Triton is absent.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.ops.masking import time_mask

_ACTS = {"none": 0, "leaky_relu": 1, "hardtanh": 2}
BLOCK_T = 32       # frames per program
BLOCK_FC = 256     # lanes (F*C positions) per program


def _activate(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "leaky_relu":
        return torch.where(y >= 0, y, slope * y)
    if act == "hardtanh":
        return torch.clamp(y, 0.0, 20.0)
    return y


def _finalize(s1_g: torch.Tensor, s2_g: torch.Tensor, lengths: torch.Tensor,
              f: int, c: int, g: int, eps: float, scale: torch.Tensor,
              bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) sums -> per-(B, C) affine (inv, off) with y = x * inv + off."""
    count = torch.clamp(lengths.to(torch.float32) * (f * (c // g)), min=1.0)[:, None]
    mean = s1_g / count
    var = torch.clamp(s2_g / count - mean ** 2, min=0.0)
    inv = torch.rsqrt(var + eps)
    inv_c = inv.repeat_interleave(c // g, dim=1) * scale
    off_c = bias - (mean * inv).repeat_interleave(c // g, dim=1) * scale
    return inv_c, off_c


def masked_group_norm_act_plain(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, lengths: torch.Tensor, *,
                                num_groups: int, eps: float = 1e-5,
                                act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Plain PyTorch version: same math as ``ops/norm.py::MaskedGroupNorm`` in JAX."""
    b, t, f, c = x.shape
    g = num_groups
    mask = time_mask(lengths, t, torch.float32)[:, :, None, None]
    xm = (x.to(torch.float32) * mask).reshape(b, t, f, g, c // g)
    inv_c, off_c = _finalize(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                             lengths, f, c, g, eps, scale, bias)
    y = (x * inv_c[:, None, None, :] + off_c[:, None, None, :]) * mask
    return _activate(y, act, slope)


def _gn_cuda(x, scale, bias, lengths, g, eps, act, slope):
    from aas_enhancement_tpu_torch.ops.triton.gn_kernels import apply_kernel, stats_kernel
    b, t, f, c = x.shape
    fc = f * c
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    n_tiles = -(-t // BLOCK_T)
    grid = (b, n_tiles, -(-fc // BLOCK_FC))
    sums = torch.empty((b, n_tiles, fc), dtype=torch.float32, device=x.device)
    sqs = torch.empty_like(sums)
    stats_kernel[grid](x, lengths, sums, sqs, t, fc, n_tiles,
                       BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
    grouped = (b, f, g, c // g)
    inv_c, off_c = _finalize(sums.sum(1).reshape(grouped).sum(dim=(1, 3)),
                             sqs.sum(1).reshape(grouped).sum(dim=(1, 3)),
                             lengths, f, c, g, eps, scale, bias)
    y = torch.empty_like(x)
    apply_kernel[grid](x, y, lengths, inv_c.repeat(1, f).contiguous(),
                       off_c.repeat(1, f).contiguous(), t, fc, float(slope),
                       ACT=_ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
    return y


def masked_group_norm_act(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, lengths: torch.Tensor, *,
                          num_groups: int, eps: float = 1e-5,
                          act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Masked GroupNorm + activation over [B, T, F, C].

    A CUDA tensor runs the Triton kernels (counted in ``.launches``, one per
    forward); a CPU tensor runs ``masked_group_norm_act_plain``.
    """
    if x.ndim != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"needs [B, T, F, C] with C % {num_groups} == 0, "
                         f"got {tuple(x.shape)}")
    if act not in _ACTS:
        raise ValueError(f"unknown act {act!r}")
    if not uses_kernel("masked_group_norm_act", x):
        return masked_group_norm_act_plain(x, scale, bias, lengths,
                                           num_groups=num_groups, eps=eps,
                                           act=act, slope=slope)
    check_kernel_inputs("masked_group_norm_act", (x, scale, bias), backward="B3'")
    if not x.is_contiguous():
        raise ValueError("masked_group_norm_act: needs a contiguous x")
    if scale.shape != (x.shape[-1],) or bias.shape != (x.shape[-1],):
        raise ValueError("masked_group_norm_act: scale/bias must be [C]")
    if lengths.shape != (x.shape[0],):
        raise ValueError("masked_group_norm_act: lengths must be [B]")
    y = _gn_cuda(x, scale, bias, lengths, num_groups, eps, act, slope)
    masked_group_norm_act.launches += 1
    return y


masked_group_norm_act.launches = 0
