"""Masked GroupNorm + activation: Triton kernels, forward and backward, and
the plain version.

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

and its VJP (``_gn_bwd``: ``_bwd_lane_stats``, ``_dx``), again in three steps:

1. a backward stats kernel: per-lane partial sums of dz and dz * x_hat over
   the valid frames of one time tile, with x_hat = (x - mean) * inv and
   dz = dy * act'(x_hat * scale + bias) (``_act_grad``: leaky 1 at z >= 0 and
   the slope below; hardtanh 1 on [0, 20], 0 elsewhere);
2. a finalize in torch: dbias and dscale are the lane sums over batch and
   frequency; scale is folded into the lane sums BEFORE the group reduction
   (it varies inside a group), giving per-(B, G) means s1 of scale * dz and
   s2 of scale * dz * x_hat;
3. a dx kernel: dx = inv * scale * dz - inv * (s1 + x_hat * s2) on valid
   frames, 0 on padded ones.

Bound on the H100: memory.  There is no matrix product; the forward's stats
pass reads x once and its apply pass reads x and writes y (3 passes over the
[B, T, F, C] activation), the backward reads x and dy twice and writes dx
(5 passes), against the plain version's separate mask, reduce, affine, mask
and activation passes with f32 intermediates and autograd's saved copies.

Layout: x [B, T, F, C] contiguous (the conv output in channels-last memory,
viewed as [B, T, F*C] lanes), f32.  The Triton bodies live in
``gn_kernels.py``, imported inside the launching functions, so this module
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


def _group_stats(s1_g: torch.Tensor, s2_g: torch.Tensor, lengths: torch.Tensor,
                 f: int, c: int, g: int, eps: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) sums -> per-(B, G) (mean, inv = 1/sqrt(var + eps))."""
    count = torch.clamp(lengths.to(torch.float32) * (f * (c // g)), min=1.0)[:, None]
    mean = s1_g / count
    var = torch.clamp(s2_g / count - mean ** 2, min=0.0)
    return mean, torch.rsqrt(var + eps)


def _affine(mean: torch.Tensor, inv: torch.Tensor, c: int, g: int,
            scale: torch.Tensor, bias: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) (mean, inv) -> per-(B, C) affine (inv, off) with y = x * inv + off."""
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
    mean, inv = _group_stats(xm.sum(dim=(1, 2, 4)), (xm * xm).sum(dim=(1, 2, 4)),
                             lengths, f, c, g, eps)
    inv_c, off_c = _affine(mean, inv, c, g, scale, bias)
    y = (x * inv_c[:, None, None, :] + off_c[:, None, None, :]) * mask
    return _activate(y, act, slope)


def _grid(x: torch.Tensor) -> tuple[int, int, int]:
    b, t, f, c = x.shape
    return b, -(-t // BLOCK_T), -(-(f * c) // BLOCK_FC)


def _gn_cuda(x, scale, bias, lengths, g, eps, act, slope):
    """Forward kernels -> (y, mean, inv), mean and inv per (B, G)."""
    from aas_enhancement_tpu_torch.ops.triton.gn_kernels import apply_kernel, stats_kernel
    b, t, f, c = x.shape
    fc = f * c
    grid = _grid(x)
    sums = torch.empty((b, grid[1], fc), dtype=torch.float32, device=x.device)
    sqs = torch.empty_like(sums)
    stats_kernel[grid](x, lengths, sums, sqs, t, fc, grid[1],
                       BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
    grouped = (b, f, g, c // g)
    mean, inv = _group_stats(sums.sum(1).reshape(grouped).sum(dim=(1, 3)),
                             sqs.sum(1).reshape(grouped).sum(dim=(1, 3)),
                             lengths, f, c, g, eps)
    inv_c, off_c = _affine(mean, inv, c, g, scale, bias)
    y = torch.empty_like(x)
    apply_kernel[grid](x, y, lengths, inv_c.repeat(1, f).contiguous(),
                       off_c.repeat(1, f).contiguous(), t, fc, float(slope),
                       ACT=_ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
    return y, mean, inv


def masked_group_norm_act_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, lengths: torch.Tensor,
                              mean: torch.Tensor, inv: torch.Tensor, *,
                              num_groups: int, act: str = "none", slope: float = 0.2
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernel B3' -> (dx [B, T, F, C], dscale [C], dbias [C]), from
    the forward's per-(B, C) ``mean`` and ``inv`` (see module docstring)."""
    from aas_enhancement_tpu_torch.ops.triton.gn_kernels import bwd_stats_kernel, dx_kernel
    b, t, f, c = x.shape
    g = num_groups
    fc = f * c
    dy = dy.contiguous()
    grid = _grid(x)
    rows = dict(inv=inv.repeat(1, f).contiguous(),
                muinv=(mean * inv).repeat(1, f).contiguous(),
                sc=scale.detach().repeat(f).contiguous(),
                bi=bias.detach().repeat(f).contiguous())
    sdz = torch.empty((b, grid[1], fc), dtype=torch.float32, device=x.device)
    sdzx = torch.empty_like(sdz)
    bwd_stats_kernel[grid](x, dy, lengths, rows["inv"], rows["muinv"], rows["sc"],
                           rows["bi"], sdz, sdzx, t, fc, grid[1], float(slope),
                           ACT=_ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
    sdz = sdz.sum(1).reshape(b, f, c)
    sdzx = sdzx.sum(1).reshape(b, f, c)
    scale32 = scale.detach()
    count = torch.clamp(lengths.to(torch.float32) * (f * (c // g)), min=1.0)[:, None]
    s1_g = (sdz * scale32).reshape(b, f, g, c // g).sum(dim=(1, 3)) / count
    s2_g = (sdzx * scale32).reshape(b, f, g, c // g).sum(dim=(1, 3)) / count
    s1 = inv * s1_g.repeat_interleave(c // g, dim=1)
    s2 = inv * s2_g.repeat_interleave(c // g, dim=1)
    dx = torch.empty_like(x)
    dx_kernel[grid](x, dy, dx, lengths, rows["inv"], rows["muinv"], rows["sc"],
                    rows["bi"], (inv * scale32).repeat(1, f).contiguous(),
                    s1.repeat(1, f).contiguous(), s2.repeat(1, f).contiguous(),
                    t, fc, float(slope), ACT=_ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC,
                    num_warps=4)
    masked_group_norm_act_bwd.launches += 1
    return dx, sdzx.sum(dim=(0, 1)), sdz.sum(dim=(0, 1))


masked_group_norm_act_bwd.launches = 0


class _GNActFn(torch.autograd.Function):
    """B3 forward, B3' backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, lengths, num_groups, eps, act, slope):
        y, mean, inv = _gn_cuda(x, scale, bias, lengths, num_groups, eps, act, slope)
        rep = x.shape[-1] // num_groups                  # per (B, G) -> per (B, C)
        ctx.save_for_backward(x, scale, bias, lengths, mean.repeat_interleave(rep, dim=1),
                              inv.repeat_interleave(rep, dim=1))
        ctx.cfg = dict(num_groups=num_groups, act=act, slope=slope)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, lengths, mean, inv = ctx.saved_tensors
        dx, dscale, dbias = masked_group_norm_act_bwd(x, dy, scale, bias, lengths,
                                                      mean, inv, **ctx.cfg)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dscale if need[1] else None,
                dbias if need[2] else None, None, None, None, None, None)


def masked_group_norm_act(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, lengths: torch.Tensor, *,
                          num_groups: int, eps: float = 1e-5,
                          act: str = "none", slope: float = 0.2) -> torch.Tensor:
    """Masked GroupNorm + activation over [B, T, F, C].

    A CUDA tensor runs the Triton kernels (the forward counted in
    ``.launches``, one per call; where a gradient is wanted, through
    ``_GNActFn``, whose backward is ``masked_group_norm_act_bwd``); a CPU
    tensor runs ``masked_group_norm_act_plain``.
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
    check_kernel_inputs("masked_group_norm_act", (x, scale, bias), backward=None)
    if not x.is_contiguous():
        raise ValueError("masked_group_norm_act: needs a contiguous x")
    if scale.shape != (x.shape[-1],) or bias.shape != (x.shape[-1],):
        raise ValueError("masked_group_norm_act: scale/bias must be [C]")
    if lengths.shape != (x.shape[0],):
        raise ValueError("masked_group_norm_act: lengths must be [B]")
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, scale, bias)):
        y = _GNActFn.apply(x, scale, bias, lengths, num_groups, eps, act, slope)
    else:
        y = _gn_cuda(x, scale, bias, lengths, num_groups, eps, act, slope)[0]
    masked_group_norm_act.launches += 1
    return y


masked_group_norm_act.launches = 0
