"""Masked GroupNorm + activation, backward (B3'): Triton kernels.

Replaces ``aas_enhancement_tpu/ops/pallas/gn_kernel.py::_gn_bwd``
(``_bwd_lane_stats``, ``_dx``), in three steps, from the per-(B, C) ``mean``
and ``inv`` the forward kernel (``ops/cuda/gn.py``) saved:

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

Bound on the H100: memory.  There is no matrix product; it reads x and dy
twice and writes dx (5 passes over the [B, T, F, C] activation), against the
plain version's autograd through separate mask, reduce, affine, mask and
activation passes with f32 intermediates and saved copies.

Layout: x [B, T, F, C] contiguous (the conv output in channels-last memory,
viewed as [B, T, F*C] lanes), f32.  The Triton bodies live in
``gn_kernels.py``, imported inside the launching function, so this module
imports where Triton is absent.
"""

from __future__ import annotations

import torch

ACTS = {"none": 0, "leaky_relu": 1, "hardtanh": 2}     # the kernels' act codes
BLOCK_T = 32       # frames per program
BLOCK_FC = 256     # lanes (F*C positions) per program


def _grid(x: torch.Tensor) -> tuple[int, int, int]:
    b, t, f, c = x.shape
    return b, -(-t // BLOCK_T), -(-(f * c) // BLOCK_FC)


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
                           ACT=ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC, num_warps=4)
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
                    t, fc, float(slope), ACT=ACTS[act], BT=BLOCK_T, BFC=BLOCK_FC,
                    num_warps=4)
    masked_group_norm_act_bwd.launches += 1
    return dx, sdzx.sum(dim=(0, 1)), sdz.sum(dim=(0, 1))


masked_group_norm_act_bwd.launches = 0
