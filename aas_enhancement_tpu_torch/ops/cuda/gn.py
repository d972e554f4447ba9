"""Masked GroupNorm + activation, forward and backward: the CUDA kernels
(``csrc/gn.cu``) and their plain versions.

Replaces ``aas_enhancement_tpu/ops/pallas/gn_kernel.py::masked_group_norm_act``:
its forward (``_lane_stats``, ``_finalize_stats``, ``_apply``) and its backward
``_gn_bwd`` (``_bwd_lane_stats``, the finalize, ``_dx``).  For a CUDA tensor
``masked_group_norm_act`` launches one cooperative kernel that sums x and x^2
over the valid frames, passes a grid-wide barrier, finalizes the per-(batch,
group) statistics (count lengths * F * C/G, var = E[x^2] - mean^2 clamped at
0, eps inside the rsqrt) and applies y = act(x * inv_c + off_c) with act
leaky_relu(slope) or hardtanh(0, 20), 0 on padded frames; see the source for
the design.  It is the only device kernel of a forward call: the wrapper
allocates the output and one scratch buffer (the per-(b, c) mean and inv the
backward reads, and the per-item partial sums) and reads the lengths in the
integer type it is given.  Where a gradient is wanted the call goes through
``_GNActFn``, whose backward ``masked_group_norm_act_bwd`` is one cooperative
kernel too: per-channel sums of dz and dz * x_hat, a grid-wide barrier, the
per-(batch, group) finalize, dx, and dscale and dbias summed in a fixed order
in the kernel.  A CPU tensor runs the plain versions.
"""

from __future__ import annotations

import torch

from aas_enhancement_tpu_torch.ops import library
from aas_enhancement_tpu_torch.ops.dispatch import check_kernel_inputs, uses_kernel
from aas_enhancement_tpu_torch.ops.masking import time_mask
from aas_enhancement_tpu_torch.utils import kernel_build

ACTS = {"none": 0, "leaky_relu": 1, "hardtanh": 2}     # the kernels' act codes
ROWS_PER_ITEM = 8      # frames per work item: kRows in csrc/gn.cu


def _activate(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "leaky_relu":
        return torch.where(y >= 0, y, slope * y)
    if act == "hardtanh":
        return torch.clamp(y, 0.0, 20.0)
    return y


def _act_grad(dy: torch.Tensor, z: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    """dy * act'(z): leaky 1 at z >= 0, else the slope; hardtanh 1 on [0, 20]."""
    if act == "leaky_relu":
        return dy * torch.where(z >= 0, 1.0, slope)
    if act == "hardtanh":
        return dy * ((z >= 0) & (z <= 20.0)).to(dy.dtype)
    return dy


def _group_stats(s1_g: torch.Tensor, s2_g: torch.Tensor, lengths: torch.Tensor,
                 f: int, c: int, g: int, eps: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) sums -> per-(B, G) (mean, inv = 1/sqrt(var + eps))."""
    count = torch.clamp(lengths.to(torch.float32) * (f * (c // g)), min=1.0)[:, None]
    mean = s1_g / count
    var = torch.clamp(s2_g / count - mean ** 2, min=0.0)
    return mean, torch.rsqrt(var + eps)


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
    inv_c = inv.repeat_interleave(c // g, dim=1) * scale
    off_c = bias - (mean * inv).repeat_interleave(c // g, dim=1) * scale
    y = (x * inv_c[:, None, None, :] + off_c[:, None, None, :]) * mask
    return _activate(y, act, slope)


def gn_kernel(x, scale, bias, lengths, g, eps, act, slope):
    """The forward kernel's launcher (the ``aas_torch::masked_group_norm_act``
    operator's CUDA implementation, and ``_GNActFn``'s forward): checks what
    the kernel takes, raises otherwise, launches once and counts it in
    ``masked_group_norm_act.launches`` -> (y, scratch): scratch
    [2 B C + partials] holds the mean and the inv per (B, C) (``_stats``),
    then the per-item partial sums.  ``lengths`` [B] int32 or int64 on x's
    device (the wrapper's ``_kernel_lengths``)."""
    check_kernel_inputs("masked_group_norm_act", (x, scale, bias))
    b, t, f, c = x.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("masked_group_norm_act: needs a contiguous, 16-byte aligned x")
    if c % 4 or c > 256 or g > 32 or x.numel() == 0:
        raise ValueError(f"masked_group_norm_act: the kernel takes C % 4 == 0, C <= 256, "
                         f"at most 32 groups and a non-empty x, got {tuple(x.shape)}, "
                         f"{g} groups")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("masked_group_norm_act: scale/bias must be [C]")
    if (lengths.shape != (b,) or lengths.dtype not in (torch.int32, torch.int64)
            or lengths.device != x.device or not lengths.is_contiguous()):
        raise ValueError("masked_group_norm_act: lengths must be [B], int32 or int64, "
                         "contiguous, on x's device")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("masked_group_norm_act: scale and bias must be contiguous")
    y = torch.empty_like(x)
    n_part = b * -(-t // ROWS_PER_ITEM) * g * 2
    scratch = torch.empty(2 * b * c + n_part, dtype=torch.float32, device=x.device)
    mean = scratch.data_ptr()
    err = kernel_build.load_library().aas_gn_act_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
        int(lengths.dtype == torch.int64), y.data_ptr(), mean, mean + 4 * b * c,
        mean + 8 * b * c, n_part, b, t, f, c, g, eps, ACTS[act], slope,
        torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(err, "aas_gn_act_fwd (cooperative launch)")
    masked_group_norm_act.launches += 1
    return y, scratch


def _stats(scratch: torch.Tensor, b: int, c: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward's (mean, inv), each [B, C], from its scratch."""
    return scratch[: 2 * b * c].view(2, b, c).unbind(0)


def masked_group_norm_act_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                                    bias: torch.Tensor, lengths: torch.Tensor,
                                    mean: torch.Tensor, inv: torch.Tensor, *,
                                    num_groups: int, act: str = "none", slope: float = 0.2
                                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward -> (dx, dscale, dbias): the closed form of
    ``gn_kernel.py::_gn_bwd`` from the forward's per-(B, C) ``mean`` and ``inv``.
    Scale is folded into each channel before the group sum (it varies inside
    a group)."""
    b, t, f, c = x.shape
    g = num_groups
    mask = time_mask(lengths, t, torch.bool)[:, :, None, None]
    row = lambda v: v[:, None, None, :]                               # noqa: E731
    xhat = x * row(inv) - row(mean * inv)
    dz = torch.where(mask, _act_grad(dy, xhat * scale + bias, act, slope), 0.0)
    sdz = dz.sum(dim=1)                                               # [B, F, C]
    sdzx = torch.where(mask, dz * xhat, 0.0).sum(dim=1)
    count = torch.clamp(lengths.to(torch.float32) * (f * (c // g)), min=1.0)[:, None]
    s1_g = (sdz * scale).reshape(b, f, g, c // g).sum(dim=(1, 3)) / count
    s2_g = (sdzx * scale).reshape(b, f, g, c // g).sum(dim=(1, 3)) / count
    s1 = inv * s1_g.repeat_interleave(c // g, dim=1)
    s2 = inv * s2_g.repeat_interleave(c // g, dim=1)
    dx = row(inv * scale) * dz - (row(s1) + xhat * row(s2))
    return torch.where(mask, dx, 0.0), sdzx.sum(dim=(0, 1)), sdz.sum(dim=(0, 1))


def masked_group_norm_act_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, lengths: torch.Tensor,
                              mean: torch.Tensor, inv: torch.Tensor, *,
                              num_groups: int, act: str = "none", slope: float = 0.2
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of ``masked_group_norm_act`` -> (dx [B, T, F, C], dscale [C],
    dbias [C]), from the forward's per-(B, C) ``mean`` and ``inv``.

    A CUDA tensor runs the kernel, one launch a call, counted in
    ``.launches``: dx, dscale and dbias are allocated, and a scratch buffer
    for the per-row and per-item partial sums.  A ``dy`` that is not
    contiguous and 16-byte aligned is copied first.  A CPU tensor runs
    ``masked_group_norm_act_bwd_plain``.
    """
    if not uses_kernel("masked_group_norm_act_bwd", x):
        return masked_group_norm_act_bwd_plain(x, dy, scale, bias, lengths, mean, inv,
                                               num_groups=num_groups, act=act, slope=slope)
    check_kernel_inputs("masked_group_norm_act_bwd", (x, dy, scale, bias, mean, inv))
    b, t, f, c = x.shape
    if (dy.shape != x.shape or mean.shape != (b, c) or inv.shape != (b, c)
            or scale.shape != (c,) or bias.shape != (c,)):
        raise ValueError(f"masked_group_norm_act_bwd: dy must be {tuple(x.shape)}, "
                         f"mean and inv [{b}, {c}], scale and bias [{c}]")
    if not (x.is_contiguous() and mean.is_contiguous() and inv.is_contiguous()
            and scale.is_contiguous() and bias.is_contiguous()) or x.data_ptr() % 16:
        raise ValueError("masked_group_norm_act_bwd: needs a contiguous, 16-byte aligned x "
                         "and contiguous scale, bias, mean and inv")
    if (lengths.shape != (b,) or lengths.dtype not in (torch.int32, torch.int64)
            or lengths.device != x.device or not lengths.is_contiguous()):
        raise ValueError("masked_group_norm_act_bwd: lengths must be [B], int32 or int64, "
                         "contiguous, on x's device")
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    dx = torch.empty_like(x)
    dscale, dbias = torch.empty(2, c, dtype=torch.float32, device=x.device)
    n_part = b * (-(-t // ROWS_PER_ITEM) + 1) * 2 * c   # per item and per batch row
    scratch = torch.empty(n_part, dtype=torch.float32, device=x.device)
    err = kernel_build.load_library().aas_gn_act_bwd(
        x.data_ptr(), dy.data_ptr(), scale.data_ptr(), bias.data_ptr(), lengths.data_ptr(),
        int(lengths.dtype == torch.int64), mean.data_ptr(), inv.data_ptr(), dx.data_ptr(),
        dscale.data_ptr(), dbias.data_ptr(), scratch.data_ptr(), n_part, b, t, f, c,
        num_groups, ACTS[act], slope, torch.cuda.current_stream(x.device).cuda_stream)
    kernel_build.check(err, "aas_gn_act_bwd (cooperative launch)")
    masked_group_norm_act_bwd.launches += 1
    return dx, dscale, dbias


masked_group_norm_act_bwd.launches = 0


class _GNActFn(torch.autograd.Function):
    """B3 forward and B3' backward, each one cooperative CUDA launch."""

    @staticmethod
    def forward(ctx, x, scale, bias, lengths, num_groups, eps, act, slope):
        y, scratch = gn_kernel(x, scale, bias, lengths, num_groups, eps, act, slope)
        ctx.save_for_backward(x, scale, bias, lengths,
                              *_stats(scratch, x.shape[0], x.shape[3]))
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

    Without a wanted gradient, the operator ``aas_torch::masked_group_norm_act``
    (``ops/library.py``): on the card the kernel (``gn_kernel``, one launch a
    call, counted in ``.launches``), on the CPU ``masked_group_norm_act_plain``.
    With one, on the card ``_GNActFn``, whose backward is
    ``masked_group_norm_act_bwd``, and on the CPU autograd through the plain
    version.
    """
    if x.ndim != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"needs [B, T, F, C] with C % {num_groups} == 0, "
                         f"got {tuple(x.shape)}")
    if act not in ACTS:
        raise ValueError(f"unknown act {act!r}")
    kernel = uses_kernel("masked_group_norm_act", x)
    if kernel:
        lengths = _kernel_lengths(lengths, x)
        scale, bias = scale.contiguous(), bias.contiguous()
    if torch.is_grad_enabled() and any(v.requires_grad for v in (x, scale, bias)):
        if kernel:
            return _GNActFn.apply(x, scale, bias, lengths, num_groups, eps, act, slope)
        return masked_group_norm_act_plain(x, scale, bias, lengths, num_groups=num_groups,
                                           eps=eps, act=act, slope=slope)
    return library.masked_group_norm_act(x, scale, bias, lengths, num_groups, eps, act, slope)


def _kernel_lengths(lengths: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Lengths as the kernel reads them: int32 or int64, on x's device,
    contiguous."""
    if lengths.dtype not in (torch.int32, torch.int64):
        lengths = lengths.to(torch.int64)
    return lengths.to(x.device).contiguous()


masked_group_norm_act.launches = 0
