"""Length-mask utilities (port of ``aas_enhancement_tpu/ops/masking.py``).

Variable-length utterances ride in padded buffers with explicit length
vectors; every op respects them, so outputs on padded frames are zero and
valid frames do not depend on the padding.
"""

from __future__ import annotations

import torch


def time_mask(lengths: torch.Tensor, max_t: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, max_t] {0,1} validity mask."""
    t = torch.arange(max_t, device=lengths.device)[None, :]
    return (t < lengths[:, None]).to(dtype)


def apply_time_mask(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Zero out padded time steps of x: [B, T, ...] with lengths [B]."""
    mask = time_mask(lengths, x.shape[1], x.dtype)
    return x * mask.reshape(mask.shape + (1,) * (x.ndim - 2))


def conv_out_length(lengths: torch.Tensor, kernel: int, stride: int,
                    padding: str = "SAME") -> torch.Tensor:
    """Sequence lengths through a strided conv: ceil(len / stride) for SAME."""
    if padding == "SAME":
        return (lengths + stride - 1) // stride
    return (lengths - kernel) // stride + 1


def masked_normalize(x: torch.Tensor, lengths: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """Per-utterance mean/std normalization of [B, T, F] over VALID frames only,
    with padded frames zeroed.  Two-pass variance, eps inside the sqrt."""
    mask = time_mask(lengths, x.shape[1], x.dtype)[:, :, None]
    count = torch.clamp(mask.sum(dim=(1, 2), keepdim=True) * x.shape[2], min=1.0)
    mean = (x * mask).sum(dim=(1, 2), keepdim=True) / count
    var = (((x - mean) ** 2) * mask).sum(dim=(1, 2), keepdim=True) / count
    return ((x - mean) / torch.sqrt(var + eps)) * mask


def masked_mean(x: torch.Tensor, lengths: torch.Tensor, axis=(1, 2)) -> torch.Tensor:
    """Mean of x [B, T, ...] over valid frames only."""
    mask = time_mask(lengths, x.shape[1], x.dtype)
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    num = (x * mask).sum(dim=axis)
    valid_cells = mask.expand(x.shape).sum(dim=axis)
    return num / torch.clamp(valid_cells, min=1.0)
