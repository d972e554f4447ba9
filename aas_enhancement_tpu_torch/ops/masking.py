"""Length-mask utilities (port of ``aas_enhancement_tpu/ops/masking.py``).

Variable-length utterances ride in padded buffers with explicit length
vectors; every op respects them, so outputs on padded frames are zero and
valid frames do not depend on the padding.  The streaming paths' helpers
live here too: ``window_stats`` and ``running_normalize`` (the running
moments of ``enhance.py``'s and ``streaming_asr.py``'s streaming forwards,
JAX ``enhance.py:72`` and ``streaming_asr.py::_window_stats``) and
``stream_windows`` (the windows of the blockwise forwards, JAX
``models/enhancer.py::blockwise_apply``).
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


def window_stats(x: torch.Tensor, valid: torch.Tensor, stats_start, stats_end
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Moments of [B, T, F] x over the valid frames t with stats_start <= t <
    stats_end -> ([B] sum, sum of squares, count of cells).  The window bounds
    are scalars (broadcast) or [B] tensors (one window a row)."""
    t_idx = torch.arange(x.shape[1], device=x.device)[None, :]
    ss = torch.as_tensor(stats_start, device=x.device).reshape(-1, 1)
    se = torch.as_tensor(stats_end, device=x.device).reshape(-1, 1)
    new = valid * (t_idx >= ss) * (t_idx < se)
    new_f = new[:, :, None]
    return ((x * new_f).sum(dim=(1, 2)), ((x ** 2) * new_f).sum(dim=(1, 2)),
            new.sum(dim=1) * x.shape[2])


def running_normalize(x: torch.Tensor, valid: torch.Tensor, inc, run) -> torch.Tensor:
    """Normalize [B, T, F] x with the running moments ``run`` (sum, sum of
    squares, count; [B] each or scalars) plus this block's ``inc``, padded
    frames zeroed: var = max(E[x^2] - mean^2, 0), eps 1e-5 inside the sqrt."""
    tot = torch.clamp(run[2] + inc[2], min=1.0)
    mean = (run[0] + inc[0]) / tot
    var = torch.clamp((run[1] + inc[1]) / tot - mean ** 2, min=0.0)
    return ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
            ) * valid[:, :, None]


def stream_windows(x: torch.Tensor, lengths: torch.Tensor, chunk_f: int, look_f: int,
                   hist_f: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """[B, T, F] x -> (windows [B * nb, W, F], their valid lengths [B * nb],
    nb): nb = ceil(T / chunk_f) windows a row of W = hist_f + chunk_f +
    look_f frames, window k holding frames k * chunk_f - hist_f + j, zeros
    outside [0, T), gathered with one index tensor.  A window's length counts
    the frames before the row's end, block 0's leading zero history included
    (the stream-start buffer is silence too), clipped to [0, W]."""
    b, t, f = x.shape
    nb = -(-t // chunk_f)
    window = hist_f + chunk_f + look_f
    padded = torch.nn.functional.pad(x, (0, 0, hist_f, nb * chunk_f - t + look_f))
    starts = torch.arange(nb, device=x.device) * chunk_f
    idx = starts[:, None] + torch.arange(window, device=x.device)[None, :]
    blocks = padded[:, idx, :].reshape(b * nb, window, f)
    blk_len = torch.clamp(lengths.to(torch.int64)[:, None] - (starts[None, :] - hist_f),
                          0, window)
    return blocks, blk_len.reshape(b * nb), nb


def masked_mean(x: torch.Tensor, lengths: torch.Tensor, axis=(1, 2)) -> torch.Tensor:
    """Mean of x [B, T, ...] over valid frames only."""
    mask = time_mask(lengths, x.shape[1], x.dtype)
    mask = mask.reshape(mask.shape + (1,) * (x.ndim - 2))
    num = (x * mask).sum(dim=axis)
    valid_cells = mask.expand(x.shape).sum(dim=axis)
    return num / torch.clamp(valid_cells, min=1.0)


def draw_stripes(gen: torch.Generator, n: int, max_width: int, limit: torch.Tensor,
                 rows: tuple[int, int] | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` stripes per row, each of width <= ``max_width`` and placed inside
    [0, limit_b): -> (width, start), int64 [B, n] on ``limit``'s device.

    The random numbers come from ``gen`` on the CPU; only they cross to the
    device, so a CUDA ``limit`` costs no host sync.  The rule is the JAX
    ``spec_augment``'s (width uniform on 0..max_width, start = floor(u *
    max(limit - width, 1))); the stream is torch's, not ``jax.random``'s.
    ``rows`` = (total, offset): draw for ``total`` rows and keep rows
    offset..offset+B, the stripes a run over all ``total`` rows gives these
    (a rank of a data-parallel run holds such a block)."""
    b = limit.shape[0]
    total, off = rows if rows is not None else (b, 0)
    width = torch.randint(0, max_width + 1, (total, n), generator=gen)[off:off + b]
    u = torch.rand((total, n), generator=gen)[off:off + b]
    width, u = width.to(limit.device), u.to(limit.device)
    hi = torch.clamp(limit[:, None] - width, min=1).to(torch.float32)
    return width, torch.floor(u * hi).to(torch.int64)


def stripe_keep(width: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """[B, n] stripes -> [B, size] bool keep mask, False inside any stripe."""
    pos = torch.arange(size, device=width.device)[None, None, :]
    inside = (pos >= start[..., None]) & (pos < (start + width)[..., None])
    return ~inside.any(dim=1)


def apply_spec_augment(x: torch.Tensor, time_stripes: tuple[torch.Tensor, torch.Tensor],
                       freq_stripes: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Zero the given (width, start) time and frequency stripes of x [B, T, F]."""
    keep_t = stripe_keep(*time_stripes, x.shape[1]).to(x.dtype)
    keep_f = stripe_keep(*freq_stripes, x.shape[2]).to(x.dtype)
    return x * keep_t[:, :, None] * keep_f[:, None, :]


def spec_augment(gen: torch.Generator, x: torch.Tensor, lengths: torch.Tensor,
                 n_time: int = 2, time_width: int = 30, n_freq: int = 2,
                 freq_width: int = 13, rows: tuple[int, int] | None = None) -> torch.Tensor:
    """SpecAugment-style masking of [B, T, F] features (Park et al. 2019): per
    utterance ``n_time`` time stripes of width <= ``time_width`` inside the
    valid frames and ``n_freq`` frequency stripes of width <= ``freq_width``
    are zeroed (after per-utterance normalization zero is the feature mean).
    Time stripes are drawn first, then frequency stripes; ``rows`` as in
    ``draw_stripes``."""
    time_stripes = draw_stripes(gen, n_time, time_width, lengths, rows)
    freq_stripes = draw_stripes(gen, n_freq, freq_width,
                                torch.full_like(lengths, x.shape[2]), rows)
    return apply_spec_augment(x, time_stripes, freq_stripes)
