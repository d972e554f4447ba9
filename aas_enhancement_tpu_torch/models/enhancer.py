"""Speech-enhancement network (port of ``aas_enhancement_tpu/models/enhancer.py``).

noisy log1p-magnitude [B, T, F] -> 2 x (5x5 conv -> MaskedGroupNorm +
leaky_relu(0.2)) -> 2 x BiLSTM -> Dense(F) -> sigmoid mask ("mask" mode) or
softplus magnitude ("mapping" mode), zeroed on padded frames.

Layout: activations between the convs stay in channels-last memory, so the
NCHW conv output viewed as [B, T, F, C] is contiguous for the GroupNorm
kernel, and the flatten to [B, T, F*C] puts feature f*C + c where the JAX
model's ``reshape(b, t, f*c)`` does (the ``wx`` rows depend on it).

``blockwise_apply`` is the streaming-matched forward of streaming
fine-tuning; ``enhanced_log_mag`` the enhanced features from the output.

``cfg.dtype`` "bfloat16" runs the model as the JAX model does: the
parameters stay float32 and are cast where they are used, the input is cast
at the model's entry, convs, GroupNorms, BiLSTMs and the projection compute
and stream bfloat16, and the projection's output is cast back to float32
before the mask.  It trains at bfloat16 too: the backward streams bfloat16
through the same layers (on the card the GroupNorm's and the BiLSTMs'
backward kernels on bf16 streams), and each parameter's gradient reaches it
as float32 through its cast, as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from aas_enhancement_tpu_torch.config import EnhancerConfig
from aas_enhancement_tpu_torch.ops.conv import DtypeConv2d
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.dispatch import compute_dtype
from aas_enhancement_tpu_torch.ops.masking import apply_time_mask, stream_windows
from aas_enhancement_tpu_torch.ops.norm import MaskedGroupNorm
from aas_enhancement_tpu_torch.ops.rnn import BiRNN


class Enhancer(nn.Module):
    """mode="mask": output is a sigmoid mask in (0, 1); enhanced = mask * noisy_mag.
    mode="mapping": output is a non-negative log1p-magnitude; enhanced = expm1(out).

    Parameters are created uninitialized; ``convert.init_like_flax`` draws
    them, or ``convert.enhancer_params_from_flax`` loads a flax tree.
    """

    def __init__(self, cfg: EnhancerConfig, num_bins: int,
                 device: torch.device | str | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg.dtype)
        c = cfg.conv_channels
        self.convs = nn.ModuleList(
            DtypeConv2d(1 if i == 0 else c, c, kernel_size=5, padding=2, device=device,
                        compute_dtype=dt)
            for i in range(cfg.conv_layers))
        self.gns = nn.ModuleList(
            MaskedGroupNorm(c, num_groups=8, act="leaky_relu", device=device, dtype=dt)
            for _ in range(cfg.conv_layers))
        rnn_in = [num_bins * (c if cfg.conv_layers else 1)] + \
                 [cfg.rnn_hidden] * (cfg.rnn_layers - 1)
        self.blstms = nn.ModuleList(
            BiRNN(d, cfg.rnn_hidden, cell="lstm", device=device, dtype=dt) for d in rnn_in)
        proj_in = cfg.rnn_hidden if cfg.rnn_layers else rnn_in[0]
        self.proj = Dense(proj_in, num_bins, device=device, dtype=dt)

    def forward(self, log_mag: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        b, t, f = log_mag.shape
        x = log_mag.to(self.dtype)[..., None]                    # [B, T, F, 1]
        for conv, gn in zip(self.convs, self.gns):
            x_nchw = x.permute(0, 3, 1, 2)                       # channels-last memory
            y = conv(x_nchw).permute(0, 2, 3, 1).contiguous()    # [B, T, F, C]
            x = gn(y, lengths)
        x = x.reshape(b, t, -1).transpose(0, 1)                  # [T, B, F*C]
        for rnn in self.blstms:
            x = rnn(x, lengths)
        out = self.proj(x.transpose(0, 1)).float()               # [B, T, F]
        out = torch.sigmoid(out) if self.cfg.mode == "mask" else F.softplus(out)
        return apply_time_mask(out, lengths)


def blockwise_apply(model: Enhancer, net_in: torch.Tensor, lengths: torch.Tensor,
                    chunk_f: int, look_f: int, hist_f: int) -> torch.Tensor:
    """The streaming-matched enhancer forward (JAX ``blockwise_apply``): windows
    of [history | chunk | lookahead] frames (``ops/masking.py::stream_windows``),
    all of them in ONE ``model`` call over [B * nb, W, F], and only each
    window's chunk kept, re-stitched to [B, T, F] and zeroed past ``lengths``.
    The BiLSTM's forward state is warm across ``hist_f`` frames only and its
    backward direction sees ``look_f`` future frames, as in
    ``streaming.StreamingEnhancer``; training through it
    (``TrainConfig.streaming_finetune``) fits G to chunked inference.  Unlike
    live inference the input is normalized with the whole utterance's moments
    and the blocks are frame-aligned.  A ragged batch's trailing windows have
    length 0."""
    b, t, _ = net_in.shape
    blocks, blk_len, nb = stream_windows(net_in, lengths, chunk_f, look_f, hist_f)
    out = model(blocks, blk_len)
    out = out.reshape(b, nb, blocks.shape[1], -1)[:, :, hist_f: hist_f + chunk_f]
    return apply_time_mask(out.reshape(b, nb * chunk_f, -1)[:, :t], lengths)


def apply_enhancement(cfg: EnhancerConfig, out: torch.Tensor,
                      noisy_mag: torch.Tensor) -> torch.Tensor:
    """Combine the network output with the noisy magnitude -> enhanced magnitude."""
    if cfg.mode == "mask":
        return out * noisy_mag
    return torch.expm1(out)


def enhanced_log_mag(cfg: EnhancerConfig, out: torch.Tensor,
                     noisy_log_mag_raw: torch.Tensor) -> torch.Tensor:
    """The enhanced log1p-magnitude (what the AM and the discriminator read)
    from the network output and the UNNORMALIZED noisy log1p-magnitude."""
    if cfg.mode == "mask":
        return torch.log1p(out * torch.expm1(noisy_log_mag_raw))
    return out
