"""DeepSpeech2-style CTC acoustic model (port of ``aas_enhancement_tpu/models/am.py``).

log1p-magnitude [B, T, F] + lengths -> 11x41 conv, stride (2, 2) ->
MaskedGroupNorm + hardtanh(0, 20) -> 11x21 conv, stride (1, 2) ->
MaskedGroupNorm + hardtanh -> rnn_layers x BiGRU (sum of directions) ->
Dense(vocab) -> logits, zeroed on padded frames.  T' = ceil(T / 2) and
F: 161 -> 81 -> 41, so the first RNN reads 41 * C features.

Layout as in ``models/enhancer.py``: the GroupNorm output [B, T, F, C] stays
contiguous and is viewed as NCHW with channels-last memory for the next conv,
and the flatten to [B, T, F*C] puts feature f*C + c where the JAX model's
``reshape(b, t, f*ch)`` does (the first ``wx``'s rows depend on it).
``am_blockwise_apply`` is the streaming-matched forward of
``TrainConfig.streaming_finetune_am``.

conv2 is a ``TapDWConv`` with ``dw_impl="auto"``: when the AM is trained on a
CUDA device its weight gradient comes from the hand-written kernel
(``ops/cuda/conv_dw.py``), once per microbatch; a frozen AM (AAS training)
and inference never compute it.  The JAX model passes ``dw_impl="xla"``
there because its Pallas kernel measured slower than XLA on a TPU v5e; that
timing says nothing about this card, so the port keeps the module's own
default and records the kernel's time beside cuDNN's (PERF.md).
"""

from __future__ import annotations

import torch
from torch import nn

from aas_enhancement_tpu_torch.config import AMConfig
from aas_enhancement_tpu_torch.ops.conv import SameConv2d, TapDWConv
from aas_enhancement_tpu_torch.ops.dense import Dense
from aas_enhancement_tpu_torch.ops.masking import (apply_time_mask, conv_out_length,
                                                   stream_windows)
from aas_enhancement_tpu_torch.ops.norm import MaskedGroupNorm
from aas_enhancement_tpu_torch.ops.rnn import BiRNN


class AcousticModel(nn.Module):
    """-> (logits [B, ceil(T/2), vocab], out_lengths [B]).

    Parameters are created uninitialized; ``convert.init_like_flax`` draws
    them, or ``convert.am_params_from_flax`` loads a flax tree.
    """

    def __init__(self, cfg: AMConfig, num_bins: int,
                 device: torch.device | str | None = None):
        super().__init__()
        if cfg.dtype != "float32":
            raise NotImplementedError(f"dtype {cfg.dtype}: only float32 is ported")
        self.cfg = cfg
        c = cfg.conv_channels
        self.conv1 = SameConv2d(1, c, (11, 41), (2, 2), device=device)
        self.gn1 = MaskedGroupNorm(c, num_groups=8, act="hardtanh", device=device)
        self.conv2 = TapDWConv(c, c, (11, 21), (1, 2), dw_impl="auto", device=device)
        self.gn2 = MaskedGroupNorm(c, num_groups=8, act="hardtanh", device=device)
        f_out = -(-num_bins // 2)            # conv1 halves F (SAME, ceil) ...
        f_out = -(-f_out // 2)               # ... and so does conv2
        rnn_in = [f_out * c] + [cfg.rnn_hidden] * (cfg.rnn_layers - 1)
        self.rnns = nn.ModuleList(
            BiRNN(d, cfg.rnn_hidden, cell=cfg.rnn_type, device=device)
            for d in rnn_in[:cfg.rnn_layers])
        self.fc = Dense(cfg.rnn_hidden if cfg.rnn_layers else rnn_in[0],
                        cfg.vocab_size, device=device)

    def forward(self, log_mag: torch.Tensor, lengths: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        x = log_mag.to(torch.float32)[:, None]                    # [B, 1, T, F]
        out_lengths = conv_out_length(lengths, 11, 2, "SAME")
        for conv, gn in ((self.conv1, self.gn1), (self.conv2, self.gn2)):
            y = conv(x).permute(0, 2, 3, 1).contiguous()          # [B, T', F', C]
            x = gn(y, out_lengths).permute(0, 3, 1, 2)            # channels-last NCHW
        b, _, t, _ = x.shape
        x = x.permute(0, 2, 3, 1).reshape(b, t, -1).transpose(0, 1)   # [T', B, F'*C]
        for rnn in self.rnns:
            x = rnn(x, out_lengths)
        logits = self.fc(x.transpose(0, 1))                       # [B, T', V]
        return apply_time_mask(logits, out_lengths), out_lengths


def am_blockwise_apply(model: AcousticModel, am_in: torch.Tensor, lengths: torch.Tensor,
                       chunk_f: int, look_f: int, hist_f: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The streaming-matched AM forward (JAX ``am_blockwise_apply``): windows of
    [history | chunk | lookahead] input frames in ONE ``model`` call, and of
    each window only the chunk's AM frames [hist_f / 2, (hist_f + chunk_f) / 2)
    kept.  AM frame j centers on input frame 2j (conv1's time stride 2,
    SAME), so these are exactly the chunk's absolute AM frames when
    ``chunk_f`` and ``hist_f`` are even; block 0's zero history is the
    stream-start buffer.  Mirrors ``streaming_asr.StreamingRecognizer``, but
    normalized with the whole utterance's moments and with the last chunk's
    zero-padded lookahead for the flush block.

    -> (logits [B, ceil(T / 2), V] on the offline frame grid, out_lengths
    [B]), which CTC and greedy decoding read like the offline forward's."""
    if chunk_f % 2 or hist_f % 2:
        raise ValueError(
            f"chunk_f ({chunk_f}) and hist_f ({hist_f}) must be EVEN input "
            f"frames for exact AM frame stitching (conv1 time stride 2)")
    b, t, _ = am_in.shape
    blocks, blk_len, nb = stream_windows(am_in, lengths, chunk_f, look_f, hist_f)
    logits, _ = model(blocks, blk_len)
    h_am, c_am = hist_f // 2, chunk_f // 2
    v = logits.shape[-1]
    logits = logits.reshape(b, nb, -1, v)[:, :, h_am: h_am + c_am]
    out_lengths = conv_out_length(lengths, 11, 2, "SAME")
    logits = logits.reshape(b, nb * c_am, v)[:, :-(-t // 2)]
    return apply_time_mask(logits, out_lengths), out_lengths
