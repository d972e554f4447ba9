"""Greedy CTC decoding on the logits' device (port of
``aas_enhancement_tpu/decode/greedy.py``).

Argmax, collapse repeats, drop blanks.  The device side emits a dense [B, T]
id matrix plus counts; strings are built on the host.  ``torch.argmax`` and
``jnp.argmax`` both take the first maximum, so ties resolve alike.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from aas_enhancement_tpu_torch.labels import BLANK_ID, LABELS


def greedy_decode(logits: torch.Tensor, logit_paddings: torch.Tensor,
                  blank_id: int = BLANK_ID) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, T, V] logits -> (ids [B, T] left-packed with -1 padding, counts [B]).

    Keep position t iff argmax[t] != blank and argmax[t] != argmax[t-1], over
    non-padded frames only.
    """
    am = torch.argmax(logits, dim=-1)                          # [B, T]
    b, t = am.shape
    valid = logit_paddings < 0.5
    prev = F.pad(am[:, :-1], (1, 0), value=-1)
    keep = valid & (am != blank_id) & (am != prev)
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1       # left-packed slot
    counts = keep.sum(dim=1)
    # Dropped positions scatter into a spare column t that is cut off.
    out = torch.full((b, t + 1), -1, dtype=am.dtype, device=am.device)
    out.scatter_(1, torch.where(keep, dest, t), am)
    return out[:, :t], counts


def ids_to_strings(ids: np.ndarray, counts: np.ndarray,
                   labels: str = LABELS) -> list[str]:
    out = []
    for row, n in zip(np.asarray(ids), np.asarray(counts)):
        out.append("".join(labels[int(i)] for i in row[: int(n)] if int(i) >= 0))
    return out


def decode_batch(logits: torch.Tensor, logit_paddings: torch.Tensor,
                 labels: str = LABELS) -> list[str]:
    ids, counts = greedy_decode(logits, logit_paddings)
    return ids_to_strings(ids.cpu().numpy(), counts.cpu().numpy(), labels)
