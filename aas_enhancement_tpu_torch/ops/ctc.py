"""CTC loss: the log-space forward (alpha) recursion (port of
``aas_enhancement_tpu/ops/ctc.py``).

The JAX package runs the recursion as a ``lax.scan`` and takes its gradient
by autodiff; here it is a Python loop over frames and autograd does the same
(reverse-mode AD of the alpha recursion is the alpha-beta gradient).  Not a
Pallas kernel, so plain torch is the port.

  ctc_loss(logits [B, T, V], logit_paddings [B, T], labels [B, U],
           label_paddings [B, U]) -> per-example negative log likelihood [B]

with blank id 0.  Unreachable states hold -1e30, not -inf, so an infeasible
alignment gives a huge finite loss and finite gradients, as in JAX
(``F.ctc_loss`` gives inf there, so it is not a drop-in port).  Padded frames
freeze alpha.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _logsumexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    # All inputs are finite (unreachable states carry _NEG_INF, not -inf), so the
    # max-shifted form is NaN-free in both value and gradient.
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def _shift_right(x: torch.Tensor, fill: float = _NEG_INF, n: int = 1) -> torch.Tensor:
    pad = torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-n]], dim=-1)


def ctc_loss(logits: torch.Tensor, logit_paddings: torch.Tensor,
             labels: torch.Tensor, label_paddings: torch.Tensor,
             blank_id: int = 0) -> torch.Tensor:
    """Per-example CTC negative log likelihood.

    logits: [B, T, V] unnormalized; logit_paddings: [B, T] (1.0 = padded frame);
    labels: [B, U] int ids (padded entries arbitrary); label_paddings: [B, U].
    """
    b, t, v = logits.shape
    u = labels.shape[1]
    s = 2 * u + 1
    dev = logits.device

    log_probs = torch.log_softmax(logits.to(torch.float32), dim=-1)

    # Extended label sequence z: [blank, l1, blank, l2, ..., lU, blank], [B, S].
    z = torch.full((b, s), blank_id, dtype=torch.int64, device=dev)
    z[:, 1::2] = labels.to(torch.int64)

    label_lens = (1.0 - label_paddings.to(torch.float32)).sum(dim=1).to(torch.int64)
    s_valid = 2 * label_lens + 1                                          # [B]
    pos = torch.arange(s, device=dev)[None, :]
    z_mask = pos < s_valid[:, None]                                       # [B, S]

    # The skip (s-2) transition: z_s is not blank AND z_s != z_{s-2}.
    z_prev2 = _shift_right(z.to(torch.float32), fill=-1.0, n=2).to(torch.int64)
    can_skip = (z != blank_id) & (z != z_prev2) & (pos >= 2)

    # Per-step log-probs of the extended labels (the JAX package's one-hot
    # product, as an exact gather).
    lp_seq = torch.gather(log_probs, 2, z[:, None, :].expand(b, t, s))   # [B, T, S]

    # alpha_0: only s=0 (blank) and s=1 (first label) are reachable.
    lp0 = lp_seq[:, 0, :]
    neg = torch.full_like(lp0, _NEG_INF)
    alpha = torch.where(pos == 0, lp0, neg)
    alpha = torch.where((pos == 1) & (s_valid[:, None] > 1), lp0, alpha)
    alpha = torch.where(z_mask, alpha, neg)

    padded = logit_paddings.to(torch.float32) > 0                         # [B, T]
    for i in range(1, t):
        diag = _shift_right(alpha, n=1)
        skip = torch.where(can_skip, _shift_right(alpha, n=2), neg)
        new = _logsumexp3(alpha, diag, skip) + lp_seq[:, i]
        new = torch.where(z_mask, new, neg)
        alpha = torch.where(padded[:, i, None], alpha, new)               # frozen

    # Loss = -logsumexp(alpha[S-1], alpha[S-2]) at each sample's valid S.
    idx_last = torch.clamp(s_valid - 1, min=0)
    idx_prev = torch.clamp(s_valid - 2, min=0)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev[:, None])[:, 0]
    a_prev = torch.where(s_valid >= 2, a_prev, torch.full_like(a_prev, _NEG_INF))
    m = torch.maximum(a_last, a_prev)
    return -(m + torch.log(torch.exp(a_last - m) + torch.exp(a_prev - m)))


def ctc_loss_mean(logits: torch.Tensor, logit_paddings: torch.Tensor,
                  labels: torch.Tensor, label_paddings: torch.Tensor,
                  blank_id: int = 0, weights: torch.Tensor | None = None,
                  denom: torch.Tensor | float | None = None) -> torch.Tensor:
    """Batch-mean CTC loss (the training objective's scalar).

    weights: optional [B] per-example weights (0 for repeat-padded rows, so
    they carry no gradient); denom: optional fixed denominator replacing
    sum(weights), which gradient accumulation passes (``train/steps.py``)."""
    per_ex = ctc_loss(logits, logit_paddings, labels, label_paddings, blank_id)
    if weights is None and denom is None:
        return per_ex.mean()
    w = (torch.ones_like(per_ex) if weights is None
         else weights.to(per_ex.dtype))
    d = w.sum() if denom is None else torch.as_tensor(denom, dtype=per_ex.dtype,
                                                      device=per_ex.device)
    return (per_ex * w).sum() / torch.clamp(d, min=1e-6)
