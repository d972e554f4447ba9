"""Batched CTC prefix beam search on the device (port of
``aas_enhancement_tpu/decode/device_beam.py``).

The JAX package decodes a batch in one ``lax.scan`` over frames; here a
Python loop over frames runs one fixed-shape step of PyTorch tensor code on
the card (or the CPU), with an explicit batch dimension where JAX has
``vmap``.  The algebra is the JAX function's, step by step:

- Beams are a fixed width-W tensor; dead slots carry -inf scores and
  per-slot sentinel hashes.
- A step's candidates are the dense [W, V] grid: column ``blank`` is "stay"
  (the same prefix: blank path + repeated last symbol), every other column
  "extend the prefix with c" (from p_b when c repeats the last symbol, else
  from the total).
- Equal prefixes merge: each beam carries two independent 32-bit rolling
  hashes of its prefix, the candidates are sorted by the hash pair (stable,
  unsigned), equal runs are merged by a segmented inclusive log-sum-exp scan,
  and each run's last element is its representative; a stable descending
  sort then keeps W (the lower index first among ties, as ``lax.top_k``).
- Char n-gram fusion gathers the dense table's row of each beam's base-V
  context index (``decode/lm.py::context_index``), updated in O(1) per
  extension.  Word and hybrid fusion stay on the host (``decode/beam.py``).
- Frames past a row's length leave it unchanged.

The uint32 arithmetic of the hashes runs in int64 masked to 32 bits after
every step, with each product split into 16-bit halves so that no product
exceeds 2^49 (``torch.uint32`` has little CUDA coverage).  Scores accumulate
in float32, so they agree with the JAX function's to float32 rounding; ids
and lengths agree exactly on non-degenerate inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from aas_enhancement_tpu_torch.labels import BLANK_ID, LABELS
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device

_M32 = 0xFFFFFFFF
NEG = float("-inf")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix1(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Rolling hash chain 1: h' = finalize(h ^ (c+1)) in uint32."""
    x = _mul32(h ^ ((c + 1) & _M32), 0x9E3779B1)
    x = _mul32(x ^ (x >> 15), 0x85EBCA6B)
    return x ^ (x >> 13)


def _mix2(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Independent chain 2 (other constants: the pair acts as a 64-bit key)."""
    x = _mul32(h ^ ((c + 0x61C88647) & _M32), 0xC2B2AE35)
    x = _mul32(x ^ (x >> 16), 0x27D4EB2F)
    return x ^ (x >> 11)


def _slot_sentinels(w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Distinct per-slot hash pairs for dead beams (live hashes start from
    slot 0's constants and evolve only through _mix1 / _mix2)."""
    i = torch.arange(1, w + 1, dtype=torch.int64, device=device)
    return _mul32(i, 0x51ED2701), _mul32(i, 0x6A09E667)


def _seg_lse(flags: torch.Tensor, vals: torch.Tensor, longest: int) -> torch.Tensor:
    """Segmented inclusive log-sum-exp scan along the last axis: segments
    start where ``flags`` is True, and the LAST element of a segment holds
    the whole segment's reduction (``lax.associative_scan`` of the JAX
    function's operator, here by doubling).  ``longest`` bounds the segments'
    length: ceil(log2(longest)) doubling steps complete the scan."""
    d = 1
    while d < longest:
        fa, va = flags[..., :-d], vals[..., :-d]
        fb, vb = flags[..., d:], vals[..., d:]
        vals = torch.cat([vals[..., :d], torch.where(fb, vb, torch.logaddexp(va, vb))], -1)
        flags = torch.cat([flags[..., :d], fa | fb], -1)
        d *= 2
    return vals


def _decode(lp: torch.Tensor, lengths: torch.Tensor, beam_width: int, blank: int,
            prune_k: int, table: torch.Tensor | None, alpha: float, beta: float):
    """lp [B, T, V] f32, lengths [B] int64 (host) -> ids [B, T] int32, lens
    [B] int32, scores [B] f32, on lp's device."""
    b, t_max, v = lp.shape
    dev = lp.device
    w = beam_width
    k = w * v
    sent1, sent2 = _slot_sentinels(w, dev)
    csym = torch.arange(v, dtype=torch.int64, device=dev)
    is_blank_col = csym == blank                                    # [V]
    iota_t = torch.arange(t_max, dtype=torch.int64, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    first = torch.ones((b, 1), dtype=torch.bool, device=dev)
    n_ctx = 1 if table is None else table.shape[0]
    if table is not None:
        alpha_t = torch.tensor(alpha, dtype=torch.float32, device=dev)
        beta_t = torch.tensor(beta, dtype=torch.float32, device=dev)

    pb = torch.full((b, w), NEG, device=dev)
    pb[:, 0] = 0.0
    pnb = torch.full((b, w), NEG, device=dev)
    h1 = sent1.repeat(b, 1)
    h1[:, 0] = 0x243F6A88
    h2 = sent2.repeat(b, 1)
    h2[:, 0] = 0x85A308D3
    last = torch.full((b, w), -1, dtype=torch.int64, device=dev)
    ctx = torch.zeros((b, w), dtype=torch.int64, device=dev)
    lens = torch.zeros((b, w), dtype=torch.int64, device=dev)
    pref = torch.zeros((b, w, t_max), dtype=torch.int64, device=dev)

    lengths = lengths.tolist()
    live_rows = torch.tensor(lengths, device=dev)
    for t in range(min(max(lengths, default=0), t_max)):
        lp_t = lp[:, t]                                             # [B, V]
        total = torch.logaddexp(pb, pnb)                            # [B, W]
        if 0 < prune_k < v:
            thresh = torch.topk(lp_t, prune_k, dim=-1).values[:, -1:]
            pmask = lp_t >= thresh                                  # [B, V]
        else:
            pmask = torch.ones_like(lp_t, dtype=torch.bool)

        is_rep = csym == last[..., None]                            # [B, W, V]
        ext_base = torch.where(is_rep, pb[..., None], total[..., None])
        pnb_ext = ext_base + lp_t[:, None, :]
        if table is not None:
            pnb_ext = pnb_ext + (alpha_t * table[ctx] + beta_t)
        pnb_ext.masked_fill_(is_blank_col | ~pmask[:, None, :], NEG)
        last_c = last.clamp(min=0)
        rep_ok = (last >= 0) & pmask.gather(1, last_c)
        pnb_stay = torch.where(rep_ok, pnb + lp_t.gather(1, last_c), NEG)   # [B, W]
        pb_stay = total + lp_t[:, blank, None]
        pb_cand = torch.where(is_blank_col, pb_stay[..., None], NEG)
        pnb_cand = torch.where(is_blank_col, pnb_stay[..., None], pnb_ext)
        h1_cand = torch.where(is_blank_col, h1[..., None], _mix1(h1[..., None], csym))
        h2_cand = torch.where(is_blank_col, h2[..., None], _mix2(h2[..., None], csym))

        # Merge equal prefixes across the flattened grid: a stable sort by
        # the unsigned hash pair (h1 major), as jnp.lexsort((h2, h1)).
        key = (h1_cand.reshape(b, k) - 0x80000000) * 0x100000000 + h2_cand.reshape(b, k)
        skey, order = torch.sort(key, dim=-1, stable=True)
        spb = pb_cand.reshape(b, k).gather(1, order)
        spnb = pnb_cand.reshape(b, k).gather(1, order)
        same = skey[:, 1:] == skey[:, :-1]
        boundary = torch.cat([first, ~same], 1)
        # A prefix is at most two candidates (its own stay and its parent's
        # extension), so one doubling step completes the scan unless a hash
        # collision made a longer run.
        longest = 2 if not bool((same[:, 1:] & same[:, :-1]).any()) else k
        seg = _seg_lse(boundary, torch.stack([spb, spnb]), longest)
        seg_pb, seg_pnb = seg[0], seg[1]
        rep = torch.cat([boundary[:, 1:], first], 1)
        tot = torch.where(rep, torch.logaddexp(seg_pb, seg_pnb), NEG)

        vals, idx = torch.sort(tot, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :w], idx[:, :w]                         # lax.top_k
        orig = order.gather(1, idx)
        src, sym = orig // v, orig % v
        is_ext = sym != blank
        n_pb, n_pnb = seg_pb.gather(1, idx), seg_pnb.gather(1, idx)
        n_h1 = h1_cand.reshape(b, k).gather(1, orig)     # the extension's hash
        n_h2 = h2_cand.reshape(b, k).gather(1, orig)
        n_last = torch.where(is_ext, sym, last.gather(1, src))
        ctx_s = ctx.gather(1, src)
        n_ctx_v = torch.where(is_ext, (ctx_s * v + sym) % n_ctx, ctx_s)
        src_len = lens.gather(1, src)
        n_len = src_len + is_ext.long()
        n_pref = torch.where(is_ext[..., None] & (iota_t == src_len[..., None]),
                             sym[..., None], pref[rows, src])

        # Dead slots (nothing reached them): per-slot sentinel identity.
        dead = torch.isneginf(vals)
        n_h1 = torch.where(dead, sent1, n_h1)
        n_h2 = torch.where(dead, sent2, n_h2)
        n_last.masked_fill_(dead, -1)
        n_ctx_v.masked_fill_(dead, 0)
        n_len.masked_fill_(dead, 0)

        new = (n_pb, n_pnb, n_h1, n_h2, n_last, n_ctx_v, n_len, n_pref)
        if t >= min(lengths):
            # Frames past a row's length are identity.
            live = (t < live_rows)[:, None]
            new = tuple(torch.where(live[..., None] if x.dim() == 3 else live, x, y)
                        for x, y in zip(new, (pb, pnb, h1, h2, last, ctx, lens, pref)))
        pb, pnb, h1, h2, last, ctx, lens, pref = new

    total = torch.logaddexp(pb, pnb)
    best = total.argmax(dim=1, keepdim=True)                       # first max, as jnp
    ids = pref[rows, best].squeeze(1)
    return (ids.to(torch.int32), lens.gather(1, best)[:, 0].to(torch.int32),
            total.gather(1, best)[:, 0])


def _inputs(log_probs, lengths, device):
    """-> lp [B, T, V] f32 on the device, lengths [B] int64 on the host."""
    if device is None:
        device = log_probs.device if isinstance(log_probs, torch.Tensor) else "cuda"
    device = resolve_device(device)
    lp = torch.as_tensor(log_probs, dtype=torch.float32).to(device)
    if lp.dim() == 2:
        lp = lp[None]
    if lengths is None:
        return lp, torch.full(lp.shape[:1], lp.shape[1], dtype=torch.int64)
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu()
    return lp, torch.as_tensor(np.asarray(lengths), dtype=torch.int64)


def _table(lp: torch.Tensor, lm_table, lm_order: int, lm_alpha: float) -> torch.Tensor | None:
    """The dense char-LM table [V^(order-1), V] on lp's device, or None
    without fusion."""
    if lm_table is None or lm_alpha == 0.0:
        return None
    v = lp.shape[-1]
    table = torch.as_tensor(np.asarray(lm_table, np.float32)).reshape(-1, v).to(lp.device)
    if table.shape[0] != v ** max(lm_order - 1, 0):
        raise ValueError(f"LM table has {table.shape[0]} contexts, expected "
                         f"{v}^{lm_order - 1} for vocab {v}")
    return table


@torch.inference_mode()
def device_beam_decode(log_probs, lengths=None, beam_width: int = 32,
                       blank: int = BLANK_ID, prune_k: int = 16,
                       lm_table: np.ndarray | None = None, lm_order: int = 0,
                       lm_alpha: float = 0.0, lm_beta: float = 0.0,
                       labels: str = LABELS, device=None) -> list[str]:
    """Batch [B, T, V] log-probs (+ valid lengths) -> decoded strings, on the
    device: ``device``, else a tensor's own device, else the card.  Char-LM
    fusion only (``lm_table`` = dense [V^(order-1), V] table,
    ``decode/lm.py::CharNGramLM.dense_table``); for word or hybrid fusion use
    the host decoders (``decode/beam.py``)."""
    lp, lens = _inputs(log_probs, lengths, device)
    table = _table(lp, lm_table, lm_order, lm_alpha)
    ids, out_lens, _ = _decode(lp, lens, beam_width, blank, prune_k, table,
                               lm_alpha, lm_beta)
    ids, out_lens = ids.cpu().numpy(), out_lens.cpu().numpy()
    return ["".join(labels[i] for i in ids[r, : out_lens[r]]) for r in range(len(ids))]


@torch.inference_mode()
def device_beam_decode_raw(log_probs, lengths=None, beam_width: int = 32,
                           blank: int = BLANK_ID, prune_k: int = 16,
                           lm_table=None, lm_order: int = 0,
                           lm_alpha: float = 0.0, lm_beta: float = 0.0, device=None):
    """Like ``device_beam_decode`` but -> (ids [B, T] int32, lens [B] int32,
    scores [B] f32) numpy arrays: the parity-test and timing interface."""
    lp, lens = _inputs(log_probs, lengths, device)
    table = _table(lp, lm_table, lm_order, lm_alpha)
    ids, out_lens, scores = _decode(lp, lens, beam_width, blank, prune_k, table,
                                    lm_alpha, lm_beta)
    return ids.cpu().numpy(), out_lens.cpu().numpy(), scores.cpu().numpy()
