"""Character and word n-gram language models for CTC beam-search shallow
fusion (copy of ``aas_enhancement_tpu/decode/lm.py``, held to it by
``tests/test_torch_lm.py``: the same texts give the same tables and files).

The stand-ins for a KenLM word LM are n-gram LMs trained from the training
manifests, with the decoder-side interface of one (alpha = LM weight, beta =
insertion bonus).

The scorer is exported as a DENSE table logp[ctx, c] of shape [V^(order-1), V]
(stupid-backoff smoothing baked in at build time).  With the 29-char CTC vocab
this is 24 KB at order 3 and 2.8 MB at order 4 — small enough to hand to the
native C++ decoder as a flat float array, which keeps the hot decode loop
branch-free (one table lookup per beam extension).

Context indexing (shared contract with native/ctc_beam/ctc_beam.cc): the context
is the last (order-1) symbol ids, big-endian (oldest id in the highest digit):
    ctx = ((... (id_oldest) * V + ...) * V + id_newest)
padded at BOS with the blank id 0 — blank never appears inside a decoded prefix,
so 0 unambiguously means "sentence start" here.
"""

from __future__ import annotations

import json
import math

import numpy as np

from aas_enhancement_tpu_torch.labels import LABELS, encode

_BACKOFF = math.log(0.4)   # stupid backoff penalty per order dropped


class CharNGramLM:
    """Char n-gram LM with stupid-backoff, dense-table export."""

    def __init__(self, order: int = 3, labels: str = LABELS):
        if order < 1:
            raise ValueError("order must be >= 1")
        self.order = order
        self.labels = labels
        # counts[m] maps context-tuple (length m) -> np.array[V] of counts.
        self.counts: list[dict[tuple, np.ndarray]] = [
            {} for _ in range(order)]
        self._table: np.ndarray | None = None

    # ------------------------------------------------------------- training
    def fit_texts(self, texts) -> "CharNGramLM":
        v = len(self.labels)
        for text in texts:
            ids = encode(text, self.labels)
            if not ids:
                continue
            # BOS padding with blank id 0 (see module docstring).
            padded = [0] * (self.order - 1) + ids
            for t in range(self.order - 1, len(padded)):
                c = padded[t]
                for m in range(self.order):
                    ctx = tuple(padded[t - m: t])
                    row = self.counts[m].get(ctx)
                    if row is None:
                        row = self.counts[m][ctx] = np.zeros(v, np.int64)
                    row[c] += 1
        self._table = None
        return self

    @classmethod
    def from_manifests(cls, manifest_paths, order: int = 3,
                       labels: str = LABELS) -> "CharNGramLM":
        from aas_enhancement_tpu_torch.data.manifest import read_manifest, read_transcript
        texts = []
        for path in ([manifest_paths] if isinstance(manifest_paths, str)
                     else manifest_paths):
            for _, txt_path in read_manifest(path):
                texts.append(read_transcript(txt_path))
        return cls(order, labels).fit_texts(texts)

    # -------------------------------------------------------------- scoring
    def _logp_sparse(self, ctx: tuple, c: int) -> float:
        """log P(c | ctx) with stupid backoff over the sparse counts."""
        penalty = 0.0
        for m in range(len(ctx), -1, -1):
            row = self.counts[m].get(ctx[len(ctx) - m:])
            if row is not None and row[c] > 0:
                return penalty + math.log(row[c] / row.sum())
            penalty += _BACKOFF
        # Unseen even as a unigram: uniform floor under the full backoff stack.
        return (len(ctx) + 1) * _BACKOFF - math.log(len(self.labels))

    def dense_table(self) -> np.ndarray:
        """[V^(order-1), V] float32 of log P(c | ctx), backoff baked in."""
        if self._table is not None:
            return self._table
        v = len(self.labels)
        m = self.order - 1
        n_ctx = v ** m
        table = np.empty((n_ctx, v), np.float32)
        for idx in range(n_ctx):
            # Decode big-endian context digits.
            ctx, rem = [], idx
            for _ in range(m):
                ctx.append(rem % v)
                rem //= v
            ctx = tuple(reversed(ctx))
            for c in range(v):
                table[idx, c] = self._logp_sparse(ctx, c)
        self._table = table
        return table

    def logp(self, c: int, context) -> float:
        """log P(c | context ids); context shorter than order-1 is BOS-padded."""
        m = self.order - 1
        ctx = tuple(([0] * m + list(context))[-m:]) if m else ()
        return self._logp_sparse(ctx, c)

    # ------------------------------------------------------------------- io
    def save(self, path: str) -> None:
        data = {
            "order": self.order,
            "labels": self.labels,
            "counts": [
                {",".join(map(str, ctx)): row.tolist()
                 for ctx, row in level.items()}
                for level in self.counts
            ],
        }
        with open(path, "w") as f:
            json.dump(data, f)

    @classmethod
    def load(cls, path: str) -> "CharNGramLM":
        with open(path) as f:
            data = json.load(f)
        lm = cls(data["order"], data["labels"])
        for m, level in enumerate(data["counts"]):
            for key, row in level.items():
                ctx = tuple(int(x) for x in key.split(",")) if key else ()
                lm.counts[m][ctx] = np.asarray(row, np.int64)
        return lm


class WordNGramLM:
    """Word bigram LM with stupid backoff — the faithful KenLM stand-in.

    A KenLM WORD LM fused into a CTC beam search scores a word exactly when
    the beam completes it.
    Here the same contract: beam search (python and native C++) adds
        alpha * logp(word | prev_word) + beta
    once per COMPLETED word — on appending the space delimiter, and for the
    trailing word when ranking final beams.  Scoring backs off
    bigram -> 0.4*unigram -> 0.4^2*OOV-floor (same stupid-backoff scheme as
    CharNGramLM).

    Native export (`export_native`) emits the SPARSE n-gram store the C++
    decoder consumes (decode/ngram.py shared contract): the stupid-backoff
    bigram model maps exactly onto ARPA-backoff form with every context's
    backoff weight equal to the constant ln(0.4) penalty, `<s>` carrying the
    sentence-initial (BOS-count) bigrams, and `<unk>`'s unigram chosen so an
    OOV word scores the historical flat `oov_logp` in every context.
    """

    is_word_lm = True

    def __init__(self, labels: str = LABELS):
        self.labels = labels
        self.uni: dict[str, int] = {}
        self.bi: dict[tuple[str, str], int] = {}
        self.bos: dict[str, int] = {}
        self.total = 0
        self.bos_total = 0
        self._ctx_totals = None
        self._native = None

    # ------------------------------------------------------------- training
    def fit_texts(self, texts) -> "WordNGramLM":
        for text in texts:
            words = text.split()
            if not words:
                continue
            self.bos[words[0]] = self.bos.get(words[0], 0) + 1
            self.bos_total += 1
            for i, w in enumerate(words):
                self.uni[w] = self.uni.get(w, 0) + 1
                self.total += 1
                if i:
                    key = (words[i - 1], w)
                    self.bi[key] = self.bi.get(key, 0) + 1
        self._ctx_totals = None
        self._native = None
        return self

    @classmethod
    def from_manifests(cls, manifest_paths, labels: str = LABELS) -> "WordNGramLM":
        from aas_enhancement_tpu_torch.data.manifest import read_manifest, read_transcript
        texts = []
        for path in ([manifest_paths] if isinstance(manifest_paths, str)
                     else manifest_paths):
            for _, txt_path in read_manifest(path):
                texts.append(read_transcript(txt_path))
        return cls(labels).fit_texts(texts)

    # -------------------------------------------------------------- scoring
    @property
    def oov_logp(self) -> float:
        # Two backoff hops (bigram -> unigram -> floor) over an open vocab.
        return 2 * _BACKOFF - math.log(self.total + len(self.uni) + 1)

    def _uni_logp(self, w: str) -> float:
        c = self.uni.get(w, 0)
        if c == 0:
            return _BACKOFF - math.log(self.total + len(self.uni) + 1)
        return math.log(c / self.total)

    def logp(self, word: str, prev: str | None = None) -> float:
        """log P(word | prev); prev None = sentence start (BOS counts)."""
        if not word:
            return 0.0
        if prev is None:
            c = self.bos.get(word, 0)
            if c > 0:
                return math.log(c / self.bos_total)
            return _BACKOFF + self._uni_logp(word)
        c = self.bi.get((prev, word), 0)
        if c > 0:
            ctx_total = self._context_total(prev)
            return math.log(c / ctx_total)
        return _BACKOFF + self._uni_logp(word)

    def _context_total(self, prev: str) -> int:
        if getattr(self, "_ctx_totals", None) is None:
            totals: dict[str, int] = {}
            for (a, _), c in self.bi.items():
                totals[a] = totals.get(a, 0) + c
            self._ctx_totals = totals
        return self._ctx_totals.get(prev, 1)

    # ------------------------------------------------------- native export
    def export_native(self):
        """-> sparse-export dict (decode/ngram.py contract) for the C++
        decoder and the python fallback (cached).

        The stupid-backoff bigram maps EXACTLY onto ARPA-backoff form:
          bo(ctx) = ln(0.4) for every context (incl. <s> and <unk>), so an
          unseen bigram scores ln(0.4) + P(w) — the historical backoff path;
          explicit bigrams (prev, w) and (<s>, w) keep their MLE log-probs;
          uni_logp[<unk>] = ln(0.4) - ln(total + V + 1), so OOV words score
          bo(any ctx) + P(<unk>) = `oov_logp` flat in every context."""
        if self._native is not None:
            return self._native
        from aas_enhancement_tpu_torch.decode import ngram
        words = sorted(self.uni)
        vocab = ["<s>", "<unk>"] + words
        wid = {w: i for i, w in enumerate(vocab)}
        vlm = len(vocab)
        uni_logp = np.full(vlm, -99.0 * math.log(10.0), np.float32)
        uni_backoff = np.full(vlm, _BACKOFF, np.float32)
        uni_logp[wid["<unk>"]] = _BACKOFF - math.log(
            self.total + len(self.uni) + 1)
        for w in words:
            uni_logp[wid[w]] = self._uni_logp(w)
        bi: dict[tuple, tuple] = {}
        for w, c in self.bos.items():
            bi[(wid["<s>"], wid[w])] = (math.log(c / self.bos_total), 0.0)
        for (a, b), c in self.bi.items():
            bi[(wid[a], wid[b])] = (math.log(c / self._context_total(a)), 0.0)
        self._native = ngram.build_export(
            2, vocab, uni_logp, uni_backoff, [bi], labels=self.labels,
            space_id=self.labels.index(" "), floor_logp=float(self.oov_logp))
        return self._native

    # ------------------------------------------------------------------- io
    def save(self, path: str) -> None:
        data = {"kind": "word", "labels": self.labels,
                "uni": self.uni, "bos": self.bos,
                "bi": {f"{a}\t{b}": c for (a, b), c in self.bi.items()},
                "total": self.total, "bos_total": self.bos_total}
        with open(path, "w") as f:
            json.dump(data, f)

    @classmethod
    def load(cls, path: str) -> "WordNGramLM":
        with open(path) as f:
            data = json.load(f)
        lm = cls(data["labels"])
        lm.uni = dict(data["uni"])
        lm.bos = dict(data["bos"])
        lm.bi = {tuple(k.split("\t")): v for k, v in data["bi"].items()}
        lm.total = data["total"]
        lm.bos_total = data["bos_total"]
        return lm


def load_lm(path: str):
    """Load any supported LM file: the json formats above (the `kind` field
    disambiguates; char-LM files predate it) or a KenLM-style ARPA text file
    (sniffed by its \\data\\ header — decode/arpa.py)."""
    with open(path, encoding="utf-8", errors="replace") as f:
        head = f.read(65536)
    if "\\data\\" in head.split("\\1-grams:")[0]:
        from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM
        return ArpaWordLM.load_arpa(path)
    data = json.loads(head if len(head) < 65536 else open(path).read())
    if data.get("kind") == "word":
        return WordNGramLM.load(path)
    return CharNGramLM.load(path)


def context_index(prefix_ids, order: int, vocab_size: int) -> int:
    """The dense-table row for a decoded prefix (shared contract with C++)."""
    m = order - 1
    if m == 0:
        return 0
    padded = ([0] * m + list(prefix_ids))[-m:]
    idx = 0
    for s in padded:
        idx = idx * vocab_size + int(s)
    return idx
