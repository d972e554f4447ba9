"""ARPA n-gram file bridge: import KenLM-style word LMs, export ours (copy
of ``aas_enhancement_tpu/decode/arpa.py``, held to it by
``tests/test_torch_lm.py``).

The ARPA text format is the lingua franca of n-gram tooling (KenLM, SRILM,
IRSTLM all emit it), so this module makes the decoders interchangeable with
that ecosystem:

- `ArpaWordLM.load_arpa(path)` reads an ARPA file of ANY order and exposes the
  SAME fusion contract as `decode.lm.WordNGramLM` (is_word_lm / logp /
  export_native), so `evaluate --word-lm model.arpa` just works, python and
  native C++ beam alike.  Every order in the file is kept: the sparse n-gram
  store (decode/ngram.py) holds them, the beam carries (order-1) words of left context, and memory is O(#n-grams) — a real
  KenLM trigram/4-gram over a 5k-50k-word vocabulary loads whole.
- `export_arpa(word_lm, path)` writes a `WordNGramLM` out as a bigram ARPA
  file.  The round trip is exact to text-float precision.

Scope notes (documented, deliberate):
- ARPA stores log10 probabilities; everything here is converted to natural
  log at parse time (the fusion contract's unit).
- Words are case-folded to the label charset (labels.encode convention);
  vocabulary entries containing characters outside the charset are kept for
  context scoring but excluded from the emittable lexicon — the CTC decoder
  can never emit them.
- Stupid backoff is not a normalized model, so `export_arpa` writes its
  constant per-context backoff weight (log10 0.4) as each unigram's backoff
  field — standard practice when interchanging stupid-backoff models.
"""

from __future__ import annotations

import math

import numpy as np

from aas_enhancement_tpu_torch.labels import LABELS

_LN10 = math.log(10.0)
_BACKOFF = math.log(0.4)           # decode.lm's stupid-backoff penalty (ln)
_SPECIALS = ("<s>", "</s>", "<unk>")


class ArpaWordLM:
    """Word n-gram LM backed by an ARPA file, fused like `WordNGramLM`.

    Storage is LM-id space: `vocab` lists unigrams in file order (position =
    LM id), `uni_logp`/`uni_backoff` are dense [vlm] arrays, and `ngrams[n-2]`
    maps order-n id tuples -> (logp_ln, backoff_ln).  Scoring is standard ARPA
    backoff through `decode.ngram.score_export` — the exact arithmetic the
    native C++ decoder replays (shared contract, decode/ngram.py docstring).
    """

    is_word_lm = True

    def __init__(self, labels: str = LABELS):
        self.labels = labels
        self.order = 0
        self.vocab: list[str] = []
        self.wid: dict[str, int] = {}
        self.uni_logp: list[float] = []
        self.uni_backoff: list[float] = []
        self.ngrams: list[dict] = []      # per order n = 2..order
        self._native = None

    # ------------------------------------------------------------- parsing
    @classmethod
    def load_arpa(cls, path: str, labels: str = LABELS) -> "ArpaWordLM":
        lm = cls(labels)
        section = 0                 # 0 = preamble, n = inside \n-grams:
        with open(path, encoding="utf-8", errors="replace") as f:
            lines = iter(f)
            for line in lines:
                if line.strip() == "\\data\\":
                    break
            else:
                raise ValueError(f"{path}: no \\data\\ section — not ARPA")
            for line in lines:
                s = line.strip()
                if not s:
                    continue
                if s == "\\end\\":
                    break
                if s.startswith("ngram "):
                    n = int(s[len("ngram "):].split("=")[0])
                    lm.order = max(lm.order, n)
                    while len(lm.ngrams) < lm.order - 1:
                        lm.ngrams.append({})
                    continue
                if s.startswith("\\") and s.endswith("-grams:"):
                    section = int(s[1:].split("-")[0])
                    lm.order = max(lm.order, section)
                    while len(lm.ngrams) < lm.order - 1:
                        lm.ngrams.append({})
                    continue
                if section == 0:
                    continue
                fields = s.split()
                # logp  w1 ... wn  [backoff]
                logp = float(fields[0]) * _LN10
                words = [lm._fold(w) for w in fields[1:1 + section]]
                rest = fields[1 + section:]
                backoff = float(rest[0]) * _LN10 if rest else 0.0
                if section == 1:
                    w = words[0]
                    i = lm.wid.get(w)
                    if i is None:               # first sight defines the id
                        lm.wid[w] = len(lm.vocab)
                        lm.vocab.append(w)
                        lm.uni_logp.append(logp)
                        lm.uni_backoff.append(backoff)
                    else:                       # case-fold collision: last wins
                        lm.uni_logp[i] = logp
                        lm.uni_backoff[i] = backoff
                else:
                    ids = tuple(lm.wid.get(w, -1) for w in words)
                    if -1 in ids:
                        # Word never declared as a unigram (malformed file);
                        # an n-gram over it could never be looked up — drop.
                        continue
                    lm.ngrams[section - 2][ids] = (logp, backoff)
        if not lm.vocab:
            raise ValueError(f"{path}: no 1-grams parsed")
        return lm

    def _fold(self, word: str) -> str:
        lw = word.lower()
        return lw if lw in _SPECIALS else word.upper()

    # ------------------------------------------------------------- scoring
    @property
    def unk_id(self) -> int:
        return self.wid.get("<unk>", -1)

    @property
    def bos_id(self) -> int:
        return self.wid.get("<s>", -1)

    @property
    def floor_logp(self) -> float:
        """Score of a word absent even as a unigram when the model has no
        <unk>: uniform floor under the vocabulary size, fully backed off."""
        return -math.log(len(self.vocab) + 1.0) + 2 * _BACKOFF

    @property
    def oov_logp(self) -> float:
        """Flat OOV score in an empty context (back-compat diagnostic)."""
        u = self.unk_id
        if u >= 0:
            return self.uni_backoff[u] + self.uni_logp[u]
        return _BACKOFF + self.floor_logp

    def _lm_id(self, word: str | None) -> int:
        if word is None:
            return self.bos_id
        return self.wid.get(self._fold(word), self.unk_id)

    def logp(self, word: str, prev=None) -> float:
        """log P(word | prev), natural log.  `prev` is a single word, None
        (sentence start = `<s>` context), or a SEQUENCE of words oldest-first
        for higher-order contexts."""
        if not word:
            return 0.0
        from aas_enhancement_tpu_torch.decode import ngram
        if prev is None or isinstance(prev, str):
            ctx = [self._lm_id(prev)]
        else:
            ctx = [self._lm_id(p) for p in prev]
        return ngram.score_export(self.export_native(), ctx,
                                  self._lm_id(word))

    # ------------------------------------------------------- native export
    def export_native(self):
        """Sparse-export dict (decode/ngram.py shared contract with
        native/ctc_beam/ctc_beam.cc and the python fallback); cached."""
        if self._native is None:
            from aas_enhancement_tpu_torch.decode import ngram
            self._native = ngram.build_export(
                max(self.order, 1), self.vocab,
                np.asarray(self.uni_logp, np.float32),
                np.asarray(self.uni_backoff, np.float32),
                self.ngrams, labels=self.labels,
                space_id=self.labels.index(" "),
                floor_logp=self.floor_logp)
        return self._native

    # ------------------------------------------------------------------- io
    def save_arpa(self, path: str) -> None:
        """Write this model back out as an ARPA file (any order).  The file
        reloads through `load_arpa` with scoring exact to text-float
        precision."""
        def f10(ln_value: float) -> str:
            return f"{ln_value / _LN10:.8f}"

        with open(path, "w", encoding="utf-8") as f:
            f.write("\\data\\\n")
            f.write(f"ngram 1={len(self.vocab)}\n")
            for n in range(2, self.order + 1):
                f.write(f"ngram {n}={len(self.ngrams[n - 2])}\n")
            f.write("\n\\1-grams:\n")
            for i, w in enumerate(self.vocab):
                f.write(f"{f10(self.uni_logp[i])}\t{w}\t"
                        f"{f10(self.uni_backoff[i])}\n")
            for n in range(2, self.order + 1):
                f.write(f"\n\\{n}-grams:\n")
                for ids, (lp, bo) in sorted(self.ngrams[n - 2].items()):
                    gram = " ".join(self.vocab[i] for i in ids)
                    if n < self.order:
                        f.write(f"{f10(lp)}\t{gram}\t{f10(bo)}\n")
                    else:
                        f.write(f"{f10(lp)}\t{gram}\n")
            f.write("\n\\end\\\n")


def fit_arpa(texts, order: int = 3, labels: str = LABELS) -> ArpaWordLM:
    """Train a word n-gram LM of ANY order on transcripts, stupid-backoff
    MLE mapped onto ARPA-backoff form (every seen context's backoff weight is
    the constant ln(0.4); explicit n-grams keep their MLE log-probs) — the
    same scheme `WordNGramLM` uses at order 2, generalized.  Returns an
    `ArpaWordLM`, so the result fuses/saves/loads exactly like an externally
    trained KenLM file."""
    if order < 2:
        raise ValueError("order must be >= 2")
    counts: list[dict] = [dict() for _ in range(order)]  # n-1 -> ctx+w counts
    total = 0
    vocab_counts: dict[str, int] = {}
    for text in texts:
        words = text.split()
        if not words:
            continue
        padded = ["<s>"] * (order - 1) + words
        for t in range(order - 1, len(padded)):
            w = padded[t]
            vocab_counts[w] = vocab_counts.get(w, 0) + 1
            total += 1
            for n in range(2, order + 1):
                key = tuple(padded[t - n + 1: t + 1])
                if key.count("<s>") > 1:
                    # Fusion inserts at most ONE <s> of context (the beam's
                    # BOS fill) — doubled-<s> n-grams are unreachable.
                    continue
                counts[n - 1][key] = counts[n - 1].get(key, 0) + 1
    if not vocab_counts:
        raise ValueError("no transcripts to train on")

    lm = ArpaWordLM(labels)
    lm.order = order
    lm.vocab = ["<unk>", "<s>", "</s>"] + sorted(vocab_counts)
    lm.wid = {w: i for i, w in enumerate(lm.vocab)}
    unk_logp = _BACKOFF - math.log(total + len(vocab_counts) + 1)
    lm.uni_logp = [unk_logp, -99.0 * _LN10, -99.0 * _LN10] + [
        math.log(vocab_counts[w] / total) for w in lm.vocab[3:]]
    lm.uni_backoff = [_BACKOFF] * len(lm.vocab)
    # Context totals per n-gram level: denominator of the MLE ratio.
    lm.ngrams = [dict() for _ in range(order - 1)]
    for n in range(2, order + 1):
        ctx_total: dict[tuple, int] = {}
        for key, c in counts[n - 1].items():
            ctx_total[key[:-1]] = ctx_total.get(key[:-1], 0) + c
        bo = _BACKOFF if n < order else 0.0
        level = lm.ngrams[n - 2]
        for key, c in counts[n - 1].items():
            ids = tuple(lm.wid[w] for w in key)
            level[ids] = (math.log(c / ctx_total[key[:-1]]), bo)
    return lm


def fit_arpa_from_manifests(manifest_paths, order: int = 3,
                            labels: str = LABELS) -> ArpaWordLM:
    from aas_enhancement_tpu_torch.data.manifest import read_manifest, read_transcript
    texts = []
    for path in ([manifest_paths] if isinstance(manifest_paths, str)
                 else manifest_paths):
        for _, txt_path in read_manifest(path):
            texts.append(read_transcript(txt_path))
    return fit_arpa(texts, order=order, labels=labels)


def export_arpa(word_lm, path: str) -> None:
    """Write a trained `decode.lm.WordNGramLM` as a bigram ARPA file.

    The written file reloads through `ArpaWordLM.load_arpa` with scoring
    equal to the source model to text-float precision, for every case the
    fusion contract exercises: seen/unseen bigrams, sentence-initial words,
    OOV words, and OOV previous contexts.
    """
    if not getattr(word_lm, "is_word_lm", False):
        raise ValueError("export_arpa needs a word LM (WordNGramLM)")
    words = sorted(word_lm.uni)
    bo10 = _BACKOFF / _LN10

    def f10(ln_value: float) -> str:
        return f"{ln_value / _LN10:.8f}"

    bigrams = []
    for w, c in sorted(word_lm.bos.items()):
        bigrams.append((f10(word_lm.logp(w, prev=None)), "<s>", w))
    for (a, b) in sorted(word_lm.bi):
        bigrams.append((f10(word_lm.logp(b, prev=a)), a, b))

    unk_logp = _BACKOFF - math.log(word_lm.total + len(word_lm.uni) + 1)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\\data\\\n")
        f.write(f"ngram 1={len(words) + 3}\n")
        f.write(f"ngram 2={len(bigrams)}\n\n")
        f.write("\\1-grams:\n")
        f.write(f"{f10(unk_logp)}\t<unk>\t{bo10:.8f}\n")
        f.write(f"-99\t<s>\t{bo10:.8f}\n")
        f.write("-99\t</s>\n")
        for w in words:
            f.write(f"{f10(word_lm._uni_logp(w))}\t{w}\t{bo10:.8f}\n")
        f.write("\n\\2-grams:\n")
        for logp10, a, b in bigrams:
            f.write(f"{logp10}\t{a} {b}\n")
        f.write("\n\\end\\\n")
