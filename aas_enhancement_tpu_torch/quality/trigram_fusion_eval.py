"""Trigram over bigram word-LM fusion on a corpus with order-3 structure
(port of the JAX repo's ``scripts/trigram_fusion_eval.py``).

The language of ``data/synthetic.py::Language(tri_classes > 1)`` keys each
word's successors on the previous word's class as well as on the current
word, so a trigram ARPA LM has something a bigram cannot capture.  The
protocol, in its own workdir:

  1. trigram-structured corpora: TRAIN (multi-condition AM training), DEV
     (fusion-weight tuning), TEST (held out), seeds 7, 104729 and 7919;
  2. the AM trained on the noisy TRAIN split through the train CLI
     (``cli/train.py --objective am``, ``ckpt_am``), so that ``cli.evaluate
     --am-checkpoint`` takes it as it is;
  3. a text-only corpus from the same language (seed 424242, the KenLM
     pattern: LM text far beyond the transcribed audio), fitted as ARPA LMs
     of order 2 and 3 (``decode/arpa.py::fit_arpa``), written as
     ``word{2,3}.arpa`` and read back; their log-p per word on 2000
     held-out sentences and their native export sizes;
  4. greedy, beam without an LM, and beams with each LM at its weights tuned
     on DEV (``grid_search_lm``, beam 16), decoded on TEST;
  5. one literal ``cli.evaluate --lm word3.arpa`` run at the tuned weights,
     its last stdout line (the JSON) kept in the result.

The AM trains and runs on ``--device`` (the card by default; without a GPU
that raises); the beams run on the host, through the native decoder on a
CUDA device (a decode on the Python route raises).  ``--lexicon-size 1000
--lm-sentences 50000`` exercises the sparse n-gram store at a realistic
vocabulary; with ``--snr-low -7 --snr-high -2`` too it gives the workdir
that ``quality.biglex_hard_pipeline`` reads.  ``trigram_bigtest`` and
``biglex_hard_pipeline`` patch the result file this writes.

Usage:
  python -m aas_enhancement_tpu_torch.quality.trigram_fusion_eval \\
      [--workdir DIR] [--lexicon-size 1000 --lm-sentences 50000] \\
      [--snr-low -7 --snr-high -2] [--out result.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import tempfile
import time

import numpy as np

from aas_enhancement_tpu_torch.cli import evaluate as cli_evaluate
from aas_enhancement_tpu_torch.cli import train as cli_train
from aas_enhancement_tpu_torch.config import AMConfig, Config, DataConfig, TrainConfig
from aas_enhancement_tpu_torch.data.synthetic import default_language, generate_corpus
from aas_enhancement_tpu_torch.decode import ngram
from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM, fit_arpa
from aas_enhancement_tpu_torch.decode.tune import grid_search_lm
from aas_enhancement_tpu_torch.evaluation import evaluate_wer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.train.loop import load_state


def am_config() -> Config:
    """The AM's networks and training settings: 3 x BiGRU-256 with 16 conv
    channels, lr 6e-4, two buckets.  ``epochs`` is a backstop only: the
    step budget is ``--am-steps`` (``TrainConfig.epochs=10`` would cap a
    384-utterance, B=16 run near 250 steps)."""
    return Config(am=AMConfig(rnn_hidden=256, rnn_layers=3, conv_channels=16),
                  train=TrainConfig(objective="am", lr_am=6e-4, log_every=50,
                                    epochs=100000),
                  data=DataConfig(num_buckets=2))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "aas_trigram"))
    p.add_argument("--n-utts", type=int, default=384)
    p.add_argument("--n-dev-utts", type=int, default=48)
    p.add_argument("--n-test-utts", type=int, default=48)
    p.add_argument("--am-steps", type=int, default=1500)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--tri-classes", type=int, default=3)
    p.add_argument("--lexicon-size", type=int, default=100,
                   help="language lexicon size: 1000+ exercises the sparse n-gram store "
                        "at a realistic vocabulary (the text-only LM corpus must then "
                        "cover the lexicon: scale --lm-sentences with it)")
    p.add_argument("--lm-sentences", type=int, default=20000,
                   help="text-only LM training corpus size (the KenLM pattern: LM text "
                        ">> transcribed audio)")
    p.add_argument("--snr-low", type=float, default=0.0)
    p.add_argument("--snr-high", type=float, default=10.0)
    p.add_argument("--beam-width", type=int, default=32)
    p.add_argument("--out", default="trigram_fusion_torch.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    workdir.require_native_beam(device)
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    t0 = time.time()
    result = {"n_utts": args.n_utts, "am_steps": args.am_steps,
              "tri_classes": args.tri_classes, "lexicon_size": args.lexicon_size,
              "lm_sentences": args.lm_sentences, "snr_range": [args.snr_low, args.snr_high]}

    def save():
        result["wall_minutes_so_far"] = round((time.time() - t0) / 60.0, 1)
        workdir.write_json(args.out, result, end="\n")

    # 1. the corpora
    corpus_kw = dict(snr_range=(args.snr_low, args.snr_high), n_words=(3, 8),
                     tri_classes=args.tri_classes, lexicon_size=args.lexicon_size,
                     reverb_prob=0.3)
    train_m = generate_corpus(os.path.join(wd, "corpus"), n_utts=args.n_utts, seed=7,
                              **corpus_kw)
    dev_m = generate_corpus(os.path.join(wd, "corpus_dev"), n_utts=args.n_dev_utts,
                            seed=104729, **corpus_kw)
    test_m = generate_corpus(os.path.join(wd, "corpus_test"), n_utts=args.n_test_utts,
                             seed=7919, **corpus_kw)

    # 2. multi-condition AM training (noisy input and transcripts) through the
    # train CLI, so that cli.evaluate --am-checkpoint takes it as it is
    cfg_path = os.path.join(wd, "config.json")
    with open(cfg_path, "w") as f:
        f.write(am_config().to_json())
    ckpt = os.path.join(wd, "ckpt_am")
    cli_train.main(["--objective", "am", "--noisy-manifest", train_m["noisy"],
                    "--config", cfg_path, "--steps", str(args.am_steps),
                    "--batch-size", str(args.batch_size), "--checkpoint-dir", ckpt,
                    "--device", str(device)])
    save()

    # 3. a text-only LM corpus from the same language; bigram and trigram fits,
    # written and read back
    lang = default_language(0, size=args.lexicon_size, tri_classes=args.tri_classes)
    rng = np.random.default_rng(424242)
    texts = [lang.sample_sentence(rng, n_words=(3, 8)) for _ in range(args.lm_sentences)]
    paths = {}
    for order in (2, 3):
        paths[order] = os.path.join(wd, f"word{order}.arpa")
        fit_arpa(texts, order=order).save_arpa(paths[order])
    bi = ArpaWordLM.load_arpa(paths[2])
    tri = ArpaWordLM.load_arpa(paths[3])
    if (bi.order, tri.order) != (2, 3):
        raise RuntimeError(f"the ARPA files read back at orders {bi.order}, {tri.order}")

    # Held-out text likelihood: the order-3 structure is there before any
    # decode claims it.
    test_texts = [lang.sample_sentence(rng, n_words=(3, 8)) for _ in range(2000)]

    def logp_per_word(lm):
        tot, n = 0.0, 0
        for t in test_texts:
            words = t.split()
            for i, w in enumerate(words):
                tot += lm.logp(w, tuple(words[max(0, i - lm.order + 1): i]) or None)
                n += 1
        return tot / n

    result["heldout_logp_per_word_bi"] = round(logp_per_word(bi), 4)
    result["heldout_logp_per_word_tri"] = round(logp_per_word(tri), 4)
    result["export_mb"] = {
        "bi": round(ngram.export_nbytes(bi.export_native()) / 2**20, 3),
        "tri": round(ngram.export_nbytes(tri.export_native()) / 2**20, 3)}
    save()

    # 4. greedy, beam without an LM, beams with each LM tuned on dev
    am_state, am_cfg = load_state(ckpt, device)
    am = am_state.am
    g = evaluate_wer(am_cfg, am, test_m["noisy"], batch_size=args.batch_size)
    result["wer_greedy_test"] = g["wer"]
    result["wer_greedy_test_ci95"] = g.get("wer_ci95")
    nolm = evaluate_wer(am_cfg, am, test_m["noisy"], batch_size=args.batch_size,
                        decoder="beam", beam_width=args.beam_width)
    workdir.check_beam_route(device)
    result["wer_beam_nolm_test"] = nolm["wer"]
    save()

    for tag, lm in (("bi", bi), ("tri", tri)):
        tuned = grid_search_lm(am_cfg, am, dev_m["noisy"], lm, batch_size=args.batch_size,
                               beam_width=16)
        workdir.check_beam_route(device)
        result[f"lm_{tag}_alpha"] = tuned["alpha"]
        result[f"lm_{tag}_beta"] = tuned["beta"]
        result[f"wer_dev_beam_{tag}"] = tuned["wer"]
        result["wer_dev_beam_no_lm"] = tuned["wer_no_lm"]
        r = evaluate_wer(am_cfg, am, test_m["noisy"], batch_size=args.batch_size,
                         decoder="beam", beam_width=args.beam_width, lm=lm,
                         lm_alpha=tuned["alpha"], lm_beta=tuned["beta"])
        workdir.check_beam_route(device)
        result[f"wer_test_{tag}"] = r["wer"]
        result[f"wer_test_{tag}_ci95"] = r.get("wer_ci95")
        save()

    result["trigram_win_abs"] = round(result["wer_test_bi"] - result["wer_test_tri"], 6)

    # 5. the user's path: cli.evaluate --lm word3.arpa (word-LM-only fusion
    # rides --lm; --word-lm is the hybrid add-on) at the dev-tuned weights,
    # its JSON line kept
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_evaluate.main(["--manifest", test_m["noisy"], "--am-checkpoint", ckpt,
                           "--decoder", "beam", "--beam-width", str(args.beam_width),
                           "--lm", paths[3], "--lm-alpha", str(result["lm_tri_alpha"]),
                           "--lm-beta", str(result["lm_tri_beta"]),
                           "--batch-size", str(args.batch_size), "--device", str(device)])
    workdir.check_beam_route(device)
    result["cli_evaluate_word_lm_tri"] = buf.getvalue().strip().splitlines()[-1]

    result.pop("wall_minutes_so_far", None)
    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    workdir.write_json(args.out, result, end="\n")
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
