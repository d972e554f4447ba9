"""Hybrid char + word LM fusion from a trained e2e workdir (port of the JAX
repo's ``scripts/hybrid_fusion_eval.py``).

Trains the char n-gram and the word bigram on the train transcripts, tunes
the single-LM and hybrid fusion weights on the dev split
(``decode/tune.py::grid_search_hybrid``: one forward, host re-decodes), and
reports the beam's WER without an LM (``wer_test_greedy``), with the char
LM and with both on the held-out test split.  ``--g-checkpoint`` /
``--am-checkpoint`` evaluate the networks of train-CLI checkpoints (e.g.
``ck_g_coadapt`` with ``ck_am_offline_ft``) in place of the workdir's.  The
AM (and G) forward runs on ``--device``, the decoding on the host, through
the native decoder on a CUDA device.

Usage:
  python -m aas_enhancement_tpu_torch.quality.hybrid_fusion_eval --workdir /tmp/aas_e2e \\
      [--order 4] [--g-checkpoint DIR] [--am-checkpoint DIR] [--out result.json] \\
      [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

from aas_enhancement_tpu_torch.decode.beam import beam_decode
from aas_enhancement_tpu_torch.decode.lm import CharNGramLM, WordNGramLM
from aas_enhancement_tpu_torch.decode.tune import cache_log_probs, grid_search_hybrid
from aas_enhancement_tpu_torch.decode.wer import corpus_wer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.train.loop import load_state


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True, help="cli.e2e workdir (has sweep_state.json)")
    p.add_argument("--order", type=int, default=4, help="char n-gram order")
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--prune-k", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--am-checkpoint", default="",
                   help="evaluate with the AM of this train-CLI checkpoint dir instead of "
                        "the workdir's (e.g. the co-adapted ck_am_offline_ft from "
                        "am_streaming_finetune --offline)")
    p.add_argument("--g-checkpoint", default="",
                   help="evaluate with the enhancer of this train-CLI checkpoint dir "
                        "instead of the workdir's (e.g. ck_g_coadapt from "
                        "coadapt_alternate)")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    workdir.require_native_beam(device)
    w = workdir.load(args.workdir, device)
    state, cfg = w.meta, w.cfg
    am, g = w.state.am, w.state.g
    if args.am_checkpoint:
        am = load_state(args.am_checkpoint, device)[0].am
    if args.g_checkpoint:
        g = load_state(args.g_checkpoint, device)[0].g

    clm = CharNGramLM.from_manifests([state["train_noisy"]], order=args.order)
    wlm = WordNGramLM.from_manifests([state["train_noisy"]])

    tuned = grid_search_hybrid(cfg, am, state["dev_noisy"], clm, wlm, enhancer=g,
                               batch_size=args.batch_size, beam_width=args.beam_width)
    workdir.check_beam_route(device)

    refs, lps = cache_log_probs(cfg, am, state["test_noisy"], enhancer=g,
                                batch_size=args.batch_size)

    def test_wer(**kw):
        hyps = [beam_decode(lp[None], None, beam_width=args.beam_width, prune_k=args.prune_k,
                            **kw)[0] for lp in lps]
        workdir.check_beam_route(device)
        return corpus_wer(refs, hyps)

    result = {
        "workdir": args.workdir, "char_order": args.order,
        "beam_width": args.beam_width, "prune_k": args.prune_k,
        "am_checkpoint": args.am_checkpoint, "g_checkpoint": args.g_checkpoint,
        "tuning": {k: tuned[k] for k in ("alpha", "beta", "word_alpha", "word_beta", "wer",
                                         "wer_char_only", "wer_no_lm")},
        "wer_test_greedy": test_wer(),
        "wer_test_char": test_wer(lm=clm, lm_alpha=tuned["alpha"], lm_beta=tuned["beta"]),
        "wer_test_hybrid": test_wer(lm=clm, lm_alpha=tuned["alpha"], lm_beta=tuned["beta"],
                                    word_lm=wlm, word_alpha=tuned["word_alpha"],
                                    word_beta=tuned["word_beta"]),
        "utterances_test": len(refs),
    }
    if args.out:
        workdir.write_json(args.out, result, indent=1)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
