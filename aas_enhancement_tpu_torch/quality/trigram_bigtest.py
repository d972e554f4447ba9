"""The trigram-vs-bigram comparison on a larger held-out split (port of the
JAX repo's ``scripts/trigram_bigtest.py``).

48 test utterances leave the trigram's win inside the bootstrap CI, so this
re-decodes the bigram and the trigram beams at their dev-tuned weights on a
fresh ``--n-utts`` corpus (seed 104659, disjoint from train 7 / dev 104729 /
test 7919) with the AM and the ARPA files that ``quality.
trigram_fusion_eval`` left in ``--workdir``, and patches
``wer_test_{bi,tri}_big`` and the paired per-utterance counts into its
result file.  The paired counts are the right lens: both LMs decode the
same utterances, so the sign of each utterance's delta says more than two
overlapping corpus-level CIs.

The fresh corpus takes the result's ``tri_classes`` and SNR range but not
its ``lexicon_size``: it is drawn from the default 100-word lexicon, as the
JAX script draws it.  The AM runs on ``--device`` (the card by default;
without a GPU that raises), the beams on the host through the native
decoder on a CUDA device.

Usage:
  python -m aas_enhancement_tpu_torch.quality.trigram_bigtest [--workdir DIR] \\
      [--n-utts 192] [--result trigram_fusion_torch.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM
from aas_enhancement_tpu_torch.evaluation import evaluate_wer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.train.loop import load_state

PRINTED = ("wer_test_bi_big", "wer_test_tri_big", "trigram_win_abs_big", "big_paired")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "aas_trigram"))
    p.add_argument("--n-utts", type=int, default=192)
    p.add_argument("--seed", type=int, default=104659,
                   help="fresh corpus seed (train 7 / dev 104729 / test 7919)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--beam-width", type=int, default=32)
    p.add_argument("--result", default="trigram_fusion_torch.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def paired(per_bi: list, per_tri: list) -> dict:
    """The per-utterance deltas (trigram's edits - bigram's) counted by sign."""
    deltas = [t - b for b, t in zip(per_bi, per_tri)]
    return {"n": len(deltas), "tri_better": sum(1 for d in deltas if d < 0),
            "bi_better": sum(1 for d in deltas if d > 0),
            "ties": sum(1 for d in deltas if d == 0)}


def run(args: argparse.Namespace) -> dict:
    """-> the patched result."""
    device = resolve_device(args.device)
    workdir.require_native_beam(device)
    with open(args.result) as f:
        result = json.load(f)
    big_m = generate_corpus(os.path.join(args.workdir, "corpus_big"), n_utts=args.n_utts,
                            seed=args.seed, snr_range=tuple(result["snr_range"]),
                            n_words=(3, 8), tri_classes=result["tri_classes"],
                            reverb_prob=0.3)

    am_state, am_cfg = load_state(os.path.join(args.workdir, "ckpt_am"), device)
    legs = {}
    for tag, order in (("bi", 2), ("tri", 3)):
        lm = ArpaWordLM.load_arpa(os.path.join(args.workdir, f"word{order}.arpa"))
        legs[tag] = evaluate_wer(am_cfg, am_state.am, big_m["noisy"],
                                 batch_size=args.batch_size, decoder="beam",
                                 beam_width=args.beam_width, lm=lm,
                                 lm_alpha=result[f"lm_{tag}_alpha"],
                                 lm_beta=result[f"lm_{tag}_beta"], per_utt=True)
        workdir.check_beam_route(device)
        result[f"wer_test_{tag}_big"] = legs[tag]["wer"]
        result[f"wer_test_{tag}_big_ci95"] = legs[tag].get("wer_ci95")

    eb, et = legs["bi"].get("per_utt"), legs["tri"].get("per_utt")
    if eb and et:
        result["big_paired"] = paired(eb, et)
    result["n_big_test_utts"] = args.n_utts
    result["trigram_win_abs_big"] = round(
        result["wer_test_bi_big"] - result["wer_test_tri_big"], 6)
    workdir.write_json(args.result, result, end="\n")
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps({k: result[k] for k in PRINTED if k in result}))
    return result


if __name__ == "__main__":
    main()
