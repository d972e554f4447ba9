"""1000-word fusion at harsh SNR through the enhancement pipeline (port of
the JAX repo's ``scripts/biglex_hard_pipeline.py``).

``quality.trigram_fusion_eval --lexicon-size 1000 --snr-low -7 --snr-high
-2`` trains its AM on the noisy audio itself, which does not converge at
-7...-2 dB.  Below ~0 dB the enhancer is the capability, so the meaningful
harsh fusion number runs that workdir's 1000-word dev and test corpora
through the flagship hard stack (enhancer and AM of ``cli.e2e --snr-low -7
--snr-high -2``, its ``checkpoint/`` directory) and fuses the workdir's
``word{2,3}.arpa`` on top: noisy and enhanced greedy WER, then each LM's
weights tuned on dev through the enhancer and its beam on test, with the
paired per-utterance counts.  It is a cross-lexicon test too: the flagship
stack trained on the ~100-word lexicon, so the AM must generalize at the
character level while the word LMs bring the new lexicon's structure.  The
``wer_pipeline_*`` keys are patched into ``--result`` beside the noisy-AM
figures already there.

``--flagship`` takes the train-CLI checkpoint directory (``load_state``
gives the configuration, the enhancer and the AM), not the JAX script's
pickle.  The networks run on ``--device`` (the card by default; without a
GPU that raises), the beams on the host through the native decoder on a
CUDA device.

Usage:
  python -m aas_enhancement_tpu_torch.quality.biglex_hard_pipeline \\
      [--flagship /tmp/aas_e2e_full_hard/checkpoint] [--workdir /tmp/aas_biglex_hard] \\
      [--result biglex_hard_fusion_torch.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from aas_enhancement_tpu_torch.decode.arpa import ArpaWordLM
from aas_enhancement_tpu_torch.decode.tune import grid_search_lm
from aas_enhancement_tpu_torch.evaluation import evaluate_wer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.quality.trigram_bigtest import paired
from aas_enhancement_tpu_torch.train.loop import load_state


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    tmp = tempfile.gettempdir()
    p.add_argument("--flagship", default=os.path.join(tmp, "aas_e2e_full_hard", "checkpoint"),
                   help="the flagship hard stack: cli.e2e's <workdir>/checkpoint")
    p.add_argument("--workdir", default=os.path.join(tmp, "aas_biglex_hard"),
                   help="biglex-hard corpora and word{2,3}.arpa from trigram_fusion_eval")
    p.add_argument("--result", default="biglex_hard_fusion_torch.json")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--beam-width", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """-> the patched result."""
    t0 = time.time()
    device = resolve_device(args.device)
    if args.flagship.endswith(".pkl"):
        raise ValueError(f"--flagship {args.flagship}: the port reads cli.e2e's "
                         "<workdir>/checkpoint directory (train/loop.py::load_state), "
                         "not a pickle")
    workdir.require_native_beam(device)
    state, cfg = load_state(args.flagship, device)
    am, g = state.am, state.g

    dev = os.path.join(args.workdir, "corpus_dev", "noisy_manifest.csv")
    test = os.path.join(args.workdir, "corpus_test", "noisy_manifest.csv")
    with open(args.result) as f:
        result = json.load(f)
    out = {}

    # Context legs: the flagship stack on the foreign lexicon, before fusion.
    out["wer_pipeline_noisy_greedy_test"] = evaluate_wer(
        cfg, am, test, batch_size=args.batch_size)["wer"]
    enh = evaluate_wer(cfg, am, test, enhancer=g, batch_size=args.batch_size)
    out["wer_pipeline_enh_greedy_test"] = enh["wer"]
    out["wer_pipeline_enh_greedy_test_ci95"] = enh.get("wer_ci95")
    out["sample_pipeline"] = {"ref": enh.get("sample_ref"),
                              "hyp_enhanced": enh.get("sample_hyp")}

    legs = {}
    for tag, order in (("bi", 2), ("tri", 3)):
        lm = ArpaWordLM.load_arpa(os.path.join(args.workdir, f"word{order}.arpa"))
        tuned = grid_search_lm(cfg, am, dev, lm, enhancer=g, batch_size=args.batch_size,
                               beam_width=args.beam_width)
        workdir.check_beam_route(device)
        out[f"pipeline_lm_{tag}_alpha"] = tuned["alpha"]
        out[f"pipeline_lm_{tag}_beta"] = tuned["beta"]
        out[f"wer_pipeline_dev_beam_{tag}"] = tuned["wer"]
        out["wer_pipeline_dev_beam_no_lm"] = tuned["wer_no_lm"]
        legs[tag] = evaluate_wer(cfg, am, test, enhancer=g, batch_size=args.batch_size,
                                 decoder="beam", beam_width=args.beam_width, lm=lm,
                                 lm_alpha=tuned["alpha"], lm_beta=tuned["beta"], per_utt=True)
        workdir.check_beam_route(device)
        out[f"wer_pipeline_test_{tag}"] = legs[tag]["wer"]
        out[f"wer_pipeline_test_{tag}_ci95"] = legs[tag].get("wer_ci95")
        print(json.dumps({k: out[k] for k in out if tag in k or "greedy" in k}), flush=True)

    eb, et = legs["bi"].get("per_utt"), legs["tri"].get("per_utt")
    if eb and et:
        out["pipeline_paired"] = paired(eb, et)
    out["pipeline_trigram_win_abs"] = round(
        out["wer_pipeline_test_bi"] - out["wer_pipeline_test_tri"], 6)
    out["pipeline_wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    out["pipeline_flagship"] = args.flagship

    result.update(out)
    workdir.write_json(args.result, result, end="\n")
    print(json.dumps(out))
    return result


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
