"""`evaluate` entry point: WER of the AM on a test manifest, noisy vs enhanced
(port of ``aas_enhancement_tpu/cli/evaluate.py``).

Runs the acoustic model over the manifest on ``--device``, decodes greedily
or with a beam (``--decoder beam``: the host C++/Python prefix beam with any
LM mode; ``--decoder device``: the batched beam on the device, no LM or a
char LM), reports corpus WER/CER, optionally enhances first and reports the
WER delta, and with ``--clean-manifest`` the SI-SNR and STOI of noisy and
enhanced waveforms; one JSON line ends the run.  ``--lm`` (char or word
n-gram, ``cli.train_lm``) fuses into the beam, ``--word-lm`` adds a word LM
to a char ``--lm`` (hybrid fusion), and ``--tune-lm-manifest`` grid-searches
the LM weights on a dev manifest first (the grid is in ``lm_tuning``).

Usage:
  python -m aas_enhancement_tpu_torch.cli.evaluate --manifest test.csv \\
      --am-checkpoint seed:0 [--enhancer-checkpoint seed:1] \\
      [--decoder beam --lm char.json --word-lm word.arpa \\
       --tune-lm-manifest dev.csv] [--clean-manifest clean.csv] \\
      [--config cfg.json] [--device cuda|cpu]

Weights: ``--am-checkpoint`` and ``--enhancer-checkpoint`` take a train-CLI
checkpoint directory of the port (``train/loop.py::load_state``; a JAX
package's directory converts with ``scripts/orbax_to_torch.py``) or
``seed:N``, which draws that network's weights from
``torch.Generator().manual_seed(N)`` with flax's init distributions.  Without
``--config`` the ``am`` and ``audio`` config sections come from the AM's
checkpoint; the ``enhancer`` section always comes from the enhancer's, as in
the JAX CLI.
"""

from __future__ import annotations

import argparse
import json

from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.decode.lm import load_lm
from aas_enhancement_tpu_torch.decode.tune import grid_search_hybrid, grid_search_lm
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.evaluation import evaluate_si_snr, evaluate_wer, init_am
from aas_enhancement_tpu_torch.train.loop import load_state


def checkpoint_seed(value: str) -> int | None:
    """``seed:N`` -> N; a checkpoint directory -> None."""
    if value.startswith("seed:"):
        return int(value[len("seed:"):])
    return None


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", required=True)
    p.add_argument("--am-checkpoint", required=True,
                   help="checkpoint dir, or seed:N (random weights from seed N)")
    p.add_argument("--enhancer-checkpoint",
                   help="checkpoint dir or seed:N; if given, also report WER on "
                        "enhanced input + delta")
    p.add_argument("--config", help="config JSON")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--decoder", choices=["greedy", "beam", "device"], default="greedy",
                   help="'beam' = host C++/Python prefix beam (any LM mode); "
                        "'device' = batched beam on the device (no LM or char-LM "
                        "fusion; decode/device_beam.py)")
    p.add_argument("--beam-width", type=int, default=32)
    p.add_argument("--lm", help="LM file for beam fusion (char or word n-gram json, or "
                                "ARPA; train with cli.train_lm)")
    p.add_argument("--lm-alpha", type=float, default=0.5, help="LM weight")
    p.add_argument("--lm-beta", type=float, default=0.0,
                   help="insertion bonus (per symbol for char LMs, per completed "
                        "word for word LMs)")
    p.add_argument("--word-lm",
                   help="word n-gram LM fused IN ADDITION to a char --lm (hybrid "
                        "char+word shallow fusion)")
    p.add_argument("--word-alpha", type=float, default=0.5,
                   help="word-LM weight (hybrid fusion)")
    p.add_argument("--word-beta", type=float, default=0.0,
                   help="per-completed-word bonus (hybrid fusion)")
    p.add_argument("--tune-lm-manifest",
                   help="dev manifest: grid-search the lm alpha/beta (and the word-LM "
                        "weights with --word-lm) on it first and use the best point "
                        "(reports the grid)")
    p.add_argument("--clean-manifest",
                   help="paired clean manifest: also report SI-SNR (dB) and STOI of "
                        "noisy and enhanced waveforms vs the clean references")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    am_seed = checkpoint_seed(args.am_checkpoint)
    if am_seed is None:
        am_state, am_cfg = load_state(args.am_checkpoint, device)
        am = am_state.am
        if am is None:
            raise SystemExit(f"{args.am_checkpoint}: checkpoint has no acoustic model "
                             f"(objective was {am_cfg.train.objective!r})")
        if not args.config:
            cfg = cfg.replace(am=am_cfg.am, audio=am_cfg.audio)
    else:
        am = init_am(cfg, am_seed, device)
    lm, word_lm = None, None
    if args.lm:
        lm = load_lm(args.lm)
    if args.word_lm:
        word_lm = load_lm(args.word_lm)
        if not getattr(word_lm, "is_word_lm", False):
            raise SystemExit(f"{args.word_lm}: --word-lm must be a WORD "
                             "n-gram LM (train with cli.train_lm --word)")
        if lm is None:
            raise SystemExit("--word-lm fuses in addition to a char --lm; "
                             "for word-LM-only fusion pass it as --lm")
    if args.decoder == "device" and (
            word_lm is not None
            or (lm is not None and getattr(lm, "is_word_lm", False))):
        raise SystemExit("--decoder device supports char-LM fusion only; "
                         "word/hybrid fusion needs --decoder beam")

    enhancer = None
    if args.enhancer_checkpoint:
        g_seed = checkpoint_seed(args.enhancer_checkpoint)
        if g_seed is None:
            g_state, g_cfg = load_state(args.enhancer_checkpoint, device)
            enhancer = g_state.g
            if enhancer is None:
                raise SystemExit(f"{args.enhancer_checkpoint}: checkpoint has no enhancer")
            cfg = cfg.replace(enhancer=g_cfg.enhancer)
        else:
            enhancer = init_enhancer(cfg, g_seed, device)

    lm_alpha, lm_beta, tune_result = args.lm_alpha, args.lm_beta, None
    word_alpha, word_beta = args.word_alpha, args.word_beta
    if args.tune_lm_manifest:
        if lm is None:
            raise SystemExit("--tune-lm-manifest requires --lm")
        if word_lm is not None:
            tune_result = grid_search_hybrid(cfg, am, args.tune_lm_manifest, lm, word_lm,
                                             enhancer=enhancer, batch_size=args.batch_size,
                                             beam_width=args.beam_width)
            word_alpha, word_beta = tune_result["word_alpha"], tune_result["word_beta"]
        else:
            tune_result = grid_search_lm(cfg, am, args.tune_lm_manifest, lm,
                                         enhancer=enhancer, batch_size=args.batch_size,
                                         beam_width=args.beam_width)
        lm_alpha, lm_beta = tune_result["alpha"], tune_result["beta"]

    kw = dict(batch_size=args.batch_size, decoder=args.decoder,
              beam_width=args.beam_width, lm=lm, lm_alpha=lm_alpha, lm_beta=lm_beta)
    if word_lm is not None:
        kw.update(word_lm=word_lm, word_alpha=word_alpha, word_beta=word_beta)
    result = {"noisy": evaluate_wer(cfg, am, args.manifest, **kw)}
    if tune_result is not None:
        result["lm_tuning"] = tune_result
    if enhancer is not None:
        result["enhanced"] = evaluate_wer(cfg, am, args.manifest, enhancer=enhancer, **kw)
        result["wer_delta"] = result["enhanced"]["wer"] - result["noisy"]["wer"]
    if args.clean_manifest:
        result["si_snr"] = evaluate_si_snr(cfg, args.manifest, args.clean_manifest,
                                           enhancer=enhancer)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
