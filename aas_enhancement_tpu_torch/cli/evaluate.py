"""`evaluate` entry point: WER of the AM on a test manifest, noisy vs enhanced
(port of ``aas_enhancement_tpu/cli/evaluate.py``).

Runs the acoustic model with greedy decoding over the manifest on
``--device``, reports corpus WER/CER, optionally enhances first and reports
the WER delta, and with ``--clean-manifest`` the SI-SNR and STOI of noisy and
enhanced waveforms; one JSON line ends the run.

Usage:
  python -m aas_enhancement_tpu_torch.cli.evaluate --manifest test.csv \\
      --am-checkpoint seed:0 [--enhancer-checkpoint seed:1] \\
      [--clean-manifest clean.csv] [--config cfg.json] [--device cuda|cpu]

Weights: ``--am-checkpoint`` and ``--enhancer-checkpoint`` take a train-CLI
checkpoint directory of the port (``train/loop.py::load_state``; a JAX
package's directory converts with ``scripts/orbax_to_torch.py``) or
``seed:N``, which draws that network's weights from
``torch.Generator().manual_seed(N)`` with flax's init distributions.  Without
``--config`` the ``am`` and ``audio`` config sections come from the AM's
checkpoint; the ``enhancer`` section always comes from the enhancer's, as in
the JAX CLI.  The beam decoders and LM flags (``--decoder beam|device``,
``--lm``, ``--word-lm``, ``--tune-lm-manifest``) raise until ROADMAP A10 /
A13 port them.
"""

from __future__ import annotations

import argparse
import json

from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.config import Config
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
                   help="only 'greedy' is ported ('beam': ROADMAP A10, "
                        "'device': ROADMAP A13)")
    p.add_argument("--beam-width", type=int, default=32, help="(beam decoders only)")
    p.add_argument("--lm", help="LM fusion (not yet ported, ROADMAP A10)")
    p.add_argument("--lm-alpha", type=float, default=0.5, help="(LM fusion only)")
    p.add_argument("--lm-beta", type=float, default=0.0, help="(LM fusion only)")
    p.add_argument("--word-lm", help="word-LM fusion (not yet ported, ROADMAP A10)")
    p.add_argument("--word-alpha", type=float, default=0.5, help="(LM fusion only)")
    p.add_argument("--word-beta", type=float, default=0.0, help="(LM fusion only)")
    p.add_argument("--tune-lm-manifest",
                   help="LM weight grid search (not yet ported, ROADMAP A10)")
    p.add_argument("--clean-manifest",
                   help="paired clean manifest: also report SI-SNR (dB) and STOI of "
                        "noisy and enhanced waveforms vs the clean references")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    for flag, value in (("--lm", args.lm), ("--word-lm", args.word_lm),
                        ("--tune-lm-manifest", args.tune_lm_manifest)):
        if value:
            raise NotImplementedError(f"{flag}: LM fusion is not yet ported (ROADMAP A10)")
    if args.decoder != "greedy":
        road = "A10" if args.decoder == "beam" else "A13"
        raise NotImplementedError(f"--decoder {args.decoder}: not yet ported "
                                  f"(ROADMAP {road})")
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

    result = {"noisy": evaluate_wer(cfg, am, args.manifest, batch_size=args.batch_size)}
    if enhancer is not None:
        result["enhanced"] = evaluate_wer(cfg, am, args.manifest, enhancer=enhancer,
                                          batch_size=args.batch_size)
        result["wer_delta"] = result["enhanced"]["wer"] - result["noisy"]["wer"]
    if args.clean_manifest:
        result["si_snr"] = evaluate_si_snr(cfg, args.manifest, args.clean_manifest,
                                           enhancer=enhancer)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
