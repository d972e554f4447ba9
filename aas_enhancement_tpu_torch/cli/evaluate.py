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

Weights: reading the JAX package's Orbax checkpoints is not ported yet
(ROADMAP A9).  Until it is, a checkpoint flag takes ``seed:N``, which draws
that network's weights from ``torch.Generator().manual_seed(N)`` with flax's
init distributions; any other value raises.  The beam decoders and LM flags
(``--decoder beam|device``, ``--lm``, ``--word-lm``, ``--tune-lm-manifest``)
raise until ROADMAP A10 / A13 port them.
"""

from __future__ import annotations

import argparse
import json

from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.evaluation import evaluate_si_snr, evaluate_wer, init_am


def checkpoint_seed(flag: str, value: str) -> int:
    """``seed:N`` -> N; anything else is a checkpoint path, which waits for A9."""
    if value.startswith("seed:"):
        return int(value[len("seed:"):])
    raise NotImplementedError(
        f"{flag} {value}: loading checkpoints is not yet ported (ROADMAP A9); "
        "pass seed:N to draw the weights from seed N")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--manifest", required=True)
    p.add_argument("--am-checkpoint", required=True,
                   help="seed:N (random weights from seed N; checkpoints: ROADMAP A9)")
    p.add_argument("--enhancer-checkpoint",
                   help="seed:N; if given, also report WER on enhanced input + delta")
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
    am_seed = checkpoint_seed("--am-checkpoint", args.am_checkpoint)
    g_seed = (checkpoint_seed("--enhancer-checkpoint", args.enhancer_checkpoint)
              if args.enhancer_checkpoint else None)
    device = resolve_device(args.device)

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    am = init_am(cfg, am_seed, device)
    enhancer = init_enhancer(cfg, g_seed, device) if g_seed is not None else None

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
