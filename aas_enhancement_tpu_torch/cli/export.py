"""`export` entry point: trained enhancer checkpoint -> serving artifact (port
of ``aas_enhancement_tpu/cli/export.py``).

Exports the STFT -> enhancer -> ISTFT program (weights in it) per
input-shape bucket with ``torch.export`` on ``--device`` (the card by
default) — see ``serving.py``.  A serving process loads the artifact with
``aas_enhancement_tpu_torch.serving.load_enhancer`` on the same device type
and needs no model code or checkpoint.

Usage:
  python -m aas_enhancement_tpu_torch.cli.export --checkpoint ck_aas --out serving/ \\
      [--batch-sizes 1,8] [--seconds 8,16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="train-CLI checkpoint dir with enhancer params")
    p.add_argument("--out", required=True, help="serving artifact directory")
    p.add_argument("--batch-sizes", default="1,8")
    p.add_argument("--seconds", default="8")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    from aas_enhancement_tpu_torch.serving import export_enhancer
    from aas_enhancement_tpu_torch.train.loop import load_state

    device = resolve_device(args.device)
    state, cfg = load_state(args.checkpoint, device)
    if state.g is None:
        raise SystemExit(f"{args.checkpoint}: checkpoint has no enhancer "
                         f"(objective was {cfg.train.objective!r})")

    manifest = export_enhancer(
        cfg, state.g, args.out,
        batch_sizes=tuple(int(x) for x in args.batch_sizes.split(",")),
        seconds=tuple(float(x) for x in args.seconds.split(",")), device=device)
    print(json.dumps({"out": args.out,
                      "entries": len(manifest["entries"]),
                      "buckets": [(e["batch"], e["samples"])
                                  for e in manifest["entries"]]}))


if __name__ == "__main__":
    main()
