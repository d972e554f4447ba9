"""Streaming latency-quality curve: the chunk x lookahead x history sweep
(port of the JAX repo's ``scripts/streaming_sweep.py``).

Streams the held-out test split through the workdir's trained enhancer at
every point of the grid (``StreamingEnhancer``, then the offline AM,
greedy) and writes latency (chunk + lookahead seconds) against WER, beside
the noisy and the offline-enhanced WER; each point's row is printed as it
is measured.  The inputs come from a ``cli.e2e`` run with the same
``--workdir``.

Usage:
  python -m aas_enhancement_tpu_torch.cli.e2e --workdir /tmp/aas_e2e_hard \\
      --snr-low -7 --snr-high -2 --aas-steps 400 --skip-streaming
  python -m aas_enhancement_tpu_torch.quality.streaming_sweep --workdir /tmp/aas_e2e_hard \\
      [--chunks 0.5,1.0,2.0 --lookaheads 0.1,0.2,0.5 --histories 0.5,1.0,2.0] \\
      [--out sweep.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import tempfile
import time

from aas_enhancement_tpu_torch.evaluation import evaluate_wer, make_eval_forward
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "aas_e2e"),
                   help="a cli.e2e workdir (its checkpoint and corpora)")
    p.add_argument("--chunks", default="0.5,1.0,2.0",
                   help="chunk seconds grid (comma-separated)")
    p.add_argument("--lookaheads", default="0.1,0.2,0.5")
    p.add_argument("--histories", default="0.5,1.0,2.0")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    wd = args.workdir
    state_path = os.path.join(wd, "sweep_state.json")
    if not os.path.exists(state_path):
        raise SystemExit(f"{state_path} missing — run aas_enhancement_tpu_torch.cli.e2e "
                         "with this --workdir first (it saves the trained state + corpus "
                         "paths)")
    w = workdir.load(wd, device)
    cfg, am, g = w.cfg, w.state.am, w.state.g
    test_noisy = w.meta["test_noisy"]

    forward = make_eval_forward(cfg, use_enhancer=False)

    # The offline reference point.
    fwd_enh = make_eval_forward(cfg, use_enhancer=True)
    offline = evaluate_wer(cfg, am, test_noisy, enhancer=g, batch_size=args.batch_size,
                           forward=fwd_enh)
    noisy = evaluate_wer(cfg, am, test_noisy, batch_size=args.batch_size, forward=forward)

    chunks = [float(x) for x in args.chunks.split(",")]
    lookaheads = [float(x) for x in args.lookaheads.split(",")]
    histories = [float(x) for x in args.histories.split(",")]
    grid = []
    t0 = time.time()
    for c, la, h in itertools.product(chunks, lookaheads, histories):
        smanifest = workdir.streamed_manifest(cfg, g, test_noisy,
                                              os.path.join(wd, f"sweep_c{c}_l{la}_h{h}"),
                                              c, la, h, device)
        wer = evaluate_wer(cfg, am, smanifest, batch_size=args.batch_size,
                           forward=forward)["wer"]
        row = {"chunk_s": c, "lookahead_s": la, "history_s": h, "latency_s": c + la,
               "wer": wer, "penalty_vs_offline": wer - offline["wer"]}
        grid.append(row)
        print(json.dumps(row), flush=True)

    result = {"wer_noisy": noisy["wer"], "wer_offline": offline["wer"],
              "grid": sorted(grid, key=lambda r: (r["latency_s"], r["wer"])),
              "wall_minutes": round((time.time() - t0) / 60.0, 1)}
    workdir.write_json(args.out or os.path.join(wd, "streaming_sweep.json"), result)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps({k: v for k, v in result.items() if k != "grid"}))
    return result


if __name__ == "__main__":
    main()
