"""Streaming-aware fine-tuning (port of the JAX repo's
``scripts/streaming_finetune_eval.py``).

Loads the trained AAS train state of a ``cli.e2e`` workdir with its
optimizers and step count (``utils/checkpoint.py::restore``), measures the
streamed held-out WER at the deployment operating point, fine-tunes the
enhancer for ``--steps`` more AAS steps through the block-bidirectional
streaming forward (``TrainConfig.streaming_finetune`` with the same chunk,
lookahead and history; G at ``lr_g * --lr-scale``, D and the AM as they
were), continuing the saved optimizer state, and measures again.  The
fine-tuned state is saved as a train-CLI checkpoint (``ck_stream_ft``),
which ``cli.serve --streaming-checkpoint`` loads.

Usage:
  python -m aas_enhancement_tpu_torch.quality.streaming_finetune_eval \\
      --workdir /tmp/aas_e2e_hard --steps 200 [--out stream_ft.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.evaluation import evaluate_wer, make_eval_forward
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.train.loop import train


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "aas_e2e"))
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--chunk", type=float, default=1.0)
    p.add_argument("--lookahead", type=float, default=0.2)
    p.add_argument("--history", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr-scale", type=float, default=0.5,
                   help="fine-tune G at lr_g * this (keep D/AM lrs)")
    p.add_argument("--save-checkpoint", default="",
                   help="also write the fine-tuned state as a train-CLI checkpoint dir "
                        "(servable via `cli.serve --streaming-checkpoint`); default "
                        "<workdir>/ck_stream_ft, '-' to skip")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def train_config(cfg: Config, args: argparse.Namespace) -> Config:
    """The e2e configuration with G's forward blockwise at the operating point."""
    return cfg.replace(train=dataclasses.replace(
        cfg.train, streaming_finetune=True, stream_chunk_s=args.chunk,
        stream_lookahead_s=args.lookahead, stream_history_s=args.history,
        lr_g=cfg.train.lr_g * args.lr_scale, batch_size=args.batch_size))


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    wd = args.workdir
    w = workdir.load(wd, device, optimizers=True)
    cfg, meta, state = w.cfg, w.meta, w.state
    am = state.am

    fwd_plain = make_eval_forward(cfg, use_enhancer=False)

    def streamed_wer(g, tag):
        smanifest = workdir.streamed_manifest(cfg, g, meta["test_noisy"],
                                              os.path.join(wd, f"ft_stream_{tag}"),
                                              args.chunk, args.lookahead, args.history, device)
        return evaluate_wer(cfg, am, smanifest, batch_size=args.batch_size,
                            forward=fwd_plain)["wer"]

    t0 = time.time()
    result = {"steps": args.steps, "chunk_s": args.chunk, "lookahead_s": args.lookahead,
              "history_s": args.history}
    fwd_enh = make_eval_forward(cfg, use_enhancer=True)
    result["wer_offline_before"] = evaluate_wer(
        cfg, am, meta["test_noisy"], enhancer=state.g, batch_size=args.batch_size,
        forward=fwd_enh)["wer"]
    result["wer_streamed_before"] = streamed_wer(state.g, "before")

    # Fine-tune through the block-bidirectional forward, continuing from the
    # saved optimizer state; the windowing matches the deployment point.
    ft_cfg = train_config(cfg, args)
    target = state.step + args.steps
    state, recs = train(ft_cfg, meta["train_noisy"], meta["train_clean"], max_steps=target,
                        state=state, device=device)
    result["ft_loss_first"] = next(r["loss_g"] for r in recs if "loss_g" in r)
    result["ft_loss_last"] = [r["loss_g"] for r in recs if "loss_g" in r][-1]

    # The fine-tuned state as a train-CLI checkpoint: what
    # `cli.serve --streaming-checkpoint` loads for its transcribe mode.
    if args.save_checkpoint != "-":
        ck_dir = args.save_checkpoint or os.path.join(wd, "ck_stream_ft")
        workdir.save_checkpoint(ck_dir, ft_cfg, state)
        result["checkpoint_dir"] = ck_dir

    g_ft = state.g
    result["wer_streamed_after"] = streamed_wer(g_ft, "after")
    result["wer_offline_after"] = evaluate_wer(
        cfg, am, meta["test_noisy"], enhancer=g_ft, batch_size=args.batch_size,
        forward=fwd_enh)["wer"]
    result["streamed_improvement"] = (result["wer_streamed_before"]
                                      - result["wer_streamed_after"])
    result["penalty_before"] = result["wer_streamed_before"] - result["wer_offline_before"]
    result["penalty_after"] = result["wer_streamed_after"] - result["wer_offline_after"]
    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)

    workdir.write_json(args.out or os.path.join(wd, "streaming_finetune.json"), result)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
