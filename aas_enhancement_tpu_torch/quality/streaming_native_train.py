"""Streaming-native AAS training (port of the JAX repo's
``scripts/streaming_native_train.py``).

The enhancer trains under the full AAS objective with its forward replaced
by the deployed block-bidirectional windowing (``TrainConfig.
streaming_finetune`` -> ``models/enhancer.py::blockwise_apply``) at the
serving operating point, for the full flagship step budget: from a fresh
draw (``--init scratch``, seed ``--seed``) or, ``--init trained``, from the
workdir's offline-trained G and D (fresh optimizers, step 0).  The AM stays
the workdir's frozen offline-pre-trained one.

Measures greedy WER offline (enhancer + AM) and on streamed features
(``StreamingEnhancer`` at the same point, then the offline AM) on the
held-out test split, against the workdir's G as the anchor, and saves a
train-CLI checkpoint (``ck_g_stream_native``; its config records the
operating point) that ``live_pipeline_eval --g-checkpoint`` and
``cli.serve --streaming-checkpoint`` take.

Usage:
  python -m aas_enhancement_tpu_torch.quality.streaming_native_train \\
      --workdir /tmp/aas_e2e --steps 1000 [--chunk 1.0 --lookahead 0.5 \\
      --history 0.5] [--init scratch|trained] [--out r.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.evaluation import evaluate_wer, make_eval_forward
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.train.loop import init_state, train


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=1000,
                   help="full flagship AAS budget, not a 300-step patch")
    p.add_argument("--chunk", type=float, default=1.0)
    p.add_argument("--lookahead", type=float, default=0.5)
    p.add_argument("--history", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--init", choices=("scratch", "trained"), default="scratch",
                   help="G/D init: fresh (streaming-native, default) or the workdir's "
                        "offline-trained weights (long blockwise continuation at full lr)")
    p.add_argument("--seed", type=int, default=31)
    p.add_argument("--save-checkpoint", default="",
                   help="train-CLI checkpoint dir for the streaming-native G; default "
                        "<workdir>/ck_g_stream_native, '-' to skip")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def train_config(cfg: Config, args: argparse.Namespace) -> Config:
    """The e2e configuration with blockwise ``aas`` at the operating point."""
    tr_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, objective="aas", streaming_finetune=True, streaming_finetune_am=False,
        am_through_enhancer=False, stream_chunk_s=args.chunk,
        stream_lookahead_s=args.lookahead, stream_history_s=args.history,
        batch_size=args.batch_size, epochs=100000, spec_augment=False))
    return tr_cfg.replace(data=dataclasses.replace(tr_cfg.data, val_manifest=""))


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    wd = args.workdir
    w = workdir.load(wd, device)
    cfg, meta = w.cfg, w.meta
    am, g_offline = w.state.am, w.state.g

    t0 = time.time()
    result = {"steps": args.steps, "init": args.init, "chunk_s": args.chunk,
              "lookahead_s": args.lookahead, "history_s": args.history}

    fwd_plain = make_eval_forward(cfg, use_enhancer=False)
    fwd_enh = make_eval_forward(cfg, use_enhancer=True)

    def wer_offline(mani, g):
        return evaluate_wer(cfg, am, mani, enhancer=g, batch_size=args.batch_size,
                            forward=fwd_enh)["wer"]

    def wer_streamed(tag, mani, g):
        smani = workdir.streamed_manifest(cfg, g, mani,
                                          os.path.join(wd, f"stream_native_{tag}"),
                                          args.chunk, args.lookahead, args.history, device)
        return evaluate_wer(cfg, am, smani, batch_size=args.batch_size,
                            forward=fwd_plain)["wer"]

    # Anchors: the workdir's offline-trained G at the same operating point.
    result["wer_offline_test_anchor"] = wer_offline(meta["test_noisy"], g_offline)
    result["wer_streamed_feats_test_anchor"] = wer_streamed("anchor", meta["test_noisy"],
                                                            g_offline)

    # Streaming-native AAS training, G's forward blockwise throughout.
    tr_cfg = train_config(cfg, args)
    state = init_state(tr_cfg, args.seed, device)
    state.am = am
    if args.init == "trained":
        state.g.load_state_dict(g_offline.state_dict())
        state.d.load_state_dict(w.state.d.state_dict())
    state, recs = train(tr_cfg, meta["train_noisy"], meta["train_clean"],
                        max_steps=args.steps, state=state, device=device)
    ctc = [r["loss_ctc"] for r in recs if "loss_ctc" in r]
    if ctc:
        result["ctc_first"], result["ctc_last"] = ctc[0], ctc[-1]

    g_native = state.g
    result["wer_offline_test"] = wer_offline(meta["test_noisy"], g_native)
    result["wer_streamed_feats_test"] = wer_streamed("native", meta["test_noisy"], g_native)
    result["wer_streamed_feats_dev"] = wer_streamed("native_dev", meta["dev_noisy"], g_native)
    result["streamed_improvement_vs_offline_g"] = (result["wer_streamed_feats_test_anchor"]
                                                   - result["wer_streamed_feats_test"])

    if args.save_checkpoint != "-":
        ck_dir = args.save_checkpoint or os.path.join(wd, "ck_g_stream_native")
        workdir.save_checkpoint(ck_dir, tr_cfg, state)
        result["checkpoint_dir"] = ck_dir

    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    workdir.write_json(args.out or os.path.join(wd, "streaming_native_train.json"), result)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
