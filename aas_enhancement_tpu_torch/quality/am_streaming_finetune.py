"""Live-deployment AM adaptation (port of the JAX repo's
``scripts/am_streaming_finetune.py``).

The AM fine-tunes on the deployed feature distribution: the frozen enhancer
runs its block-streaming forward (``TrainConfig.streaming_finetune``) and the
AM trains through its own (``streaming_finetune_am`` ->
``models/am.py::am_blockwise_apply``), both in the ``am`` objective's step
(``am_through_enhancer``), at ``lr_am * --lr-scale``, optionally anchored to
the base AM's posteriors (``--distill``: ``TrainConfig.distill_lambda``, a
KL term to the AM as the run started).  ``--offline`` adapts the AM to the
offline pipeline instead (full-sequence forwards everywhere).

The new train state is ``init_state`` seed 17 of the fine-tune's config,
holding the workdir's AM (or ``--am-init``'s) and G (or ``--g-checkpoint``'s):
fresh SGD, step 0.  Measured before and after: greedy WER of the
streamed-enhancer + offline-AM chain on dev and test (``--offline``: the
offline enhanced WER), written as JSON; the adapted AM is saved as a
train-CLI checkpoint (``ck_am_stream_ft`` / ``ck_am_offline_ft``) for
``live_pipeline_eval --am-checkpoint`` and ``coadapt_alternate``.

Usage:
  python -m aas_enhancement_tpu_torch.quality.am_streaming_finetune --workdir /tmp/aas_e2e \\
      [--g-checkpoint DIR] [--steps 300] [--distill 1.0] [--offline] [--out r.json] \\
      [--device cuda|cpu]
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
from aas_enhancement_tpu_torch.train.loop import init_state, load_state, train

SEED = 17


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--chunk", type=float, default=1.0)
    p.add_argument("--lookahead", type=float, default=0.5)
    p.add_argument("--history", type=float, default=0.5)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr-scale", type=float, default=0.1,
                   help="fine-tune the AM at lr_am * this")
    p.add_argument("--g-checkpoint", default="",
                   help="frozen enhancer of this train-CLI checkpoint (e.g. ck_stream_ft "
                        "from streaming_finetune_eval); default: the workdir's G")
    p.add_argument("--distill", type=float, default=0.0,
                   help="posterior-anchor distillation weight (TrainConfig."
                        "distill_lambda): a KL term tying the adapted AM's frame "
                        "posteriors to the base AM's on the same features")
    p.add_argument("--offline", action="store_true",
                   help="offline co-adaptation: both networks run their full-sequence "
                        "forwards; measures the offline enhanced greedy WER before and "
                        "after instead of the streamed-feature legs")
    p.add_argument("--save-checkpoint", default="",
                   help="write the adapted AM as a train-CLI checkpoint dir; default "
                        "<workdir>/ck_am_stream_ft (--offline: ck_am_offline_ft), '-' to "
                        "skip")
    p.add_argument("--am-init", default="",
                   help="train-CLI checkpoint whose AM starts the fine-tune instead of the "
                        "workdir's base AM (a later block of an alternating co-adaptation)")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def train_config(cfg: Config, args: argparse.Namespace) -> Config:
    """The e2e configuration with the ``am`` objective through the frozen G."""
    ft_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, objective="am", am_through_enhancer=True,
        streaming_finetune=not args.offline, streaming_finetune_am=not args.offline,
        stream_chunk_s=args.chunk, stream_lookahead_s=args.lookahead,
        stream_history_s=args.history, lr_am=cfg.train.lr_am * args.lr_scale,
        distill_lambda=args.distill, batch_size=args.batch_size, epochs=100000,
        spec_augment=False))
    return ft_cfg.replace(data=dataclasses.replace(ft_cfg.data, val_manifest=""))


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    wd = args.workdir
    w = workdir.load(wd, device)
    cfg, meta = w.cfg, w.meta
    am, g = w.state.am, w.state.g
    if args.g_checkpoint:
        g = load_state(args.g_checkpoint, device)[0].g
    if args.am_init:
        am = load_state(args.am_init, device)[0].am

    fwd_plain = make_eval_forward(cfg, use_enhancer=False)

    def streamed(tag, manifest):
        """The frozen G streamed at the operating point -> enhanced-wav
        manifest (the offline mirror of the live AM's input)."""
        return workdir.streamed_manifest(cfg, g, manifest,
                                         os.path.join(wd, f"am_ft_stream_{tag}"),
                                         args.chunk, args.lookahead, args.history, device)

    t0 = time.time()
    result = {"steps": args.steps, "offline": args.offline, "chunk_s": args.chunk,
              "lookahead_s": args.lookahead, "history_s": args.history,
              "g_checkpoint": args.g_checkpoint, "lr_scale": args.lr_scale,
              "distill_lambda": args.distill, "am_init": args.am_init}

    fwd_enh = make_eval_forward(cfg, use_enhancer=True)

    def wer_on(mani, am_):
        return evaluate_wer(cfg, am_, mani, batch_size=args.batch_size,
                            forward=fwd_plain)["wer"]

    def wer_offline(mani, am_):
        return evaluate_wer(cfg, am_, mani, enhancer=g, batch_size=args.batch_size,
                            forward=fwd_enh)["wer"]

    if args.offline:
        result["wer_offline_dev_before"] = wer_offline(meta["dev_noisy"], am)
        result["wer_offline_test_before"] = wer_offline(meta["test_noisy"], am)
    else:
        # The adaptation target: greedy WER on streamed-enhanced features.
        dev_s = streamed("dev", meta["dev_noisy"])
        test_s = streamed("test", meta["test_noisy"])
        result["wer_streamed_feats_dev_before"] = wer_on(dev_s, am)
        result["wer_streamed_feats_test_before"] = wer_on(test_s, am)
        result["wer_offline_test_before"] = wer_offline(meta["test_noisy"], am)

    # Fine-tune: frozen G -> AM, blockwise forwards unless --offline.
    ft_cfg = train_config(cfg, args)
    state = init_state(ft_cfg, SEED, device)
    state.am.load_state_dict(am.state_dict())
    state.g.load_state_dict(g.state_dict())
    state, recs = train(ft_cfg, meta["train_noisy"], max_steps=args.steps, state=state,
                        device=device)
    ctc = [r["loss_ctc_am"] for r in recs if "loss_ctc_am" in r]
    result["ft_loss_first"], result["ft_loss_last"] = ctc[0], ctc[-1]

    am_ft = state.am
    if args.offline:
        result["wer_offline_dev_after"] = wer_offline(meta["dev_noisy"], am_ft)
        result["wer_offline_test_after"] = wer_offline(meta["test_noisy"], am_ft)
        result["offline_improvement"] = (result["wer_offline_test_before"]
                                         - result["wer_offline_test_after"])
    else:
        result["wer_streamed_feats_dev_after"] = wer_on(dev_s, am_ft)
        result["wer_streamed_feats_test_after"] = wer_on(test_s, am_ft)
        result["wer_offline_test_after"] = wer_offline(meta["test_noisy"], am_ft)
        result["streamed_feats_improvement"] = (result["wer_streamed_feats_test_before"]
                                                - result["wer_streamed_feats_test_after"])

    if args.save_checkpoint != "-":
        ck_dir = args.save_checkpoint or os.path.join(
            wd, "ck_am_offline_ft" if args.offline else "ck_am_stream_ft")
        workdir.save_checkpoint(ck_dir, ft_cfg, state)
        result["checkpoint_dir"] = ck_dir

    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    workdir.write_json(args.out or os.path.join(wd, "am_streaming_finetune.json"), result)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
