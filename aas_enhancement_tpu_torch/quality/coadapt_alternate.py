"""Block-coordinate co-adaptation: G re-fine-tuned against the adapted AM
(port of the JAX repo's ``scripts/coadapt_alternate.py``).

``am_streaming_finetune --offline`` adapts the AM to the frozen enhancer's
output; this is the complementary coordinate step: the enhancer fine-tunes
under the frozen-AM CTC objective (``acoustic``) where the frozen AM is the
co-adapted one, at ``lr_g * --lr-scale``.  The new train state is
``init_state`` seed 23 of the fine-tune's config, holding the adapted AM
and the workdir's G (or ``--g-init``'s): fresh Adam, step 0.

Measures greedy offline WER on dev and test for (G', adapted AM) before and
after, and the cross-pairing (G', base AM) on test; saves G' as a train-CLI
checkpoint (``ck_g_coadapt``) for ``hybrid_fusion_eval --g-checkpoint
--am-checkpoint``.

Usage:
  python -m aas_enhancement_tpu_torch.quality.coadapt_alternate --workdir /tmp/aas_e2e \\
      [--am-checkpoint <wd>/ck_am_offline_ft] [--steps 300] [--out r.json] \\
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

SEED = 23


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--am-checkpoint", default="",
                   help="co-adapted AM (default <workdir>/ck_am_offline_ft)")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr-scale", type=float, default=0.1,
                   help="fine-tune G at lr_g * this")
    p.add_argument("--save-checkpoint", default="",
                   help="write G' as a train-CLI checkpoint dir; default "
                        "<workdir>/ck_g_coadapt, '-' to skip")
    p.add_argument("--g-init", default="",
                   help="train-CLI checkpoint whose G starts the coordinate step instead "
                        "of the workdir's offline G (a later block of the alternation)")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def train_config(cfg: Config, args: argparse.Namespace) -> Config:
    """The e2e configuration with ``acoustic`` (G under the frozen AM's CTC)."""
    ft_cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, objective="acoustic", lr_g=cfg.train.lr_g * args.lr_scale,
        batch_size=args.batch_size, epochs=100000, spec_augment=False,
        streaming_finetune=False, streaming_finetune_am=False, am_through_enhancer=False))
    return ft_cfg.replace(data=dataclasses.replace(ft_cfg.data, val_manifest=""))


def run(args: argparse.Namespace) -> dict:
    device = resolve_device(args.device)
    wd = args.workdir
    w = workdir.load(wd, device)
    cfg, meta = w.cfg, w.meta
    am_base, g0 = w.state.am, w.state.g
    if args.g_init:
        g0 = load_state(args.g_init, device)[0].g

    am_ck = args.am_checkpoint or os.path.join(wd, "ck_am_offline_ft")
    am_ft = load_state(am_ck, device)[0].am

    fwd_enh = make_eval_forward(cfg, use_enhancer=True)

    def wer(mani, am, g):
        return evaluate_wer(cfg, am, mani, enhancer=g, batch_size=args.batch_size,
                            forward=fwd_enh)["wer"]

    t0 = time.time()
    result = {"steps": args.steps, "am_checkpoint": am_ck, "lr_scale": args.lr_scale,
              "g_init": args.g_init}
    result["wer_test_before"] = wer(meta["test_noisy"], am_ft, g0)
    result["wer_dev_before"] = wer(meta["dev_noisy"], am_ft, g0)

    # Coordinate step: G under the frozen co-adapted AM's CTC.
    ft_cfg = train_config(cfg, args)
    state = init_state(ft_cfg, SEED, device)
    state.am.load_state_dict(am_ft.state_dict())
    state.g.load_state_dict(g0.state_dict())
    state, recs = train(ft_cfg, meta["train_noisy"], max_steps=args.steps, state=state,
                        device=device)
    ctc = [r["loss_ctc"] for r in recs if "loss_ctc" in r]
    if ctc:
        result["ft_loss_first"], result["ft_loss_last"] = ctc[0], ctc[-1]

    g2 = state.g
    result["wer_test_after"] = wer(meta["test_noisy"], am_ft, g2)
    result["wer_dev_after"] = wer(meta["dev_noisy"], am_ft, g2)
    # Cross-pairing anchor: G' under the original AM (pair-specific or generic?).
    result["wer_test_gprime_base_am"] = wer(meta["test_noisy"], am_base, g2)
    result["improvement"] = result["wer_test_before"] - result["wer_test_after"]

    if args.save_checkpoint != "-":
        ck_dir = args.save_checkpoint or os.path.join(wd, "ck_g_coadapt")
        workdir.save_checkpoint(ck_dir, ft_cfg, state)
        result["checkpoint_dir"] = ck_dir

    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    workdir.write_json(args.out or os.path.join(wd, "coadapt_alternate.json"), result)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
