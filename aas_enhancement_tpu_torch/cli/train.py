"""`train` entry point of the port (counterpart of ``aas_enhancement_tpu/cli/train.py``).

  adversarial  GAN on the spectrogram discriminator, needs --clean-manifest (unpaired)
  acoustic     CTC of the frozen AM on the enhanced features
  aas          both: L_G = L_CTC + lambda_adv * L_adv, needs --clean-manifest
  am           AM CTC pre-training on --noisy-manifest (typically the clean
               corpus): SGD with Nesterov momentum, optional --spec-augment and
               --am-through-enhancer (the frozen enhancer in front of the AM)

Same flags and final JSON line as the JAX CLI, plus ``--device``.  Metric
records go to stderr as JSON lines; the last stdout line is
{"final_step": N, "loss_...": ...}.

Usage:
  python -m aas_enhancement_tpu_torch.cli.train --objective aas \\
      --noisy-manifest noisy.csv --clean-manifest clean.csv --steps 100 \\
      [--am-checkpoint seed:0] [--config cfg.json] [--device cuda|cpu]

Weights: reading the JAX package's Orbax checkpoints is not ported yet
(ROADMAP A9), so ``--am-checkpoint`` and ``--g-checkpoint`` take ``seed:N``
(that network's weights drawn from seed N with flax's init distributions;
for ``am`` the AM's initial weights and the frozen enhancer's).
Not ported yet, and raising with their ROADMAP item: the objective
``paired`` (A8); ``--checkpoint-dir``, ``--continue-from``, ``--val-manifest``,
``--eval-every``, ``--metrics``, ``--tensorboard``, ``--profile-dir`` and
``--sortagrad`` (A9); ``--streaming-finetune``, ``--streaming-finetune-am``
and ``--stream-*`` (A11).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.cli.evaluate import checkpoint_seed
from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.train.loop import init_state, train

# flag (argparse dest) -> ROADMAP item of what it needs
_UNPORTED = {
    "checkpoint_dir": "A9", "resume": "A9", "val_manifest": "A9", "metrics": "A9",
    "tensorboard": "A9", "profile_dir": "A9", "sortagrad": "A9",
    "streaming_finetune": "A11", "streaming_finetune_am": "A11",
    "stream_chunk": "A11", "stream_lookahead": "A11", "stream_history": "A11",
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--objective", required=True,
                   choices=["paired", "adversarial", "acoustic", "aas", "am"])
    p.add_argument("--noisy-manifest", required=True,
                   help="training manifest (the clean manifest for --objective am)")
    p.add_argument("--clean-manifest", help="unpaired clean corpus (adversarial, aas)")
    p.add_argument("--am-checkpoint",
                   help="seed:N, the frozen AM of acoustic/aas or the initial AM of "
                        "am (checkpoints: ROADMAP A9)")
    p.add_argument("--config", help="config JSON file")
    p.add_argument("--steps", type=int, default=0, help="stop after N steps (0 = epochs)")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--grad-accum", type=int, default=0,
                   help="split each batch into k microbatches, one update")
    p.add_argument("--lambda-adv", type=float, default=None)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--val-manifest", help="(validation: ROADMAP A9)")
    p.add_argument("--eval-every", type=int, default=-1, help="(validation only)")
    p.add_argument("--lr-anneal", type=float, default=None,
                   help="per-epoch LR divisor, e.g. 1.1")
    p.add_argument("--spec-augment", action="store_true",
                   help="SpecAugment time and frequency masking of the AM's "
                        "features (objective am)")
    p.add_argument("--sortagrad", action="store_true", help="(ROADMAP A9)")
    p.add_argument("--streaming-finetune", action="store_true", help="(ROADMAP A11)")
    p.add_argument("--stream-chunk", type=float, default=None, help="(ROADMAP A11)")
    p.add_argument("--stream-lookahead", type=float, default=None, help="(ROADMAP A11)")
    p.add_argument("--stream-history", type=float, default=None, help="(ROADMAP A11)")
    p.add_argument("--streaming-finetune-am", action="store_true", help="(ROADMAP A11)")
    p.add_argument("--am-through-enhancer", action="store_true",
                   help="objective am: feed the AM the FROZEN enhancer's output "
                        "features (the enhancer from --g-checkpoint)")
    p.add_argument("--g-checkpoint",
                   help="seed:N, the enhancer's initial weights (frozen with "
                        "--am-through-enhancer)")
    p.add_argument("--checkpoint-dir", default="", help="(ROADMAP A9)")
    p.add_argument("--continue-from", dest="resume", action="store_true",
                   help="(ROADMAP A9)")
    p.add_argument("--metrics", help="(JSONL metrics file: ROADMAP A9)")
    p.add_argument("--profile-dir", help="(ROADMAP A9)")
    p.add_argument("--tensorboard", help="(ROADMAP A9)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    for dest, item in _UNPORTED.items():
        value = getattr(args, dest)
        if value not in (None, False, ""):
            flag = "--continue-from" if dest == "resume" else "--" + dest.replace("_", "-")
            raise NotImplementedError(f"{flag}: not yet ported (ROADMAP {item})")
    if args.eval_every >= 0:
        raise NotImplementedError("--eval-every: validation is not yet ported (ROADMAP A9)")
    if args.objective == "paired":
        raise NotImplementedError("--objective paired: not yet ported (ROADMAP A8)")
    if args.am_through_enhancer and args.objective != "am":
        p.error("--am-through-enhancer only applies to --objective am")
    if args.objective in ("adversarial", "aas") and not args.clean_manifest:
        p.error(f"--objective {args.objective} requires --clean-manifest (unpaired corpus)")
    am_seed = (checkpoint_seed("--am-checkpoint", args.am_checkpoint)
               if args.am_checkpoint else None)
    g_seed = (checkpoint_seed("--g-checkpoint", args.g_checkpoint)
              if args.g_checkpoint else None)
    device = resolve_device(args.device)

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    tr = {"objective": args.objective}
    for key, value in (("epochs", args.epochs), ("batch_size", args.batch_size),
                       ("grad_accum", args.grad_accum), ("log_every", args.log_every)):
        if value:
            tr[key] = value
    if args.lambda_adv is not None:
        tr["lambda_adv"] = args.lambda_adv
    if args.lr_anneal is not None:
        tr["lr_anneal"] = args.lr_anneal
    if args.spec_augment:
        tr["spec_augment"] = True
    if args.am_through_enhancer:
        tr["am_through_enhancer"] = True
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))

    if am_seed is None and args.objective in ("acoustic", "aas"):
        print("WARNING: no --am-checkpoint given; using a RANDOM-INIT frozen AM "
              "(fine for smoke tests, useless as supervision)", flush=True)
    if args.am_through_enhancer and g_seed is None:
        print("WARNING: --am-through-enhancer without --g-checkpoint; the frozen "
              "enhancer is RANDOM-INIT (fine for smoke tests, not a deployment "
              "distribution)", flush=True)
    state = init_state(cfg, cfg.train.seed, device, g_seed=g_seed, am_seed=am_seed)
    state, records = train(cfg, args.noisy_manifest, args.clean_manifest,
                           max_steps=args.steps, state=state, device=device)

    final = next((r for r in reversed(records)
                  if any(k.startswith("loss") for k in r)), {})
    print(json.dumps({"final_step": int(state.step),
                      **{k: v for k, v in final.items() if k.startswith("loss")}}))


if __name__ == "__main__":
    main()
