"""`train` entry point of the port (counterpart of ``aas_enhancement_tpu/cli/train.py``).

  paired       L1 between enhanced and clean log-magnitudes (plus the config's
               lambda_mrstft x the MR-STFT loss), needs --clean-manifest: the
               paired clean corpus, in the noisy manifest's order
  adversarial  GAN on the spectrogram discriminator, needs --clean-manifest (unpaired)
  acoustic     CTC of the frozen AM on the enhanced features
  aas          both: L_G = L_CTC + lambda_adv * L_adv, needs --clean-manifest
  am           AM CTC pre-training on --noisy-manifest (typically the clean
               corpus): SGD with Nesterov momentum, optional --spec-augment and
               --am-through-enhancer (the frozen enhancer in front of the AM)

Same flags and final JSON line as the JAX CLI, plus ``--device`` and
``--dist-backend``.  Metric records go to stderr as JSON lines (and to
``--metrics`` / ``--tensorboard``); the last stdout line is {"final_step": N,
"loss_...": ..., and with ``--val-manifest`` "val_wer" (and, but for
``paired``, "val_wer_noisy")}.

Data parallelism: under ``torchrun --nproc_per_node N`` each process is a
rank on ``cuda:$LOCAL_RANK`` (the default ``--device``) with nccl, and the
global ``--batch-size`` splits over the ranks (``parallel/mesh.py``); the
config's ``mesh.num_devices`` is 0 (every process) or N.  Rank 0 alone
writes the checkpoints, the metrics and the final JSON line.  Ranks that
share one card (or run on the CPU) take ``--dist-backend gloo``.

Usage:
  python -m aas_enhancement_tpu_torch.cli.train --objective aas \\
      --noisy-manifest noisy.csv --clean-manifest clean.csv --steps 100 \\
      [--am-checkpoint ckpt_am/] [--checkpoint-dir ckpt_g/ [--continue-from]] \\
      [--val-manifest dev.csv --eval-every 50] [--config cfg.json] [--device cuda|cpu]
  torchrun --standalone --nproc_per_node 8 -m aas_enhancement_tpu_torch.cli.train \
      --objective am --noisy-manifest clean.csv --steps 100
  torchrun --standalone --nproc_per_node 2 -m aas_enhancement_tpu_torch.cli.train \
      --objective am --noisy-manifest clean.csv --device cpu      # gloo on the CPU

Weights: ``--am-checkpoint`` and ``--g-checkpoint`` take a train-CLI
checkpoint directory of the port (``train/loop.py::load_state``; a JAX
package's directory converts with ``scripts/orbax_to_torch.py``) or
``seed:N`` (that network's weights drawn from seed N with flax's init
distributions).  The frozen AM keeps the checkpoint's architecture (its
``am`` config section), and so does a warm-started or frozen enhancer; for
``adversarial`` / ``aas`` the ``--g-checkpoint``'s discriminator comes too;
for ``paired`` and ``adversarial`` the ``--am-checkpoint`` is validation's
decode-only AM.  An ``am`` run keeps the ``--g-checkpoint``'s enhancer
frozen in its state, also without ``--am-through-enhancer`` (the step does
not read it then), so its checkpoints carry it, as the JAX CLI's do.
``config.json`` is written into ``--checkpoint-dir`` before training.
``--streaming-finetune`` trains G (or the ``am`` objective's frozen G runs)
through the blockwise streaming forward, ``--streaming-finetune-am`` the AM,
at the ``--stream-chunk`` / ``--stream-lookahead`` / ``--stream-history``
operating point in seconds (the config's ``train.stream_*_s``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.cli.evaluate import checkpoint_seed
from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.enhance import init_enhancer
from aas_enhancement_tpu_torch.parallel.mesh import make_mesh
from aas_enhancement_tpu_torch.train.loop import init_state, keep_frozen_g, load_state, train


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--objective", required=True,
                   choices=["paired", "adversarial", "acoustic", "aas", "am"])
    p.add_argument("--noisy-manifest", required=True,
                   help="training manifest (the clean manifest for --objective am)")
    p.add_argument("--clean-manifest",
                   help="paired clean corpus (paired) or unpaired clean corpus "
                        "(adversarial, aas)")
    p.add_argument("--am-checkpoint",
                   help="AM checkpoint dir or seed:N: the frozen AM of acoustic/aas, "
                        "the initial AM of am, the decode-only validation AM of "
                        "paired/adversarial")
    p.add_argument("--config", help="config JSON file")
    p.add_argument("--steps", type=int, default=0, help="stop after N steps (0 = epochs)")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=0)
    p.add_argument("--grad-accum", type=int, default=0,
                   help="split each batch into k microbatches, one update")
    p.add_argument("--lambda-adv", type=float, default=None)
    p.add_argument("--log-every", type=int, default=0)
    p.add_argument("--val-manifest",
                   help="dev manifest: periodic greedy-WER validation + best-WER "
                        "checkpoint selection")
    p.add_argument("--eval-every", type=int, default=-1,
                   help="validate every N steps (0 = each epoch end)")
    p.add_argument("--lr-anneal", type=float, default=None,
                   help="per-epoch LR divisor, e.g. 1.1")
    p.add_argument("--spec-augment", action="store_true",
                   help="SpecAugment time and frequency masking of the AM's "
                        "features (objective am)")
    p.add_argument("--sortagrad", action="store_true",
                   help="serve epoch 0 strictly shortest-first")
    p.add_argument("--streaming-finetune", action="store_true",
                   help="train G through the block-bidirectional streaming forward "
                        "(chunked inference parity)")
    p.add_argument("--stream-chunk", type=float, default=None,
                   help="streaming fine-tuning chunk seconds (default 1.0)")
    p.add_argument("--stream-lookahead", type=float, default=None,
                   help="streaming fine-tuning lookahead seconds (default 0.2)")
    p.add_argument("--stream-history", type=float, default=None,
                   help="streaming fine-tuning history seconds (default 1.0)")
    p.add_argument("--streaming-finetune-am", action="store_true",
                   help="objective am: train the AM through the block-streaming AM "
                        "forward at the --stream-* operating point")
    p.add_argument("--am-through-enhancer", action="store_true",
                   help="objective am: feed the AM the FROZEN enhancer's output "
                        "features (the enhancer from --g-checkpoint)")
    p.add_argument("--g-checkpoint",
                   help="enhancer checkpoint dir or seed:N: the warm start of the "
                        "generator objectives (with its discriminator for "
                        "adversarial/aas), the frozen enhancer of "
                        "--am-through-enhancer")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--continue-from", dest="resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--metrics", help="JSONL metrics path")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler trace of a few steady-state steps "
                        "into this dir (Chrome/Perfetto)")
    p.add_argument("--tensorboard",
                   help="TensorBoard log dir (needs the tensorboard package)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; cuda:$LOCAL_RANK under torchrun) or cpu")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="process group backend under torchrun (default: nccl on cuda, "
                        "gloo on cpu; gloo lets ranks share one card)")
    args = p.parse_args(argv)

    if args.am_through_enhancer and args.objective != "am":
        p.error("--am-through-enhancer only applies to --objective am")
    if args.objective == "paired" and not args.clean_manifest:
        p.error("--objective paired requires --clean-manifest (paired targets)")
    if args.objective in ("adversarial", "aas") and not args.clean_manifest:
        p.error(f"--objective {args.objective} requires --clean-manifest (unpaired corpus)")
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    # "cuda" is cuda:$LOCAL_RANK under torchrun
    mesh = make_mesh(cfg.mesh, resolve_device(args.device), backend=args.dist_backend)
    device = mesh.device
    say = print if mesh.is_main else (lambda *a, **kw: None)
    tr = {"objective": args.objective}
    for key, value in (("epochs", args.epochs), ("batch_size", args.batch_size),
                       ("grad_accum", args.grad_accum), ("log_every", args.log_every)):
        if value:
            tr[key] = value
    for key, value in (("lambda_adv", args.lambda_adv), ("lr_anneal", args.lr_anneal),
                       ("profile_dir", args.profile_dir),
                       ("stream_chunk_s", args.stream_chunk),
                       ("stream_lookahead_s", args.stream_lookahead),
                       ("stream_history_s", args.stream_history)):
        if value is not None:
            tr[key] = value
    if args.eval_every >= 0:
        tr["eval_every"] = args.eval_every
    for key in ("sortagrad", "spec_augment", "am_through_enhancer", "streaming_finetune",
                "streaming_finetune_am"):
        if getattr(args, key):
            tr[key] = True
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **tr))
    if args.val_manifest:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, val_manifest=args.val_manifest))

    am_seed, am = None, None
    if args.am_checkpoint:
        am_seed = checkpoint_seed(args.am_checkpoint)
        if am_seed is None:
            am_state, am_cfg = load_state(args.am_checkpoint, device)
            am = am_state.am
            if am is None:
                p.error(f"{args.am_checkpoint}: checkpoint has no acoustic model "
                        f"(objective was {am_cfg.train.objective!r})")
            cfg = cfg.replace(am=am_cfg.am)    # the frozen AM keeps its architecture
    elif args.objective in ("acoustic", "aas"):
        say("WARNING: no --am-checkpoint given; using a RANDOM-INIT frozen AM "
              "(fine for smoke tests, useless as supervision)", flush=True)
    g_seed, g, d = None, None, None
    if args.g_checkpoint:
        g_seed = checkpoint_seed(args.g_checkpoint)
        if g_seed is None:
            g_state, g_cfg = load_state(args.g_checkpoint, device)
            g = g_state.g
            if g is None:
                p.error(f"{args.g_checkpoint}: checkpoint has no enhancer "
                        f"(objective was {g_cfg.train.objective!r})")
            cfg = cfg.replace(enhancer=g_cfg.enhancer)    # G keeps its architecture
            if args.objective in ("adversarial", "aas") and g_state.d is not None:
                d = g_state.d
                cfg = cfg.replace(discriminator=g_cfg.discriminator)
    elif args.am_through_enhancer:
        say("WARNING: --am-through-enhancer without --g-checkpoint; the frozen "
              "enhancer is RANDOM-INIT (fine for smoke tests, not a deployment "
              "distribution)", flush=True)

    state = init_state(cfg, cfg.train.seed, device, g_seed=g_seed, am_seed=am_seed)
    # Graft the loaded networks' weights; the optimizers keep their parameters.
    for name, net in (("am", am), ("g", g), ("d", d)):
        if net is not None and getattr(state, name) is not None:
            getattr(state, name).load_state_dict(net.state_dict())
    if args.g_checkpoint and state.g is None:
        # An objective that builds no G (am without --am-through-enhancer)
        # keeps the given one frozen in its state, as the JAX CLI grafts it.
        keep_frozen_g(state, cfg, device, g if g is not None
                      else init_enhancer(cfg, g_seed, device))
    if args.checkpoint_dir and mesh.is_main:
        os.makedirs(args.checkpoint_dir, exist_ok=True)
        with open(os.path.join(args.checkpoint_dir, "config.json"), "w") as f:
            f.write(cfg.to_json())

    state, records = train(cfg, args.noisy_manifest, args.clean_manifest,
                           paired=args.objective == "paired", max_steps=args.steps,
                           state=state, device=device, metrics_path=args.metrics,
                           tensorboard_dir=args.tensorboard,
                           checkpoint_dir=args.checkpoint_dir or None, resume=args.resume,
                           eval_am=am if args.objective in ("paired", "adversarial") else None,
                           mesh=mesh)

    final = next((r for r in reversed(records)
                  if any(k.startswith("loss") for k in r)), {})
    out = {"final_step": int(state.step),
           **{k: v for k, v in final.items() if k.startswith("loss")}}
    last_val = next((r for r in reversed(records) if "val_wer" in r), None)
    if last_val is not None:
        out["val_wer"] = last_val["val_wer"]
        if "val_wer_noisy" in last_val:
            out["val_wer_noisy"] = last_val["val_wer_noisy"]
    say(json.dumps(out))
    mesh.close()


if __name__ == "__main__":
    main()
