"""`enhance` entry point: batch-enhance a manifest (or single wav) and write wavs
(port of ``aas_enhancement_tpu/cli/enhance.py``).

Each utterance is padded to a 2/4/8/16 s bucket, run through the
STFT -> enhancer -> ISTFT path on ``--device`` and written; one JSON line
with the real-time factor (wall seconds / audio seconds) ends the run.

With ``--streaming`` each utterance goes through ``streaming.enhance_stream``
instead, in pushes of 0.1 s: blocks of ``--history-seconds`` | ``--chunk-seconds``
| ``--lookahead-seconds``, normalized with running moments.

Usage:
  python -m aas_enhancement_tpu_torch.cli.enhance --manifest noisy_manifest.csv \
      --out-dir out/ [--checkpoint ckpt_g/] [--device cuda|cpu]
      [--streaming [--chunk-seconds 1.0 --lookahead-seconds 0.2 --history-seconds 1.0]]
``--checkpoint`` takes a train-CLI checkpoint directory of the port (a JAX
package's directory converts with ``scripts/orbax_to_torch.py``); without
``--config`` its ``enhancer`` and ``audio`` config sections are used.
Without --checkpoint the network is random-init from the config's train seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.data import read_manifest, read_wav, write_wav
from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.streaming import enhance_stream
from aas_enhancement_tpu_torch.train.loop import load_state


def _bucket_length(n: int, buckets: list[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    # Longer than the largest bucket: round up to its granularity.
    step = buckets[-1]
    return ((n + step - 1) // step) * step


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", help="single noisy wav")
    p.add_argument("--manifest", help="noisy manifest CSV (wav_path,txt_path)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--checkpoint", help="checkpoint dir (omit for random init)")
    p.add_argument("--config", help="config JSON (defaults used if omitted)")
    p.add_argument("--mode", choices=["mask", "mapping"], default=None)
    p.add_argument("--streaming", action="store_true",
                   help="chunked streaming path (block-bidirectional, "
                        "chunk+lookahead latency) instead of whole-utterance")
    p.add_argument("--chunk-seconds", type=float, default=1.0)
    p.add_argument("--lookahead-seconds", type=float, default=0.2)
    p.add_argument("--history-seconds", type=float, default=1.0,
                   help="left context per block (warm fwd-BLSTM state; "
                        "adds compute, not latency)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)

    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    else:
        cfg = Config()
    if args.mode:
        cfg = cfg.replace(enhancer=dataclasses.replace(cfg.enhancer, mode=args.mode))
    state = None
    if args.checkpoint:
        state, ck_cfg = load_state(args.checkpoint, device)
        if state.g is None:
            raise SystemExit(f"{args.checkpoint}: checkpoint has no enhancer")
        if not args.config:
            cfg = cfg.replace(enhancer=ck_cfg.enhancer, audio=ck_cfg.audio)
    if state is None:
        model = init_enhancer(cfg, cfg.train.seed, device)
    else:        # the network of the config, the checkpoint's weights (no draw)
        with torch.device("meta"):
            model = Enhancer(cfg.enhancer, cfg.audio.num_bins)
        model.load_state_dict(state.g.state_dict(), assign=True)
        model.eval()

    paths = []
    if args.input:
        paths.append(args.input)
    if args.manifest:
        paths.extend(w for w, _ in read_manifest(args.manifest))
    if not paths:
        p.error("need --input or --manifest")

    os.makedirs(args.out_dir, exist_ok=True)
    fn = make_enhance_fn(cfg, device)

    sr = cfg.audio.sample_rate
    buckets = [sr * s for s in (2, 4, 8, 16)]
    total_audio, total_wall = 0.0, 0.0
    for path in paths:
        wav, file_sr = read_wav(path)
        if file_sr != sr:
            raise ValueError(f"{path}: sample rate {file_sr} != config {sr}")
        n = len(wav)

        t0 = time.perf_counter()
        if args.streaming:
            enhanced = np.concatenate(list(enhance_stream(
                cfg, model, wav, args.chunk_seconds, args.lookahead_seconds,
                args.history_seconds, device=device)))
        else:
            x = np.zeros(_bucket_length(n, buckets), np.float32)
            x[:n] = wav
            out = fn(model, torch.from_numpy(x)[None], torch.tensor([n]))
            enhanced = out[0, :n].cpu().numpy()          # waits for the device
        wall = time.perf_counter() - t0

        write_wav(os.path.join(args.out_dir, os.path.basename(path)), enhanced, sr)
        total_audio += n / sr
        total_wall += wall

    rtf = total_wall / max(total_audio, 1e-9)
    print(json.dumps({"utterances": len(paths), "audio_seconds": round(total_audio, 3),
                      "wall_seconds": round(total_wall, 3), "rtf": round(rtf, 5)}))


if __name__ == "__main__":
    main()
