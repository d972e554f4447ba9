"""Time the forward routes of the recurrence kernels at one width.

    python -m aas_enhancement_tpu_torch.utils.rnn_bench [--cell gru] [--hidden 512]
        [--frames 401] [--batch 4 8 32] [--reps 10]

For each batch size: the wrapper's route at that width (the resident kernel
on clusters, where the width has one) and the streaming kernel on the same
random inputs, inference and training variant; per call the median time
between two CUDA events and the kernel's device time from ``torch.profiler``;
the largest difference between the two routes' outputs; and, for a resident
route, how many of its clusters the card runs at once.  Each timing follows
half a second of launches of the same kernel, and the SM clock is read right
after it: a card that has been idle clocks lower than one under sustained
load, and a recurrence's dependent steps take the clock's time.  The first line is the card's name and power limit.  Needs a GPU; to compare two versions of a
kernel, run it from two copies of the package in one call.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import torch


def time_routes(cell: str, h_dim: int, frames: int, batch: int, reps: int) -> list[dict]:
    """One row per (route, variant) of ``cell`` at [frames, batch, h_dim]:
    {"route", "variant", "sm_clock", "event_ms", "device_ms", "max_abs_diff"}."""
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.utils.profiling import profile_call

    device = torch.device("cuda")
    gates = 4 if cell == "lstm" else 3
    gen = torch.Generator().manual_seed(batch)
    gx = (0.5 * torch.randn(frames, batch, 2 * gates * h_dim, generator=gen)).to(device)
    halves = (gx[..., :gates * h_dim], gx[..., gates * h_dim:])
    wh = (torch.randn(2, h_dim, gates * h_dim, generator=gen) / h_dim ** 0.5).to(device)
    bh = (0.1 * torch.randn(2, gates * h_dim, generator=gen)).to(device)
    lengths = torch.tensor([frames - (7 * i) % (frames // 2 + 1) for i in range(batch)],
                           device=device)
    m = (torch.arange(frames, device=device)[:, None] < lengths[None]).float()
    name = f"{cell}_scan_tm"
    own = (krnn.lstm_resident_cluster if cell == "lstm" else krnn.gru_resident_cluster)(h_dim)
    rows, ref = [], None
    for route in dict.fromkeys((own, 0)):
        for save in (False, True):
            run = lambda: krnn._forward(name, halves, m, wh, bh, save=save,   # noqa: E731
                                        route=route)[0]
            out = run()
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            t0 = time.perf_counter()         # an idle card clocks down: half a second
            while time.perf_counter() - t0 < 0.5:    # of launches brings it back up
                run()
                torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                run()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            with tempfile.TemporaryDirectory() as tmp:
                busy = profile_call(run, 5, 1, os.path.join(tmp, "trace.json"))["busy_ms"]
            clock = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
            rows.append({"route": route, "variant": "training" if save else "inference",
                         "sm_clock": clock[0] if clock else "unknown",
                         "event_ms": statistics.median(times), "device_ms": busy,
                         "max_abs_diff": max((a - b).abs().max().item()
                                             for a, b in zip(out, ref))})
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cell", choices=("lstm", "gru"), default="gru")
    p.add_argument("--hidden", type=int, default=512)
    p.add_argument("--frames", type=int, default=401)
    p.add_argument("--batch", type=int, nargs="+", default=[4, 8, 32])
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"[rnn_bench] {smi.splitlines()[0]} | {args.cell} H={args.hidden} "
          f"T={args.frames}, median of {args.reps} calls")
    for batch in args.batch:
        for row in time_routes(args.cell, args.hidden, args.frames, batch, args.reps):
            route = row["route"]
            what = "streaming" if not route else (
                f"resident, clusters of {route} "
                f"({krnn.resident_clusters_at_once(args.cell, args.hidden, route)} at once)")
            print(f"[rnn_bench] B={batch} {what}, {row['variant']}: "
                  f"{row['event_ms']:.4f} ms between events, {row['device_ms']:.4f} ms on "
                  f"the device (profiler), {1e3 * row['device_ms'] / args.frames:.3f} us a "
                  f"step, SM clock right after {row['sm_clock']} | max abs difference to "
                  f"the first route {row['max_abs_diff']:.3e}")


if __name__ == "__main__":
    main()
