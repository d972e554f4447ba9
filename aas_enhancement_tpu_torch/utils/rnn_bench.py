"""Time the two routes of the recurrence kernels at one width.

    python -m aas_enhancement_tpu_torch.utils.rnn_bench [--cell gru] [--hidden 512]
        [--frames 401] [--batch 4 8 32] [--reps 10] [--backward]

For each batch size: the wrapper's route at that width (the resident kernel
on clusters, where the width has one) and the streaming kernel on the same
random inputs, the forward's inference and training variants or, with
``--backward``, the backward kernel (with the weight gradients' dgh, as a
trained GRU writes it) on what the training forward saved for those inputs;
per call the median time between two CUDA events and the kernel's device
time (``utils.profiling.device_time``: the profiler, or CUDA events on a
busy stream where it dropped events); the largest difference between the
two routes' outputs (y, or dgx of the backward); and, for a resident route,
how many of its clusters the card runs at once.  Each timing follows half a second of
launches of the same kernel, and the SM clock is read right after it: a card
that has been idle clocks lower than one under sustained load, and a
recurrence's dependent steps take the clock's time.  The first line is the
card's name and power limit.  Needs a GPU; to compare two versions of a
kernel, run it from two copies of the package in one call.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch


def time_routes(cell: str, h_dim: int, frames: int, batch: int, reps: int,
                backward: bool = False) -> list[dict]:
    """One row per (route, variant) of ``cell`` at [frames, batch, h_dim]:
    {"route", "variant", "sm_clock", "event_ms", "device_ms", "device_ms_by",
    "max_abs_diff"}.
    The variants are "inference" and "training" (forward) or "backward"."""
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.utils.profiling import device_time

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
    if backward:
        ys, saved = krnn._forward(name, halves, m, wh, bh, save=True)
        dys = tuple(torch.randn(y.shape, generator=gen).to(device) for y in ys)
        own = krnn.bwd_resident_cluster(cell, h_dim)
        variants = ("backward",)
    else:
        own = (krnn.lstm_resident_cluster if cell == "lstm" else krnn.gru_resident_cluster)(
            h_dim)
        variants = ("inference", "training")
    rows, ref = [], None
    for route in dict.fromkeys((own, 0)):
        for variant in variants:
            if backward:
                run = lambda: krnn._backward(name, m, wh, saved, dys, True,   # noqa: E731
                                             route=route)[0]
            else:
                run = lambda: krnn._forward(name, halves, m, wh, bh,          # noqa: E731
                                            save=variant == "training", route=route)[0]
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
            # The backward's call also transposes wh (streaming route) and
            # computes dWh: count the kernel's own time.
            alone = (lambda: krnn._backward(name, m, wh, saved, dys, False,   # noqa: E731
                                            route=route)) if backward else None
            busy, by = device_time(run, "bwd_kernel" if backward else None, alone, warmup=1)
            clock = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
            rows.append({"route": route, "variant": variant,
                         "sm_clock": clock[0] if clock else "unknown",
                         "event_ms": statistics.median(times), "device_ms": busy,
                         "device_ms_by": by,
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
    p.add_argument("--backward", action="store_true",
                   help="time the backward kernel's two routes, not the forward's")
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
        for row in time_routes(args.cell, args.hidden, args.frames, batch, args.reps,
                               args.backward):
            route = row["route"]
            what = "streaming"
            if route:
                at_once = krnn.resident_clusters_at_once(args.cell, args.hidden, route,
                                                         backward=args.backward)
                what = f"resident, clusters of {route} ({at_once} at once)"
            print(f"[rnn_bench] B={batch} {what}, {row['variant']}: "
                  f"{row['event_ms']:.4f} ms between events, {row['device_ms']:.4f} ms on "
                  f"the device ({row['device_ms_by']}), "
                  f"{1e3 * row['device_ms'] / args.frames:.3f} us a "
                  f"step, SM clock right after {row['sm_clock']} | max abs difference to "
                  f"the first route {row['max_abs_diff']:.3e}")


if __name__ == "__main__":
    main()
