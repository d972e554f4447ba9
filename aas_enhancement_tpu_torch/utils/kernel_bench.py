"""Time the ISTFT and GroupNorm forward wrappers at the shapes the paths give
them, host and device apart.

    python -m aas_enhancement_tpu_torch.utils.kernel_bench [--reps 20]

Cases: the ISTFT at B=4 x 8 s, hop 160 (the enhance path) and hop 80; the
GroupNorm forward at the enhancer's [4, 801, 161, 32] with leaky_relu and at
the AM's [4, 401, 81, 32] and [4, 401, 41, 32] with hardtanh, ragged lengths.
Per case and call: the host time of the wrapper (``--reps`` calls enqueued
back to back behind a sleeping kernel, so that the host never waits on the
device: perf_counter around them over the count), the median time between
two CUDA events around one call on an idle stream (host and device), and the
device time (``utils.profiling.device_time``).  The first line is the card's
name and power limit.  Needs a GPU; to compare two versions of a kernel, run
it from two copies of the package in one call.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch


def host_ms(fn, reps: int) -> float:
    """Host time per call of ``fn`` with the device kept busy meanwhile."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)          # ~25 ms at 2 GHz: longer than the enqueues
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def event_ms(fn, reps: int) -> float:
    """Median time between two CUDA events around one call on an idle stream."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(device) -> dict:
    """label -> a call of the wrapper on inputs made from a fixed seed."""
    from aas_enhancement_tpu_torch.ops.cuda import gn, stft as kstft
    gen = torch.Generator().manual_seed(0)
    n = 16000 * 8
    wav = (0.3 * torch.randn(4, n, generator=gen)).to(device)
    out = {}
    for hop in (160, 80):
        re, im = kstft.stft_plain(wav, 320, hop)
        out[f"istft hop {hop} [4, {re.shape[1]}, 161]"] = (
            lambda re=re, im=im, hop=hop: kstft.istft(re, im, 320, hop, "hann", True, n))
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).to(device)
    bias = (0.1 * torch.randn(32, generator=gen)).to(device)
    for t, f, act, lens in ((801, 161, "leaky_relu", [801, 701, 601, 401]),
                            (401, 81, "hardtanh", [401, 351, 301, 201]),
                            (401, 41, "hardtanh", [401, 351, 301, 201])):
        x = (0.5 + torch.randn(4, t, f, 32, generator=gen)).to(device)
        lengths = torch.tensor(lens, device=device)
        out[f"gn_act {act} [4, {t}, {f}, 32]"] = (
            lambda x=x, lengths=lengths, act=act: gn.masked_group_norm_act(
                x, scale, bias, lengths, num_groups=8, act=act))
    return out


def main(argv=None) -> None:
    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    from aas_enhancement_tpu_torch.utils.profiling import device_time
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"[kernel_bench] {smi.splitlines()[0]} | torch {torch.__version__}")
    with torch.inference_mode():
        for label, fn in cases(device).items():
            host = host_ms(fn, args.reps)
            events = event_ms(fn, args.reps)
            dev, by = device_time(fn)
            print(f"[kernel_bench] {label}: host {host:.4f} ms a call | between events "
                  f"{events:.4f} ms | device {dev:.4f} ms ({by})")


if __name__ == "__main__":
    main()
