"""Time the ISTFT and the GroupNorm forward and backward wrappers at the shapes
the paths give them, host and device apart.

    python -m aas_enhancement_tpu_torch.utils.kernel_bench [--reps 20] [--only TEXT]

Cases: the ISTFT at B=4 x 8 s, hop 160 (the enhance path) and hop 80; the
GroupNorm forward at the enhancer's [4, 801, 161, 32] with leaky_relu and at
the AM's [4, 401, 81, 32] and [4, 401, 41, 32] with hardtanh, ragged lengths;
the GroupNorm backward (the wrapper alone, on the mean and inv the forward
kernel saved and a random dy) at the training steps' B=8 at the same widths,
with the lengths of ``chip_smoke.py``'s backward cases (``BWD_FRAMES``,
``BWD_AM_FRAMES``), and the whole backward pass there (``autograd.grad``
through the forward's Function, dx, dscale and dbias).
Per case and call: the host time of the wrapper (``--reps`` calls enqueued
back to back behind a sleeping kernel, so that the host never waits on the
device: perf_counter around them over the count), the median time between
two CUDA events around one call on an idle stream (host and device), and the
device time (``utils.profiling.device_time``), beside the least time the
bytes the function must move take at the card's 3.35 TB/s (x, and dy, read
on the valid frames only).  ``--only TEXT`` runs the cases whose label holds
it.  The first line is the card's name and power limit.  Needs a GPU; to
compare two versions of a kernel, run it from two copies of the package in
one call.
"""

from __future__ import annotations

import argparse
import contextlib
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


PEAK_BYTES_S = 3.35e12      # the H100 SXM's HBM3 rate


def _valid(lens: list[int], t: int) -> float:
    """The share of [B, T] frames that ``lens`` leaves valid."""
    return sum(min(n, t) for n in lens) / (len(lens) * t)


def cases(device) -> dict:
    """label -> (a call on inputs made from a fixed seed, the bytes the
    function must move: each input read once, each output written once; the
    GroupNorm reads x (and dy) on the valid frames only)."""
    from aas_enhancement_tpu_torch.ops.cuda import gn, stft as kstft
    gen = torch.Generator().manual_seed(0)
    n = 16000 * 8
    wav = (0.3 * torch.randn(4, n, generator=gen)).to(device)
    out = {}
    for hop in (160, 80):
        re, im = kstft.stft_plain(wav, 320, hop)
        out[f"istft hop {hop} [4, {re.shape[1]}, 161]"] = (
            lambda re=re, im=im, hop=hop: kstft.istft(re, im, 320, hop, "hann", True, n),
            4 * (re.numel() + im.numel() + wav.numel()))
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).to(device)
    bias = (0.1 * torch.randn(32, generator=gen)).to(device)
    for t, f, act, lens in ((801, 161, "leaky_relu", [801, 701, 601, 401]),
                            (401, 81, "hardtanh", [401, 351, 301, 201]),
                            (401, 41, "hardtanh", [401, 351, 301, 201])):
        x = (0.5 + torch.randn(4, t, f, 32, generator=gen)).to(device)
        lengths = torch.tensor(lens, device=device)
        out[f"gn_act {act} [4, {t}, {f}, 32]"] = (
            lambda x=x, lengths=lengths, act=act: gn.masked_group_norm_act(
                x, scale, bias, lengths, num_groups=8, act=act),
            (_valid(lens, t) + 1) * 4 * x.numel())
    for t, f, act, lens in ((801, 161, "leaky_relu", [801, 701, 601, 401, 801, 751, 501, 301]),
                            (401, 81, "hardtanh", [401, 351, 301, 201, 401, 376, 251, 151]),
                            (401, 41, "hardtanh", [401, 351, 301, 201, 401, 376, 251, 151])):
        x = (0.5 + 3.0 * torch.randn(8, t, f, 32, generator=gen)).to(device)
        dy = torch.randn(8, t, f, 32, generator=gen).to(device)
        lengths = torch.tensor(lens, device=device)
        work = (2 * _valid(lens, t) + 1) * 4 * x.numel()
        mean, inv = gn._stats(gn.gn_kernel(x, scale, bias, lengths, 8, 1e-5, act, 0.2)[1], 8, 32)
        out[f"gn_bwd {act} [8, {t}, {f}, 32]"] = (
            lambda x=x, dy=dy, lengths=lengths, mean=mean, inv=inv, act=act:
            gn.masked_group_norm_act_bwd(x, dy, scale, bias, lengths, mean, inv,
                                         num_groups=8, act=act), work)
        # The whole backward pass: autograd.grad through the forward's Function.
        xg, sg, bg = (v.clone().requires_grad_() for v in (x, scale, bias))
        y = gn.masked_group_norm_act(xg, sg, bg, lengths, num_groups=8, act=act)
        out[f"gn_bwd pass {act} [8, {t}, {f}, 32]"] = (
            lambda y=y, inputs=(xg, sg, bg), dy=dy:
            torch.autograd.grad(y, inputs, dy, retain_graph=True), work)
    return out


def main(argv=None) -> None:
    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    from aas_enhancement_tpu_torch.utils.profiling import device_time
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--only", default="", help="run the cases whose label holds this")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"[kernel_bench] {smi.splitlines()[0]} | torch {torch.__version__}")
    for label, (fn, n_bytes) in cases(device).items():
        if args.only not in label:
            continue
        # The backward pass needs autograd; the wrappers alone run without it.
        with contextlib.nullcontext() if " pass " in label else torch.inference_mode():
            host = host_ms(fn, args.reps)
            events = event_ms(fn, args.reps)
            dev, by = device_time(fn)
        bound = n_bytes / PEAK_BYTES_S * 1e3
        print(f"[kernel_bench] {label}: host {host:.4f} ms a call | between events "
              f"{events:.4f} ms | device {dev:.4f} ms ({by}) | bound {bound:.4f} ms "
              f"({n_bytes / 1e6:.1f} MB at 3.35 TB/s): {bound / dev:.0%} of it")


if __name__ == "__main__":
    main()
