"""Time the ISTFT, the GroupNorm forward and backward, the STFT's and the
ISTFT's VJP wrappers and the conv weight gradient at bf16 at the shapes the
paths give them, host and device apart, and one paired training step.

    python -m aas_enhancement_tpu_torch.utils.kernel_bench [--reps 20] [--only TEXT]

Cases: the ISTFT at B=4 x 8 s, hop 160 (the enhance path) and hop 80; the
GroupNorm forward at the enhancer's [4, 801, 161, 32] with leaky_relu and at
the AM's [4, 401, 81, 32] and [4, 401, 41, 32] with hardtanh, ragged lengths;
the GroupNorm backward (the wrapper alone, on the mean and inv the forward
kernel saved and a random dy) at the training steps' B=8 at the same widths,
with the lengths of ``chip_smoke.py``'s backward cases (``BWD_FRAMES``,
``BWD_AM_FRAMES``), and the whole backward pass there (``autograd.grad``
through the forward's Function, dx, dscale and dbias); ``stft_vjp`` at the
MR-STFT loss's (256, 64), (512, 128), (1024, 256) and at (320, 160), and
``istft_vjp`` at (320, 160) and the MR resolutions, B=8 x 8 s with
cotangents zero past each row's valid frames or samples (``BWD_FRAMES``);
the ``paired`` step with ``lambda_mrstft`` 0.5 at B=8 x 8 s, the shipped
widths (its wall between events and its busy device time; no bound);
``conv_dw_same`` on bf16 x and dy at the AM's conv2 (11 x 21, stride (1,
2), [B, 401, 81, 32]) at B=8 and 32, beside cuDNN's bf16 weight gradient
(``torch.nn.grad.conv2d_weight``) on the same tensors, bound by the
operations at the 989 TFLOP/s bf16 rate; ``conv_dw_same`` on f32 x and dy
(the split route, "bf16x3"), ``conv_dw_fma`` (the FMA route) and cuDNN's f32
weight gradient (TF32 off) on the same tensors at the AM's conv2 at B=8, the
e2e protocol's conv2 ([16, 301, 81, 16]) and the enhancer's 5 x 5 ([8, 801,
161, 32]), each with two bounds: the f32 operations at 67 TFLOP/s (the FMA
route's) and six bf16 products a position at 989 TFLOP/s (the split
route's).
Per case and call: the host time of the wrapper (``--reps`` calls enqueued
back to back behind a sleeping kernel, so that the host never waits on the
device: perf_counter around them over the count), the median time between
two CUDA events around one call on an idle stream (host and device), and the
device time (``utils.profiling.device_time``), beside the least time the
bytes the function must move take at the card's 3.35 TB/s (x, and dy, read
on the valid frames only; the VJPs' inputs and outputs in full).  ``--only
TEXT`` runs the cases whose label holds it.  The first line is the card's
name and power limit.  Needs a GPU; to compare two versions of a kernel, run
it from two copies of the package in one call (the VJP, "gn_bwd pass" and
paired cases run on an older package too: copy this file into its utils/).
To time a part of the VJP kernels by its absence, build them with one of
``csrc/stft_vjp.cu``'s switch-offs (the library is built apart; the
results are wrong):

    AAS_KERNEL_DEFINES=AAS_VJP_SKIP_FFT python -m aas_enhancement_tpu_torch.utils.kernel_bench --only _vjp

(``AAS_VJP_SKIP_LOAD``: no input staged; ``AAS_VJP_SKIP_FFT``: no pass of
the transform; ``AAS_VJP_SKIP_OUT``: no overlap-add, no bins stored), and
so the parts of ``csrc/conv_dw.cu``'s tensor-core kernel, ``--only
"conv_dw bf16"`` or ``--only "conv_dw f32"`` (``AAS_DW_SKIP_STAGE``: only a
slice's first two windows staged; ``AAS_DW_SKIP_MMA``: no product;
``AAS_DW_SKIP_LOAD``: no fragment loaded from shared memory).
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
PEAK_BF16_S = 989e12        # and its dense bf16 tensor-core rate
PEAK_F32_S = 67e12          # and its f32 rate outside the tensor cores


def _valid(lens: list[int], t: int) -> float:
    """The share of [B, T] frames that ``lens`` leaves valid."""
    return sum(min(n, t) for n in lens) / (len(lens) * t)


def cases(device) -> dict:
    """label -> (a call on inputs made from a fixed seed, the bytes the
    function must move: each input read once, each output written once; the
    GroupNorm reads x (and dy) on the valid frames only; None for the step;
    the bf16 operations where they bound the call, else 0; and the f32
    operations of the f32 weight gradients, else 0).  Labels with " pass "
    or "step" run with autograd, the others in inference mode."""
    import torch.nn.functional as F
    from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
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
    # The VJPs at B=8 x 8 s, cotangents zero past each row's valid frames
    # (dre, dim) or samples (dy).
    frames = torch.tensor([801, 701, 601, 401, 801, 751, 501, 301])
    lens = (frames - 1) * 160
    dy = (torch.randn(8, n, generator=gen) * (torch.arange(n)[None] < lens[:, None])).to(device)
    for n_fft, hop in ((256, 64), (512, 128), (1024, 256), (320, 160)):
        t = 1 + n // hop
        valid = (torch.arange(t)[None] < (1 + lens // hop)[:, None])[..., None]
        dre = (torch.randn(8, t, n_fft // 2 + 1, generator=gen) * valid).to(device)
        dim = (torch.randn(8, t, n_fft // 2 + 1, generator=gen) * valid).to(device)
        out[f"stft_vjp n_fft {n_fft} hop {hop} [8, {t}, {n_fft // 2 + 1}]"] = (
            lambda a=dre, c=dim, f=n_fft, h=hop: kstft.stft_vjp(a, c, n, f, h),
            4 * (dre.numel() + dim.numel() + 8 * n))
        out[f"istft_vjp n_fft {n_fft} hop {hop} [8, {t}, {n_fft // 2 + 1}]"] = (
            lambda f=n_fft, h=hop, t=t: kstft.istft_vjp(dy, t, f, h),
            4 * (dy.numel() + dre.numel() + dim.numel()))
    out["paired step lambda_mrstft 0.5 B=8 x 8 s"] = (_paired_step(device, gen, n), None)
    for b in (8, 32):
        x = torch.randn(b, 401, 81, 32, generator=gen).to(device).bfloat16()
        dy = torch.randn(b, 401, 41, 32, generator=gen).to(device).bfloat16()
        work = (2 * (x.numel() + dy.numel()) + 4 * 11 * 21 * 32 * 32,
                2.0 * b * 401 * 41 * 11 * 21 * 32 * 32)
        out[f"conv_dw bf16 AM conv2 [{b}, 401, 81, 32]"] = (
            lambda x=x, dy=dy: kconv.conv_dw_same(x, dy, 11, 21, (1, 2)), *work)
        x_nchw = F.pad(x.permute(0, 3, 1, 2), (*kconv.same_pad(81, 21, 2),
                                               *kconv.same_pad(401, 11, 1)))
        out[f"cuDNN wgrad bf16 AM conv2 [{b}, 401, 81, 32]"] = (
            lambda x=x_nchw, dy=dy: torch.nn.grad.conv2d_weight(
                x, (32, 32, 11, 21), dy.permute(0, 3, 1, 2), stride=(1, 2)), *work)
    for label, (b, t, f, c, kt, kf, st) in (
            ("AM conv2 [8, 401, 81, 32]", (8, 401, 81, 32, 11, 21, (1, 2))),
            ("e2e conv2 [16, 301, 81, 16]", (16, 301, 81, 16, 11, 21, (1, 2))),
            ("enhancer 5x5 [8, 801, 161, 32]", (8, 801, 161, 32, 5, 5, (1, 1)))):
        fo = -(-f // st[1])
        x = torch.randn(b, t, f, c, generator=gen).to(device)
        dy = torch.randn(b, t, fo, c, generator=gen).to(device)
        flops = 2.0 * b * t * fo * kt * kf * c * c
        work = (4 * (x.numel() + dy.numel() + kt * kf * c * c), 6 * flops, flops)
        out[f"conv_dw f32 {label}"] = (
            lambda x=x, dy=dy, kt=kt, kf=kf, st=st: kconv.conv_dw_same(x, dy, kt, kf, st), *work)
        out[f"conv_dw f32 fma {label}"] = (
            lambda x=x, dy=dy, kt=kt, kf=kf, st=st: kconv.conv_dw_fma(x, dy, kt, kf, st), *work)
        x_nchw = F.pad(x.permute(0, 3, 1, 2), (*kconv.same_pad(f, kf, st[1]),
                                               *kconv.same_pad(t, kt, 1)))
        out[f"conv_dw f32 cuDNN wgrad {label}"] = (
            _tf32_off(lambda x=x_nchw, dy=dy, c=c, kt=kt, kf=kf, st=st:
                      torch.nn.grad.conv2d_weight(x, (c, c, kt, kf), dy.permute(0, 3, 1, 2),
                                                  stride=st)), *work)
    return {k: (*v, 0.0, 0.0)[:4] for k, v in out.items()}


def _tf32_off(fn):
    """``fn`` with cuDNN's TF32 off during the call (f32 products in full, as
    the f32 routes compute them), the setting restored after it."""
    def call():
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn()
        finally:
            torch.backends.cudnn.allow_tf32 = before
    return call


def _paired_step(device, gen, n: int):
    """One ``paired`` step with the MR-STFT term at B=8 x n samples, the
    shipped widths, weights from the config's train seed: a call."""
    import dataclasses
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="paired",
                                                lambda_mrstft=0.5, batch_size=8))
    state = init_state(cfg, cfg.train.seed, device)
    step = make_train_step(cfg)
    batch = {"wav": (0.3 * torch.randn(8, n, generator=gen)).to(device),
             "wav_lengths": torch.full((8,), n, device=device),
             "clean_wav": (0.3 * torch.randn(8, n, generator=gen)).to(device)}
    return lambda: step(state, batch)


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
    for label, (fn, n_bytes, ops, f32_ops) in cases(device).items():
        if args.only not in label:
            continue
        # The backward pass and the step need autograd; the wrappers alone run without it.
        grad = " pass " in label or "step" in label
        with contextlib.nullcontext() if grad else torch.inference_mode():
            if n_bytes is None:      # a step waits on the device itself: no host time
                events = event_ms(fn, args.reps)
                dev, by = device_time(fn)
                print(f"[kernel_bench] {label}: between events {events:.4f} ms | busy on "
                      f"the device {dev:.4f} ms ({by})")
                continue
            host = host_ms(fn, args.reps)
            events = event_ms(fn, args.reps)
            dev, by = device_time(fn)
        bound = max(n_bytes / PEAK_BYTES_S, ops / PEAK_BF16_S) * 1e3
        by_what = (f"{ops / 1e9:.1f} GFLOP at 989 TFLOP/s" if ops / PEAK_BF16_S
                   > n_bytes / PEAK_BYTES_S else f"{n_bytes / 1e6:.1f} MB at 3.35 TB/s")
        f32 = ""
        if f32_ops:
            fma_bound = max(n_bytes / PEAK_BYTES_S, f32_ops / PEAK_F32_S) * 1e3
            f32 = (f" | f32 FMA bound {fma_bound:.4f} ms ({f32_ops / 1e9:.1f} GFLOP at 67 "
                   f"TFLOP/s): {fma_bound / dev:.0%} of it")
        print(f"[kernel_bench] {label}: host {host:.4f} ms a call | between events "
              f"{events:.4f} ms | device {dev:.4f} ms ({by}) | bound {bound:.4f} ms "
              f"({by_what}): {bound / dev:.0%} of it{f32}")


if __name__ == "__main__":
    main()
