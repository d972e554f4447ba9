#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (aas_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
1. device: the card's name and power limit, TF32 off for the parity checks;
2. build: the CUDA kernels from csrc/ (nvcc, sm_90a, one process per source)
   and the Triton version;
3. kernels: each kernel against its plain PyTorch version on the card at the
   full-width shapes its paths give it (B=4 x 8 s, ragged lengths): the
   enhance path's (T=801, F=161, C=32, LSTM H=256) and the AM's (GN +
   hardtanh at [4, 401, 81, 32] and [4, 401, 41, 32], GRU T=401, H=512),
   with the max abs error, the tolerance and the median time of kernel and
   plain version (CUDA events, after warmup, timed in turns);
4. slice: the port's enhance CLI on a synthetic corpus with --device cuda,
   counting each kernel's launches; then a full-width B=4 x 8 s batch on the
   card against the same weights on the CPU, and the batch's real-time factor;
5. recognize: the port's evaluate CLI (noisy and enhanced WER, SI-SNR) on a
   synthetic corpus with --device cuda, counting each kernel's launches; then
   the recognition forward (enhancer + AM, 4 x BiGRU-512) at B=4 x 8 s on the
   card against the same weights on the CPU (logits, greedy ids), and its
   time per batch with and without the enhancer.
The line before the last two is a JSON summary of the kernels (launches from
the recognize phase's CLI run, which runs all five), the next the card's name
and power limit, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SR, B, SECONDS = 16000, 4, 8
N = SR * SECONDS
LENGTHS = [N, 112000, 96000, 64000]   # 801, 701, 601 and 401 valid frames of 801
AM_T = 401                            # AM frames of 801: conv1 halves time (ceil)
AM_LENGTHS = [401, 351, 301, 201]     # conv_out_length of 801/701/601/401

# Tolerances (max abs error, kernel vs plain version, f32 on the card).  Both
# sides accumulate in float32 in different orders; each bound is about 3-50x
# the error measured on an H100 at these inputs.
TOL = {
    "stft": (1e-4, "|X| up to ~40 from 320-term f32 sums on unit-scale audio"),
    "istft": (1e-5, "unit-scale audio, 2 x 161-term f32 sums per sample"),
    "gn_act": (1e-5, "unit-scale normalized output, f32 group sums over 0.1-2.6M values"),
    "lstm": (1e-5, "|y| < 1, f32 rounding carried through 801 recurrent steps"),
    "gru": (1e-5, "|y| < 1, 512-term f32 dots, rounding carried through 401 steps"),
}
SLICE_TOL = (1e-4, "wav in [-1, 1] after STFT, 2 conv+GN, 2 BiLSTM-256 over 801 "
             "steps, ISTFT: f32 rounding of card vs CPU sum orders compounds")
RECOGNIZE_TOL = (1e-4, "logits O(1) after STFT, enhancer, 2 convs of up to 7392-term "
                 "f32 sums, 4 BiGRU-512 over 401 steps and FC: card vs CPU sum "
                 "orders compound")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> list[float]:
    """Per-call device times in ms (CUDA events), after warmup."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def max_err(a, b) -> float:
    import torch
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if not torch.isfinite(a).all():
        fail("non-finite kernel output")
    return (a - b).abs().max().item()


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    import triton
    from aas_enhancement_tpu_torch.utils import kernel_build
    t0 = time.perf_counter()
    so = kernel_build.build()
    kernel_build.load_library()
    print(f"[build] {so} in {time.perf_counter() - t0:.1f} s | triton {triton.__version__}")
    with open(so[:-3] + ".log") as f:
        for line in f:
            if "Used" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")


def make_inputs(device):
    """The slice's full-width inputs, from a fixed seed (made on the CPU)."""
    import torch
    gen = torch.Generator().manual_seed(0)
    t = torch.arange(N) / SR
    wav = 0.4 * torch.sin(2 * torch.pi * 440.0 * t)[None] \
        + 0.2 * torch.randn(B, N, generator=gen)
    lengths = torch.tensor(LENGTHS)
    wav = wav * (torch.arange(N)[None] < lengths[:, None])
    return wav.to(device), lengths.to(device), gen


def kernel_counters() -> dict:
    """The five kernel wrappers of the two paths, by kernel name."""
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    from aas_enhancement_tpu_torch.ops.triton import gn
    return {"stft": kstft.stft, "istft": kstft.istft, "gn_act": gn.masked_group_norm_act,
            "lstm": krnn.lstm_scan_tm, "gru": krnn.gru_scan_tm}


def phase_kernels(device):
    import torch
    from aas_enhancement_tpu_torch.convert import init_like_flax
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    from aas_enhancement_tpu_torch.ops.masking import time_mask
    from aas_enhancement_tpu_torch.ops.rnn import BiRNN
    from aas_enhancement_tpu_torch.ops.triton import gn

    wav, lengths, gen = make_inputs(device)
    frames = 1 + lengths // 160
    t_len = 1 + N // 160
    re, im = kstft.stft_plain(wav, 320, 160)
    gain = torch.rand(re.shape, generator=gen).to(device)       # an enhancement mask
    x_gn = (0.5 + torch.randn(B, t_len, 161, 32, generator=gen)).to(device)
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).to(device)
    bias = (0.1 * torch.randn(32, generator=gen)).to(device)
    rnn = init_like_flax(BiRNN(161 * 32, 256), gen).to(device)
    m = time_mask(frames, t_len).T.contiguous()
    # The AM's shapes: GN + hardtanh after conv1 (F 81) and conv2 (F 41), and
    # the first BiGRU-512 layer over the 41 * 32 conv features.
    am_frames = torch.tensor(AM_LENGTHS, device=device)
    x_am = {f: (0.5 + 3.0 * torch.randn(B, AM_T, f, 32, generator=gen)).to(device)
            for f in (81, 41)}
    gru = init_like_flax(BiRNN(41 * 32, 512, cell="gru"), gen).to(device)
    with torch.no_grad():
        gru.bh.copy_(0.1 * torch.randn(gru.bh.shape, generator=gen))   # n-slice inside r
    m_am = time_mask(am_frames, AM_T).T.contiguous()

    with torch.inference_mode():
        gates = rnn.wx(torch.randn(t_len, B, 161 * 32, generator=gen).to(device))
        gxf, gxb = gates[..., :1024], gates[..., 1024:]          # strided, as in BiRNN
        g_gates = gru.wx(torch.randn(AM_T, B, 41 * 32, generator=gen).to(device))
        g_xf, g_xb = g_gates[..., :1536], g_gates[..., 1536:]
        leaky = dict(num_groups=8, act="leaky_relu", slope=0.2)
        hard = dict(num_groups=8, act="hardtanh")
        cases = {       # label: (kernel name, wrapper, plain version, args, kwargs)
            "stft": ("stft", kstft.stft, kstft.stft_plain, (wav, 320, 160), {}),
            "istft": ("istft", kstft.istft, kstft.istft_plain,
                      (re * gain, im * gain, 320, 160, "hann", True, N), {}),
            "gn_act": ("gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                       (x_gn, scale, bias, frames), leaky),
            "gn_act hardtanh [4, 401, 81, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[81], scale, bias, am_frames), hard),
            "gn_act hardtanh [4, 401, 41, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[41], scale, bias, am_frames), hard),
            "lstm": ("lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                     (gxf, gxb, m, rnn.wh, rnn.bh), {}),
            "gru": ("gru", krnn.gru_scan_tm, krnn.gru_scan_tm_plain,
                    (g_xf, g_xb, m_am, gru.wh, gru.bh), {}),
        }
        results = {}
        for label, (name, kernel, plain, args, kw) in cases.items():
            k_out = kernel(*args, **kw)
            p_out = plain(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(k_out, p_out)
            tol, why = TOL[name]
            reps = 5 if name in ("lstm", "gru") else 20
            run_k = lambda: kernel(*args, **kw)                        # noqa: E731
            run_p = lambda: plain(*args, **kw)                         # noqa: E731
            t_p = cuda_ms(run_p, reps)                                 # in turns:
            t_k = cuda_ms(run_k, reps) + cuda_ms(run_k, reps)          # plain, kernel,
            t_p += cuda_ms(run_p, reps)                                # kernel, plain
            ms, plain_ms = statistics.median(t_k), statistics.median(t_p)
            print(f"[kernel] {label}: max_abs_err {err:.3e} (tol {tol:.0e}: {why}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                  f"x{plain_ms / ms:.2f}")
            if not err <= tol:
                fail(f"{label}: max abs err {err:.3e} > tol {tol:.0e}")
            if name in results:         # the JSON line keeps the first shape's
                err = max(err, results[name][0])       # times and the worst error
                ms, plain_ms = results[name][1:]
            results[name] = (err, ms, plain_ms)
    return results


def phase_slice(device, card):
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus, read_manifest, read_wav
    from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn

    counters = {k: v for k, v in kernel_counters().items() if k != "gru"}
    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1)
        out_dir = os.path.join(tmp, "enhanced")
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--manifest", manifests["noisy"], "--out-dir", out_dir,
                      "--device", "cuda"])
        launches = {k: fn.launches for k, fn in counters.items()}
        cli_line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[slice] cli.enhance --device cuda: {json.dumps(cli_line)} "
              f"| launches {json.dumps(launches)}")
        for name, count in launches.items():
            if count == 0:
                fail(f"the enhance run launched no {name} kernel")
        for wav_path, _ in read_manifest(manifests["noisy"]):
            x, _ = read_wav(wav_path)
            y, _ = read_wav(os.path.join(out_dir, os.path.basename(wav_path)))
            if len(y) != len(x) or not torch.isfinite(torch.from_numpy(y)).all():
                fail(f"{wav_path}: enhanced wav has length {len(y)} != {len(x)} "
                     "or non-finite values")
        print(f"[slice] {len(launches)} kernels launched; "
              f"{cli_line['utterances']} wavs written, lengths match, finite")

    cfg = Config()
    model_cpu = init_enhancer(cfg, cfg.train.seed, "cpu")
    model_gpu = copy.deepcopy(model_cpu).to(device)
    wav, lengths, _ = make_inputs("cpu")
    t0 = time.perf_counter()
    y_cpu = make_enhance_fn(cfg, "cpu")(model_cpu, wav, lengths)
    cpu_s = time.perf_counter() - t0
    fn_gpu = make_enhance_fn(cfg, device)
    y_gpu = fn_gpu(model_gpu, wav.to(device), lengths.to(device))
    if y_gpu.shape != (B, N) or not torch.isfinite(y_gpu).all():
        fail(f"slice output shape {tuple(y_gpu.shape)} or non-finite values")
    err = (y_gpu.cpu() - y_cpu).abs().max().item()
    tol, why = SLICE_TOL
    print(f"[slice] B={B} x {SECONDS} s card vs CPU (same weights): max_abs_err "
          f"{err:.3e} (tol {tol:.0e}: {why}); |y|max {y_cpu.abs().max().item():.3f}; "
          f"CPU plain path {cpu_s:.2f} s")
    if not err <= tol:
        fail(f"card vs CPU slice error {err:.3e} > {tol:.0e}")

    full = torch.full((B,), N, device=device)
    wav_d = wav.to(device)
    time_batch("[slice]", "enhance", card, lambda: fn_gpu(model_gpu, wav_d, full))
    return launches


def time_batch(tag: str, what: str, card: str, fn) -> float:
    """Host wall time of one synchronized full-width call: median of 5 after
    2 warmups (allocator and Triton JIT), TF32 off as set in phase_device."""
    import torch
    walls = []
    for i in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 2:
            walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"{tag} B={B} x {SECONDS} s {what} on {card}, TF32 off: "
          f"{wall * 1e3:.2f} ms/batch, RTF {wall / (B * SECONDS):.6f}, "
          f"{B / wall:.1f} utterances/s "
          f"(median of {len(walls)}; walls ms {[round(w * 1e3, 2) for w in walls]})")
    return wall


def phase_recognize(device, card):
    import torch
    from aas_enhancement_tpu_torch.cli import evaluate as cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.enhance import init_enhancer
    from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward

    counters = kernel_counters()
    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1)
        for fn in counters.values():
            fn.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["--manifest", manifests["noisy"], "--am-checkpoint", "seed:0",
                      "--enhancer-checkpoint", "seed:1",
                      "--clean-manifest", manifests["clean"], "--device", "cuda"])
        launches = {k: fn.launches for k, fn in counters.items()}
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"[recognize] cli.evaluate --device cuda: {json.dumps(line)} "
          f"| launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the recognize run launched no {name} kernel")
    if set(line) != {"noisy", "enhanced", "wer_delta", "si_snr"}:
        fail(f"cli.evaluate printed keys {sorted(line)}")
    for leg in ("noisy", "enhanced"):
        r = line[leg]
        if r["utterances"] != 6 or not 0.0 <= r["wer"] < float("inf"):
            fail(f"{leg}: {r['utterances']} utterances, WER {r['wer']}")
    if not all(abs(v) < float("inf") for v in line["si_snr"].values()):
        fail(f"non-finite SI-SNR/STOI {line['si_snr']}")

    cfg = Config()
    am_cpu, enh_cpu = init_am(cfg, 0), init_enhancer(cfg, 1)
    am_gpu, enh_gpu = copy.deepcopy(am_cpu).to(device), copy.deepcopy(enh_cpu).to(device)
    wav, lengths, _ = make_inputs("cpu")
    fwd = make_eval_forward(cfg, use_enhancer=True)
    t0 = time.perf_counter()
    logits_cpu, pads_cpu = fwd(am_cpu, enh_cpu, wav, lengths)
    cpu_s = time.perf_counter() - t0
    logits, pads = fwd(am_gpu, enh_gpu, wav.to(device), lengths.to(device))
    logits, pads = logits.cpu(), pads.cpu()
    if logits.shape != (B, AM_T, cfg.am.vocab_size) or not torch.isfinite(logits).all():
        fail(f"recognition logits shape {tuple(logits.shape)} or non-finite values")
    valid = pads_cpu < 0.5
    if not torch.equal(pads, pads_cpu) or valid.sum(1).tolist() != AM_LENGTHS:
        fail(f"frame paddings differ: valid frames {valid.sum(1).tolist()}")
    err = (logits - logits_cpu).abs().max().item()
    tol, why = RECOGNIZE_TOL
    top2 = logits_cpu.topk(2, dim=-1).values
    sure = valid & (top2[..., 0] - top2[..., 1] > 2 * tol)
    same = (logits.argmax(-1) == logits_cpu.argmax(-1)) | ~sure
    print(f"[recognize] B={B} x {SECONDS} s card vs CPU (same weights): logits "
          f"max_abs_err {err:.3e} (tol {tol:.0e}: {why}); greedy ids equal on "
          f"{int((same & sure).sum())} of {int(sure.sum())} valid frames with top-2 "
          f"margin > {2 * tol:.0e} ({int(valid.sum())} valid); |logit|max "
          f"{logits_cpu.abs().max().item():.3f}; CPU plain path {cpu_s:.2f} s")
    if not err <= tol:
        fail(f"card vs CPU logits error {err:.3e} > {tol:.0e}")
    if not same.all():
        fail("greedy ids differ between card and CPU on a frame with a clear margin")

    full = torch.full((B,), N, device=device)
    wav_d = wav.to(device)
    fwd_noisy = make_eval_forward(cfg, use_enhancer=False)
    time_batch("[recognize]", "recognition forward (enhancer + AM)", card,
               lambda: fwd(am_gpu, enh_gpu, wav_d, full))
    time_batch("[recognize]", "recognition forward (AM alone, noisy leg)", card,
               lambda: fwd_noisy(am_gpu, None, wav_d, full))
    return launches


def main() -> int:
    sys.path.insert(0, HERE)
    name, smi = phase_device()
    import torch
    device = torch.device("cuda", 0)
    phase_build()
    results = phase_kernels(device)
    phase_slice(device, smi)                # counts the enhance CLI run's launches
    launches = phase_recognize(device, smi)  # counts the evaluate CLI run's launches

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "flax", "aas_enhancement_tpu")]
    if bad:
        fail(f"JAX or the JAX package was imported: {bad[:5]}")
    meta = {
        "stft": ("cuda", "aas_enhancement_tpu_torch/csrc/stft.cu",
                 "aas_enhancement_tpu/ops/pallas/stft_kernel.py:71"),
        "istft": ("cuda", "aas_enhancement_tpu_torch/csrc/istft.cu",
                  "aas_enhancement_tpu/ops/pallas/stft_kernel.py:160"),
        "gn_act": ("triton", "aas_enhancement_tpu_torch/ops/triton/gn.py",
                   "aas_enhancement_tpu/ops/pallas/gn_kernel.py:311"),
        "lstm": ("cuda", "aas_enhancement_tpu_torch/csrc/lstm_tm.cu",
                 "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:692"),
        "gru": ("cuda", "aas_enhancement_tpu_torch/csrc/gru_tm.cu",
                "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:892"),
    }
    kernels = [{"name": k, "route": r, "source": s, "replaces": rep,
                "launches": launches[k], "max_abs_err": results[k][0],
                "ms": results[k][1], "plain_ms": results[k][2]}
               for k, (r, s, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
