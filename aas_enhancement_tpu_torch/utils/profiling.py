"""Where the device time of one enhance call, one recognition forward, one
AAS train step, one AM pre-training step, one paired step and one chunk call
of the streaming enhancer and recognizer goes (counterpart of
``aas_enhancement_tpu/utils/profiling.py``).

    python -m aas_enhancement_tpu_torch.utils.profiling [--batch 4] [--seconds 8]
        [--calls 3] [--warmup 3] [--trace-dir traces/]

Runs ``make_enhance_fn``, then ``make_eval_forward(use_enhancer=True)``
(enhancer + AM, the evaluate CLI's enhanced leg), both at ``--batch``, then
one ``aas`` step of ``make_train_step`` (G and D gradients and updates, the
frozen AM), one ``am`` step (the AM's gradients, clip, SGD) and one
``paired`` step with ``lambda_mrstft`` 0.5 (G's gradient through the
MR-STFT term's STFT and ISTFT adjoints, clip, Adam) at
``TrainConfig.batch_size``, then one steady-state chunk call (``feed`` of
1 s) of ``StreamingEnhancer`` and of ``StreamingRecognizer`` with the
enhancer at B=1 and ``TrainConfig``'s stream operating point, all at the
shipped ``Config`` width on full rows of
random audio (the steps with random transcripts of 48 labels),
with PyTorch's default TF32 settings as the CLIs run, records ``--calls``
calls of each with ``torch.profiler`` (CPU and CUDA activity) after
``--warmup`` calls, and prints per call and path:
the device time of each kernel name, ranked, with its share; the device busy
time (the union of kernel, memcpy and memset intervals); the idle share of the
profiled span, 1 - busy / span, where the span runs from the first device
event to the last (the profiler's host cost stretches it); and the idle share
of an unprofiled call, 1 - busy / wall, where wall is the median host time of
``--calls`` synchronized calls made right after, in the same process.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import textwrap
import time
from collections import defaultdict

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(trace: dict, calls: int = 1) -> dict:
    """Device events of a Chrome trace (``torch.profiler`` export) -> per-call
    totals: ``{"busy_ms", "span_ms", "idle_share", "events", "by_name":
    [(name, ms, count), ...] ranked by ms}``."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    if not events:
        raise RuntimeError("the trace holds no device events")
    by_name = defaultdict(lambda: [0.0, 0])
    spans = []
    for e in events:
        start, dur = float(e["ts"]), float(e.get("dur", 0.0))
        by_name[e["name"]][0] += dur
        by_name[e["name"]][1] += 1
        spans.append((start, start + dur))
    spans.sort()
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = max(end for _, end in spans) - spans[0][0]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    return {"busy_ms": busy / 1e3 / calls, "span_ms": span / 1e3 / calls,
            "idle_share": 1.0 - busy / span if span > 0 else 0.0,
            "events": len(events) / calls,
            "by_name": [(name, us / 1e3 / calls, n / calls) for name, (us, n) in ranked]}


def profile_call(fn, calls: int, warmup: int, trace_path: str) -> dict:
    """Profile ``calls`` calls of ``fn()`` after ``warmup`` calls, then time
    ``calls`` unprofiled ones; the Chrome trace is written to ``trace_path``.
    The summary gains ``wall_ms`` (median unprofiled call) and ``idle_wall``
    (1 - busy / wall)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        summary = summarize_trace(json.load(f), calls)
    walls = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    summary["wall_ms"] = statistics.median(walls)
    summary["idle_wall"] = 1.0 - summary["busy_ms"] / summary["wall_ms"]
    return summary


def device_time(run, match: str | None = None, alone=None, calls: int = 5,
                warmup: int = 2, tries: int = 2) -> tuple[float, str]:
    """The device time per call of ``run``'s work, or with ``match`` of its
    kernels whose name holds it -> (ms, source).  From ``torch.profiler``
    ("profiler") where a session recorded every kernel the same number of
    times in each of ``calls`` calls; in a long process the profiler has been
    seen on an H100 to drop kernel events (most often the last call's, so
    that a reading came out 4/5 of the truth), so after ``tries`` sessions
    that did not, the time is taken between two CUDA events around
    ``alone()`` (default ``run()``: the launches of the kernels to time) on a
    stream that a sleeping kernel keeps busy while the host enqueues the
    call, so that no host time falls between the events ("events on a busy
    stream")."""
    for _ in range(tries):
        with tempfile.TemporaryDirectory() as tmp:
            try:
                summary = profile_call(run, calls, warmup, os.path.join(tmp, "trace.json"))
            except RuntimeError:                   # no device event at all
                continue
        ms = summary["busy_ms"] if match is None else sum(
            t for name, t, _ in summary["by_name"] if match in name)
        if ms > 0 and all(float(n).is_integer() for _, _, n in summary["by_name"]):
            return ms, "profiler"
    fn = alone or run
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        torch.cuda._sleep(20_000_000)      # ~10 ms at 2 GHz: longer than a call's host time
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), "events on a busy stream"


def device_kernel_names(fn) -> dict:
    """{name: launches} of the device events (kernels, copies, sets) that
    ``torch.profiler`` records for one ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    names = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            names[ev.name] = names.get(ev.name, 0) + 1
    return names


_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_FRESH = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from aas_enhancement_tpu_torch.utils.profiling import device_kernel_names
{setup}
out = []
for fn in calls:
    fn()
    torch.cuda.synchronize()
    out.append(device_kernel_names(fn))
print(json.dumps(out))
"""


def kernel_names_in_fresh_process(setup: str, timeout: float = 300) -> list[dict]:
    """``device_kernel_names`` of each call in the list ``calls`` that the
    Python source ``setup`` defines (``torch`` imported), each called once
    before, in a fresh Python process.  Late in a long process on an H100,
    torch.profiler has left a kernel's record out of a session while keeping
    the session's other records (the GroupNorm backward, in ``chip_smoke.py``
    and in the GPU tests); in a fresh process it has not."""
    code = _FRESH.format(root=_ROOT, setup=textwrap.dedent(setup))
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"profiling in a fresh process failed: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def profile_paths(batch: int, seconds: float, calls: int, warmup: int,
                  trace_dir: str) -> dict:
    """{"enhance": summary, "recognize": summary, "train": summary,
    "train_am": summary, "train_paired": summary, "stream_enhance": summary,
    "stream_recognize": summary} at ``batch`` (the steps at
    ``TrainConfig.batch_size``, the streaming chunk calls at 1) x ``seconds``
    on the GPU, weights drawn from the config's train seed; each summary also
    holds its ``batch``."""
    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
    from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.steps import make_train_step

    device = resolve_device("cuda")
    cfg = Config()
    n = int(seconds * cfg.audio.sample_rate)
    gen = torch.Generator().manual_seed(0)
    wav = (0.3 * torch.randn(batch, n, generator=gen)).to(device)
    lengths = torch.full((batch,), n, device=device)
    enhancer = init_enhancer(cfg, cfg.train.seed, device)
    am = init_am(cfg, cfg.train.seed, device)
    enhance = make_enhance_fn(cfg, device)
    recognize = make_eval_forward(cfg, use_enhancer=True)
    out = {
        "enhance": profile_call(lambda: enhance(enhancer, wav, lengths), calls,
                                warmup, os.path.join(trace_dir, "enhance_trace.json")),
        "recognize": profile_call(lambda: recognize(am, enhancer, wav, lengths), calls,
                                  warmup, os.path.join(trace_dir, "recognize_trace.json")),
    }
    state = init_state(cfg, cfg.train.seed, device)
    step = make_train_step(cfg)
    train_batch, u = cfg.train.batch_size, 48
    tb = {"wav": (0.3 * torch.randn(train_batch, n, generator=gen)).to(device),
          "wav_lengths": torch.full((train_batch,), n, device=device),
          "labels": torch.randint(1, cfg.am.vocab_size, (train_batch, u),
                                  generator=gen).to(device),
          "label_paddings": torch.zeros(train_batch, u, device=device),
          "clean_wav": (0.3 * torch.randn(train_batch, n, generator=gen)).to(device),
          "clean_wav_lengths": torch.full((train_batch,), n, device=device)}
    out["train"] = profile_call(lambda: step(state, tb), calls, warmup,
                                os.path.join(trace_dir, "train_trace.json"))
    del state
    am_cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="am"))
    am_state = init_state(am_cfg, cfg.train.seed, device)
    am_step = make_train_step(am_cfg)
    am_tb = {k: v for k, v in tb.items() if not k.startswith("clean")}
    out["train_am"] = profile_call(lambda: am_step(am_state, am_tb), calls, warmup,
                                   os.path.join(trace_dir, "train_am_trace.json"))
    del am_state
    # The paired step with the MR-STFT term: every kernel of the objective.
    p_cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="paired",
                                                  lambda_mrstft=0.5))
    p_state = init_state(p_cfg, cfg.train.seed, device)
    p_step = make_train_step(p_cfg)
    p_tb = {k: tb[k] for k in ("wav", "wav_lengths", "clean_wav")}
    out["train_paired"] = profile_call(lambda: p_step(p_state, p_tb), calls, warmup,
                                       os.path.join(trace_dir, "train_paired_trace.json"))
    del p_state
    # One chunk call of the streaming engines at TrainConfig's operating point
    # (chunk 1.0, lookahead 0.2, history 1.0 s), B=1, in steady state: host
    # work, copies and the device call of one window.
    from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
    from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
    t = cfg.train
    kw = dict(chunk_seconds=t.stream_chunk_s, lookahead_seconds=t.stream_lookahead_s,
              history_seconds=t.stream_history_s)
    chunk = int(t.stream_chunk_s * cfg.audio.sample_rate)
    audio = (0.3 * torch.randn(64 * chunk, generator=gen)).numpy()
    engines = {"stream_enhance": StreamingEnhancer(cfg, enhancer, device=device, **kw),
               "stream_recognize": StreamingRecognizer(cfg, am, enhancer, device=device,
                                                       **kw)}
    for path, eng in engines.items():
        eng.feed(audio[: int(t.stream_lookahead_s * cfg.audio.sample_rate)])
        pos = itertools.count()

        def feed(eng=eng, pos=pos):
            i = next(pos) % 63 * chunk
            eng.feed(audio[i: i + chunk])

        out[path] = profile_call(feed, calls, warmup,
                                 os.path.join(trace_dir, f"{path}_trace.json"))
    for path, summary in out.items():
        summary["batch"] = (train_batch if path.startswith("train")
                            else 1 if path.startswith("stream") else batch)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--trace-dir", help="keep the seven Chrome traces in this directory")
    p.add_argument("--top", type=int, default=25, help="kernel names to print")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace_dir or tmp
        os.makedirs(trace_dir, exist_ok=True)
        summaries = profile_paths(args.batch, args.seconds, args.calls, args.warmup,
                                  trace_dir)
    for path, s in summaries.items():
        what = ("one 1 s chunk call" if path.startswith("stream")
                else f"{args.seconds} s")
        print(f"[profile {path}] {torch.cuda.get_device_name(0)} | B={s['batch']} x "
              f"{what}, per call over {args.calls} calls after "
              f"{args.warmup} warmups | device busy {s['busy_ms']:.3f} ms | span "
              f"{s['span_ms']:.3f} ms | idle share {100 * s['idle_share']:.2f}% | "
              f"unprofiled wall {s['wall_ms']:.3f} ms, idle share "
              f"{100 * s['idle_wall']:.2f}% | "
              f"{s['events']:.0f} device events | "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
        uneven = [name for name, _, count in s["by_name"] if not float(count).is_integer()]
        if uneven:      # dropped profiler events, or work that varies between calls
            print(f"[profile {path}] {len(uneven)} kernel names ran a fractional number of "
                  f"times a call (dropped profiler events, or work that varies between "
                  f"calls): {[n[:60] for n in uneven[:3]]}")
        for name, ms, count in s["by_name"][:args.top]:
            print(f"[profile {path}] {ms:9.3f} ms {100 * ms / s['busy_ms']:6.2f}% "
                  f"x{count:<5g} {name[:110]}")


if __name__ == "__main__":
    main()
