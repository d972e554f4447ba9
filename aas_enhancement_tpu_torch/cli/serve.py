"""`serve` entry point: live streaming-enhancement server (port of
``aas_enhancement_tpu/cli/serve.py``).

Loads a trained enhancer checkpoint directory of the port and serves
concurrent live sessions over TCP: every connected stream's next block runs
in ONE device call per tick (``streaming.BatchedStreamingEnhancer``, or with
``--transcribe`` ``streaming_asr.BatchedStreamingRecognizer``; protocol in
``serve.py``), on ``--device`` (the card by default; without a GPU it
raises, never falling back to the CPU).

The operating points, the weight choice and the advisories are the JAX
package's, copied with their messages: they encode that package's sweeps,
and the files their text names are its records, not measurements of this
port.  In short: chunk 1.0 s / history 0.5 s always, lookahead 0.5 s in
transcribe mode and 0.2 s in enhance mode; ``--weights auto`` serves a
streaming-finetuned enhancer (``--streaming-checkpoint``) in transcribe mode
only, and only when it was fine-tuned AT the serving point; an adapted AM
(``--am-checkpoint``) is served only when adapted at the serving point.

Usage:
  python -m aas_enhancement_tpu_torch.cli.serve --checkpoint ck_aas \
      [--streaming-checkpoint ck_aas_stream_ft] [--transcribe] \
      [--am-checkpoint ck_am_stream_ft] \
      [--weights auto|offline|streaming] \
      [--host 127.0.0.1] [--port 7207] [--max-streams 64] \
      [--chunk 1.0] [--lookahead MODE-DEPENDENT] [--history 0.5] \
      [--device cuda|cpu]
The first stdout line is one JSON object (address, mode, weights, operating
point, latency, advisories); the server then runs until Ctrl-C, or until its
ticker fails, which re-raises here.
"""

from __future__ import annotations

import argparse
import json
import time

# The measured-best operating points (live_pipeline_r3.json chosen_point and
# streaming_sweep_r3.json).  Tests pin these — change only with a new sweep.
DEFAULT_CHUNK_S = 1.0
DEFAULT_HISTORY_S = 0.5
DEFAULT_LOOKAHEAD_S = {"transcribe": 0.5, "enhance": 0.2}


def resolve_operating_point(transcribe: bool, chunk: float | None,
                            lookahead: float | None,
                            history: float | None) -> tuple[float, float, float]:
    """CLI overrides fall back to the measured-best deployment point."""
    mode = "transcribe" if transcribe else "enhance"
    return (DEFAULT_CHUNK_S if chunk is None else chunk,
            DEFAULT_LOOKAHEAD_S[mode] if lookahead is None else lookahead,
            DEFAULT_HISTORY_S if history is None else history)


def pick_weights(weights: str, transcribe: bool,
                 have_streaming: bool) -> str:
    """'offline' or 'streaming' per the measured interaction (module doc)."""
    if weights == "auto":
        return "streaming" if (transcribe and have_streaming) else "offline"
    if weights == "streaming" and not have_streaming:
        raise SystemExit("--weights streaming needs --streaming-checkpoint")
    return weights


def ft_point_matches(ft_cfg, chunk: float, lookahead: float,
                     history: float, tol: float = 1e-6,
                     flag: str = "streaming_finetune") -> bool:
    """True iff the fine-tuned checkpoint was trained AT this serving point.

    A streaming fine-tune specializes the enhancer to one windowing; serving
    it at a different one is measurably harmful (live_pipeline_r4_hard_ft
    .json: a 0.2 s-lookahead fine-tune deployed at the 0.5 s transcribe
    point costs 18.5%->22.7% live hybrid WER under harsh SNR).  A checkpoint
    whose config does not record a streaming fine-tune at all (e.g. a plain
    train-CLI checkpoint) never matches — unknown provenance is off-point.

    `flag` selects which fine-tune the checkpoint must record:
    "streaming_finetune" (enhancer) or "streaming_finetune_am" (the
    live-adapted acoustic model, scripts/am_streaming_finetune.py).
    """
    t = ft_cfg.train
    return (bool(getattr(t, flag))
            and abs(t.stream_chunk_s - chunk) <= tol
            and abs(t.stream_lookahead_s - lookahead) <= tol
            and abs(t.stream_history_s - history) <= tol)


def guard_streaming_pick(requested: str, ft_cfg, chunk: float,
                         lookahead: float, history: float):
    """Final weight choice once the streaming checkpoint's config is known.

    Returns (which, warning_or_None): `auto` falls back to offline weights
    when the fine-tune's recorded operating point differs from the serving
    point (the measured-safe default); an explicit `--weights streaming` is
    obeyed but warned about.
    """
    if ft_point_matches(ft_cfg, chunk, lookahead, history):
        return "streaming", None
    t = ft_cfg.train
    trained = (t.stream_chunk_s, t.stream_lookahead_s, t.stream_history_s)
    msg = (f"streaming checkpoint fine-tuned at chunk/lookahead/history "
           f"{trained} but serving at {(chunk, lookahead, history)} — "
           f"off-point fine-tunes hurt (live_pipeline_r4_hard_ft.json)")
    if requested == "auto":
        return "offline", msg + "; --weights auto falls back to offline"
    return "streaming", ("WARNING: " + msg
                         + " (explicit --weights streaming, serving anyway)")


def deployment_advisories(which: str, am_weights: str) -> list[str]:
    """Measured condition-dependent interactions the operator must know
    (VERDICT r4 weak #6) — the operating-point guards above catch windowing
    MISMATCHES, but a matched adaptation can still be the wrong serving
    choice for the deployment's SNR condition / decode mode.  Full matrix:
    README.md "Deployment decision matrix".

    `which`      enhancer weights actually served ("offline"/"streaming")
    `am_weights` acoustic model actually served ("base"/"adapted"/absent "")
    """
    adv = []
    if am_weights == "adapted":
        adv.append(
            "adapted AM served: helps LM-less greedy transcripts (round-5 "
            "distill-anchored adaptation: live greedy 37.0%->35.7% easy, "
            "58.4%->56.7% harsh) but costs a downstream hybrid beam+LM "
            "rescore on BOTH conditions when the enhancer is a full-budget "
            "blockwise continuation (live_pipeline_r5{,_hard}_amft.json: "
            "easy 5.46%->5.88%, harsh 12.6%->14.3%) — if consumers "
            "rescore, serve the base AM; AM adaptation is a greedy-"
            "deployment tool")
    if which == "streaming":
        adv.append(
            "streaming weights served: a SHORT post-hoc fine-tune decodes "
            "worse than base under a hybrid beam+LM rescore "
            "(hybrid_fusion_r3.json streaming_finetune_interaction), but a "
            "full-budget blockwise CONTINUATION beats base on every live "
            "leg — greedy AND hybrid, both conditions (live_pipeline_r5"
            "{,_hard}_b32.json: hybrid 6.7%->2.1% easy, 18.5%->5.5% harsh) "
            "— prefer the continuation recipe (train --streaming-finetune "
            "--g-checkpoint <offline-ck> at full LR/budget) over 300-step "
            "patches")
    return adv


def start_server(argv=None):
    """Parse the flags, load the checkpoints, and start the server ->
    (the started ``EnhanceServer``, the JSON line's dict).  ``main`` prints
    the line and waits; tests drive this with ``--port 0`` and stop it."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", required=True,
                   help="train-CLI checkpoint dir with enhancer params")
    p.add_argument("--streaming-checkpoint", default="",
                   help="optional streaming-finetuned checkpoint dir (train "
                        "--streaming-finetune); used by --weights auto in "
                        "transcribe mode")
    p.add_argument("--weights", choices=("auto", "offline", "streaming"),
                   default="auto",
                   help="which enhancer weights to serve (auto = the "
                        "reference's choice per mode; see module docstring)")
    p.add_argument("--am-checkpoint", default="",
                   help="live-adapted acoustic-model checkpoint dir (train "
                        "--objective am --streaming-finetune-am); transcribe "
                        "mode serves its AM when it was adapted AT the serving "
                        "point, else falls back to the base checkpoint's AM "
                        "with a warning")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7207)
    p.add_argument("--max-streams", type=int, default=64)
    p.add_argument("--chunk", type=float, default=None,
                   help=f"block seconds (default {DEFAULT_CHUNK_S})")
    p.add_argument("--lookahead", type=float, default=None,
                   help="lookahead seconds (default "
                        f"{DEFAULT_LOOKAHEAD_S['transcribe']} transcribe / "
                        f"{DEFAULT_LOOKAHEAD_S['enhance']} enhance)")
    p.add_argument("--history", type=float, default=None,
                   help=f"history seconds (default {DEFAULT_HISTORY_S})")
    p.add_argument("--transcribe", action="store_true",
                   help="serve live TRANSCRIPTS (enhancer + AM per block; "
                        "checkpoint must carry acoustic-model params) — "
                        "response frames are UTF-8 transcript deltas")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
    from aas_enhancement_tpu_torch.serve import EnhanceServer
    from aas_enhancement_tpu_torch.train.loop import load_state

    device = resolve_device(args.device)
    chunk, lookahead, history = resolve_operating_point(
        args.transcribe, args.chunk, args.lookahead, args.history)
    which = pick_weights(args.weights, args.transcribe,
                         bool(args.streaming_checkpoint))

    state, cfg = load_state(args.checkpoint, device)
    g = state.g
    if which == "streaming":
        ft_state, ft_cfg = load_state(args.streaming_checkpoint, device)
        if ft_state.g is None:
            raise SystemExit(f"{args.streaming_checkpoint}: checkpoint has no "
                             f"enhancer params")
        which, warn = guard_streaming_pick(args.weights, ft_cfg,
                                           chunk, lookahead, history)
        if warn:
            print(f"serve: {warn}", flush=True)
        if which == "streaming":
            g = ft_state.g
    if g is None and not (args.transcribe and state.am is not None):
        raise SystemExit(f"{args.checkpoint}: checkpoint has no enhancer "
                         f"(objective was {cfg.train.objective!r})")
    if args.transcribe and state.am is None and not args.am_checkpoint:
        raise SystemExit(f"{args.checkpoint}: --transcribe needs acoustic-"
                         f"model params (train objective 'am' or 'aas')")

    am, am_weights = state.am, "base"
    if args.transcribe and args.am_checkpoint:
        am_state, am_cfg = load_state(args.am_checkpoint, device)
        if am_state.am is None:
            raise SystemExit(f"{args.am_checkpoint}: checkpoint has no "
                             f"acoustic-model params")
        if ft_point_matches(am_cfg, chunk, lookahead, history,
                            flag="streaming_finetune_am"):
            am, am_weights = am_state.am, "adapted"
        elif state.am is None:
            raise SystemExit(
                f"{args.am_checkpoint}: AM adaptation point differs from the "
                f"serving point and {args.checkpoint} carries no base AM to "
                f"fall back to")
        else:
            t = am_cfg.train
            print(f"serve: AM checkpoint adapted at chunk/lookahead/history "
                  f"{(t.stream_chunk_s, t.stream_lookahead_s, t.stream_history_s)} "
                  f"but serving at {(chunk, lookahead, history)} — falling "
                  f"back to the base AM (off-point fine-tunes hurt, "
                  f"live_pipeline_r4_hard_ft.json)", flush=True)

    advisories = deployment_advisories(
        which, am_weights if args.transcribe else "")
    for a in advisories:
        print(f"serve advisory: {a}", flush=True)

    server = EnhanceServer(cfg, g.eval() if g is not None else None, host=args.host,
                           port=args.port, max_streams=args.max_streams,
                           chunk_seconds=chunk, lookahead_seconds=lookahead,
                           history_seconds=history,
                           am=am.eval() if args.transcribe else None,
                           device=device).start()
    line = {"serving": f"{server.address[0]}:{server.address[1]}",
            "mode": "transcribe" if args.transcribe else "enhance",
            "weights": which,
            **({"am_weights": am_weights} if args.transcribe else {}),
            "chunk_s": chunk, "lookahead_s": lookahead,
            "history_s": history,
            "max_streams": args.max_streams,
            "latency_s": chunk + lookahead,
            "advisories": advisories}
    return server, line


def wait(server, poll_seconds: float = 1.0) -> None:
    """Serve until Ctrl-C (then stop) or until the ticker fails (``check``
    re-raises its exception; the server has already hung up every session)."""
    try:
        while True:
            server.check()
            time.sleep(poll_seconds)
    except KeyboardInterrupt:
        server.stop()


def main(argv=None) -> None:
    server, line = start_server(argv)
    print(json.dumps(line), flush=True)
    wait(server)


if __name__ == "__main__":
    main()
