"""The live-pipeline WER: streaming enhancer -> streaming AM -> greedy and a
hybrid beam rescore, from a trained e2e workdir (port of the JAX repo's
``scripts/live_pipeline_eval.py``).

Audio goes through ``StreamingRecognizer`` (both networks block-streaming
with running normalization), fed ``--feed-seconds`` at a time; the session's
emitted log-probs are decoded greedily (the live transcript) and rescored
with the char + word hybrid beam (the final transcript).  The fusion weights
are tuned on the dev split under the same live condition: a coordinate grid
(the char point, then the word point with the char point fixed, each kept
only where strictly better), each stage refined past a grid edge by
``decode/tune.py::edge_refine``.  ``--g-checkpoint`` / ``--am-checkpoint``
serve the networks of a train-CLI checkpoint in place of the workdir's.

On a CUDA device the host beam must take the native decoder.  Prints the
result; writes it to ``--out`` when given.

Usage:
  python -m aas_enhancement_tpu_torch.quality.live_pipeline_eval --workdir /tmp/aas_e2e \\
      [--chunk 1.0] [--lookahead 0.2] [--history 0.5] [--order 4] [--beam-width 16] \\
      [--g-checkpoint DIR] [--am-checkpoint DIR] [--out result.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from aas_enhancement_tpu_torch.data.wav import read_wav
from aas_enhancement_tpu_torch.decode.beam import beam_decode
from aas_enhancement_tpu_torch.decode.lm import CharNGramLM, WordNGramLM
from aas_enhancement_tpu_torch.decode.tune import edge_refine
from aas_enhancement_tpu_torch.decode.wer import corpus_wer, corpus_wer_ci
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality import workdir
from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
from aas_enhancement_tpu_torch.train.loop import load_state


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", required=True)
    p.add_argument("--chunk", type=float, default=1.0)
    p.add_argument("--lookahead", type=float, default=0.2)
    p.add_argument("--history", type=float, default=0.5)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--prune-k", type=int, default=8)
    p.add_argument("--feed-seconds", type=float, default=0.1)
    p.add_argument("--g-checkpoint", default="",
                   help="serve the enhancer of this train-CLI checkpoint dir instead of "
                        "the workdir's (e.g. ck_stream_ft from streaming_finetune_eval, "
                        "ck_g_stream_native from streaming_native_train)")
    p.add_argument("--am-checkpoint", default="",
                   help="serve the AM of this train-CLI checkpoint dir (e.g. the "
                        "live-adapted ck_am_stream_ft from am_streaming_finetune)")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    grids = p.add_argument_group(
        "fusion tune grids (comma-separated floats; widen them when the best point "
        "lands on an edge)")
    grids.add_argument("--alpha-grid", default="0.3,0.6,1.0,1.5")
    grids.add_argument("--beta-grid", default="-0.5,0.0,0.5,1.0")
    grids.add_argument("--word-alpha-grid", default="0.3,0.6,1.0")
    grids.add_argument("--word-beta-grid", default="0.0,0.5,1.0")
    return p.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    g_alpha = [float(x) for x in args.alpha_grid.split(",")]
    g_beta = [float(x) for x in args.beta_grid.split(",")]
    g_walpha = [float(x) for x in args.word_alpha_grid.split(",")]
    g_wbeta = [float(x) for x in args.word_beta_grid.split(",")]
    device = resolve_device(args.device)
    workdir.require_native_beam(device)

    w = workdir.load(args.workdir, device)
    state, cfg = w.meta, w.cfg
    am, g = w.state.am, w.state.g
    if args.g_checkpoint:
        g = load_state(args.g_checkpoint, device)[0].g
    if args.am_checkpoint:
        am = load_state(args.am_checkpoint, device)[0].am

    sr = cfg.audio.sample_rate
    step = int(args.feed_seconds * sr)

    def stream_split(manifest):
        """-> (refs, greedy transcripts, per-utterance [T, V] live log-probs)."""
        refs, greedy, lps = [], [], []
        for line in open(manifest).read().splitlines():
            wav_path, txt_path = line.split(",")
            wav, _ = read_wav(wav_path)
            rec = StreamingRecognizer(cfg, am, enhancer=g, chunk_seconds=args.chunk,
                                      lookahead_seconds=args.lookahead,
                                      history_seconds=args.history, collect_logits=True,
                                      device=device)
            for i in range(0, len(wav), step):
                rec.feed(wav[i: i + step])
            rec.flush()
            refs.append(open(txt_path).read().strip())
            greedy.append(rec.transcript())
            lps.append(rec.log_probs())
        return refs, greedy, lps

    t0 = time.time()
    result = {"workdir": args.workdir, "g_checkpoint": args.g_checkpoint,
              "am_checkpoint": args.am_checkpoint, "chunk_s": args.chunk,
              "lookahead_s": args.lookahead, "history_s": args.history,
              "latency_s": args.chunk + args.lookahead,
              "beam_width": args.beam_width, "prune_k": args.prune_k,
              "grids": {"alpha": g_alpha, "beta": g_beta,
                        "word_alpha": g_walpha, "word_beta": g_wbeta}}

    clm = CharNGramLM.from_manifests([state["train_noisy"]], order=args.order)
    wlm = WordNGramLM.from_manifests([state["train_noisy"]])

    def hybrid_wer(lps, refs, pt):
        hyps = [beam_decode(lp[None], None, beam_width=args.beam_width, prune_k=args.prune_k,
                            lm=clm, lm_alpha=pt["alpha"], lm_beta=pt["beta"], word_lm=wlm,
                            word_alpha=pt["word_alpha"], word_beta=pt["word_beta"])[0]
                for lp in lps]
        workdir.check_beam_route(device)
        return corpus_wer(refs, hyps)

    # Hybrid fusion tuned on dev under the live condition (a coordinate grid,
    # as decode/tune.py::grid_search_hybrid, over live log-probs).
    dev_refs, dev_greedy, dev_lps = stream_split(state["dev_noisy"])
    result["dev_greedy"] = corpus_wer(dev_refs, dev_greedy)

    def char_wer(a_, b_):
        return hybrid_wer(dev_lps, dev_refs, {"alpha": a_, "beta": b_, "word_alpha": 0.0,
                                              "word_beta": 0.0})

    best_c, wer_c = (0.0, 0.0), result["dev_greedy"]
    for a_ in g_alpha:
        for b_ in g_beta:
            w_ = char_wer(a_, b_)
            if w_ < wer_c:
                best_c, wer_c = (a_, b_), w_
    if best_c[0] > 0.0:
        ca, cb, wer_c = edge_refine(char_wer, best_c[0], best_c[1], wer_c, g_alpha, g_beta)
        best_c = (ca, cb)
    best = {"alpha": best_c[0], "beta": best_c[1], "word_alpha": 0.0, "word_beta": 0.0}
    wer_h = wer_c
    for wa in g_walpha:
        for wb in g_wbeta:
            pt = {**best, "word_alpha": wa, "word_beta": wb}
            w_ = hybrid_wer(dev_lps, dev_refs, pt)
            if w_ < wer_h:
                best, wer_h = pt, w_
    if best["word_alpha"] > 0.0:
        wa, wb, wer_h = edge_refine(
            lambda wa_, wb_: hybrid_wer(dev_lps, dev_refs,
                                        {**best, "word_alpha": wa_, "word_beta": wb_}),
            best["word_alpha"], best["word_beta"], wer_h, g_walpha, g_wbeta,
            a_key="word_alpha", b_key="word_beta")
        best = {**best, "word_alpha": wa, "word_beta": wb}
    result["tuned"] = {**best, "dev_wer": wer_h, "dev_wer_char_only": wer_c}

    # The held-out test split, live.
    refs, greedy, lps = stream_split(state["test_noisy"])
    wg, lo, hi = corpus_wer_ci(refs, greedy)
    result["live_greedy_test"] = wg
    result["live_greedy_test_ci95"] = [lo, hi]
    result["live_hybrid_test"] = hybrid_wer(lps, refs, best)
    result["utterances"] = len(refs)
    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    if args.out:
        workdir.write_json(args.out, result, indent=1)
    return result


def main(argv=None) -> dict:
    result = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
