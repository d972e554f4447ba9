"""`e2e` entry point: the end-to-end quality protocol (port of the JAX repo's
``scripts/e2e_demo.py``, the same stages, seeds, configurations and result
keys).

  1. a synthetic TRAIN corpus and DISJOINT dev and held-out TEST corpora
     (seeds 7, 104729 and 7919: other sentences, noise draws and SNRs from
     the same language);
  2. CTC pre-training of the acoustic model on clean train speech;
  3. greedy WER on the held-out clean and noisy test split;
  4. the enhancer trained with the full AAS objective (the pre-trained AM,
     frozen, and the discriminator) on the train split only; the train state
     (networks and optimizers) saved for the scripts that read the workdir;
  5. WER on the enhanced held-out split and the delta against noisy;
  6. beam decoding with word, char and hybrid LM fusion (LMs from the train
     transcripts, weights tuned on the dev split, applied to test);
  7. train-split WERs (memorization against generalization);
  8. the held-out split streamed through the trained enhancer: WER streamed
     against offline, and SI-SNR / STOI of noisy, enhanced and streamed.

The defaults are the flagship protocol (384 train utterances, AM 1500 and
AAS 1000 steps, batch 16); ``--ablation`` runs the superseded 96-utterance
regime.  Every network runs on ``--device`` (the card by default; without a
GPU that raises).  On a CUDA device the host beam must take the native
decoder (``decode/beam.py``, built by ``utils/native_build.py``): a missing
library or a Python-route decode raises.

Writes ``result.json`` into ``--workdir`` (or ``--out``) after every stage
(with ``wall_minutes_so_far`` until the last) and prints the result as the
last line of its standard output; each stage's seconds go to stderr.  The
workdir keeps the corpora, ``checkpoint/`` (``config.json`` and the AAS
train state, ``train/loop.py::load_state`` opens it), ``sweep_state.json``
(the checkpoint and the manifests) and ``streamed/``.

Usage:
  python -m aas_enhancement_tpu_torch.cli.e2e [--ablation] [--spec-augment] \\
      [--snr-low -7 --snr-high -2] [--workdir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import (AMConfig, Config, DataConfig,
                                              DiscriminatorConfig, EnhancerConfig,
                                              TrainConfig)
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus
from aas_enhancement_tpu_torch.data.wav import read_wav, write_wav
from aas_enhancement_tpu_torch.decode.lm import CharNGramLM, WordNGramLM
from aas_enhancement_tpu_torch.decode.tune import grid_search_hybrid, grid_search_lm
from aas_enhancement_tpu_torch.evaluation import evaluate_si_snr, evaluate_wer
from aas_enhancement_tpu_torch.ops.dispatch import resolve_device
from aas_enhancement_tpu_torch.quality.workdir import (check_beam_route,
                                                       require_native_beam)
from aas_enhancement_tpu_torch.streaming import enhance_stream
from aas_enhancement_tpu_torch.train.loop import init_state, train
from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

# The superseded data-starved regime; explicit flags still win.
ABLATION = {"n_utts": 96, "n_dev_utts": 32, "am_steps": 500, "aas_steps": 300}
CORPUS_SEEDS = {"corpus": 7, "corpus_dev": 104729, "corpus_test": 7919}
AAS_SEED = 1          # G from seed 1, D from seed 2; the AM is the pre-trained one


def cfg_for(objective: str, batch_size: int, lambda_adv: float) -> Config:
    """The protocol's networks and training settings for ``objective``
    (``am`` or ``aas``): AM 3 x BiGRU-256 with 16 conv channels, enhancer
    2 conv layers of 16 channels and 2 x BiLSTM-128, discriminator
    (16, 32, 64), two buckets."""
    return Config(
        am=AMConfig(rnn_hidden=256, rnn_layers=3, conv_channels=16),
        enhancer=EnhancerConfig(conv_channels=16, conv_layers=2, rnn_hidden=128,
                                rnn_layers=2),
        discriminator=DiscriminatorConfig(channels=(16, 32, 64)),
        train=TrainConfig(objective=objective, batch_size=batch_size, epochs=100000,
                          log_every=25, lr_am=6e-4, lr_g=3e-4, lr_d=3e-4,
                          lambda_adv=lambda_adv),
        data=DataConfig(num_buckets=2),
    )


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "aas_e2e"))
    p.add_argument("--n-utts", type=int, default=384)
    p.add_argument("--n-dev-utts", type=int, default=48)
    p.add_argument("--n-test-utts", type=int, default=48)
    p.add_argument("--am-steps", type=int, default=1500)
    p.add_argument("--aas-steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--vocab-chars", type=int, default=0,
                   help="legacy uniform-char corpus; default 0 = structured "
                        "lexicon+bigram language")
    p.add_argument("--reverb-prob", type=float, default=0.3)
    p.add_argument("--lambda-adv", type=float, default=0.2)
    p.add_argument("--snr-low", type=float, default=0.0)
    p.add_argument("--snr-high", type=float, default=10.0)
    p.add_argument("--spec-augment", action="store_true",
                   help="SpecAugment during AM pre-training")
    p.add_argument("--skip-streaming", action="store_true")
    p.add_argument("--full", action="store_true",
                   help="no-op: the flagship protocol is the default")
    p.add_argument("--ablation", action="store_true",
                   help="the data-starved regime (96 train utts, am 500 / aas 300 "
                        "steps, 32 dev); explicit --n-utts/--*-steps flags win")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    if args.ablation:
        print("=" * 72)
        print("ABLATION REGIME: 96-utt data-starved protocol — held-out WER here is\n"
              "bounded by sentence diversity (BASELINE.md generalization-gap table), not\n"
              "by the models. Flagship numbers come from the DEFAULT (384-utt) run.")
        print("=" * 72)
        for k, v in ABLATION.items():
            if getattr(args, k) == p.get_default(k):
                setattr(args, k, v)
    return args


def run(args: argparse.Namespace) -> tuple[dict, dict]:
    """The protocol -> (result, seconds per stage)."""
    device = resolve_device(args.device)
    require_native_beam(device)
    wd = args.workdir
    os.makedirs(wd, exist_ok=True)
    corpus_kw = dict(snr_range=(args.snr_low, args.snr_high),
                     vocab_chars=args.vocab_chars, n_words=(3, 8),
                     reverb_prob=args.reverb_prob)
    sizes = {"corpus": args.n_utts, "corpus_dev": args.n_dev_utts,
             "corpus_test": args.n_test_utts}
    manifests, dev, test = (generate_corpus(os.path.join(wd, name), n_utts=sizes[name],
                                            seed=seed, **corpus_kw)
                            for name, seed in CORPUS_SEEDS.items())
    bs = args.batch_size

    result = {"n_utts": args.n_utts, "n_test_utts": args.n_test_utts,
              "am_steps": args.am_steps, "aas_steps": args.aas_steps,
              "full_protocol": not args.ablation, "ablation": args.ablation,
              "snr_range": [args.snr_low, args.snr_high]}
    walls: dict[str, float] = {}
    t0 = time.time()
    t_stage = [time.perf_counter()]
    out_path = args.out or os.path.join(wd, "result.json")

    def save(stage: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        walls[stage] = round(now - t_stage[0], 3)
        t_stage[0] = now
        print(f"[e2e] {stage}: {walls[stage]} s", file=sys.stderr, flush=True)
        result["wall_minutes_so_far"] = round((time.time() - t0) / 60.0, 1)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)

    # 1. AM pre-training on clean train speech.
    cfg_am = cfg_for("am", bs, args.lambda_adv)
    if args.spec_augment:
        cfg_am = cfg_am.replace(train=dataclasses.replace(cfg_am.train, spec_augment=True))
        result["spec_augment"] = True
    am_state, recs = train(cfg_am, manifests["clean"], max_steps=args.am_steps,
                           device=device)
    result["am_ctc_first"] = recs[0]["loss_ctc_am"]
    result["am_ctc_last"] = recs[-1]["loss_ctc_am"]
    am = am_state.am.eval().requires_grad_(False)
    save("am")

    # 2. Greedy WER on the held-out clean and noisy input.
    clean_wer = evaluate_wer(cfg_am, am, test["clean"], batch_size=bs)
    noisy_wer = evaluate_wer(cfg_am, am, test["noisy"], batch_size=bs)
    result["wer_clean_test"] = clean_wer["wer"]
    result["wer_noisy_test"] = noisy_wer["wer"]
    result["wer_noisy_test_ci95"] = noisy_wer.get("wer_ci95")
    result["sample"] = {"ref": noisy_wer["sample_ref"],
                        "hyp_noisy": noisy_wer["sample_hyp"]}
    save("wer_noisy")

    # 3. Full AAS training on the train split, the pre-trained AM frozen in it.
    cfg_aas = cfg_for("aas", bs, args.lambda_adv)
    aas_state = init_state(cfg_aas, AAS_SEED, device)
    aas_state.am = am
    aas_state, recs = train(cfg_aas, manifests["noisy"], manifests["clean"],
                            max_steps=args.aas_steps, state=aas_state, device=device)
    result["aas_ctc_first"] = recs[0]["loss_ctc"]
    result["aas_ctc_last"] = recs[-1]["loss_ctc"]
    g = aas_state.g.eval()
    save("aas")

    # The trained pipeline for the scripts that read the workdir: the whole
    # train state (optimizers included), which load_state opens.
    ck_dir = os.path.join(wd, "checkpoint")
    shutil.rmtree(ck_dir, ignore_errors=True)
    os.makedirs(ck_dir)
    with open(os.path.join(ck_dir, "config.json"), "w") as f:
        f.write(cfg_aas.to_json())
    ckpt.save(ck_dir, aas_state.step, aas_state, max_to_keep=1)
    with open(os.path.join(wd, "sweep_state.json"), "w") as f:
        json.dump({"checkpoint": ck_dir, "test_noisy": test["noisy"],
                   "test_clean": test["clean"], "dev_noisy": dev["noisy"],
                   "train_noisy": manifests["noisy"],
                   "train_clean": manifests["clean"]}, f)

    # 4. WER on the enhanced held-out input -> the delta.
    enh_wer = evaluate_wer(cfg_aas, am, test["noisy"], enhancer=g, batch_size=bs)
    result["wer_enhanced_test"] = enh_wer["wer"]
    result["wer_enhanced_test_ci95"] = enh_wer.get("wer_ci95")
    result["wer_delta_test"] = enh_wer["wer"] - noisy_wer["wer"]
    result["sample"]["hyp_enhanced"] = enh_wer["sample_hyp"]
    save("wer_enhanced")

    # 4b. Beam + LM decoding: LMs from the train transcripts, fusion weights
    # tuned on dev (enhanced), applied to test.
    wlm = WordNGramLM.from_manifests([manifests["noisy"]])
    clm = CharNGramLM.from_manifests([manifests["noisy"]], order=4)
    for tag, lm in (("wlm", wlm), ("clm", clm)):
        tuned = grid_search_lm(cfg_aas, am, dev["noisy"], lm, enhancer=g,
                               batch_size=bs, beam_width=16)
        check_beam_route(device)
        result[f"lm_{tag}_alpha"] = tuned["alpha"]
        result[f"lm_{tag}_beta"] = tuned["beta"]
        result[f"wer_dev_beam_{tag}"] = tuned["wer"]
        result["wer_dev_beam_no_lm"] = tuned["wer_no_lm"]
        result[f"wer_enhanced_test_beam_{tag}"] = evaluate_wer(
            cfg_aas, am, test["noisy"], enhancer=g, batch_size=bs, decoder="beam",
            beam_width=16, lm=lm, lm_alpha=tuned["alpha"], lm_beta=tuned["beta"])["wer"]
        check_beam_route(device)
    # The word LM is the headline ctcdecode-parity number.
    result["wer_enhanced_test_beam_lm"] = result["wer_enhanced_test_beam_wlm"]
    save("beam_lm")

    # Hybrid char + word fusion, coordinate descent on dev; test at beam 64.
    hy = grid_search_hybrid(cfg_aas, am, dev["noisy"], clm, wlm, enhancer=g,
                            batch_size=bs, beam_width=16)
    check_beam_route(device)
    result["lm_hybrid"] = {k: hy[k] for k in ("alpha", "beta", "word_alpha", "word_beta")}
    result["wer_dev_beam_hybrid"] = hy["wer"]
    result["wer_enhanced_test_beam_hybrid"] = evaluate_wer(
        cfg_aas, am, test["noisy"], enhancer=g, batch_size=bs, decoder="beam",
        beam_width=64, lm=clm, lm_alpha=hy["alpha"], lm_beta=hy["beta"], word_lm=wlm,
        word_alpha=hy["word_alpha"], word_beta=hy["word_beta"])["wer"]
    check_beam_route(device)
    save("beam_hybrid")

    # Train-split numbers (memorization against generalization).
    noisy_train = evaluate_wer(cfg_am, am, manifests["noisy"], batch_size=bs)
    enh_train = evaluate_wer(cfg_aas, am, manifests["noisy"], enhancer=g, batch_size=bs)
    result["wer_noisy_train"] = noisy_train["wer"]
    result["wer_enhanced_train"] = enh_train["wer"]
    save("wer_train")

    # 5. The held-out split streamed through the trained G, then 6. fidelity.
    if not args.skip_streaming:
        sdir = os.path.join(wd, "streamed")
        os.makedirs(sdir, exist_ok=True)
        lines = []
        for line in open(test["noisy"]).read().splitlines():
            wav_path, txt_path = line.split(",")
            wav, sr = read_wav(wav_path)
            out = np.concatenate(list(enhance_stream(cfg_aas, g, wav, device=device)))
            spath = os.path.join(sdir, os.path.basename(wav_path))
            write_wav(spath, out[: len(wav)], sr)
            lines.append(f"{spath},{txt_path}")
        smanifest = os.path.join(sdir, "manifest.csv")
        with open(smanifest, "w") as f:
            f.write("\n".join(lines) + "\n")
        stream_wer = evaluate_wer(cfg_am, am, smanifest, batch_size=bs)
        result["wer_streamed_test"] = stream_wer["wer"]
        result["streaming_penalty"] = stream_wer["wer"] - enh_wer["wer"]
        save("streamed")

        result.update(evaluate_si_snr(cfg_aas, test["noisy"], test["clean"],
                                      enhancer=g, streamed_manifest=smanifest))
        save("si_snr")

    result.pop("wall_minutes_so_far", None)
    result["wall_minutes"] = round((time.time() - t0) / 60.0, 1)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    return result, walls


def main(argv=None) -> dict:
    result, _ = run(parse_args(argv))
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
