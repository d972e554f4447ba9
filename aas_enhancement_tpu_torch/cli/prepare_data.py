"""`prepare_data` entry point: synthetic corpus generation + manifest tooling.

Reference parity: the data prep scripts (SURVEY.md §2 "Data prep scripts") that
download/link corpora and write manifests.  Real CHiME-4/Librispeech are licensed and
absent here, so the primary mode generates the deterministic synthetic corpus; a
--from-dir mode builds a manifest from any directory of wav+txt pairs so real corpora
plug in when available.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from aas_enhancement_tpu_torch.data.manifest import write_manifest
from aas_enhancement_tpu_torch.data.synthetic import generate_corpus


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-utts", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--snr-low", type=float, default=0.0)
    p.add_argument("--snr-high", type=float, default=10.0)
    p.add_argument("--vocab-chars", type=int, default=0,
                   help="legacy mode: restrict uniform-random transcripts to "
                        "the first N chars (easier CTC); 0 = structured "
                        "lexicon+bigram language (default)")
    p.add_argument("--lang-seed", type=int, default=0,
                   help="language seed (lexicon + bigram model); keep equal "
                        "across train/dev/test corpora so an LM transfers")
    p.add_argument("--lexicon-size", type=int, default=100)
    p.add_argument("--tri-classes", type=int, default=1,
                   help="structured mode: >1 plants genuine trigram word "
                        "structure (successor distribution depends on the "
                        "previous word's class) so an order-3 LM beats an "
                        "order-2 one at decode time")
    p.add_argument("--n-words-low", type=int, default=2)
    p.add_argument("--n-words-high", type=int, default=5)
    p.add_argument("--rate-jitter", type=float, default=None,
                   help="speaking-rate sigma (default 0.25 structured, 0 legacy)")
    p.add_argument("--coarticulation", type=float, default=None,
                   help="formant-glide fraction (default 0.35 structured, 0 legacy)")
    p.add_argument("--reverb-prob", type=float, default=0.0,
                   help="fraction of noisy utterances convolved with a "
                        "synthetic RIR before noise mixing")
    p.add_argument("--from-dir", help="instead: build manifest from an existing dir "
                                      "of .wav files with sibling .txt transcripts")
    p.add_argument("--chime4-dir", help="instead: build manifests from a CHiME-4 "
                                        "checkout (see --chime4-split)")
    p.add_argument("--chime4-split", default="tr05_simu",
                   help="CHiME-4 split dir under data/audio/16kHz/isolated "
                        "(e.g. tr05_simu, dt05_simu, et05_real)")
    p.add_argument("--channel", default="CH5",
                   help="CHiME-4 isolated channel suffix to select")
    args = p.parse_args(argv)

    if args.chime4_dir:
        _prepare_chime4(args)
        return

    if args.from_dir:
        entries = []
        for wav in sorted(glob.glob(os.path.join(args.from_dir, "**", "*.wav"),
                                    recursive=True)):
            txt = os.path.splitext(wav)[0] + ".txt"
            if os.path.exists(txt):
                entries.append((wav, txt))
        manifest = os.path.join(args.out_dir, "manifest.csv")
        write_manifest(manifest, entries)
        print(json.dumps({"manifest": manifest, "utterances": len(entries)}))
        return

    out = generate_corpus(args.out_dir, n_utts=args.n_utts, seed=args.seed,
                          snr_range=(args.snr_low, args.snr_high),
                          vocab_chars=args.vocab_chars,
                          n_words=(args.n_words_low, args.n_words_high),
                          lang_seed=args.lang_seed,
                          lexicon_size=args.lexicon_size,
                          tri_classes=args.tri_classes,
                          rate_jitter=args.rate_jitter,
                          coarticulation=args.coarticulation,
                          reverb_prob=args.reverb_prob)
    print(json.dumps({**out, "utterances": args.n_utts}))


def _prepare_chime4(args) -> None:
    """Manifest generation for a real CHiME-4 checkout (SURVEY.md §2 "Data prep
    scripts"; the reference's primary corpus, BASELINE.json:2).

    Expected layout (standard CHiME-4 distribution; unverifiable offline, so this
    is tolerant): wavs under `<root>/data/audio/16kHz/isolated/<split>/` named
    `<utt>_<env>.<channel>.wav` (or plain `<utt>.wav`), transcriptions under
    `<root>/data/transcriptions/<split>/<utt>.trn` — falling back to a recursive
    search for `.trn`/`.txt` siblings anywhere in the checkout.
    """
    import re

    root = args.chime4_dir
    split = args.chime4_split
    wav_dirs = [os.path.join(root, "data", "audio", "16kHz", "isolated", split),
                os.path.join(root, split), root]
    wavs = []
    for d in wav_dirs:
        if os.path.isdir(d):
            wavs = sorted(glob.glob(os.path.join(d, "**", "*.wav"), recursive=True))
            if wavs:
                break
    if args.channel:
        chan = [w for w in wavs if f".{args.channel}." in os.path.basename(w)]
        any_channel_tagged = any(".CH" in os.path.basename(w) for w in wavs)
        if chan:
            wavs = chan
        elif any_channel_tagged:
            # Channel-tagged corpus but the requested channel doesn't exist —
            # mixing all channels silently would double-count utterances.
            raise SystemExit(f"no wavs with channel {args.channel!r} under {root} "
                             f"(channel-tagged files present; pick an existing one)")

    # Transcript lookup: utterance id = basename up to the first '.' minus env tag.
    trn_index: dict[str, str] = {}
    for pattern in ("**/*.trn", "**/*.txt"):
        for t in glob.glob(os.path.join(root, pattern), recursive=True):
            trn_index.setdefault(os.path.splitext(os.path.basename(t))[0], t)

    os.makedirs(args.out_dir, exist_ok=True)
    entries, missing = [], 0
    for w in wavs:
        base = os.path.basename(w).split(".")[0]
        utt = re.sub(r"_(BUS|CAF|PED|STR)$", "", base)
        txt = trn_index.get(base) or trn_index.get(utt)
        if txt is None:
            missing += 1
            continue
        entries.append((w, txt))
    manifest = os.path.join(args.out_dir, f"{split}_manifest.csv")
    write_manifest(manifest, entries)
    print(json.dumps({"manifest": manifest, "utterances": len(entries),
                      "missing_transcripts": missing}))


if __name__ == "__main__":
    main()
