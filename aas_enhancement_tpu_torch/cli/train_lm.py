"""`train_lm` entry point: build an n-gram LM from training manifests (port
of ``aas_enhancement_tpu/cli/train_lm.py``; it writes the same files, byte
for byte).

The KenLM stand-ins for beam-search fusion are n-gram models trained on the
corpus transcripts, consumed by `evaluate --decoder beam|device --lm <out>`
(`--word-lm` for word LMs in hybrid fusion):

  --level char   char n-gram, fused per symbol (dense-table export)
  --level word   word n-gram with stupid backoff, fused per completed word —
                 the faithful ctcdecode+KenLM equivalent (default).
                 --order 2 (default) trains the WordNGramLM json format;
                 --order >= 3 trains an any-order ARPA model via
                 decode.arpa.fit_arpa (sparse n-gram fusion, KenLM parity) —
                 --out is then written in ARPA format (load_lm sniffs it).

Usage:
  python -m aas_enhancement_tpu_torch.cli.train_lm \
      --manifest train_manifest.csv --level word --out lm.json
  python -m aas_enhancement_tpu_torch.cli.train_lm \
      --manifest train_manifest.csv --level word --order 3 --out lm.arpa
"""

from __future__ import annotations

import argparse
import json

from aas_enhancement_tpu_torch.decode.lm import CharNGramLM, WordNGramLM


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", action="append", required=True,
                   help="training manifest csv (repeatable)")
    p.add_argument("--level", choices=["char", "word"], default="word")
    p.add_argument("--order", type=int, default=0,
                   help="n-gram order. char level: dense table is "
                        "V^(order-1) x V, keep <= 4 (default 3). word "
                        "level: 2 = bigram json (default), >= 3 = any-order "
                        "ARPA via the sparse fusion store")
    p.add_argument("--out", required=True, help="output LM json path")
    p.add_argument("--arpa", default="",
                   help="also export the word LM as a KenLM-style ARPA file "
                        "(word level only; loadable via --lm/--word-lm)")
    args = p.parse_args(argv)

    if args.arpa and args.level != "word":
        p.error("--arpa only applies to --level word")
    if args.level == "word":
        order = args.order or 2
        if order >= 3:
            from aas_enhancement_tpu_torch.decode.arpa import fit_arpa_from_manifests
            lm = fit_arpa_from_manifests(args.manifest, order=order)
            lm.save_arpa(args.out)
            if args.arpa and args.arpa != args.out:
                lm.save_arpa(args.arpa)
            print(json.dumps({"out": args.out, "level": "word",
                              "order": order, "format": "arpa",
                              "vocab_words": len(lm.vocab) - 3,
                              "ngrams": [len(lv) for lv in lm.ngrams]}))
        else:
            lm = WordNGramLM.from_manifests(args.manifest)
            lm.save(args.out)
            if args.arpa:
                from aas_enhancement_tpu_torch.decode.arpa import export_arpa
                export_arpa(lm, args.arpa)
            print(json.dumps({"out": args.out, "level": "word",
                              "arpa": args.arpa or None,
                              "vocab_words": len(lm.uni),
                              "bigrams": len(lm.bi), "tokens": lm.total}))
    else:
        lm = CharNGramLM.from_manifests(args.manifest, order=args.order or 3)
        lm.save(args.out)
        n_ctx = sum(len(level) for level in lm.counts)
        print(json.dumps({"out": args.out, "level": "char", "order": lm.order,
                          "contexts": n_ctx, "vocab": len(lm.labels)}))


if __name__ == "__main__":
    main()
