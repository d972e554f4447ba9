"""The quality protocols: those that read the end-to-end workdir
(``cli/e2e.py``) and those with a workdir of their own; one module per JAX
repo script, under the script's file name.

Each runs as ``python -m aas_enhancement_tpu_torch.quality.<name>`` with the
script's flags, defaults, result keys, default output paths and checkpoint
directory names, plus ``--device`` (the card by default; without a GPU that
raises), and keeps ``parse_args(argv)`` / ``run(args) -> result`` for a
caller in the same process.  They chain: each writes a train-CLI checkpoint
that the next takes through ``--g-checkpoint`` / ``--am-checkpoint``.

  streaming_native_train  G trained blockwise at the deployment point
                          (``ck_g_stream_native``)
  live_pipeline_eval      the fully-live session, greedy and hybrid rescore
  hybrid_fusion_eval      char + word fusion tuned on dev, test WERs
  am_streaming_finetune   the AM adapted through the frozen G, streamed or
                          ``--offline`` (``ck_am_stream_ft`` / ``ck_am_offline_ft``)
  coadapt_alternate       G re-fine-tuned against the adapted AM (``ck_g_coadapt``)
  streaming_sweep         chunk x lookahead x history grid of streamed WER
  streaming_finetune_eval short blockwise fine-tune that continues the saved
                          optimizer state (``ck_stream_ft``)

With a workdir of their own (trigram-structured corpora, an AM trained
through the train CLI into ``ckpt_am``, ``word{2,3}.arpa``), patching one
result file in turn:

  trigram_fusion_eval     trigram over bigram word-LM fusion, tuned on dev
  trigram_bigtest         both beams on a larger fresh split, paired counts
  biglex_hard_pipeline    the 1000-word, -7...-2 dB corpora through the
                          flagship hard stack (``cli.e2e``'s ``checkpoint/``)

``workdir.py`` reads the workdir and streams a manifest through the enhancer.
"""
