#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (aas_enhancement_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
1. device: the card's name and power limit, TF32 off for the parity checks;
2. build: the native host libraries from native/ (make, g++: the beam
   decoder and the wav loader), then the CUDA kernels from csrc/ (nvcc,
   sm_90a, one process per source), with each kernel's registers, shared
   memory and spills from ptxas;
3. kernels: each kernel against its plain PyTorch version on the card at the
   full-width shapes its paths give it (B=4 x 8 s, ragged lengths): the
   enhance path's (T=801, F=161, C=32, LSTM H=256) and the AM's (GN +
   hardtanh at [4, 401, 81, 32] and [4, 401, 41, 32], GRU T=401, H=512),
   with the max abs error, the tolerance and the median time of kernel and
   plain version (CUDA events, after warmup, timed in turns).  The LSTM and
   GRU lines (resident route: wh[d] in a cluster's shared memory) also give
   the streaming kernel's and the training variant's time at the same shape,
   the kernel's device time from the profiler and the number of the route's
   clusters the card runs at once; further LSTM cases run B=6 (a
   partial row tile), B=32, H=64 and 128 (clusters of 2 and 4) and H=512 (the
   streaming route), further GRU cases B=8 and B=32, further STFT and ISTFT
   cases hop 80; the STFT, ISTFT and GroupNorm lines also give the device
   time of the kernel and of the library call from the profiler (one call
   between two events reads mostly host time at a few microseconds), the
   STFT and ISTFT lines their route (n_fft 320 must take the two-stage
   transform), the ISTFT and GroupNorm lines check the same bits on two calls;
4. slice: the port's enhance CLI on a synthetic corpus with --device cuda,
   counting each kernel's launches (and failing unless the LSTM and, on the
   later paths, the 512-wide GRU took the resident route); then a full-width
   B=4 x 8 s batch on the card against the same weights on the CPU, the
   device kernels of one such call (the profiler's count, and those of the
   GroupNorm forward and the ISTFT: one each a wrapper call), and the batch's
   real-time factor;
5. recognize: the port's evaluate CLI (noisy and enhanced WER, SI-SNR) on a
   synthetic corpus with --device cuda, counting each kernel's launches; then
   the recognition forward (enhancer + AM, 4 x BiGRU-512) at B=4 x 8 s on the
   card against the same weights on the CPU (logits, greedy ids), the device
   kernels of one call, and its time per batch with and without the enhancer;
5a. bf16: the models at dtype="bfloat16" (their forwards; the shipped
   widths): the GroupNorm (leaky at [4, 801, 161, 32], hardtanh at the AM's
   two shapes), LSTM-256 and GRU-512 (resident, and the streaming kernel
   forced on the same inputs) and the stacked forwards on bf16 streams
   against their plain versions on the card (BF16_TOL, relative to the
   plain output's largest value), timed, with the bound at 2-byte streams
   and the bf16 tensor-core rate; cli.enhance and cli.evaluate (greedy) with
   a bf16 config, one stream through StreamingEnhancer and through
   StreamingRecognizer, and the cli.export artifact of a bf16 checkpoint
   directory against the live call (equal bits), each path's launches
   counted and every GroupNorm, LSTM and GRU wrapper's last launch on bf16
   streams (fn.dtype); enhance and recognition card vs CPU at B=4 x 2 s
   (BF16_PATH_TOL), the bf16 wave apart from the f32 wave of the same
   weights by more than the f32 card-vs-CPU limit; enhance and recognition
   at B=4 x 8 s timed f32 beside bf16 (in turns) with their device busy time;
5c. train_bf16: training at dtype="bfloat16": the backward kernels on bf16
   streams at B=8, ragged (LSTM-256 and GRU-512 resident, time-major and
   stacked, with the streaming route on the same inputs; the GroupNorm at
   its three shapes, one device kernel a call read in a fresh process; the
   AM's conv2 dW) against their plain versions on the same bf16 inputs
   (BF16_BWD_TOL), timed in turns with the same kernels on f32 inputs, the
   bound at 2-byte streams; one bf16 aas, am and paired (MR-STFT term) step
   card vs CPU at B=4 x 2 s (BF16_STEP_TOL, BF16_GRAD_TOL); each step's
   launches at B=8 with the GroupNorm, LSTM, GRU and conv_dw wrappers' last
   launches, forward and backward, on bf16 streams; the steps at B=8 and
   B=32 x 8 s, bf16 beside f32 in turns, with peak memory, and the aas step
   at B=128 x 8 s (the JAX package's production shape); cli.train with a
   bf16 --config for two steps of aas, adversarial, acoustic, paired, am and
   am --streaming-finetune-am, and an am run saved at step 2 and continued
   to step 3;
5b. decode: on a full-width AM and enhancer (seeds 0 and 1), the recognition
   forward at B=4 x 8 s, ragged, and its log-probs through the host beam
   (native C++, W=32) with no LM, a char 3-gram, a word LM and both (the
   LMs written by cli.train_lm from the phase's synthetic corpus; the route
   must be native, and the native batch must give beam_search_python's ids
   on two rows), and through the device beam (W=32, prune 16, no LM and the
   char 3-gram: ids and lengths equal to its CPU run, scores within 1e-3
   relative), timed (median of 5 after 2) with its device events, busy time
   and idle share beside the native batch decoder's wall on the same
   log-probs; cli.evaluate --decoder beam --lm --word-lm --tune-lm-manifest
   and --decoder device --lm on 6 utterances (launches counted with the
   forward's); a batch with native_decode against the Python reader's; and
   cli.train --objective am, 2 steps, with use_grain (2 spawned workers);
6. train: the port's train CLI (--objective aas, 3 steps, B=4) on a synthetic
   corpus with --device cuda, counting each kernel's launches (the backward
   kernels included); one AAS step's metrics and G and D gradients at
   B=4 x 8 s on the card against the same weights and batch on the CPU; and
   full AAS steps timed at B=8 and B=32 x 8 s;
7. birnn: BiRNN(time_major=False), the route to the stacked-layout LSTM and
   GRU kernels, forward and backward at H=256 and H=512 against
   BiRNN(time_major=True) on the transposed input, counting their launches;
8. train_am: the train CLI with --objective am (AM pre-training, 3 steps,
   B=4) on the card, counting launches (conv_dw once per microbatch, gru_bwd
   once per layer); one AM step at B=4 x 8 s against the CPU (metrics, every
   AM gradient tensor, updated parameters); the kernel names of one step
   with conv2's dW from the kernel and from cuDNN; AM steps timed at B=8 and
   B=32 x 8 s, and at B=8 with SpecAugment and the KL anchor;
8a. dp: data parallelism on this one card: 2 ranks (processes running this
   script with --dp-rank) over gloo, B=8 x 8 s global (4 rows a rank), 3
   steps of aas at f32, of am at bf16 with SpecAugment, and of the same am
   at f32 (the witness that the bf16 run's gradient difference is bf16
   rounding, not the data-parallel path), through
   make_mesh, replicate_state, shard_batch and the step's all-reduce; in
   each rank the kernels' launches (conv_dw on route "mma", every GN / GRU
   launch on bf16 streams in the am run); step 1's metrics and gradients
   of rank 0 against one process at B=8 on the card (DP_TOL,
   DP_GRAD_TOL), the parameters of the two ranks equal after the last
   step; the step walls of 1 rank at B=8 and of each rank, and the
   all-reduce's MB and ms a step (informative); then the train CLI under
   torchrun --nproc_per_node 1 with --dist-backend nccl (final_step 2);
9. checkpoint: the CLIs with checkpoint directories at full width on the
   card (B=4, 6 synthetic utterances): AM pre-training saved at step 2 and
   resumed with --continue-from to step 4 against an uninterrupted 4-step
   run (losses of steps 3-4), the saved AM (load_state) on the card against
   the CPU, AAS fine-tuning with --am-checkpoint DIR and validation every
   step, cli.evaluate and cli.enhance from both directories; each run's
   launches, the save and load seconds, the checkpoints' MB and the seconds
   of a validation;
10. paired: one paired step (G's gradient of the L1 between enhanced and
   clean log-magnitudes, clip, Adam), ragged, at B=4 x 8 s with
   lambda_mrstft 0 and at B=8 with 0.5 (the MR-STFT term, whose gradient
   runs through the STFT's and the ISTFT's VJP kernels), card vs CPU (metrics, every G gradient tensor) and
   its launches; steps timed at B=8 and B=32; then cli.train --objective
   paired (lambda_mrstft 0.5, B=4, 3 steps) with a checkpoint directory,
   cli.enhance from it, and an am run given it as --g-checkpoint, whose
   directory keeps that enhancer and enhances too;
11. streaming: the four streaming engines (StreamingEnhancer, B=1;
   BatchedStreamingEnhancer, 8 streams; StreamingRecognizer and
   BatchedStreamingRecognizer with the enhancer in front) at chunk 1.0,
   lookahead 0.2, history 1.0 s on 8 synthetic streams pushed in 0.1 s
   pieces, card vs CPU (samples, log-probs or logits, greedy ids), each
   engine's launches; each engine's steady-state chunk call timed (ms, RTF,
   device busy and idle share, launches a call); one aas step with
   streaming_finetune and one am step with streaming_finetune_am at B=4 x
   8 s card vs CPU (metrics, every gradient tensor) with their launches, and
   both timed at B=8 and B=32 x 8 s with busy time, peak memory and the
   recurrences' routes, clusters at once and waves; then cli.enhance
   --streaming and cli.train --streaming-finetune / --streaming-finetune-am
   (2 steps, B=4) on their default device, the card.
11a. hop: the 25 ms / 10 ms framing (n_fft 400, hop 160, 201 bins: a hop
   that does not divide n_fft) at the default widths: the STFT and ISTFT
   kernels at B=4 x 8 s and their VJP kernels at B=8 x 8 s at (400, 160)
   against their plain versions, timed beside torch.stft / torch.istft (and
   autograd.grad through them) with their device times, route, device
   kernels a call and frames transformed; the enhance function and the
   recognition forward at B=2 x 2 s and one chunk call of StreamingEnhancer
   and of StreamingRecognizer, card vs CPU; cli.enhance, cli.evaluate
   (greedy), cli.train --objective paired (lambda_mrstft 0.5, 2 steps, a
   checkpoint directory) and --objective aas (1 step) on 3 utterances with
   --device cuda; cli.export of the paired directory and one artifact call
   against the live call (equal bits); each run's launches, and the STFT,
   ISTFT and ISTFT-VJP routes those runs took at (400, 160);
11b. e2e: the end-to-end quality protocol (python -m
   aas_enhancement_tpu_torch.cli.e2e) in this process at a tiny size
   (E2E_ARGV: 32 / 8 / 8 utterances, 40 AM and 10 AAS steps, B=8) at its own
   widths (AM 3 x BiGRU-256, enhancer 2 x BiLSTM-128, 16 channels), after
   its kernels at those widths against their plain versions (kernels_e2e:
   GN and its backward at the flagship batch's [16, 601, 161, 16] and
   [16, 301, 81 | 41, 16], the BiLSTM-128 and BiGRU-256 forward and backward
   on their resident routes, B6 f32 at the AM's conv2 with 16 channels): AM
   pre-training, held-out greedy WER, AAS with the pre-trained AM frozen,
   the checkpoint, word / char / hybrid LM fusion tuned on dev, train-split
   WERs, the streamed split, SI-SNR and STOI; its stage walls, WERs and
   launches printed; it fails unless the result has every key of the JAX
   round's e2e_result_r5.json with finite numbers, the AM's CTC fell, each
   of B1, B1', B2, B2', B3, B3', B4, B5 and B6 launched and the host beam
   took the native route;
11c. quality: the seven quality protocols of aas_enhancement_tpu_torch/
   quality/ in this process on [e2e]'s workdir, chained (QUALITY_CHAIN: 3
   training steps at B=8, one- or two-point grids): streaming_native_train
   --init trained, live_pipeline_eval on its G, am_streaming_finetune
   (streamed, distill-anchored) and --offline, coadapt_alternate on the
   offline-adapted AM, hybrid_fusion_eval on that pair, streaming_sweep,
   streaming_finetune_eval (the saved optimizers continued); each
   protocol's seconds and numbers and the chain's launches printed; every
   checkpoint through load_state, the two streaming G checkpoints through
   cli.serve --streaming-checkpoint; it fails unless each result has
   exactly the keys of the port's CPU run (QUALITY_KEYS) with finite
   numbers, each checkpoint opens with its objective and step, both G
   checkpoints serve as the streaming weights, the host beam took the
   native route and each of B1, B1', B2, B2', B3, B3', B4, B5 and B6
   launched;
11d. fusion: the three quality protocols with a workdir of their own, in
   this process, chained in a temporary workdir at the 1000-word, -7...-2
   dB condition (FUSION_CHAIN: 16 / 4 / 4 utterances, 5 AM steps at B=8
   through cli.train, 2000 LM sentences, beam 8): trigram_fusion_eval
   (word{2,3}.arpa fitted and read back, greedy and beams tuned on dev,
   cli.evaluate --lm word3.arpa), trigram_bigtest (8 fresh utterances),
   biglex_hard_pipeline with [e2e]'s checkpoint as the flagship stack; each
   protocol's seconds and numbers and the chain's launches printed; it
   fails unless each result has exactly the keys the JAX scripts give
   (FUSION_KEYS) with finite numbers, the trigram's held-out log-p per word
   is above the bigram's, ckpt_am opens as objective am at its step, the
   host beam took the native route and each of B1, B2, B2', B3, B3', B4 and
   B6 launched;
12. serve: a full-width checkpoint directory (aas: G, D, the AM) written
   here; load_state's seconds against the random draw it made before this
   port's serving slice (init_state + load_state_dict); cli.serve with no
   --device (the card) at its defaults, --port 0 --max-streams 8, in a
   process of its own (start-up seconds to its JSON line, stopped with
   Ctrl-C) and in this one through start_server (launches counted): enhance
   mode (chunk 1.0, lookahead 0.2, history 0.5 s) with 8 concurrent
   sessions of 0.8-6 s against StreamingEnhancer on the card and the CPU,
   transcribe mode (lookahead 0.5 s) against StreamingRecognizer's
   transcripts on the card (ids with a small top-2 margin counted), a 9th
   session refused, each session's seconds from its end-of-stream sent to
   received; engine ticks timed at 1, 8 and 64 busy slots of 64, and at 1
   of 1 and 8 of 8, in both modes (ms, headroom chunk / tick, busy, idle
   share, launches a tick, the recurrences' waves);
13. export: cli.export --batch-sizes 1,8 --seconds 8 from that directory
   on the card; the artifact loaded in a fresh process that imports no
   model or training code and reads no checkpoint, at B=1 and B=8 (ragged)
   x 8 s and a (1, 10000) input (the (1, 128000) bucket), against
   make_enhance_fn on the card with the same weights, each call's launches
   (STFT 1, ISTFT 1, GN 2, LSTM 2), an uncovered shape refused, load
   seconds and MB; artifact and live calls timed in turns.
The kernels phase also checks the backward kernels (LSTM, GRU, GroupNorm,
the stacked LSTM and GRU) at B=8, and the GRU's at B=32, against autograd
through the plain versions, the conv weight-gradient kernel at the AM's
and the enhancer's shapes, and the STFT's and the ISTFT's VJP kernels (no
TPU counterpart: the JAX package differentiates its matmul-DFT with XLA) at
the MR-STFT loss's resolutions (256, 64), (512, 128), (1024, 256) and the
enhancer's (320, 160), B=8 x 8 s, ragged, against their plain versions (and
the forward STFT at the three MR n_fft), with the library call
torch.autograd.grad through torch.stft / torch.istft beside them.  The recurrences' backward lines give the route
(resident: wh[d] in a cluster's registers), the clusters the card runs at
once, the kernel alone between events and on the device, the same bits on
two calls, and the streaming backward's time and gradient error on the same
inputs; the paths fail unless their backward ran resident too.  The
GroupNorm backward lines give the wrapper alone (on the forward kernel's
saved mean and inv) against the plain closed form, the same bits on two
calls, the device kernels of one call (profiled in a fresh process; it fails
unless one) and the device time of the whole backward pass and of the
wrapper alone.
Each kernel line gives, beside the kernel's and the plain version's time, the
least time the card could take (bound: the larger of bytes moved once over
3.35 TB/s and f32 operations over 67 TFLOP/s, the H100's published rates)
and, where one PyTorch call computes the same function, that call's time.
The line before the last two is a JSON summary of the kernels (launches from
the last path above that runs the kernel; "launches_by_path" has each
path's), the next the card's name and power limit, the last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import shutil
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
BWD_B = 8                             # the backward kernels' batch (TrainConfig default)
BWD_FRAMES = [801, 701, 601, 401, 801, 751, 501, 301]
BWD_AM_FRAMES = [401, 351, 301, 201, 401, 376, 251, 151]
TRAIN_BATCHES = (8, 32)               # timed AAS and AM steps, x 8 s
SCRIPT_LIMIT_S = 1200.0               # the time the script has, its build included
PEAK_BYTES_S = 3.35e12                # H100 SXM: HBM3 bytes/s (published)
PEAK_F32_S = 67e12                    # H100 SXM: f32 FLOP/s outside the tensor cores

# Tolerances (max abs error, kernel vs plain version, f32 on the card).  Both
# sides accumulate in float32 in different orders; each bound is about 3-50x
# the error measured on an H100 at these inputs.
TOL = {
    "stft": (1e-4, "|X| up to ~40 from f32 sums over 320 samples on unit-scale audio"),
    "istft": (1e-5, "unit-scale audio, 2 x 161-term f32 sums per sample"),
    "gn_act": (1e-5, "unit-scale normalized output, f32 group sums over 0.1-2.6M values"),
    "lstm": (1e-5, "|y| < 1, f32 rounding carried through 801 recurrent steps"),
    "gru": (1e-5, "|y| < 1, 512-term f32 dots, rounding carried through 401 steps"),
}
TOL["lstm_stacked"], TOL["gru_stacked"] = TOL["lstm"], TOL["gru"]
# Backward kernels: max abs error over the gradients relative to the largest
# |gradient| of the same tensor, kernel vs autograd through the plain version.
BWD_TOL = {
    "lstm_bwd": (1e-4, "dh carried back through 801 steps of 1024-term f32 dots; "
                 "dWh sums T*B = 6408 outer products"),
    "gru_bwd": (1e-4, "dh carried back through 401 steps of 1536-term f32 dots; "
                "dWh sums T*B = 3208 outer products"),
    "gn_bwd": (1e-5, "f32 group sums over 0.2-5M values, then one fused elementwise pass"),
    "conv_dw": (1e-4, "each dW entry is an f32 sum over up to 1.03M positions, added "
                "row by row and slice by slice in the kernel, by one matmul in the "
                "plain version"),
}
BWD_TOL["lstm_stacked_bwd"] = BWD_TOL["lstm_bwd"]
BWD_TOL["gru_stacked_bwd"] = BWD_TOL["gru_bwd"]
# Card vs CPU, one AAS step from the same weights and batch (f32, TF32 off):
# metrics relative; each gradient tensor's max abs difference relative to its
# own max|g|.  A tensor whose CPU max|g| is below GRAD_ZERO of the network's
# largest |g| is zero to rounding (e.g. a bias whose true gradient cancels)
# and is held to GRAD_ZERO of the network's max|g| instead.
TRAIN_TOL = (1e-4, "CTC over 401 frames, D scores, through STFT, conv/GN, 2 "
             "BiLSTM-256 x 801 and 4 BiGRU-512 x 401 steps: card vs CPU sum orders")
GRAD_ZERO = 1e-5
# Measured on an H100, per tensor: G 6.4e-05 to 2.2e-04 (convs.0.bias), D
# 0 to 1.8e-04 (convs.1.weight); no tensor zero to rounding.
# One AM step, card vs CPU: each AM gradient tensor against its own max|g|,
# and the parameters after the SGD update against the CPU's.
AM_GRAD_TOL = (1e-3, "AM gradient carried back through CTC over 401 frames, 4 "
               "BiGRU-512 (dWh sums 1604 outer products), two GroupNorms and the "
               "convs' weight gradients (f32 sums over 0.07-0.5M positions that "
               "cancel), in the card's and the CPU's orders")
AM_PARAM_TOL = (1e-6, "p - lr * clipped g with lr 3e-4 and |clipped g| <= 400: the "
                "gradient's differences, scaled by lr")
TRAIN_GRAD_TOL = {
    "g": (1e-3, "G gradient carried back through CTC, 4 BiGRU-512, the AM's convs and "
          "GNs, 2 BiLSTM-256 and the enhancer's convs; weight and bias gradients are "
          "f32 sums of 3208-6408 frames' products that cancel, in cuDNN's and the "
          "CPU's orders"),
    "d": (1e-3, "D weight gradients: f32 sums over the clean and the detached enhanced "
          "batch's frames that cancel, in cuDNN's and the CPU's orders"),
}
# Resume on the card: 4 uninterrupted AM steps against 2 + save + resume + 2
# (bit for bit on the CPU, tests/test_torch_loop.py).
RESUME_TOL = (1e-4, "AM CTC losses of steps 3-4, each side after its own SGD steps on "
              "the card: cuDNN's conv backward may sum in another order each run")
SLICE_TOL = (1e-4, "wav in [-1, 1] after STFT, 2 conv+GN, 2 BiLSTM-256 over 801 "
             "steps, ISTFT: f32 rounding of card vs CPU sum orders compounds")
VJP_TOL = (1e-4, "each gradient entry an f32 sum of up to n_fft terms, in the kernel's "
           "radix-FFT order and the plain version's matmul order, relative to max|g|")
MR_PAIRS = ((256, 64), (512, 128), (1024, 256))     # the MR-STFT loss's resolutions
# One paired step, card vs CPU from the same weights and batch: metrics
# relative, each G gradient tensor against its own max|g| (GRAD_ZERO as the
# AAS step's).
PAIRED_TOL = (1e-4, "L1 of log-magnitudes over 4-8 x 801 x 161 bins after STFT, 2 conv+GN, "
              "2 BiLSTM-256 x 801; with the MR-STFT term ISTFT + 3 x 2 STFTs: card vs "
              "CPU sum orders")
PAIRED_GRAD_TOL = {
    0.0: (1e-3, "G gradient back through log1p, the mask, 2 BiLSTM-256 x 801 and 2 "
          "conv+GN: f32 sums of 6408 frames' products that cancel, in cuDNN's and the "
          "CPU's orders"),
    # Measured on an H100: 5.8e-05 without the MR-STFT term, 9.5e-04 with it.
    0.5: (3e-3, "as without the MR-STFT term, plus its log-magnitude L1, which passes "
          "sign(.) / (|X| + 1e-7) back from every bin: f32 rounding of |X| near 0 moves "
          "G's gradient by ~1e-4-1e-3 of its max (the JAX step's own gradient moves "
          "4.3e-04 under a 1e-7 change of its input, tests/test_torch_paired.py)")}
PAIRED_KERNELS = ("stft", "istft", "gn_act", "lstm", "lstm_bwd", "gn_bwd", "stft_vjp",
                  "istft_vjp")
# Launches of one paired step at the shipped enhancer (2 conv + GN, 2 BiLSTM):
# the noisy and the clean STFT, and with the MR-STFT term the ISTFT, 3 + 3
# STFTs and the adjoints of the ISTFT and of the estimate's 3 STFTs.
PAIRED_LAUNCHES = {
    0.0: {"stft": 2, "istft": 0, "gn_act": 2, "lstm": 2, "lstm_bwd": 2, "gn_bwd": 2,
          "stft_vjp": 0, "istft_vjp": 0},
    0.5: {"stft": 8, "istft": 1, "gn_act": 2, "lstm": 2, "lstm_bwd": 2, "gn_bwd": 2,
          "stft_vjp": 3, "istft_vjp": 1}}
RECOGNIZE_TOL = (1e-4, "logits O(1) after STFT, enhancer, 2 convs of up to 7392-term "
                 "f32 sums, 4 BiGRU-512 over 401 steps and FC: card vs CPU sum "
                 "orders compound")
# The bf16 models' forwards (phase bf16).  Kernel vs plain on the same bf16
# inputs: max abs error relative to the plain version's largest |value|.
PEAK_BF16_S = 989e12                  # H100 SXM: bf16 FLOP/s in the tensor cores, dense
BF16_TOL = {
    "gn_act": (2.0 ** -7, "one bf16 ulp at the top: z = x inv_c + off_c in f32, rounded "
               "apart where the f32 sums' order differs"),
    "lstm": (2.0 ** -6, "f32 sums of bf16-exact products in another order; an h that "
             "rounds apart is fed back over 801 steps"),
    "gru": (2.0 ** -6, "f32 sums of bf16-exact products in another order; an h that "
            "rounds apart is fed back over 401 steps"),
}
BF16_TOL["lstm_stacked"], BF16_TOL["gru_stacked"] = BF16_TOL["lstm"], BF16_TOL["gru"]
# Card vs CPU of a bf16 path: relative to the CPU output's largest |value|.
BF16_PATH_TOL = (5e-2, "bf16 products of cuBLAS / cuDNN and of the CPU, rounded at other "
                 "points, through STFT, 2 conv+GN, 2 BiLSTM-256 (and the AM's convs, GNs "
                 "and 4 BiGRU-512)")
BF16_SECONDS = 2                      # the card-vs-CPU batch (the CPU runs bf16 slowly)
# Training at bf16 (phase train_bf16).  The backward kernels on bf16 streams
# against their plain versions on the same bf16 inputs: max abs error of each
# gradient tensor relative to the plain tensor's largest |value|.
BF16_BWD_TOL = {
    "lstm_bwd": (2e-2, "the kernel reads the bf16 copies of h and c that the forward saved "
                 "(as the Pallas VJP does), the plain autograd its own f32 state; both "
                 "round the gate gradient to bf16 before the products; dh carried back "
                 "over 801 steps"),
    "gru_bwd": (2e-2, "the kernel reads the bf16 copy of h (as the Pallas VJP), the plain "
                "autograd its f32 h; dh carried back over 401 steps"),
    "gn_bwd": (2.0 ** -7, "dx: one bf16 ulp at the top, f32 sums in another order; dscale "
               "and dbias within 1e-4 of their max"),
    "conv_dw": (1e-4, "f32 sums of the same bf16 values, in the kernel's slice order and "
                "one matmul's"),
}
BF16_BWD_TOL["lstm_stacked_bwd"] = BF16_BWD_TOL["lstm_bwd"]
BF16_BWD_TOL["gru_stacked_bwd"] = BF16_BWD_TOL["gru_bwd"]
# A bf16 step card vs CPU (B=4 x BF16_SECONDS): metrics relative; each
# gradient tensor's distance to the CPU's within a share of the CPU tensor's
# norm (the JAX package's own bf16 gradients of the convs and GroupNorms sit
# 5-16% of their max from its f32 ones, tests/test_torch_bf16_steps.py); a
# tensor whose CPU max|g| is below BF16_GRAD_ZERO of the network's is held to
# BF16_GRAD_ZERO of the network's max|g| element by element.
BF16_STEP_TOL = (2e-2, "bf16 losses from bf16 models: cuBLAS / cuDNN bf16 products and the "
                 "kernels against the CPU's, rounded at other points")
BF16_GRAD_TOL = {
    0.0: (0.1, "bf16 gradients of every layer: the bf16 rounding of each cast and product "
          "at other points, carried back through CTC (or the L1), the recurrences, "
          "GroupNorms and convs"),
    0.5: (0.35, "with the MR-STFT term, whose sign(.) / (|X| + 1e-7) parts flip under "
          "bf16 rounding (JAX's bf16 gradient is 0.7-3.9 x its max from its f32 one)")}
BF16_GRAD_ZERO = 1e-3
BF16_STEP_KERNELS = {
    "aas": ("stft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd", "gn_bwd"),
    "am": ("stft", "gn_act", "gru", "gru_bwd", "gn_bwd", "conv_dw"),
    "paired": ("stft", "istft", "gn_act", "lstm", "lstm_bwd", "gn_bwd", "stft_vjp",
               "istft_vjp")}
# The kernels that stream bf16 on each step (the STFTs and their VJPs stay f32).
BF16_STEP_STREAMS = {"aas": BF16_STEP_KERNELS["aas"][1:],
                     "am": BF16_STEP_KERNELS["am"][1:],
                     "paired": ("gn_act", "lstm", "lstm_bwd", "gn_bwd")}
BF16_B_PRODUCTION = 128                  # the JAX package's bench_train_step batch


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


def bound(n_bytes: float, flops: float, peak_ops: float = PEAK_F32_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes moved
    once over its memory rate and the operations over the rate of their type
    (f32 outside the tensor cores unless ``peak_ops`` says otherwise)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S * 1e3, flops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def valid_share(lengths, t_len: int) -> float:
    """The share of [B, T] frames that lengths [B] leaves valid."""
    return lengths.clamp(max=t_len).sum().item() / (lengths.numel() * t_len)


def in_turns(run_k, run_p, reps: int, warmup: int = 2) -> tuple[float, float]:
    """Median ms of kernel and plain version, timed plain, kernel, kernel, plain."""
    t_p = cuda_ms(run_p, reps, warmup)
    t_k = cuda_ms(run_k, reps, warmup) + cuda_ms(run_k, reps, warmup)
    t_p += cuda_ms(run_p, reps, warmup)
    return statistics.median(t_k), statistics.median(t_p)


def keep(results: dict, name: str, label: str, err: float, ms: float, plain_ms: float,
         work: tuple[float, float], library_ms: float | None = None,
         rel_err: float | None = None) -> str:
    """Record a kernel's check at the shape ``label``.  The JSON line's own
    numbers are all the first shape's (the main path's); "shapes" has every
    shape's, with the error relative to the reference's largest value where
    the check is relative.  -> the text of its bound and library time."""
    bound_ms, bound_by = bound(*work)
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": library_ms}
    if rel_err is not None:
        row["rel_err"] = rel_err
    results.setdefault(name, {**row, "shapes": {}})["shapes"][label] = row
    lib = "" if library_ms is None else f" | library call {library_ms:.4f} ms"
    return (f"bound {bound_ms:.4f} ms by {bound_by} ({work[0] / 1e6:.1f} MB, "
            f"{work[1] / 1e9:.3f} GFLOP){lib}")


def max_err(a, b) -> float:
    import torch
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    if not torch.isfinite(a).all():
        fail("non-finite kernel output")
    return (a - b).abs().max().item()


def check_step(phase: str, what: str, aux_cpu, aux_gpu, grads_cpu, grads_gpu,
               grad_tols: dict, metric_tol: tuple = TRAIN_TOL,
               sides: str = "card vs CPU") -> None:
    """Card vs CPU of one step (or the ``sides`` named): its metrics
    (relative, ``metric_tol``) and each network's gradient tensors
    (``grad_tols``: net -> (tol, why)), each against its own max|g|.  A
    tensor whose reference (``*_cpu``) max|g| is below GRAD_ZERO of the
    network's is zero to rounding and is held to GRAD_ZERO of the network's."""
    tol, why = metric_tol
    rel = {k: abs(float(aux_gpu[k]) - float(v)) / max(abs(float(v)), 1e-6)
           for k, v in aux_cpu.items()}
    print(f"[{phase}] {what}, {sides} (same weights and batch): metrics "
          f"{json.dumps({k: round(float(v), 6) for k, v in aux_gpu.items()})}; largest "
          f"relative difference {max(rel.values()):.3e} ({max(rel, key=rel.get)}) (tol "
          f"{tol:.0e}: {why})")
    if set(aux_gpu) != set(aux_cpu) or not max(rel.values()) <= tol:
        fail(f"{what}: {sides} metrics differ: {rel}")
    bad = []
    for net, (gtol, gwhy) in grad_tols.items():
        scale = max(v.abs().max().item() for v in grads_cpu[net].values())
        rel, zero = {}, {}
        for n, v in grads_cpu[net].items():
            diff = (grads_gpu[net][n].cpu() - v).abs().max().item()
            if v.abs().max().item() > GRAD_ZERO * scale:
                rel[n] = diff / v.abs().max().item()
            else:
                zero[n] = diff / scale
        worst = max(rel, key=rel.get)
        print(f"[{phase}] {net.upper()} gradients ({len(rel)} tensors, each against its own "
              f"max|g|): largest difference {rel[worst]:.3e} at {worst} (tol {gtol:.0e}: "
              f"{gwhy}); {len(zero)} tensors zero to rounding (max|g| <= {GRAD_ZERO:.0e} of "
              f"the network's {scale:.3e}), largest difference "
              f"{max(zero.values(), default=0.0):.3e} of it (tol {GRAD_ZERO:.0e})")
        print(f"[{phase}] {net.upper()} gradient differences per tensor: "
              f"{json.dumps({n: float(f'{e:.3e}') for n, e in {**rel, **zero}.items()})}")
        bad += [f"{net} {n}: {e:.3e} of its max|g|" for n, e in rel.items() if not e <= gtol]
        bad += [f"{net} {n}: {e:.3e} of the network's max|g|"
                for n, e in zero.items() if not e <= GRAD_ZERO]
    if bad:
        fail(f"{what}: {sides} gradients differ: {bad}")


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
    from aas_enhancement_tpu_torch.utils import kernel_build, native_build
    t0 = time.perf_counter()
    if not native_build.build():
        fail("the native host libraries (native/: the beam decoder, the wav loader) did "
             "not build")
    print(f"[build] native host libraries {sorted(os.listdir(native_build.BUILD_DIR))} "
          f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    so = kernel_build.build()
    kernel_build.load_library()
    print(f"[build] {so} in {time.perf_counter() - t0:.1f} s")
    with open(so[:-3] + ".log") as f:        # each kernel's mangled name, then its use
        for line in f:
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
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


STACKED = ("lstm_stacked", "gru_stacked", "lstm_stacked_bwd", "gru_stacked_bwd")
RECURRENT = ("lstm", "gru", "lstm_stacked", "gru_stacked")
RECURRENT_BWD = ("lstm_bwd", "gru_bwd", "lstm_stacked_bwd", "gru_stacked_bwd")
# The forward route each width must take: blocks per cluster of the resident
# kernel, 0 for the streaming kernel.
RNN_ROUTES = {"lstm": {64: 2, 128: 4, 256: 8, 512: 0}, "gru": {256: 8, 512: 16}}


def kernel_counters() -> dict:
    """The kernel wrappers of all paths, by kernel name."""
    from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    return {"stft": kstft.stft, "istft": kstft.istft, "gn_act": gn.masked_group_norm_act,
            "lstm": krnn.lstm_scan_tm, "gru": krnn.gru_scan_tm,
            "lstm_bwd": krnn.lstm_scan_tm_bwd, "gru_bwd": krnn.gru_scan_tm_bwd,
            "gn_bwd": gn.masked_group_norm_act_bwd, "conv_dw": kconv.conv_dw_same,
            "lstm_stacked": krnn.lstm_scan_stacked, "gru_stacked": krnn.gru_scan_stacked,
            "lstm_stacked_bwd": krnn.lstm_scan_stacked_bwd,
            "gru_stacked_bwd": krnn.gru_scan_stacked_bwd,
            "stft_vjp": kstft.stft_vjp, "istft_vjp": kstft.istft_vjp}


def counted(names, run) -> dict:
    """Set the named kernels' launch counts to 0, drive ``run()``, and read
    the counts: {name: launches of that run}.  Every path's LSTMs and GRUs
    are of widths that a resident route holds (LSTM 128 and 256, GRU 256 and
    512): a run whose last LSTM or GRU launch, forward or backward, was not
    on the resident route fails."""
    counters = {k: v for k, v in kernel_counters().items() if k in names}
    for fn in counters.values():
        fn.launches = 0
        for attr in ("route", "dtype"):
            if hasattr(fn, attr):
                setattr(fn, attr, None)
    run()
    for k, fn in counters.items():
        if k in RECURRENT + RECURRENT_BWD and fn.launches and not fn.route:
            fail(f"{k}: the path's recurrence ran on the streaming route (route {fn.route})")
    return {k: fn.launches for k, fn in counters.items()}


def phase_kernels(device):
    import torch
    from aas_enhancement_tpu_torch.convert import init_like_flax
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    from aas_enhancement_tpu_torch.ops.masking import time_mask
    from aas_enhancement_tpu_torch.ops.rnn import BiRNN

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

    window = torch.hann_window(320, periodic=True, device=device)

    def rnn_work(gates_t, gh: int, mask, mod):
        """(bytes, flops) of one bidirectional recurrence over gates [T, B, 2GH]:
        gx, m, wh, bh read and y written once; the recurrent product's FMAs."""
        t_n, b_n, h = gates_t.shape[0], gates_t.shape[1], mod.hidden
        return (nbytes(gates_t, mask, mod.wh, mod.bh) + 2 * t_n * b_n * h * 4,
                2.0 * 2 * t_n * b_n * h * gh)

    with torch.inference_mode():
        gates = rnn.wx(torch.randn(t_len, B, 161 * 32, generator=gen).to(device))
        gxf, gxb = gates[..., :1024], gates[..., 1024:]          # strided, as in BiRNN
        g_gates = gru.wx(torch.randn(AM_T, B, 41 * 32, generator=gen).to(device))
        g_xf, g_xb = g_gates[..., :1536], g_gates[..., 1536:]
        # The stacked layout of BiRNN(time_major=False): direction 1 flipped.
        gx_s, m_s = (x.contiguous() for x in krnn.to_stacked(gxf, gxb, m))
        g_gx_s, g_m_s = (x.contiguous() for x in krnn.to_stacked(g_xf, g_xb, m_am))
        leaky = dict(num_groups=8, act="leaky_relu", slope=0.2)
        hard = dict(num_groups=8, act="hardtanh")
        # The GroupNorm forward reads x on the valid frames only, and writes y
        # whole (0 on padded frames).
        gn_fwd_work = {x.shape[2]: ((valid_share(lens, x.shape[1]) + 1) * nbytes(x),
                                    10.0 * valid_share(lens, x.shape[1]) * x.numel())
                       for x, lens in ((x_gn, frames), (x_am[81], am_frames),
                                       (x_am[41], am_frames))}
        # A 320-point real transform per frame needs an FFT's operations
        # (5 n log2 n), not the direct sum's that the kernels spend.
        dft_flops = B * t_len * 5.0 * 320 * math.log2(320)
        re80, im80 = kstft.stft_plain(wav, 320, 80)
        gain80 = torch.rand(re80.shape, generator=torch.Generator().manual_seed(13)).to(device)
        # Further LSTM shapes: B=6 (tiles of 4 and 2 rows) at the enhancer's
        # width, and H=512, which no cluster of 8 holds (the streaming route).
        lens6 = torch.tensor(LENGTHS + [88000, 1600], device=device)
        m6 = time_mask(1 + lens6 // 160, t_len).T.contiguous()
        gates6 = (0.5 * torch.randn(t_len, 6, 2048, generator=gen)).to(device)
        m32 = time_mask(1 + lens6[torch.arange(32, device=device) % 6] // 160, t_len).T.contiguous()
        gates32 = (0.5 * torch.randn(t_len, 32, 2048, generator=gen)).to(device)
        wide = init_like_flax(BiRNN(64, 512), gen).to(device)
        gates_w = (0.5 * torch.randn(AM_T, B, 4096, generator=gen)).to(device)
        # The LSTM's clusters of 2 and 4 (H=64, 128) and the GRU at the train
        # steps' batches, from a generator of their own so that the cases
        # above see the random numbers they always saw.
        gen_more = torch.Generator().manual_seed(5)
        narrow = {h: init_like_flax(BiRNN(64, h), gen_more).to(device) for h in (64, 128)}
        gates_n = {h: (0.5 * torch.randn(t_len, B, 8 * h, generator=gen_more)).to(device)
                   for h in narrow}
        g_gates_b = {b: (0.5 * torch.randn(AM_T, b, 3072, generator=gen_more)).to(device)
                     for b in TRAIN_BATCHES}
        m_am_b = {b: time_mask(am_frames[torch.arange(b, device=device) % B], AM_T)
                  .T.contiguous() for b in TRAIN_BATCHES}
        cases = {   # label: (kernel name, wrapper, plain, args, kwargs, (bytes, flops), library)
            "stft": ("stft", kstft.stft, kstft.stft_plain, (wav, 320, 160), {},
                     (nbytes(wav, re, im), dft_flops),
                     lambda: torch.stft(wav, 320, 160, window=window, center=True,
                                        pad_mode="reflect", return_complex=True)),
            "stft hop 80": ("stft", kstft.stft, kstft.stft_plain, (wav, 320, 80), {},
                            (nbytes(wav, re80, im80), 2 * dft_flops),
                            lambda: torch.stft(wav, 320, 80, window=window, center=True,
                                               pad_mode="reflect", return_complex=True)),
            "istft": ("istft", kstft.istft, kstft.istft_plain,
                      (re * gain, im * gain, 320, 160, "hann", True, N), {},
                      (nbytes(re, im, wav), dft_flops),
                      lambda z=torch.complex(re * gain, im * gain).transpose(1, 2):
                      torch.istft(z, 320, 160, window=window, center=True, length=N)),
            "istft hop 80": ("istft", kstft.istft, kstft.istft_plain,
                             (re80 * gain80, im80 * gain80, 320, 80, "hann", True, N), {},
                             (nbytes(re80, im80, wav), 2 * dft_flops),
                             lambda z=torch.complex(re80 * gain80, im80 * gain80)
                             .transpose(1, 2): torch.istft(z, 320, 80, window=window,
                                                           center=True, length=N)),
            "gn_act": ("gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                       (x_gn, scale, bias, frames), leaky, gn_fwd_work[161], None),
            "gn_act hardtanh [4, 401, 81, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[81], scale, bias, am_frames), hard, gn_fwd_work[81], None),
            "gn_act hardtanh [4, 401, 41, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[41], scale, bias, am_frames), hard, gn_fwd_work[41], None),
            "lstm": ("lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                     (gxf, gxb, m, rnn.wh, rnn.bh), {}, rnn_work(gates, 1024, m, rnn), None),
            "lstm T=801 B=6 H=256 (a partial row tile)": (
                "lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                (gates6[..., :1024], gates6[..., 1024:], m6, rnn.wh, rnn.bh), {},
                rnn_work(gates6, 1024, m6, rnn), None),
            "lstm T=801 B=32 H=256 (eight row tiles, 128 blocks)": (
                "lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                (gates32[..., :1024], gates32[..., 1024:], m32, rnn.wh, rnn.bh), {},
                rnn_work(gates32, 1024, m32, rnn), None),
            "lstm T=401 B=4 H=512 (the streaming route)": (
                "lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                (gates_w[..., :2048], gates_w[..., 2048:], m_am, wide.wh, wide.bh), {},
                rnn_work(gates_w, 2048, m_am, wide), None),
            **{f"lstm T=801 B=4 H={h} (clusters of {RNN_ROUTES['lstm'][h]})": (
                "lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain,
                (gates_n[h][..., :4 * h], gates_n[h][..., 4 * h:], m, narrow[h].wh,
                 narrow[h].bh), {}, rnn_work(gates_n[h], 4 * h, m, narrow[h]), None)
               for h in narrow},
            "gru": ("gru", krnn.gru_scan_tm, krnn.gru_scan_tm_plain,
                    (g_xf, g_xb, m_am, gru.wh, gru.bh), {},
                    rnn_work(g_gates, 1536, m_am, gru), None),
            **{f"gru T=401 B={b} H=512 ({-(-b // 4)} clusters a direction)": (
                "gru", krnn.gru_scan_tm, krnn.gru_scan_tm_plain,
                (g_gates_b[b][..., :1536], g_gates_b[b][..., 1536:], m_am_b[b], gru.wh,
                 gru.bh), {}, rnn_work(g_gates_b[b], 1536, m_am_b[b], gru), None)
               for b in TRAIN_BATCHES},
            "lstm_stacked": ("lstm_stacked", krnn.lstm_scan_stacked,
                             krnn.lstm_scan_stacked_plain, (gx_s, m_s, rnn.wh, rnn.bh), {},
                             rnn_work(gates, 1024, m_s, rnn), None),
            "gru_stacked": ("gru_stacked", krnn.gru_scan_stacked,
                            krnn.gru_scan_stacked_plain, (g_gx_s, g_m_s, gru.wh, gru.bh), {},
                            rnn_work(g_gates, 1536, g_m_s, gru), None),
        }
        results, outs = {}, {}
        for label, (name, kernel, plain, args, kw, work, library) in cases.items():
            k_out = outs[label] = kernel(*args, **kw)
            p_out = plain(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(k_out, p_out)
            tol, why = TOL[name]
            reps = 5 if name in RECURRENT else 20
            if label != name and name in RECURRENT:
                reps = 3
            ms, plain_ms = in_turns(lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                                    reps)
            lib_ms = None if library is None else statistics.median(cuda_ms(library, reps))
            text = keep(results, name, label, err, ms, plain_ms, work, lib_ms)
            if name in ("stft", "istft"):
                n1, n2 = kernel.route
                results[name]["shapes"][label]["kernel_route"] = f"two stages, {n1} x {n2}"
                results[name].setdefault("kernel_route", f"two stages, {n1} x {n2}")
                text += f" | route: 320 = {n1} x {n2}"
                if not n1:
                    fail(f"{label}: n_fft 320 took the direct sum")
            if name in ("istft", "gn_act"):
                again = kernel(*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(again, k_out):
                    fail(f"{label}: two calls of the kernel gave different bits")
                text += " | same bits on two calls"
            if name in ("stft", "istft", "gn_act"):
                row = results[name]["shapes"][label]
                text += device_times(row, lambda: kernel(*args, **kw), library)
                if label == name:
                    results[name].update({k: row[k] for k in (
                        "device_ms", "device_ms_by", "library_device_ms") if k in row})
            if name in RECURRENT:
                text += rnn_routes(results, name, label, kernel, args, p_out, reps)
            print(f"[kernel] {label}: max_abs_err {err:.3e} (tol {tol:.0e}: {why}) | "
                  f"kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | "
                  f"x{plain_ms / ms:.2f} | {text}")
            if not err <= tol:
                fail(f"{label}: max abs err {err:.3e} > tol {tol:.0e}")
        # One device code serves both layouts: the stacked entries give the
        # time-major entries' bits (direction 1 flipped back).
        for cell in ("lstm", "gru"):
            yf, yb = outs[cell]
            ys = outs[f"{cell}_stacked"]
            if not (torch.equal(ys[:, 0], yf) and torch.equal(ys[:, 1].flip(0), yb)):
                fail(f"{cell}: the stacked entry's output differs from the time-major entry's")
        print("[kernel] lstm_stacked, gru_stacked: bit-identical to the time-major entries")
    kernels_backward(device, gen, results)
    kernels_conv_dw(device, gen, results)
    kernels_vjp(device, results)
    return results


VJP_SHAPES = {"stft_vjp": MR_PAIRS + ((320, 160),), "istft_vjp": ((320, 160),) + MR_PAIRS}


def vjp_kernels(batch: int, n: int, shapes: dict = VJP_SHAPES) -> list:
    """{kernel name: launches} of the device kernels of one VJP wrapper call
    at each of ``shapes``' (name, shape) in turn, B = batch x n samples, in a
    fresh process (``utils.profiling.kernel_names_in_fresh_process``)."""
    from aas_enhancement_tpu_torch.utils.profiling import kernel_names_in_fresh_process
    return kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
calls = []
dy = torch.randn({batch}, {n}, device="cuda")
for name, pairs in {shapes!r}.items():
    for n_fft, hop in pairs:
        t = 1 + {n} // hop
        dre = torch.randn({batch}, t, n_fft // 2 + 1, device="cuda")
        dim = torch.randn_like(dre)
        calls.append((lambda a=dre, c=dim, f=n_fft, h=hop: kstft.stft_vjp(a, c, {n}, f, h))
                     if name == "stft_vjp" else
                     (lambda f=n_fft, h=hop, t=t: kstft.istft_vjp(dy, t, f, h)))
""")


def kernels_vjp(device, results: dict, shapes: dict = VJP_SHAPES,
                mr_forward: bool = True) -> None:
    """The STFT's and the ISTFT's VJP kernels against their plain versions
    (the written-out adjoints) at B=8 x 8 s, ragged: cotangents zero past
    each row's valid frames or samples, as a masked loss gives them.  The
    main path's shape comes first (stft_vjp: the MR-STFT loss's (256, 64);
    istft_vjp: the enhancer's (320, 160)).  Per shape also the route
    (``vjp_plan``), the device kernels of one call (exactly one), the blocks
    resident on an SM with the shared memory, registers and spills behind
    them (``vjp_residency``), and the frames the kernel transformed (its own
    count; fails unless each frame once: no halo).  With ``mr_forward`` also
    the forward STFT at the MR n_fft.  Library: torch.autograd.grad through torch.stft / torch.istft, the graph
    built once, the backward alone timed."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft

    gen = torch.Generator().manual_seed(17)
    lens = torch.tensor([(f - 1) * 160 for f in BWD_FRAMES])
    b = len(lens)
    x = (0.3 * torch.randn(b, N, generator=gen) * (torch.arange(N)[None] < lens[:, None]))
    x = x.to(device)
    dy = (torch.randn(b, N, generator=gen) * (torch.arange(N)[None] < lens[:, None])).to(device)
    tol, why = VJP_TOL

    def rel(got, ref) -> float:
        err = max(max_err(g, r) for g, r in zip(got, ref))
        return err, err / max(r.abs().max().item() for r in ref)

    for n_fft, hop in MR_PAIRS if mr_forward else ():   # the forward at the MR resolutions
        window = torch.hann_window(n_fft, periodic=True, device=device)
        with torch.inference_mode():
            out = kstft.stft(x, n_fft, hop)
            ref = kstft.stft_plain(x, n_fft, hop)
            torch.cuda.synchronize()
            err = max_err(out, ref)
            run_k = lambda n_fft=n_fft, hop=hop: kstft.stft(x, n_fft, hop)      # noqa: E731
            lib = lambda n_fft=n_fft, hop=hop, w=window: torch.stft(      # noqa: E731
                x, n_fft, hop, window=w, center=True, pad_mode="reflect", return_complex=True)
            ms, plain_ms = in_turns(run_k, lambda: kstft.stft_plain(x, n_fft, hop), 10)
            lib_ms = statistics.median(cuda_ms(lib, 10))
            t_len = out[0].shape[1]
            label = f"stft n_fft {n_fft} hop {hop} B={b} (MR-STFT)"
            text = keep(results, "stft", label, err, ms, plain_ms,
                        (nbytes(x, *out), b * t_len * 5.0 * n_fft * math.log2(n_fft)), lib_ms)
            row = results["stft"]["shapes"][label]
            row["kernel_route"] = f"two stages, {kstft.stft.route[0]} x {kstft.stft.route[1]}"
            text += f" | route {row['kernel_route']}" + device_times(row, run_k, lib)
        print(f"[kernel] {label}: max_abs_err {err:.3e} (tol {TOL['stft'][0]:.0e}) | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | {text}")
        if not err <= TOL["stft"][0] or not kstft.stft.route[0]:
            fail(f"{label}: max abs err {err:.3e}, route {kstft.stft.route}")

    names = iter(vjp_kernels(b, N, shapes))
    for name, pairs in shapes.items():
        for n_fft, hop in pairs:
            window = torch.hann_window(n_fft, periodic=True, device=device)
            t_len = 1 + N // hop
            f = n_fft // 2 + 1
            valid = (torch.arange(t_len)[None] < (1 + lens // hop)[:, None])[..., None]
            dre = (torch.randn(b, t_len, f, generator=gen) * valid).to(device)
            dim = (torch.randn(b, t_len, f, generator=gen) * valid).to(device)
            flops = b * t_len * 5.0 * n_fft * math.log2(n_fft)
            if name == "stft_vjp":
                run_k = lambda a=dre, c=dim, n=n_fft, h=hop, **kw: kstft.stft_vjp(  # noqa: E731
                    a, c, N, n, h, **kw)
                run_p = lambda a=dre, c=dim, n=n_fft, h=hop: kstft.stft_vjp_plain(  # noqa: E731
                    a, c, N, n, h)
                xg = x.clone().requires_grad_()
                z = torch.stft(xg, n_fft, hop, window=window, center=True, pad_mode="reflect",
                               return_complex=True)
                gz = torch.complex(dre, dim).transpose(1, 2)
                lib = lambda z=z, xg=xg, gz=gz: torch.autograd.grad(  # noqa: E731
                    z, xg, gz, retain_graph=True)
                work = (nbytes(dre, dim) + b * N * 4, flops)
                grads = "dx"
            else:
                run_k = lambda n=n_fft, h=hop, t=t_len, **kw: kstft.istft_vjp(  # noqa: E731
                    dy, t, n, h, **kw)
                run_p = lambda n=n_fft, h=hop, t=t_len: kstft.istft_vjp_plain(  # noqa: E731
                    dy, t, n, h)
                zr, zi = dre.clone().requires_grad_(), dim.clone().requires_grad_()
                y = torch.istft(torch.complex(zr, zi).transpose(1, 2), n_fft, hop,
                                window=window, center=True, length=N)
                lib = lambda y=y, zr=zr, zi=zi: torch.autograd.grad(  # noqa: E731
                    y, (zr, zi), dy, retain_graph=True)
                work = (nbytes(dy, dre, dim), flops)
                grads = "dre, dim"
            out_k = run_k()
            again = run_k()
            out_p = run_p()
            torch.cuda.synchronize()
            out_k, again, out_p = ((o,) if torch.is_tensor(o) else o for o in (out_k, again, out_p))
            err, rel_err = rel(out_k, out_p)
            if not all(torch.equal(a, c) for a, c in zip(out_k, again)):
                fail(f"{name} ({n_fft}, {hop}): two calls of the kernel gave different bits")
            plan = getattr(kstft, name).route
            ms, plain_ms = in_turns(run_k, run_p, 10)
            lib_ms = statistics.median(cuda_ms(lib, 10))
            label = f"{name} n_fft {n_fft} hop {hop} B={b}"
            text = keep(results, name, label, err, ms, plain_ms, work, lib_ms, rel_err=rel_err)
            row = results[name]["shapes"][label]
            row["kernel_route"] = (f"radix {'x'.join(map(str, plan.radices))}, "
                                   f"{plan.lanes} lanes x {plan.frames} frames a block"
                                   if plan.radices else "direct")
            called = [k for k, c in next(names).items() for _ in range(c)
                      if "Memcpy" not in k and "Memset" not in k]
            res = kstft.vjp_residency(name, n_fft, hop)
            counter = torch.zeros(1, dtype=torch.int32, device=device)
            run_k(frames_done=counter)
            transformed = int(counter.item())
            halo = transformed / (b * t_len) - 1
            row.update(device_kernels=called, residency=res, frames_transformed=transformed,
                       halo_share=halo)
            text += (f" | route {row['kernel_route']} | same bits on two calls | device "
                     f"kernels of a call {called} | {res['blocks_per_sm']} blocks an SM "
                     f"({res['smem_bytes']} B shared, {res['registers']} registers, "
                     f"{res['local_bytes']} B local a thread) | frames transformed "
                     f"{transformed} of {b * t_len} (halo share {halo:.0%}, counted by the "
                     f"kernel)")
            if len(called) != 1 or not re.search(rf"(?<!\w){name}_kernel\b", called[0]):
                fail(f"{label}: one call ran the device kernels {called}, not one {name}_kernel")
            if transformed != b * t_len:
                fail(f"{label}: the kernel transformed {transformed} frames, not each of the "
                     f"{b * t_len} once")
            text += device_times(row, run_k, lib)
            if next(iter(results[name]["shapes"])) == label:
                results[name].update({k: v for k, v in row.items() if k not in results[name]})
            print(f"[kernel] {label}: {grads} max_abs_err {err:.3e}, relative to max|g| "
                  f"{rel_err:.3e} (tol {tol:.0e}: {why}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text}")
            if not rel_err <= tol or not plan.radices:
                fail(f"{label}: gradient error {rel_err:.3e} of max|g|, route {plan}")
            del lib


def device_times(row: dict, run_k, run_lib=None) -> str:
    """The device time of a kernel's launches and, where there is one, of the
    library call's kernels (``utils.profiling.device_time``: the profiler, or
    where it dropped events CUDA events on a busy stream).  The CUDA-event
    times of the line are taken around one call on an idle stream, so they
    hold the wrapper's host time too: most of the reading for a kernel of a
    few microseconds.  -> text."""
    from aas_enhancement_tpu_torch.utils.profiling import device_time
    row["device_ms"], row["device_ms_by"] = device_time(run_k)
    text = (f" | on the device alone ({row['device_ms_by']}): kernel "
            f"{row['device_ms']:.4f} ms")
    if run_lib is not None:
        row["library_device_ms"], by = device_time(run_lib)
        text += f", library call {row['library_device_ms']:.4f} ms ({by})"
    return text


def rnn_routes(results: dict, name: str, label: str, kernel, args, p_out, reps: int) -> str:
    """The route the LSTM or GRU wrapper just took at this shape, the time of
    the training variant on it, the kernel's device time from the profiler
    and, where it is the resident route, the streaming kernel's output and
    time on the same inputs (through the wrapper's private route argument);
    with it the number of its clusters the card runs at once.
    Fails if the width did not take the route ``RNN_ROUTES`` names.  -> text
    for the kernel's line."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    cell = name.split("_")[0]
    entry = f"{cell}_scan_stacked" if name.endswith("stacked") else f"{cell}_scan_tm"
    *gx, m, wh, bh = args
    route, h = kernel.route, wh.shape[1]
    if route != RNN_ROUTES[cell][h]:
        fail(f"{label}: H={h} took route {route}, not {RNN_ROUTES[cell][h]} "
             "(0 is the streaming kernel)")
    row = results[name]["shapes"][label]
    row["kernel_route"] = f"resident, clusters of {route}" if route else "streaming"
    row["training_ms"] = statistics.median(cuda_ms(
        lambda: krnn._forward(entry, tuple(gx), m, wh, bh, save=True), reps))
    text = f" | route: {row['kernel_route']}"
    if route:
        row["clusters_at_once"] = krnn.resident_clusters_at_once(cell, h)
        text += (f", {row['clusters_at_once']} such clusters at once by "
                 "cudaOccupancyMaxActiveClusters")
    text += f" | training variant {row['training_ms']:.4f} ms"
    text += device_times(row, lambda: kernel(*args))
    if route:
        stream = lambda: krnn._forward(entry, tuple(gx), m, wh, bh, save=False,   # noqa: E731
                                       route=0)[0]
        s_out = stream()
        torch.cuda.synchronize()
        err = max_err(s_out if len(s_out) > 1 else s_out[0], p_out)
        if not err <= TOL[name][0]:
            fail(f"{label}: the streaming kernel's max abs err {err:.3e}")
        row["streaming_ms"] = statistics.median(cuda_ms(stream, reps))
        text += (f" | streaming kernel {row['streaming_ms']:.4f} ms (max_abs_err "
                 f"{err:.3e}), x{row['streaming_ms'] / row['ms']:.2f}")
    if label == name:
        results[name].update({k: row[k] for k in ("kernel_route", "training_ms", "device_ms",
                                                  "device_ms_by", "streaming_ms",
                                                  "clusters_at_once")
                              if k in row})
    return text


def _rnn_call(gates, m, wh, bh, gh: int):
    """fn -> fn(gxf, gxb, m, wh, bh) on the two strided halves of ``gates``."""
    return lambda fn: fn(gates[..., :gh], gates[..., gh:], m, wh, bh)


def kernels_backward(device, gen, results: dict) -> None:
    """The backward kernels at the training path's full widths, B=8 with
    ragged lengths: the kernel autograd Functions' gradients against
    torch.autograd.grad through the plain versions on the card, and the
    time of the backward pass alone (the graph built once, kept).  For the
    recurrences also (``rnn_bwd_routes``) the route, the kernel alone, the
    streaming backward on the same inputs, and the GRU at B=32.  The
    stacked-layout cases and the B=32 case come last and draw from generators
    of their own, so the other cases see the random numbers they always saw."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.masking import time_mask

    def randn(*shape, scale=1.0, gen=gen):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    gen_stacked = torch.Generator().manual_seed(7)
    gen_b32 = torch.Generator().manual_seed(9)
    later = {}
    frames = torch.tensor(BWD_FRAMES, device=device)
    am_frames = torch.tensor(BWD_AM_FRAMES, device=device)
    # label: (kernel name, fn(wrapper or plain) -> outs, pair, inputs, work,
    # (entry, gx, m, wh, bh) of a recurrence or the GroupNorm's (lengths,
    # options), the cotangents' generator)
    cases = {}

    def rnn_case(name, cell, t_len, h, b, lens, gen_x):
        g = 4 if cell == "lstm" else 3
        gates = randn(t_len, b, 2 * g * h, scale=0.5, gen=gen_x).requires_grad_()
        wh = randn(2, h, g * h, scale=h ** -0.5, gen=gen_x).requires_grad_()
        bh = randn(2, g * h, scale=0.1, gen=gen_x).requires_grad_()
        m = time_mask(lens, t_len).T.contiguous()
        # Read once: the saved h (and c), the saved activations [.., 4H], dy, wh;
        # written once: dgx, dwh, dbh.  dh = dg wh^T and dWh = h^T dg, one FMA
        # per term each.
        cells = 2 * t_len * b
        work = (4.0 * (cells * h * ((5 if cell == "gru" else 6) + 1 + g)
                       + 2 * wh.numel() + bh.numel()),
                2.0 * 2 * cells * h * g * h)
        tm = ((krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain) if cell == "lstm"
              else (krnn.gru_scan_tm, krnn.gru_scan_tm_plain))
        halves = (gates[..., :g * h], gates[..., g * h:])
        return (name, _rnn_call(gates, m, wh, bh, g * h), tm, (gates, wh, bh), work,
                (f"{cell}_scan_tm", halves, m, wh, bh), gen_x), (g, m, wh, bh, work)

    for name, cell, t_len, h, lens in (("lstm_bwd", "lstm", 1 + N // 160, 256, frames),
                                       ("gru_bwd", "gru", AM_T, 512, am_frames)):
        cases[f"{name} T={t_len} B={BWD_B} H={h}"], (g, m, wh, bh, work) = rnn_case(
            name, cell, t_len, h, BWD_B, lens, gen)
        stacked = ((krnn.lstm_scan_stacked, krnn.lstm_scan_stacked_plain) if cell == "lstm"
                   else (krnn.gru_scan_stacked, krnn.gru_scan_stacked_plain))
        gx_s = randn(t_len, 2, BWD_B, g * h, scale=0.5, gen=gen_stacked).requires_grad_()
        m_s = torch.stack([m, m.flip(0)], dim=1).contiguous()
        later[f"{cell}_stacked_bwd T={t_len} B={BWD_B} H={h}"] = (
            f"{cell}_stacked_bwd",
            lambda fn, gx=gx_s, ms=m_s, wh=wh, bh=bh: (fn(gx, ms, wh, bh),),
            stacked, (gx_s, wh, bh), work, (f"{cell}_scan_stacked", (gx_s,), m_s, wh, bh),
            gen_stacked)
    b32 = TRAIN_BATCHES[-1]
    later[f"gru_bwd T={AM_T} B={b32} H=512 (waves of clusters)"] = rnn_case(
        "gru_bwd", "gru", AM_T, 512, b32, am_frames[torch.arange(b32, device=device) % BWD_B],
        gen_b32)[0]
    gn_shapes = []
    for act, f, lens, slope in (("leaky_relu", 161, frames, 0.2),
                                ("hardtanh", 81, am_frames, 0.2),
                                ("hardtanh", 41, am_frames, 0.2)):
        t_len = 1 + N // 160 if act == "leaky_relu" else AM_T
        x = (0.5 + 3.0 * randn(BWD_B, t_len, f, 32)).requires_grad_()
        scale = (1 + randn(32, scale=0.1)).requires_grad_()
        bias = randn(32, scale=0.1).requires_grad_()
        kw = dict(num_groups=8, act=act, slope=slope)
        gn_shapes.append((BWD_B, t_len, f, 32, act, lens.tolist()))
        valid = valid_share(lens, t_len)     # x, dy read on the valid frames, dx written whole
        cases[f"gn_bwd {act} [{BWD_B}, {t_len}, {f}, 32]"] = (
            "gn_bwd", lambda fn, x=x, s=scale, b=bias, ln=lens, kw=kw: (fn(x, s, b, ln, **kw),),
            (gn.masked_group_norm_act, gn.masked_group_norm_act_plain), (x, scale, bias),
            ((2 * valid + 1) * nbytes(x), 20.0 * valid * x.numel()), (lens, kw), gen)

    cases.update(later)
    gn_names = iter(gn_bwd_kernels(gn_shapes))      # in the order of the gn_bwd cases
    for label, (name, run, (kernel, plain), inputs, work, detail, cot_gen) in cases.items():
        outs_k, outs_p = run(kernel), run(plain)
        cots = tuple(torch.randn(o.shape, generator=cot_gen).to(device) for o in outs_k)
        grads_k = torch.autograd.grad(outs_k, inputs, cots, retain_graph=True)
        grads_p = torch.autograd.grad(outs_p, inputs, cots, retain_graph=True)
        torch.cuda.synchronize()
        err = max_err(grads_k, grads_p)
        rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(grads_k, grads_p))
        tol, why = BWD_TOL[name]
        reps = 3 if name != "gn_bwd" else 10
        backward_k = lambda: torch.autograd.grad(outs_k, inputs, cots,   # noqa: E731
                                                 retain_graph=True)
        ms, plain_ms = in_turns(
            backward_k, lambda: torch.autograd.grad(outs_p, inputs, cots, retain_graph=True),
            reps, warmup=1)
        grads = {"gn_bwd": "dx, dscale, dbias", "lstm_bwd": "dgxf, dgxb, dwh, dbh",
                 "gru_bwd": "dgxf, dgxb, dwh, dbh"}.get(name, "dgx, dwh, dbh")
        text = keep(results, name, label, err, ms, plain_ms, work, rel_err=rel)
        row = results[name]["shapes"][label]
        if name == "gn_bwd":
            text += device_times(row, backward_k)
            text += gn_bwd_alone(row, label, inputs, cots[0], *detail, next(gn_names))
        else:
            text += rnn_bwd_routes(row, name, label, detail, cots, grads_p)
        if next(iter(results[name]["shapes"])) == label:    # the main path's shape
            results[name].update({k: v for k, v in row.items() if k not in results[name]})
        print(f"[kernel] {label}: grads ({grads}) max_abs_err {err:.3e}, relative "
              f"to max|grad| {rel:.3e} (tol {tol:.0e}: {why}) | "
              f"backward pass {ms:.4f} ms | plain backward {plain_ms:.4f} ms | "
              f"x{plain_ms / ms:.2f} | {text}")
        if not rel <= tol:
            fail(f"{label}: gradient error {rel:.3e} of max|grad| > tol {tol:.0e}")
        del outs_k, outs_p, grads_k, grads_p


def gn_bwd_kernels(shapes: list, dtype: str = "float32") -> list:
    """{kernel name: launches} of the device kernels of one GroupNorm backward
    wrapper call at each (B, T, F, C, act, lengths) of ``shapes`` on ``dtype``
    streams, each on the mean and inv its forward kernel saved, in a fresh
    process (``utils.profiling.kernel_names_in_fresh_process``)."""
    from aas_enhancement_tpu_torch.utils.profiling import kernel_names_in_fresh_process
    return kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import gn
calls = []
for b, t, f, c, act, lens in {shapes!r}:
    x = torch.randn(b, t, f, c, device="cuda").to(torch.{dtype})
    scale, bias = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    lengths = torch.tensor(lens, device="cuda")
    stats = gn._stats(gn.gn_kernel(x, scale, bias, lengths, 8, 1e-5, act, 0.2)[1], b, c)
    args = (x, torch.randn_like(x), scale, bias, lengths, *stats)
    calls.append(lambda args=args, act=act: gn.masked_group_norm_act_bwd(
        *args, num_groups=8, act=act))
""")


def gn_bwd_alone(row: dict, label: str, inputs, dy, lengths, kw: dict, names: list) -> str:
    """The GroupNorm backward wrapper alone, on the mean and inv that the
    forward kernel saves for these inputs and on the case's cotangent:
    against the plain closed form (``masked_group_norm_act_bwd_plain``),
    each gradient's error relative to its max|value|, failing past the
    tolerance; the same bits on two calls; the device kernels of one call
    (``names``, from ``gn_bwd_kernels``: failing unless exactly one); both
    timed in turns between CUDA events; the wrapper's device time alone
    (``utils.profiling.device_time``; the line's ``device_ms`` is the whole
    backward pass's).  -> text for the kernel's line."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.utils.profiling import device_time
    x, scale, bias = (v.detach() for v in inputs)
    scratch = gn.gn_kernel(x, scale, bias, lengths, kw["num_groups"], 1e-5, kw["act"],
                           kw["slope"])[1]
    args = (x, dy, scale, bias, lengths, *gn._stats(scratch, x.shape[0], x.shape[3]))
    kernel = lambda: gn.masked_group_norm_act_bwd(*args, **kw)          # noqa: E731
    plain = lambda: gn.masked_group_norm_act_bwd_plain(*args, **kw)     # noqa: E731
    first, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{label}: two calls of the backward kernel gave different bits")
    rel = max((a - r).abs().max().item() / r.abs().max().item() for a, r in zip(first, ref))
    if not rel <= BWD_TOL["gn_bwd"][0]:
        fail(f"{label}: the backward kernel's error {rel:.3e} of max|grad| against the "
             "closed form")
    if sum(names.values()) != 1 or "gn_act_bwd_kernel" not in next(iter(names)):
        fail(f"{label}: one backward call launched {names}, not one device kernel")
    row["alone_rel_err"] = rel
    row["kernel_ms"], row["closed_form_ms"] = in_turns(kernel, plain, 10, warmup=1)
    row["alone_device_ms"], row["alone_device_ms_by"] = device_time(kernel)
    return (f" | the wrapper alone: error {rel:.3e} of max|grad| against the closed form; "
            f"same bits on two calls; 1 device kernel a call ({next(iter(names))[:40]}); "
            f"{row['kernel_ms']:.4f} ms between events (closed form "
            f"{row['closed_form_ms']:.4f} ms); on the device {row['alone_device_ms']:.4f} ms "
            f"({row['alone_device_ms_by']})")


def rnn_bwd_routes(row: dict, name: str, label: str, rnn, cots, grads_p) -> str:
    """The route the LSTM or GRU backward wrapper just took at this shape
    (failing unless it is the one ``RNN_ROUTES`` names for the width), and
    with it, on what the training forward saves for these inputs: two calls
    of the kernel alone (``_backward``, the weight gradients included) must
    give the same bits; the streaming backward (route 0) on the same inputs,
    its gradient error against the plain version; both timed in turns
    between CUDA events and on the device (``utils.profiling.device_time``);
    the clusters of the resident backward the card runs at once.  -> text for
    the kernel's line."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.utils.profiling import device_time
    entry, gx, m, wh, bh = rnn
    cell = entry.split("_")[0]
    h = wh.shape[1]
    route = krnn._BACKWARD[entry].route
    if route != RNN_ROUTES[cell][h]:
        fail(f"{label}: H={h} took backward route {route}, not {RNN_ROUTES[cell][h]}")
    with torch.no_grad():
        _, saved = krnn._forward(entry, tuple(x.detach() for x in gx), m, wh.detach(),
                                 bh.detach(), save=True)

    def backward(r):      # the cotangents: (dy,) stacked, (dyf, dyb) time-major
        dgx, dwh, dbh = krnn._backward(entry, m, wh.detach(), saved, cots, True, route=r)
        return (torch.cat(dgx, dim=-1) if len(dgx) == 2 else dgx[0], dwh, dbh)

    def kernel_only(r):
        return krnn._backward(entry, m, wh.detach(), saved, cots, False, route=r)

    first, again, stream = backward(None), backward(None), backward(0)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{label}: two calls of the backward kernel gave different bits")
    s_rel = max((a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(stream, grads_p))
    if not s_rel <= BWD_TOL[name][0]:
        fail(f"{label}: the streaming backward's gradient error {s_rel:.3e} of max|grad|")
    row["kernel_route"] = f"resident, clusters of {route}" if route else "streaming"
    row["clusters_at_once"] = krnn.resident_clusters_at_once(cell, h, route, backward=True)
    row["kernel_ms"], row["streaming_ms"] = in_turns(lambda: backward(None),
                                                     lambda: backward(0), 5, warmup=1)
    # On the device: the backward kernel's own time (without the weight
    # gradients' products and, where the profiler dropped events, for the
    # GRU without dgh's stores).
    row["device_ms"], row["device_ms_by"] = device_time(
        lambda: backward(None), "res_bwd_kernel", alone=lambda: kernel_only(None))
    row["streaming_device_ms"], by = device_time(
        lambda: backward(0), "tm_bwd_kernel", alone=lambda: kernel_only(0))
    row["streaming_rel_err"] = s_rel
    dev, s_dev = row["device_ms"], row["streaming_device_ms"]
    return (f" | route: {row['kernel_route']}, {row['clusters_at_once']} such clusters at "
            f"once by cudaOccupancyMaxActiveClusters; same bits on two calls | the kernel "
            f"alone (with dWh, dbh) {row['kernel_ms']:.4f} ms, on the device "
            f"{dev:.4f} ms ({row['device_ms_by']}), {1e3 * dev / gx[0].shape[0]:.3f} us a "
            f"step | streaming backward {row['streaming_ms']:.4f} ms, on the device "
            f"{s_dev:.4f} ms ({by}) (gradient error {s_rel:.3e} of max|grad|), "
            f"x{row['streaming_ms'] / row['kernel_ms']:.2f} between events, "
            f"x{s_dev / dev:.2f} on the device")


def kernels_conv_dw(device, gen, results: dict) -> None:
    """The conv weight-gradient kernel at B=8 against its plain version: the
    AM's conv2 (11 x 21, stride (1, 2), [8, 401, 81, 32] -> 41 bins) with a
    ragged dy (zero past each row's length, as the GroupNorm's mask leaves
    it), and the enhancer's 5 x 5 stride-(1, 1) convs at [8, 801, 161, 32];
    two runs must give the same bits.  The library call beside it is cuDNN's
    weight gradient (torch.nn.grad.conv2d_weight), f32 and TF32."""
    import torch
    import torch.nn.functional as F
    from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
    from aas_enhancement_tpu_torch.ops.masking import time_mask

    tol, why = BWD_TOL["conv_dw"]
    shapes = (("AM conv2 11x21 s(1,2)", AM_T, 81, 11, 21, (1, 2), BWD_AM_FRAMES),
              ("enhancer conv 5x5 s(1,1)", 1 + N // 160, 161, 5, 5, (1, 1), BWD_FRAMES))
    for label, t_len, f, kt, kf, strides, lens in shapes:
        fo = -(-f // strides[1])
        x = torch.randn(BWD_B, t_len, f, 32, generator=gen).to(device)
        mask = time_mask(torch.tensor(lens, device=device), t_len)[:, :, None, None]
        dy = torch.randn(BWD_B, t_len, fo, 32, generator=gen).to(device) * mask
        got = kconv.conv_dw_same(x, dy, kt, kf, strides)
        again = kconv.conv_dw_same(x, dy, kt, kf, strides)
        ref = kconv.conv_dw_same_plain(x, dy, kt, kf, strides)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            fail(f"conv_dw {label}: two runs gave different bits")
        err = max_err(got, ref)
        rel = err / ref.abs().max().item()
        ms, plain_ms = in_turns(lambda: kconv.conv_dw_same(x, dy, kt, kf, strides),
                                lambda: kconv.conv_dw_same_plain(x, dy, kt, kf, strides),
                                reps=5, warmup=1)
        # cuDNN's weight gradient on the same tensors (NCHW views of the same
        # channels-last memory, SAME padding applied to x), for the record only.
        pads = (*kconv.same_pad(f, kf, strides[1]), *kconv.same_pad(t_len, kt, 1))
        x_nchw = F.pad(x.permute(0, 3, 1, 2), pads)
        dy_nchw = dy.permute(0, 3, 1, 2)
        cudnn = lambda: torch.nn.grad.conv2d_weight(                       # noqa: E731
            x_nchw, (32, 32, kt, kf), dy_nchw, stride=strides)
        lib_err = (cudnn().permute(2, 3, 1, 0) - ref).abs().max().item() / ref.abs().max().item()
        lib_ms = statistics.median(cuda_ms(cudnn, 5))
        torch.backends.cudnn.allow_tf32 = True
        lib_tf32_ms = statistics.median(cuda_ms(cudnn, 5))
        torch.backends.cudnn.allow_tf32 = False
        work = (nbytes(x, dy, ref), 2.0 * BWD_B * t_len * fo * kt * kf * 32 * 32)
        text = keep(results, "conv_dw", label, err, ms, plain_ms, work, lib_ms, rel_err=rel)
        print(f"[kernel] conv_dw {label} x [{BWD_B}, {t_len}, {f}, 32] ragged dy: "
              f"max_abs_err {err:.3e}, relative to max|dW| {rel:.3e} (tol {tol:.0e}: "
              f"{why}); same bits on two runs | kernel {ms:.4f} ms | plain {plain_ms:.4f} "
              f"ms | x{plain_ms / ms:.2f} | {text} (cuDNN wgrad f32, its error "
              f"{lib_err:.3e}; with TF32 {lib_tf32_ms:.4f} ms)")
        if not rel <= tol:
            fail(f"conv_dw {label}: error {rel:.3e} of max|dW| > tol {tol:.0e}")


def phase_slice(device, card):
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus, read_manifest, read_wav
    from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn

    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))
        out_dir = os.path.join(tmp, "enhanced")
        buf = io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(buf):
                cli.main(["--manifest", manifests["noisy"], "--out-dir", out_dir,
                          "--device", "cuda"])

        launches = counted(("stft", "istft", "gn_act", "lstm"), run_cli)
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
    print_device_kernels("[slice]", "enhance call", lambda: fn_gpu(model_gpu, wav_d, full))
    time_batch("[slice]", "enhance", card, lambda: fn_gpu(model_gpu, wav_d, full))
    return launches


def print_device_kernels(tag: str, what: str, fn) -> None:
    """The device kernels of one profiled full-width call: their number, and
    those of the GroupNorm forward and the ISTFT (one launch a wrapper call).
    Late in this process the profiler has dropped events: a reading, no check."""
    from aas_enhancement_tpu_torch.utils.profiling import device_kernel_names
    names = device_kernel_names(fn)
    ours = {n[:40]: c for n, c in names.items() if "gn_act" in n or "istft" in n}
    print(f"{tag} one B={B} x {SECONDS} s {what}: {sum(names.values())} device kernels "
          f"by torch.profiler, {len(names)} names; GroupNorm forward and ISTFT: "
          f"{json.dumps(ours)}")


def time_batch(tag: str, what: str, card: str, fn) -> float:
    """Host wall time of one synchronized full-width call: median of 5 after
    2 warmups (allocator), TF32 off as set in phase_device."""
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

    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))
        buf = io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(buf):
                cli.main(["--manifest", manifests["noisy"], "--am-checkpoint", "seed:0",
                          "--enhancer-checkpoint", "seed:1",
                          "--clean-manifest", manifests["clean"], "--device", "cuda"])

        launches = counted(("stft", "istft", "gn_act", "lstm", "gru"), run_cli)
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
    am_cpu, enh_cpu = init_am(cfg, 0, "cpu"), init_enhancer(cfg, 1, "cpu")
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
    print_device_kernels("[recognize]", "recognition forward (enhancer + AM)",
                         lambda: fwd(am_gpu, enh_gpu, wav_d, full))
    time_batch("[recognize]", "recognition forward (enhancer + AM)", card,
               lambda: fwd(am_gpu, enh_gpu, wav_d, full))
    time_batch("[recognize]", "recognition forward (AM alone, noisy leg)", card,
               lambda: fwd_noisy(am_gpu, None, wav_d, full))
    return launches


def kernels_bf16(device, results: dict) -> None:
    """B3 (leaky at the enhancer's shape, hardtanh at the AM's two), B1 and
    B2 (resident, and the streaming kernel forced on the same inputs) and the
    stacked B7, B7' forwards on bf16 streams at the bf16 paths' full-width
    shapes, against their plain versions on the card (``BF16_TOL``), timed in
    turns; each wrapper must record a bf16 launch.  The bound counts bf16
    gx, x and y at 2 bytes and the recurrent products at the bf16 tensor-core
    rate (the kernels run them as f32 FMAs on bf16-exact values)."""
    import torch
    from aas_enhancement_tpu_torch.convert import init_like_flax
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.masking import time_mask
    from aas_enhancement_tpu_torch.ops.rnn import BiRNN
    from aas_enhancement_tpu_torch.utils.profiling import device_time

    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(16)
    _, lengths, _ = make_inputs(device)
    frames, am_frames = 1 + lengths // 160, torch.tensor(AM_LENGTHS, device=device)
    t_len = 1 + N // 160
    x_gn = (0.5 + torch.randn(B, t_len, 161, 32, generator=gen)).to(device, bf16)
    x_am = {f: (0.5 + 3.0 * torch.randn(B, AM_T, f, 32, generator=gen)).to(device, bf16)
            for f in (81, 41)}
    scale = (1 + 0.1 * torch.randn(32, generator=gen)).to(device)
    bias = (0.1 * torch.randn(32, generator=gen)).to(device)
    rnn = init_like_flax(BiRNN(161 * 32, 256, dtype=bf16), gen).to(device)
    gru = init_like_flax(BiRNN(41 * 32, 512, cell="gru", dtype=bf16), gen).to(device)
    with torch.no_grad():
        gru.bh.copy_(0.1 * torch.randn(gru.bh.shape, generator=gen))
    m, m_am = time_mask(frames, t_len).T.contiguous(), time_mask(am_frames, AM_T).T.contiguous()
    leaky = dict(num_groups=8, act="leaky_relu", slope=0.2)
    hard = dict(num_groups=8, act="hardtanh")

    def gn_work(x, lens):
        share = valid_share(lens, x.shape[1])
        return (share + 1) * nbytes(x), 10.0 * share * x.numel()

    def rnn_work(gates_t, gh: int, mask, wh, bh):
        t_n, b_n, h = gates_t.shape[0], gates_t.shape[1], wh.shape[1]
        return (nbytes(gates_t, mask, wh, bh) + 2 * t_n * b_n * h * 2,
                2.0 * 2 * t_n * b_n * h * gh, PEAK_BF16_S)

    with torch.inference_mode():
        gates = rnn.wx(torch.randn(t_len, B, 161 * 32, generator=gen).to(device))
        g_gates = gru.wx(torch.randn(AM_T, B, 41 * 32, generator=gen).to(device))
        wh, bh = rnn.wh.to(bf16).float(), rnn.bh.to(bf16).float()   # as BiRNN hands them
        g_wh, g_bh = gru.wh.to(bf16).float(), gru.bh.to(bf16).float()
        gxf, gxb = gates[..., :1024], gates[..., 1024:]
        g_xf, g_xb = g_gates[..., :1536], g_gates[..., 1536:]
        gx_s, m_s = (x.contiguous() for x in krnn.to_stacked(gxf, gxb, m))
        g_gx_s, g_m_s = (x.contiguous() for x in krnn.to_stacked(g_xf, g_xb, m_am))
        cases = {   # label: (name, wrapper, plain, args, kwargs, work)
            "bf16 gn_act leaky [4, 801, 161, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_gn, scale, bias, frames), leaky, gn_work(x_gn, frames)),
            "bf16 gn_act hardtanh [4, 401, 81, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[81], scale, bias, am_frames), hard, gn_work(x_am[81], am_frames)),
            "bf16 gn_act hardtanh [4, 401, 41, 32]": (
                "gn_act", gn.masked_group_norm_act, gn.masked_group_norm_act_plain,
                (x_am[41], scale, bias, am_frames), hard, gn_work(x_am[41], am_frames)),
            "bf16 lstm T=801 B=4 H=256": (
                "lstm", krnn.lstm_scan_tm, krnn.lstm_scan_tm_plain, (gxf, gxb, m, wh, bh), {},
                rnn_work(gates, 1024, m, wh, bh)),
            "bf16 gru T=401 B=4 H=512": (
                "gru", krnn.gru_scan_tm, krnn.gru_scan_tm_plain,
                (g_xf, g_xb, m_am, g_wh, g_bh), {}, rnn_work(g_gates, 1536, m_am, g_wh, g_bh)),
            "bf16 lstm_stacked T=801 B=4 H=256": (
                "lstm_stacked", krnn.lstm_scan_stacked, krnn.lstm_scan_stacked_plain,
                (gx_s, m_s, wh, bh), {}, rnn_work(gates, 1024, m_s, wh, bh)),
            "bf16 gru_stacked T=401 B=4 H=512": (
                "gru_stacked", krnn.gru_scan_stacked, krnn.gru_scan_stacked_plain,
                (g_gx_s, g_m_s, g_wh, g_bh), {}, rnn_work(g_gates, 1536, g_m_s, g_wh, g_bh)),
        }
        for label, (name, kernel, plain, args, kw, work) in cases.items():
            kernel.dtype = None
            k_out = kernel(*args, **kw)
            p_out = plain(*args, **kw)
            torch.cuda.synchronize()
            outs = k_out if isinstance(k_out, tuple) else (k_out,)
            if kernel.dtype != bf16 or any(o.dtype != bf16 for o in outs):
                fail(f"{label}: the wrapper launched a {kernel.dtype} kernel, outputs "
                     f"{[o.dtype for o in outs]}")
            k32 = tuple(o.float() for o in outs)
            p32 = tuple(o.float() for o in (p_out if isinstance(p_out, tuple) else (p_out,)))
            err = max_err(k32, p32)
            top = max(o.abs().max().item() for o in p32)
            tol, why = BF16_TOL[name]
            reps = 5 if name in RECURRENT else 20
            ms, plain_ms = in_turns(lambda: kernel(*args, **kw), lambda: plain(*args, **kw),
                                    reps)
            text = keep(results, name, label, err, ms, plain_ms, work, None,
                        rel_err=err / top)
            row = results[name]["shapes"][label]
            row["dtype"] = "bfloat16"
            row["device_ms"], row["device_ms_by"] = device_time(lambda: kernel(*args, **kw))
            text += f" | on the device alone ({row['device_ms_by']}): {row['device_ms']:.4f} ms"
            if name in RECURRENT:
                cell = name.split("_")[0]
                entry = f"{cell}_scan_stacked" if name.endswith("stacked") else f"{cell}_scan_tm"
                route, h = kernel.route, args[-2].shape[1]
                if route != RNN_ROUTES[cell][h]:
                    fail(f"{label}: H={h} took route {route}, not {RNN_ROUTES[cell][h]}")
                *gx, mk, w, bb = args
                stream = lambda: krnn._forward(entry, tuple(gx), mk, w, bb,   # noqa: E731
                                               save=False, route=0)[0]
                s_err = max_err(tuple(o.float() for o in stream()), p32) / top
                torch.cuda.synchronize()
                row["kernel_route"] = f"resident, clusters of {route}"
                row["streaming_ms"] = statistics.median(cuda_ms(stream, 3))
                text += (f" | route: resident, clusters of {route} | streaming kernel "
                         f"{row['streaming_ms']:.4f} ms (error {s_err:.3e} of max|plain|)")
                if not s_err <= tol:
                    fail(f"{label}: the streaming kernel's error {s_err:.3e} of max|plain|")
            print(f"[bf16] {label}: max_abs_err {err:.3e} = {err / top:.3e} of max|plain| "
                  f"{top:.3f} (tol {tol:.2e}: {why}) | kernel {ms:.4f} ms | plain "
                  f"{plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text}")
            if not err <= tol * top:
                fail(f"{label}: max abs err {err:.3e} > {tol:.2e} x {top:.3f}")


def bf16_config(cfg):
    """``cfg`` with the enhancer, the AM and the discriminator at bfloat16."""
    return cfg.replace(**{n: dataclasses.replace(getattr(cfg, n), dtype="bfloat16")
                          for n in ("enhancer", "am", "discriminator")})


def check_bf16_launches(tag: str, launches: dict, names) -> None:
    """Each named kernel ran on the path, and its last launch streamed bf16
    (conv_dw's on the tensor-core route)."""
    import torch
    counters = kernel_counters()
    for name in names:
        if not launches.get(name):
            fail(f"{tag}: launched no {name} kernel")
        if counters[name].dtype != torch.bfloat16:
            fail(f"{tag}: {name}'s last launch streamed {counters[name].dtype}, not bf16")
        if name == "conv_dw" and counters[name].route != "mma":
            fail(f"{tag}: conv_dw's last launch took route {counters[name].route}, not mma")


def phase_bf16(device, card, results: dict):
    """The bf16 models' forwards on the card (``dtype="bfloat16"``, shipped
    widths): the bf16 kernels against their plain versions
    (``kernels_bf16``); cli.enhance and cli.evaluate (greedy) with a bf16
    config; one StreamingEnhancer and one StreamingRecognizer stream; a
    cli.export artifact of a bf16 checkpoint directory against the live
    call; each path's launches with every kernel's last launch on bf16
    streams; the enhance and recognition forwards card vs CPU at bf16
    (B=4 x 2 s), and the bf16 wave against the f32 wave of the same weights
    (it must differ by more than the f32 card-vs-CPU limit: the dtype reached
    the device); enhance and recognition at B=4 x 8 s timed, f32 beside bf16,
    with their device busy time.  -> {path: launches}."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as cli_enhance
    from aas_enhancement_tpu_torch.cli import evaluate as cli_evaluate
    from aas_enhancement_tpu_torch.cli import export as cli_export
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
    from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward
    from aas_enhancement_tpu_torch.serving import load_enhancer
    from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
    from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
    from aas_enhancement_tpu_torch.train.loop import init_state, load_state
    from aas_enhancement_tpu_torch.utils import checkpoint as ckpt
    from aas_enhancement_tpu_torch.utils.profiling import device_time

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels_bf16(device, results)
    cfg32 = Config()
    cfg16 = bf16_config(cfg32)
    enhance_k, recognize_k = ("stft", "istft", "gn_act", "lstm"), ("stft", "gn_act", "lstm",
                                                                 "gru")
    by_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))
        cfg_path = os.path.join(tmp, "bf16.json")
        with open(cfg_path, "w") as f:
            f.write(cfg16.to_json())
        buf = io.StringIO()

        def run_enhance():
            with contextlib.redirect_stdout(buf):
                cli_enhance.main(["--manifest", manifests["noisy"], "--out-dir",
                                  os.path.join(tmp, "enhanced"), "--config", cfg_path,
                                  "--device", "cuda"])

        by_path["enhance_bf16"] = counted(enhance_k, run_enhance)
        check_bf16_launches("cli.enhance (bf16)", by_path["enhance_bf16"], enhance_k[2:])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[bf16] cli.enhance --config (bf16) --device cuda: {json.dumps(line)} | "
              f"launches {json.dumps(by_path['enhance_bf16'])}, gn_act and lstm on bf16")
        if line["utterances"] != 6:
            fail(f"cli.enhance (bf16) enhanced {line['utterances']} utterances")
        buf = io.StringIO()

        def run_evaluate():
            with contextlib.redirect_stdout(buf):
                cli_evaluate.main(["--manifest", manifests["noisy"], "--am-checkpoint",
                                   "seed:0", "--enhancer-checkpoint", "seed:1",
                                   "--clean-manifest", manifests["clean"], "--config",
                                   cfg_path, "--device", "cuda"])

        by_path["recognize_bf16"] = counted(recognize_k + ("istft",), run_evaluate)
        check_bf16_launches("cli.evaluate (bf16)", by_path["recognize_bf16"],
                            recognize_k[1:])
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(f"[bf16] cli.evaluate --config (bf16) --device cuda: {json.dumps(line)} | "
              f"launches {json.dumps(by_path['recognize_bf16'])}, gn_act, lstm and gru "
              "on bf16")
        for leg in ("noisy", "enhanced"):
            if line[leg]["utterances"] != 6 or not 0.0 <= line[leg]["wer"] < float("inf"):
                fail(f"cli.evaluate (bf16) {leg}: {line[leg]}")

        # A bf16 checkpoint directory (the seeds' f32 weights under a bf16
        # config), its cli.export artifact against the live call.
        ck = os.path.join(tmp, "ck_bf16")
        os.makedirs(ck)
        only = lambda c: c.replace(train=dataclasses.replace(   # noqa: E731
            c.train, objective="enhance_only"))
        with open(os.path.join(ck, "config.json"), "w") as f:
            f.write(only(cfg16).to_json())
        ckpt.save(ck, 1, init_state(only(cfg32), 0, "cpu"))
        art = os.path.join(tmp, "art_bf16")
        with contextlib.redirect_stdout(io.StringIO()):
            cli_export.main(["--checkpoint", ck, "--out", art, "--batch-sizes", "1",
                             "--seconds", str(SECONDS), "--device", "cuda"])
        served = load_enhancer(art, device)
        wav, _, _ = make_inputs("cpu")
        one = wav[:1].numpy()
        got = {}
        by_path["export_bf16"] = counted(enhance_k, lambda: got.update(y=served.enhance(one)))
        check_bf16_launches("cli.export artifact (bf16)", by_path["export_bf16"],
                            enhance_k[2:])
        g16 = load_state(ck, device)[0].g.eval()
        live = make_enhance_fn(cfg16, device)(g16, torch.from_numpy(one).to(device),
                                              torch.tensor([N], device=device)).cpu().numpy()
        err = float(np.abs(got["y"] - live).max())
        print(f"[bf16] cli.export --batch-sizes 1 --seconds {SECONDS} (bf16 directory): "
              f"artifact vs live call max_abs_err {err:.3e} (tol 0: the live path's "
              f"operators on the same device) | launches {json.dumps(by_path['export_bf16'])}")
        if err != 0.0:
            fail(f"the bf16 artifact differs from the live call by {err:.3e}")

    # Card vs CPU at bf16 (B=4 x 2 s), and the bf16 wave against the f32 one.
    n = SR * BF16_SECONDS
    wav, _, _ = make_inputs("cpu")
    wav = wav[:, :n].contiguous()
    lengths = torch.tensor([n, n - 4000, n - 8000, n // 2])
    wav = wav * (torch.arange(n)[None] < lengths[:, None])
    enh16_cpu, enh32_cpu = init_enhancer(cfg16, 1, "cpu"), init_enhancer(cfg32, 1, "cpu")
    am16_cpu = init_am(cfg16, 0, "cpu")
    enh16, enh32 = copy.deepcopy(enh16_cpu).to(device), copy.deepcopy(enh32_cpu).to(device)
    am16 = copy.deepcopy(am16_cpu).to(device)
    y_cpu = make_enhance_fn(cfg16, "cpu")(enh16_cpu, wav, lengths)
    y16 = make_enhance_fn(cfg16, device)(enh16, wav.to(device), lengths.to(device)).cpu()
    y32 = make_enhance_fn(cfg32, device)(enh32, wav.to(device), lengths.to(device)).cpu()
    tol, why = BF16_PATH_TOL
    top = y_cpu.abs().max().item()
    err, apart = (y16 - y_cpu).abs().max().item(), (y16 - y32).abs().max().item()
    print(f"[bf16] enhance B={B} x {BF16_SECONDS} s (bf16) card vs CPU: max_abs_err "
          f"{err:.3e} = {err / top:.3e} of max|y| {top:.3f} (tol {tol:.0e}: {why}); the "
          f"bf16 wave vs the f32 wave on the card: {apart:.3e} (must exceed the f32 limit "
          f"{SLICE_TOL[0]:.0e})")
    if not err <= tol * top:
        fail(f"bf16 enhance card vs CPU {err:.3e} > {tol:.0e} x {top:.3f}")
    if not apart > SLICE_TOL[0]:
        fail(f"the bf16 enhance path equals the f32 one to {apart:.3e}: the dtype never "
             "reached the device")
    fwd = make_eval_forward(cfg16, use_enhancer=True)
    logits_cpu, pads_cpu = fwd(am16_cpu, enh16_cpu, wav, lengths)
    logits, pads = (x.cpu() for x in fwd(am16, enh16, wav.to(device), lengths.to(device)))
    top = logits_cpu.abs().max().item()
    err = (logits - logits_cpu).abs().max().item()
    valid = pads_cpu < 0.5
    top2 = logits_cpu.topk(2, dim=-1).values
    sure = valid & (top2[..., 0] - top2[..., 1] > 2 * tol * top)
    same = (logits.argmax(-1) == logits_cpu.argmax(-1)) | ~sure
    print(f"[bf16] recognition B={B} x {BF16_SECONDS} s (bf16) card vs CPU: logits "
          f"max_abs_err {err:.3e} = {err / top:.3e} of max|logit| {top:.3f} (tol {tol:.0e}); "
          f"greedy ids equal on {int((same & sure).sum())} of {int(sure.sum())} valid frames "
          f"with a top-2 margin > {2 * tol:.0e} x max ({int(valid.sum())} valid)")
    if not torch.equal(pads, pads_cpu) or not err <= tol * top or not same.all():
        fail("bf16 recognition card vs CPU: paddings, logits or clear ids differ")

    # One stream through each engine at bf16, card vs CPU.
    stream = wav[0, :n].numpy()
    push = SR // 10

    def enhance_stream(dev, g):
        eng = StreamingEnhancer(cfg16, g, device=dev, **STREAM_KW)
        return np.concatenate([eng.feed(stream[i: i + push]) for i in range(0, n, push)]
                              + [eng.flush()])

    out = {}
    by_path["stream_enhance_bf16"] = counted(
        enhance_k, lambda: out.update(card=enhance_stream(device, enh16)))
    check_bf16_launches("StreamingEnhancer (bf16)", by_path["stream_enhance_bf16"],
                        enhance_k[2:])
    ref = enhance_stream("cpu", enh16_cpu)
    top = float(np.abs(ref).max())
    err = float(np.abs(out["card"] - ref).max())
    print(f"[bf16] StreamingEnhancer (bf16, {BF16_SECONDS} s in 0.1 s pushes) card vs CPU: "
          f"max_abs_err {err:.3e} = {err / top:.3e} of max (tol {tol:.0e}) | launches "
          f"{json.dumps(by_path['stream_enhance_bf16'])}")
    if out["card"].shape != ref.shape or not err <= tol * top:
        fail(f"StreamingEnhancer (bf16) card vs CPU {err:.3e}")

    def recognize_stream(dev, am, g):
        rec = StreamingRecognizer(cfg16, am, g, collect_logits=True, device=dev, **STREAM_KW)
        ids = [i for k in range(0, n, push) for i in rec.feed(stream[k: k + push])]
        return ids + rec.flush(), rec.log_probs()

    by_path["stream_recognize_bf16"] = counted(
        recognize_k, lambda: out.update(rec=recognize_stream(device, am16, enh16)))
    check_bf16_launches("StreamingRecognizer (bf16)", by_path["stream_recognize_bf16"],
                        recognize_k[1:])
    ids, lp = out["rec"]
    ref_ids, ref_lp = recognize_stream("cpu", am16_cpu, enh16_cpu)
    top = float(np.abs(ref_lp).max())
    err = float(np.abs(lp - ref_lp).max())
    srt = np.sort(ref_lp, axis=-1)
    sure = srt[:, -1] - srt[:, -2] > 2 * tol * top
    bad = int(np.sum(sure & (np.asarray(ids) != np.asarray(ref_ids))))
    print(f"[bf16] StreamingRecognizer (bf16) card vs CPU: log-probs max_abs_err {err:.3e} "
          f"= {err / top:.3e} of max (tol {tol:.0e}); ids differ on {bad} of {int(sure.sum())} "
          f"frames with a clear margin | launches "
          f"{json.dumps(by_path['stream_recognize_bf16'])}")
    if len(ids) != len(ref_ids) or not err <= tol * top or bad:
        fail("StreamingRecognizer (bf16) card vs CPU differs")

    # bf16 beside f32 at B=4 x 8 s: wall (median of 5 after 2) and device busy.
    am32 = init_am(cfg32, 0, "cpu").to(device)
    wav_d, full = make_inputs(device)[0], torch.full((B,), N, device=device)
    runs = {"enhance": {dt: (lambda f=make_enhance_fn(c, device), g=g: f(g, wav_d, full))
                        for dt, c, g in (("f32", cfg32, enh32), ("bf16", cfg16, enh16))},
            "recognition (enhancer + AM)": {
                dt: (lambda f=make_eval_forward(c, True), a=a, g=g: f(a, g, wav_d, full))
                for dt, c, a, g in (("f32", cfg32, am32, enh32), ("bf16", cfg16, am16, enh16))}}
    for what, by_dt in runs.items():
        walls, busy = {"f32": [], "bf16": []}, {}
        for dt in ("f32", "bf16", "bf16", "f32"):          # in turns: two medians each
            walls[dt].append(time_batch("[bf16]", f"{what} {dt}", card, by_dt[dt]) * 1e3)
            busy.setdefault(dt, device_time(by_dt[dt]))
        wall = {dt: statistics.mean(w) for dt, w in walls.items()}
        print(f"[bf16] {what} B={B} x {SECONDS} s: wall f32 {wall['f32']:.2f} ms "
              f"{[round(w, 2) for w in walls['f32']]}, bf16 {wall['bf16']:.2f} ms "
              f"{[round(w, 2) for w in walls['bf16']]} (f32 / bf16 "
              f"x{wall['f32'] / wall['bf16']:.2f}); device busy f32 {busy['f32'][0]:.3f} ms "
              f"({busy['f32'][1]}), bf16 {busy['bf16'][0]:.3f} ms ({busy['bf16'][1]}) "
              f"(x{busy['f32'][0] / busy['bf16'][0]:.2f})")
    return by_path


def kernels_bf16_backward(device, results: dict) -> None:
    """B1' and B2' (resident; the streaming route on the same inputs), the
    B7 / B7' VJPs (stacked), B3' (leaky at the enhancer's shape, hardtanh at
    the AM's two) and B6 (the AM's conv2, also at B=32:
    ``kernels_conv_dw_bf16``) on bf16 streams at B=8, ragged, against their
    plain versions on the same bf16 inputs (``BF16_BWD_TOL``): the
    recurrences' backward kernel alone on what the bf16 training forward
    saved, against autograd through the plain version; the GroupNorm's on
    its forward kernel's statistics against the closed form; conv_dw against
    conv_dw_same_plain.  Timed in turns with the same kernel on the f32
    inputs; the bound counts the bf16 streams at 2 bytes and the products at
    the bf16 tensor-core rate.  Each wrapper must record a bf16 launch."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.masking import time_mask
    from aas_enhancement_tpu_torch.utils.profiling import device_time

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator().manual_seed(17)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    frames = torch.tensor(BWD_FRAMES, device=device)
    am_frames = torch.tensor(BWD_AM_FRAMES, device=device)
    for name, cell, t_len, h, lens, stacked in (
            ("lstm_bwd", "lstm", 1 + N // 160, 256, frames, False),
            ("gru_bwd", "gru", AM_T, 512, am_frames, False),
            ("lstm_stacked_bwd", "lstm", 1 + N // 160, 256, frames, True),
            ("gru_stacked_bwd", "gru", AM_T, 512, am_frames, True)):
        g = (4 if cell == "lstm" else 3) * h
        entry = f"{cell}_scan_{'stacked' if stacked else 'tm'}"
        label = f"bf16 {name} T={t_len} B={BWD_B} H={h}"
        wh = randn(2, h, g, scale=h ** -0.5).to(bf16).float()     # as the bf16 BiRNN hands it
        bh = randn(2, g, scale=0.1).to(bf16).float()
        m = time_mask(lens, t_len).T.contiguous()
        if stacked:
            m = torch.stack([m, m.flip(0)], dim=1).contiguous()
            x32 = randn(t_len, 2, BWD_B, g, scale=0.5)
        else:
            x32 = randn(t_len, BWD_B, 2 * g, scale=0.5)
        dy32 = randn(t_len, 2, BWD_B, h) if stacked else randn(2, t_len, BWD_B, h)
        runs = {}
        for dt in (f32, bf16):
            x = x32.to(dt)
            gx = (x,) if stacked else (x[..., :g], x[..., g:])
            _, saved = krnn._forward(entry, gx, m, wh, bh, save=True)
            dys = (dy32.to(dt),) if stacked else tuple(dy32.to(dt).unbind(0))
            runs[dt] = (gx, saved, dys)
        gx, saved, dys = runs[bf16]
        bwd = krnn._BACKWARD[entry]
        before = bwd.launches
        got = krnn._backward(entry, m, wh, saved, dys, True)
        if (bwd.launches != before + 1 or bwd.dtype != bf16
                or any(x.dtype != bf16 for x in got[0]) or any(s.dtype != bf16
                                                               for s in saved[:-1])):
            fail(f"{label}: the backward launched {bwd.launches - before} kernel(s) at "
                 f"{bwd.dtype}, dgx {[x.dtype for x in got[0]]}")
        if bwd.route != RNN_ROUTES[cell][h]:
            fail(f"{label}: the backward took route {bwd.route}, not {RNN_ROUTES[cell][h]}")
        inputs = [x.detach().clone().requires_grad_() for x in (*gx, wh, bh)]
        plain = getattr(krnn, f"{entry}_plain")

        def run_plain(plain=plain, inputs=inputs, m=m, dys=dys):
            out = plain(*inputs[:-2], m, *inputs[-2:])
            return torch.autograd.grad(out if isinstance(out, tuple) else (out,), inputs, dys)

        def rels(a, b):
            return [(x.float() - y.float()).abs().max().item() / y.float().abs().max().item()
                    for x, y in zip(a, b)]

        flat = (*got[0], got[1], got[2])
        ref = run_plain()
        stream = krnn._backward(entry, m, wh, saved, dys, True, route=0)
        torch.cuda.synchronize()
        rel = max(rels(flat, ref))
        err = max((x.float() - y.float()).abs().max().item() for x, y in zip(flat, ref))
        s_rel = max(rels((*stream[0], stream[1], stream[2]), flat))
        f32_run = runs[f32]
        ms, f32_ms = in_turns(
            lambda: krnn._backward(entry, m, wh, saved, dys, True),
            lambda: krnn._backward(entry, m, wh, f32_run[1], f32_run[2], True), 5, 1)
        dgx_ms, f32_dgx_ms = in_turns(        # without the weight gradient: the kernel alone
            lambda: krnn._backward(entry, m, wh, saved, dys, False),
            lambda: krnn._backward(entry, m, wh, f32_run[1], f32_run[2], False), 5, 1)
        plain_ms = statistics.median(cuda_ms(run_plain, 2, 1))
        s_ms = statistics.median(cuda_ms(
            lambda: krnn._backward(entry, m, wh, saved, dys, True, route=0), 3, 1))
        cells = 2 * t_len * BWD_B * h
        # Read once: the saved h (and c) and dy at 2 bytes, the activations
        # [.., 4H] and wh f32; written once: dgx (and the GRU's dgh) at 2
        # bytes, dwh and dbh f32.  dh = dg wh^T and dWh = h^T dg at the bf16
        # tensor-core rate.
        per_cell = 2 + 16 + 2 + 2 * g // h + (2 + 2 * g // h if cell == "gru" else 2)
        work = (cells * per_cell + 4.0 * (2 * wh.numel() + bh.numel()),
                2.0 * 2 * cells * g, PEAK_BF16_S)
        tol, why = BF16_BWD_TOL[name]
        text = keep(results, name, label, err, ms, plain_ms, work, None, rel_err=rel)
        row = results[name]["shapes"][label]
        row.update(dtype="bfloat16", f32_ms=f32_ms, streaming_ms=s_ms, dgx_only_ms=dgx_ms,
                   f32_dgx_only_ms=f32_dgx_ms, kernel_route=f"resident, clusters of {bwd.route}")
        row["device_ms"], row["device_ms_by"] = device_time(
            lambda: krnn._backward(entry, m, wh, saved, dys, True))
        print(f"[train_bf16] {label}: dgx (bf16), dwh, dbh (f32) against autograd through "
              f"the plain version: largest error {rel:.3e} of the tensor's max (tol "
              f"{tol:.0e}: {why}) | kernel alone {ms:.4f} ms (f32 inputs, same call: "
              f"{f32_ms:.4f} ms, x{f32_ms / ms:.2f}); without the weight gradient "
              f"{dgx_ms:.4f} ms (f32 {f32_dgx_ms:.4f}) | on the device alone "
              f"({row['device_ms_by']}): {row['device_ms']:.4f} ms | plain backward "
              f"{plain_ms:.4f} ms | route: resident, clusters of {bwd.route} | streaming "
              f"kernel {s_ms:.4f} ms, {s_rel:.3e} of max from the resident | {text}")
        if not rel <= tol or not s_rel <= tol:
            fail(f"{label}: gradient error {rel:.3e} (streaming {s_rel:.3e}) > {tol:.0e}")
        del runs, saved, got, ref, stream, inputs

    gn_shapes = []
    for act, t_len, f, lens in (("leaky_relu", 1 + N // 160, 161, frames),
                                ("hardtanh", AM_T, 81, am_frames),
                                ("hardtanh", AM_T, 41, am_frames)):
        label = f"bf16 gn_bwd {act} [{BWD_B}, {t_len}, {f}, 32]"
        x32 = 0.5 + 3.0 * randn(BWD_B, t_len, f, 32)
        dy32 = randn(BWD_B, t_len, f, 32)
        scale, bias = 1 + randn(32, scale=0.1), randn(32, scale=0.1)
        gn_shapes.append((BWD_B, t_len, f, 32, act, lens.tolist()))
        args = {}
        for dt in (f32, bf16):
            x = x32.to(dt)
            _, scratch = gn.gn_kernel(x, scale, bias, lens, 8, 1e-5, act, 0.2)
            args[dt] = (x, dy32.to(dt), scale, bias, lens, *gn._stats(scratch, BWD_B, 32))
        kw = dict(num_groups=8, act=act)
        before = gn.masked_group_norm_act_bwd.launches
        got = gn.masked_group_norm_act_bwd(*args[bf16], **kw)
        ref = gn.masked_group_norm_act_bwd_plain(*args[bf16], **kw)
        torch.cuda.synchronize()
        if (gn.masked_group_norm_act_bwd.launches != before + 1
                or gn.masked_group_norm_act_bwd.dtype != bf16 or got[0].dtype != bf16):
            fail(f"{label}: the backward did not launch once on bf16 streams")
        top = ref[0].float().abs().max().item()
        err = (got[0].float() - ref[0].float()).abs().max().item()
        err_p = max((a - b).abs().max().item() / b.abs().max().item()
                    for a, b in zip(got[1:], ref[1:]))
        ms, f32_ms = in_turns(lambda: gn.masked_group_norm_act_bwd(*args[bf16], **kw),
                              lambda: gn.masked_group_norm_act_bwd(*args[f32], **kw), 10)
        plain_ms = statistics.median(cuda_ms(
            lambda: gn.masked_group_norm_act_bwd_plain(*args[bf16], **kw), 5))
        valid = valid_share(lens, t_len)       # x, dy read on the valid frames, dx written whole
        x = args[bf16][0]
        work = ((2 * valid + 1) * nbytes(x), 20.0 * valid * x.numel())
        tol, why = BF16_BWD_TOL["gn_bwd"]
        text = keep(results, "gn_bwd", label, err, ms, plain_ms, work, None, rel_err=err / top)
        row = results["gn_bwd"]["shapes"][label]
        row.update(dtype="bfloat16", f32_ms=f32_ms)
        text += device_times(row, lambda: gn.masked_group_norm_act_bwd(*args[bf16], **kw))
        print(f"[train_bf16] {label}: dx (bf16) max_abs_err {err:.3e} = {err / top:.3e} of "
              f"max|dx| (tol {tol:.2e}: {why}); dscale, dbias {err_p:.3e} of their max | "
              f"kernel {ms:.4f} ms (f32 inputs, same call: {f32_ms:.4f} ms, "
              f"x{f32_ms / ms:.2f}) | plain {plain_ms:.4f} ms | {text}")
        if not err <= tol * top or not err_p <= 1e-4:
            fail(f"{label}: dx error {err / top:.3e} of max, dscale/dbias {err_p:.3e}")
        del args, got, ref
    for shape, names in zip(gn_shapes, gn_bwd_kernels(gn_shapes, "bfloat16")):
        print(f"[train_bf16] bf16 gn_bwd {shape[4]} {list(shape[:4])}: device kernels of "
              f"one wrapper call (fresh process): {json.dumps(names)}")
        if sum(names.values()) != 1:
            fail(f"the bf16 GroupNorm backward ran {names}, not one device kernel")

    for b in (BWD_B, TRAIN_BATCHES[-1]):
        kernels_conv_dw_bf16(b, device, gen, results)
    names = conv_dw_kernels()
    print(f"[train_bf16] bf16 conv_dw AM conv2 [{BWD_B}, {AM_T}, 81, 32]: device kernels of "
          f"one wrapper call (fresh process): {json.dumps(names)}")
    if (sorted(names.values()) != [1, 1] or not any("conv_dw_mma_kernel" in n for n in names)
            or not any("conv_dw_reduce_kernel" in n for n in names)):
        fail(f"a bf16 conv_dw call ran {names}, not the tensor-core kernel and the reduction "
             "once each")


def kernels_conv_dw_bf16(b: int, device, gen, results: dict) -> None:
    """B6 on bf16 x and dy at the AM's conv2 (x [b, 401, 81, 32], ragged dy)
    against its plain version on the same values: the tensor-core route
    ("mma"), one launch a call, f32 dW, the same bits on two runs; timed in
    turns with the f32 route on the f32 inputs, beside the plain version and
    cuDNN's bf16 weight gradient on the same bf16 tensors, which it must
    beat."""
    import torch
    import torch.nn.functional as F
    from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
    from aas_enhancement_tpu_torch.ops.masking import time_mask

    bf16, f32 = torch.bfloat16, torch.float32
    label = f"bf16 conv_dw AM conv2 11x21 s(1,2) x [{b}, {AM_T}, 81, 32]"
    frames = torch.tensor((BWD_AM_FRAMES * (b // BWD_B + 1))[:b], device=device)
    x32 = torch.randn(b, AM_T, 81, 32, generator=gen).to(device)
    dy32 = (torch.randn(b, AM_T, 41, 32, generator=gen).to(device)
            * time_mask(frames, AM_T)[:, :, None, None])
    x, dy = x32.to(bf16), dy32.to(bf16)
    before = kconv.conv_dw_same.launches
    got = kconv.conv_dw_same(x, dy, 11, 21, (1, 2))
    route = kconv.conv_dw_same.route
    again = kconv.conv_dw_same(x, dy, 11, 21, (1, 2))
    ref = kconv.conv_dw_same_plain(x, dy, 11, 21, (1, 2))
    torch.cuda.synchronize()
    if (kconv.conv_dw_same.launches != before + 2 or kconv.conv_dw_same.dtype != bf16
            or route != "mma" or got.dtype != f32 or not torch.equal(got, again)):
        fail(f"{label}: {kconv.conv_dw_same.launches - before} launches at "
             f"{kconv.conv_dw_same.dtype}, route {route}, dW {got.dtype}, same bits "
             f"{torch.equal(got, again)}")
    err = max_err(got, ref)
    rel = err / ref.abs().max().item()
    ms, f32_ms = in_turns(lambda: kconv.conv_dw_same(x, dy, 11, 21, (1, 2)),
                          lambda: kconv.conv_dw_same(x32, dy32, 11, 21, (1, 2)), 5, 1)
    plain_ms = statistics.median(cuda_ms(
        lambda: kconv.conv_dw_same_plain(x, dy, 11, 21, (1, 2)), 3, 1))
    x_nchw = F.pad(x.permute(0, 3, 1, 2), (*kconv.same_pad(81, 21, 2),
                                           *kconv.same_pad(AM_T, 11, 1)))
    cudnn = lambda: torch.nn.grad.conv2d_weight(                           # noqa: E731
        x_nchw, (32, 32, 11, 21), dy.permute(0, 3, 1, 2), stride=(1, 2))
    lib_ms = statistics.median(cuda_ms(cudnn, 5))
    work = (nbytes(x, dy, ref), 2.0 * b * AM_T * 41 * 11 * 21 * 32 * 32, PEAK_BF16_S)
    tol, why = BF16_BWD_TOL["conv_dw"]
    text = keep(results, "conv_dw", label, err, ms, plain_ms, work, lib_ms, rel_err=rel)
    row = results["conv_dw"]["shapes"][label]
    row.update(dtype="bfloat16", route=route, f32_ms=f32_ms)
    print(f"[train_bf16] {label}, ragged dy: route {route}; dW (f32) max_abs_err {err:.3e}, "
          f"{rel:.3e} of max|dW| (tol {tol:.0e}: {why}); same bits on two runs | kernel "
          f"{ms:.4f} ms (the f32 route on f32 inputs, same call: {f32_ms:.4f} ms, "
          f"x{f32_ms / ms:.2f}) | plain {plain_ms:.4f} ms | {text} (cuDNN wgrad on the bf16 "
          f"tensors, bf16 dW; x{lib_ms / ms:.2f} of the kernel's time)")
    if not rel <= tol:
        fail(f"{label}: error {rel:.3e} of max|dW| > {tol:.0e}")
    if not ms < lib_ms:
        fail(f"{label}: the kernel ({ms:.4f} ms) is not faster than cuDNN's bf16 weight "
             f"gradient ({lib_ms:.4f} ms)")


def conv_dw_kernels() -> dict:
    """{kernel name: launches} of the device kernels of one bf16 conv_dw
    wrapper call at the AM's conv2 (B=8), in a fresh process
    (``utils.profiling.kernel_names_in_fresh_process``)."""
    from aas_enhancement_tpu_torch.utils.profiling import kernel_names_in_fresh_process
    names, = kernel_names_in_fresh_process(f"""
from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
x = torch.randn({BWD_B}, {AM_T}, 81, 32, device="cuda").bfloat16()
dy = torch.randn({BWD_B}, {AM_T}, 41, 32, device="cuda").bfloat16()
calls = [lambda: kconv.conv_dw_same(x, dy, 11, 21, (1, 2))]
""")
    return names


def check_step_bf16(what: str, aux_cpu, aux_gpu, grads_cpu, grads_gpu, lam: float) -> None:
    """Card vs CPU of one bf16 step: metrics (``BF16_STEP_TOL``) and each
    gradient tensor (``BF16_GRAD_TOL``, the tensor's norm; ``BF16_GRAD_ZERO``)."""
    tol, why = BF16_STEP_TOL
    rel = {k: abs(float(aux_gpu[k]) - float(v)) / max(abs(float(v)), 1e-6)
           for k, v in aux_cpu.items()}
    worst = max(rel, key=rel.get)
    print(f"[train_bf16] {what}, card vs CPU: metrics "
          f"{json.dumps({k: round(float(v), 6) for k, v in aux_gpu.items()})}; largest "
          f"relative difference {rel[worst]:.3e} ({worst}) (tol {tol:.0e}: {why})")
    if set(aux_gpu) != set(aux_cpu) or not rel[worst] <= tol:
        fail(f"{what}: card vs CPU metrics differ: {rel}")
    gtol, gwhy = BF16_GRAD_TOL[lam]
    bad = []
    for net, grads in grads_cpu.items():
        scale = max(v.abs().max().item() for v in grads.values())
        errs = {}
        for n, v in grads.items():
            d = grads_gpu[net][n].cpu() - v
            if grads_gpu[net][n].dtype != v.dtype:
                bad.append(f"{net} {n}: {grads_gpu[net][n].dtype}")
            if v.abs().max().item() > BF16_GRAD_ZERO * scale:
                errs[n] = (d.norm() / v.norm()).item()
                if not errs[n] <= gtol:
                    bad.append(f"{net} {n}: {errs[n]:.3e} of its norm")
            else:
                errs[n] = d.abs().max().item() / scale
                if not errs[n] <= BF16_GRAD_ZERO:
                    bad.append(f"{net} {n}: {errs[n]:.3e} of the network's max|g|")
        w = max(errs, key=errs.get)
        print(f"[train_bf16] {net.upper()} gradients ({len(errs)} tensors, float32): largest "
              f"difference {errs[w]:.3e} of the tensor's norm at {w} (tol {gtol}: {gwhy}); "
              f"per tensor {json.dumps({n: float(f'{e:.3e}') for n, e in errs.items()})}")
    if bad:
        fail(f"{what}: card vs CPU bf16 gradients differ: {bad}")


def phase_train_bf16(device, card, results: dict):
    """Training at bf16 on the card (``dtype="bfloat16"``, shipped widths):
    the bf16 backward kernels against their plain versions
    (``kernels_bf16_backward``); one bf16 step of the aas, am and paired
    (MR-STFT term on) objectives card vs CPU at B=4 x BF16_SECONDS; each
    step's launches at B=8 with every GroupNorm, LSTM, GRU and conv_dw
    wrapper's last launch, forward and backward, on bf16 streams; the three
    steps at B=8 and B=32 x 8 s timed bf16 beside f32 (in turns) with their
    peak memory, and the aas step at B=128 x 8 s (the JAX package's
    production shape); cli.train with a bf16 --config for two steps of each
    objective and of the blockwise am variant, and an am run saved at step 2
    and continued to step 3.  -> {path: launches}."""
    import torch
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.state import TrainState
    from aas_enhancement_tpu_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    kernels_bf16_backward(device, results)
    gen = torch.Generator().manual_seed(23)
    lam = {"aas": 0.0, "am": 0.0, "paired": 0.5}

    def config(objective: str, b: int, dtype: str):
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective=objective,
                                                    batch_size=b,
                                                    lambda_mrstft=lam[objective]))
        return bf16_config(cfg) if dtype == "bf16" else cfg

    def batch_of(objective: str, b: int, lengths: list[int]) -> dict:
        if objective == "paired":
            return paired_batch(b, gen, lengths)
        full = train_batch(b, gen, lengths)
        return {k: v for k, v in full.items()
                if objective != "am" or not k.startswith("clean")}

    # One bf16 step of each objective, card vs CPU, at B=4 x BF16_SECONDS.
    n = SR * BF16_SECONDS
    for objective in ("aas", "am", "paired"):
        cfg = config(objective, B, "bf16")
        state_cpu = init_state(cfg, cfg.train.seed, "cpu", am_seed=0)
        state_gpu = TrainState(**{k: copy.deepcopy(getattr(state_cpu, k)).to(device)
                                  for k in ("g", "d", "am") if getattr(state_cpu, k) is not None})
        batch = {k: v[:, :n].contiguous() if v.ndim == 2 and v.shape[1] == N else v
                 for k, v in batch_of(objective, B, [n, n - 4000, n - 8000, n // 2]).items()}
        step = make_train_step(cfg)
        t0 = time.perf_counter()
        grads_cpu, aux_cpu = step.batch_grads(state_cpu, batch)
        cpu_s = time.perf_counter() - t0
        grads_gpu, aux_gpu = step.batch_grads(state_gpu, {k: v.to(device)
                                                          for k, v in batch.items()})
        torch.cuda.synchronize()
        check_step_bf16(f"one bf16 {objective} step B={B} x {BF16_SECONDS} s (lambda_mrstft "
                        f"{lam[objective]}; CPU plain path {cpu_s:.2f} s)", aux_cpu, aux_gpu,
                        grads_cpu, grads_gpu, lam[objective])
        del state_cpu, state_gpu, grads_cpu, grads_gpu

    # Launches of one bf16 step at B=8, then the steps timed bf16 beside f32.
    by_path = {}
    for objective in ("aas", "am", "paired"):
        names = BF16_STEP_KERNELS[objective]
        states = {dt: init_state(config(objective, B, dt), Config().train.seed, device,
                                 am_seed=0) for dt in ("f32", "bf16")}
        for b in TRAIN_BATCHES:
            steps = {dt: make_train_step(config(objective, b, dt)) for dt in states}
            batch = {k: v.to(device) for k, v in batch_of(objective, b, [N]).items()}
            if b == BWD_B:
                path = f"{objective}_step_bf16"
                by_path[path] = counted(names, lambda: steps["bf16"](states["bf16"], batch))
                check_bf16_launches(f"one bf16 {objective} step", by_path[path],
                                    BF16_STEP_STREAMS[objective])
                print(f"[train_bf16] launches of one bf16 {objective} step B={b}: "
                      f"{json.dumps(by_path[path])}; {', '.join(BF16_STEP_STREAMS[objective])} "
                      "on bf16 streams")
            walls, peak = {"f32": [], "bf16": []}, {}
            for dt in ("f32", "bf16", "bf16", "f32"):          # in turns
                torch.cuda.reset_peak_memory_stats()
                for i in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _, aux = steps[dt](states[dt], batch)
                    torch.cuda.synchronize()
                    if i >= 1:
                        walls[dt].append(time.perf_counter() - t0)
                peak[dt] = max(peak.get(dt, 0), torch.cuda.max_memory_allocated() / 2**30)
                if not all(abs(float(v)) < float("inf") for v in aux.values()):
                    fail(f"non-finite {dt} {objective} metrics at B={b}: {aux}")
            wall = {dt: statistics.median(w) * 1e3 for dt, w in walls.items()}
            print(f"[train_bf16] B={b} x {SECONDS} s {objective} step on {card}: bf16 "
                  f"{wall['bf16']:.2f} ms/step, f32 {wall['f32']:.2f} (f32 / bf16 "
                  f"x{wall['f32'] / wall['bf16']:.2f}); peak device memory bf16 "
                  f"{peak['bf16']:.2f} GiB, f32 {peak['f32']:.2f} GiB (both states resident; "
                  f"medians of 6 after a warmup, in turns; walls ms "
                  f"{json.dumps({dt: [round(x * 1e3, 2) for x in w] for dt, w in walls.items()})})")
            del steps, batch
        del states

    # The aas step at the JAX package's production shape (bench.py), bf16.
    b = BF16_B_PRODUCTION
    state = init_state(config("aas", b, "bf16"), Config().train.seed, device, am_seed=0)
    step = make_train_step(config("aas", b, "bf16"))
    batch = {k: v.to(device) for k, v in batch_of("aas", b, [N]).items()}
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, aux = step(state, batch)
        torch.cuda.synchronize()
        if i >= 1:
            walls.append(time.perf_counter() - t0)
    if not all(abs(float(v)) < float("inf") for v in aux.values()):
        fail(f"non-finite bf16 aas metrics at B={b}: {aux}")
    wall = statistics.median(walls)
    print(f"[train_bf16] B={b} x {SECONDS} s aas step (bf16, the JAX package's production "
          f"shape) on {card}: {wall * 1e3:.2f} ms/step, {b / wall:.2f} utterances/s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (median of "
          f"{len(walls)} after a warmup; walls ms {[round(w * 1e3, 2) for w in walls]})")
    del state, step, batch

    # cli.train with a bf16 --config: two steps of each objective, the
    # blockwise am variant, and an am run saved at step 2 and continued to 3.
    cli_k = ("stft", "istft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd", "gn_bwd",
             "conv_dw", "stft_vjp", "istft_vjp")
    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1, word_len=(2, 6))
        cfg_path = os.path.join(tmp, "bf16.json")
        cfg = bf16_config(Config())
        with open(cfg_path, "w") as f:
            f.write(cfg.replace(train=dataclasses.replace(cfg.train,
                                                          lambda_mrstft=0.5)).to_json())
        common = ["--batch-size", str(B), "--log-every", "1", "--config", cfg_path,
                  "--am-checkpoint", "seed:0", "--device", "cuda"]
        runs = [(obj, ["--objective", obj, "--noisy-manifest", m["noisy"],
                       "--clean-manifest", m["clean"]]) for obj in
                ("aas", "adversarial", "acoustic", "paired")]
        runs.append(("am", ["--objective", "am", "--noisy-manifest", m["clean"]]))
        runs.append(("am --streaming-finetune-am",
                     ["--objective", "am", "--noisy-manifest", m["clean"],
                      "--streaming-finetune-am"]))
        ck = os.path.join(tmp, "ck_am")
        runs.append(("am --checkpoint-dir", ["--objective", "am", "--noisy-manifest",
                                             m["clean"], "--checkpoint-dir", ck]))
        for tag, argv in runs:
            line, records, launches = _cli_run(f"cli.train --objective {tag} (bf16 config)",
                                               train_cli.main, argv + common + ["--steps", "2"],
                                               "train_bf16", cli_k)
            if (line.get("final_step") != 2 or [r["step"] for r in records] != [1, 2]
                    or not all(abs(v) < float("inf") for k, v in line.items()
                               if k.startswith("loss"))):
                fail(f"cli.train {tag} (bf16) printed {line} after {records}")
            streams = [k for k in ("gn_act", "gn_bwd", "lstm", "lstm_bwd", "gru", "gru_bwd",
                                   "conv_dw") if launches.get(k)]
            check_bf16_launches(f"cli.train {tag} (bf16)", launches, streams)
            by_path["cli_train_bf16_" + re.sub(r"\W+", "_", tag).strip("_")] = launches
        line, records, _ = _cli_run(
            "cli.train --objective am --steps 3 --checkpoint-dir --continue-from (bf16)",
            train_cli.main, ["--objective", "am", "--noisy-manifest", m["clean"],
                             "--checkpoint-dir", ck, "--continue-from", *common,
                             "--steps", "3"], "train_bf16", cli_k)
        saved = json.loads(open(os.path.join(ck, "config.json")).read())
        if (line.get("final_step") != 3 or [r["step"] for r in records] != [3]
                or saved["am"]["dtype"] != "bfloat16"):
            fail(f"the continued bf16 am run printed {line} after {records}, its "
                 f"directory's AM dtype {saved['am']['dtype']}")
        print(f"[train_bf16] the bf16 am run saved at step 2 continued to step 3 from "
              f"{sorted(os.listdir(ck))}: {json.dumps(line)}")
    return by_path


def train_batch(b: int, gen, lengths: list[int]) -> dict:
    """An AAS batch of b utterances (sine + noise, valid up to ``lengths``),
    ragged transcripts of up to 48 labels and an unpaired clean batch, all
    rows real (weight 1), on the CPU."""
    import torch
    reps = -(-b // len(lengths))
    lens = torch.tensor((lengths * reps)[:b], dtype=torch.int32)
    t = torch.arange(N) / SR
    valid = torch.arange(N)[None] < lens[:, None]
    wav = (0.4 * torch.sin(2 * torch.pi * 440.0 * t)[None]
           + 0.2 * torch.randn(b, N, generator=gen)) * valid
    clean = 0.3 * torch.randn(b, N, generator=gen) * valid.flip(0)
    u = 48
    n_labels = torch.tensor(([48, 40, 30, 20] * reps)[:b])
    return {"wav": wav, "wav_lengths": lens,
            "labels": torch.randint(1, 29, (b, u), generator=gen, dtype=torch.int32),
            "label_paddings": (torch.arange(u)[None] >= n_labels[:, None]).float(),
            "clean_wav": clean, "clean_wav_lengths": lens.flip(0),
            "row_weights": torch.ones(b), "clean_row_weights": torch.ones(b)}


def phase_train(device, card):
    import torch
    from aas_enhancement_tpu_torch.cli import train as cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.state import TrainState
    from aas_enhancement_tpu_torch.train.steps import make_train_step

    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))
        out, err = io.StringIO(), io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                cli.main(["--objective", "aas", "--noisy-manifest", manifests["noisy"],
                          "--clean-manifest", manifests["clean"], "--steps", "3",
                          "--batch-size", "4", "--am-checkpoint", "seed:0",
                          "--device", "cuda"])

        launches = counted(("stft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd",
                            "gn_bwd"), run_cli)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    records = [json.loads(r) for r in err.getvalue().splitlines() if r.startswith("{")]
    for r in records:
        print(f"[train] record {json.dumps(r)}")
    print(f"[train] cli.train --objective aas --steps 3 --batch-size 4 --device cuda: "
          f"{json.dumps(line)} | launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the train run launched no {name} kernel")
    if (line.get("final_step") != 3 or records[-1]["step"] != 3
            or set(line) != {"final_step", "loss_ctc", "loss_adv_g", "loss_g", "loss_d"}
            or not all(abs(v) < float("inf") for v in line.values())):
        fail(f"cli.train printed {line} after records {[r['step'] for r in records]}")

    # One AAS step, card vs CPU, from the same weights and batch: metrics and
    # the G and D gradients (not post-Adam parameters: the first Adam step
    # moves near-zero gradients by up to +-lr).
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B))
    gen = torch.Generator().manual_seed(3)
    state_cpu = init_state(cfg, cfg.train.seed, "cpu", am_seed=0)
    state_gpu = TrainState(g=copy.deepcopy(state_cpu.g).to(device),
                           d=copy.deepcopy(state_cpu.d).to(device),
                           am=copy.deepcopy(state_cpu.am).to(device))
    batch = train_batch(B, gen, LENGTHS)
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    grads_cpu, aux_cpu = step.batch_grads(state_cpu, batch)
    cpu_s = time.perf_counter() - t0
    grads_gpu, aux_gpu = step.batch_grads(state_gpu, {k: v.to(device) for k, v in batch.items()})
    torch.cuda.synchronize()
    check_step("train", f"one AAS step B={B} x {SECONDS} s (CPU plain path {cpu_s:.2f} s)",
               aux_cpu, aux_gpu, grads_cpu, grads_gpu, TRAIN_GRAD_TOL)

    for b in TRAIN_BATCHES:
        cfg_b = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=b))
        state = init_state(cfg_b, cfg.train.seed, device, am_seed=0)
        step_b = make_train_step(cfg_b)
        batch = {k: v.to(device) for k, v in train_batch(b, gen, [N]).items()}
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, aux = step_b(state, batch)
            torch.cuda.synchronize()
            if i >= 2:
                walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        if not all(abs(float(v)) < float("inf") for v in aux.values()):
            fail(f"non-finite AAS metrics at B={b}: {aux}")
        print(f"[train] B={b} x {SECONDS} s AAS step on {card}, TF32 off: "
              f"{wall * 1e3:.2f} ms/step, {b / wall:.2f} utterances/s, "
              f"{b * SECONDS / wall:.1f} s of audio per s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (median of "
              f"{len(walls)} after 2 warmups; walls ms {[round(w * 1e3, 2) for w in walls]})")
        del state, batch
    return launches


def phase_birnn(device):
    """BiRNN(time_major=False), the route to the stacked-layout kernels:
    output and gradients (x, wx, wh, bh) against BiRNN(time_major=True) with
    the same weights on the transposed input, both on the card."""
    import torch
    from aas_enhancement_tpu_torch.convert import init_like_flax
    from aas_enhancement_tpu_torch.ops.rnn import BiRNN

    gen = torch.Generator().manual_seed(11)
    pairs = []
    for cell, d, h, t_len, lens in (("lstm", 256, 256, 1 + N // 160, BWD_FRAMES),
                                    ("gru", 512, 512, AM_T, BWD_AM_FRAMES)):
        tm = init_like_flax(BiRNN(d, h, cell=cell), gen).to(device)
        with torch.no_grad():
            tm.bh.copy_(0.1 * torch.randn(tm.bh.shape, generator=gen))
        bm = BiRNN(d, h, cell=cell, time_major=False, device=device)
        bm.load_state_dict(tm.state_dict())
        x = torch.randn(BWD_B, t_len, d, generator=gen).to(device).requires_grad_()
        cot = torch.randn(BWD_B, t_len, h, generator=gen).to(device)
        pairs.append((cell, h, t_len, tm, bm, x, cot, torch.tensor(lens, device=device)))

    got = {}

    def run():
        for cell, _, _, _, bm, x, cot, lens in pairs:
            y = bm(x, lens)
            got[cell] = (y, torch.autograd.grad(y, (x, *bm.parameters()), cot))
        torch.cuda.synchronize()

    launches = counted(STACKED, run)
    for cell, h, t_len, tm, _, x, cot, lens in pairs:
        y_ref = tm(x.transpose(0, 1), lens).transpose(0, 1)
        ref = torch.autograd.grad(y_ref, (x, *tm.parameters()), cot)
        y, grads = got[cell]
        err = max_err(y, y_ref)
        rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(grads, ref))
        tol, why = TOL[cell]
        gtol = BWD_TOL[f"{cell}_bwd"][0]
        print(f"[birnn] {cell} BiRNN(time_major=False) [{BWD_B}, {t_len}, {h}] vs "
              f"time_major=True on the transposed input: y max_abs_err {err:.3e} (tol "
              f"{tol:.0e}: {why}); grads (x, wx.kernel, wx.bias, wh, bh) relative to "
              f"max|grad| {rel:.3e} (tol {gtol:.0e})")
        if not (err <= tol and rel <= gtol):
            fail(f"birnn {cell}: batch-major and time-major routes differ")
    print(f"[birnn] launches {json.dumps(launches)}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the batch-major BiRNN run launched no {name} kernel")
    return launches


AM_KERNELS = ("stft", "gn_act", "gru", "gru_bwd", "gn_bwd", "conv_dw")


def am_batch(b: int, gen, lengths: list[int], device) -> dict:
    """The noisy rows, transcripts and weights of ``train_batch``, on ``device``."""
    return {k: v.to(device) for k, v in train_batch(b, gen, lengths).items()
            if not k.startswith("clean")}


def phase_train_am(device, card):
    import torch
    from aas_enhancement_tpu_torch.cli import train as cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.state import TrainState, am_sgd, apply_update
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    from aas_enhancement_tpu_torch.utils.profiling import device_kernel_names

    steps, batch_size = 3, 4
    out, err = io.StringIO(), io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))

        def run_cli():
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                cli.main(["--objective", "am", "--noisy-manifest", manifests["clean"],
                          "--steps", str(steps), "--batch-size", str(batch_size),
                          "--am-checkpoint", "seed:0", "--device", "cuda"])

        launches = counted(AM_KERNELS, run_cli)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    records = [json.loads(r) for r in err.getvalue().splitlines() if r.startswith("{")]
    for r in records:
        print(f"[train_am] record {json.dumps(r)}")
    print(f"[train_am] cli.train --objective am --steps {steps} --batch-size {batch_size} "
          f"--device cuda: {json.dumps(line)} | launches {json.dumps(launches)}")
    layers = Config().am.rnn_layers
    want = {"stft": steps, "gn_act": 2 * steps, "gn_bwd": 2 * steps, "conv_dw": steps,
            "gru": layers * steps, "gru_bwd": layers * steps}
    if launches != want:
        fail(f"the am run's launches {launches} are not {want} (per step: conv_dw 1, "
             f"gru and gru_bwd {layers})")
    if (line.get("final_step") != steps or records[-1]["step"] != steps
            or set(line) != {"final_step", "loss_ctc_am"}
            or not all(abs(v) < float("inf") for v in line.values())
            or "am_grad_norm" not in records[-1]):
        fail(f"cli.train printed {line} after records {records}")

    # One AM step, card vs CPU, from the same weights and batch: metrics,
    # every gradient tensor, and the parameters after the update.
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="am", batch_size=B))
    gen = torch.Generator().manual_seed(4)
    state_cpu = init_state(cfg, cfg.train.seed, "cpu", am_seed=0)
    am_gpu = copy.deepcopy(state_cpu.am).to(device)
    state_gpu = TrainState(am=am_gpu, am_opt=am_sgd(cfg, am_gpu.parameters(),
                                                    cfg.train.lr_am))
    batch = am_batch(B, gen, LENGTHS, "cpu")
    step = make_train_step(cfg)
    t0 = time.perf_counter()
    grads_cpu, aux_cpu = step.batch_grads(state_cpu, batch)
    cpu_s = time.perf_counter() - t0
    batch_gpu = {k: v.to(device) for k, v in batch.items()}
    grads_gpu, aux_gpu = step.batch_grads(state_gpu, batch_gpu)
    torch.cuda.synchronize()
    check_step("train_am", f"one AM step B={B} x {SECONDS} s (CPU plain path {cpu_s:.2f} s)",
               aux_cpu, aux_gpu, grads_cpu, grads_gpu, {"am": AM_GRAD_TOL})
    norms = []
    for st, grads in ((state_cpu, grads_cpu), (state_gpu, grads_gpu)):    # the update
        names = [n for n, _ in st.am.named_parameters()]
        norms.append(float(apply_update(
            st.am_opt, list(st.am.parameters()), [grads["am"][n] for n in names],
            cfg.train.lr_am, cfg.train.max_grad_norm)))
    ptol, pwhy = AM_PARAM_TOL
    perr = max((p.detach().cpu() - q.detach()).abs().max().item()
               for p, q in zip(state_gpu.am.parameters(), state_cpu.am.parameters()))
    print(f"[train_am] parameters after the clipped SGD update, card vs CPU: max_abs_err "
          f"{perr:.3e} (tol {ptol:.0e}: {pwhy}); am_grad_norm {norms[1]:.3f} (CPU "
          f"{norms[0]:.3f})")
    if not perr <= ptol:
        fail(f"card vs CPU updated AM parameters differ by {perr:.3e}")
    del state_cpu, state_gpu, am_gpu

    # Kernel names of one B=8 step with conv2's dW from the kernel (the
    # default) and from cuDNN: the names only the cuDNN run shows are conv2's
    # cuDNN weight-gradient kernels, and the default run has none of them.
    cfg8 = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=BWD_B))
    state = init_state(cfg8, cfg.train.seed, device, am_seed=0)
    step8 = make_train_step(cfg8)
    batch8 = am_batch(BWD_B, gen, [N], device)
    step8(state, batch8)                                       # warm up
    names = {}
    for impl in ("auto", "cudnn"):
        state.am.conv2.dw_impl = impl
        names[impl] = device_kernel_names(lambda: step8(state, batch8))
    state.am.conv2.dw_impl = "auto"
    ours = {n: c for n, c in names["auto"].items() if "conv_dw" in n}
    only_cudnn = {n: c for n, c in names["cudnn"].items()       # PyTorch's own
                  if c > names["auto"].get(n, 0)                # elementwise kernels
                  and "at::native" not in n and not n.startswith("Mem")}   # aside
    print(f"[train_am] one B={BWD_B} step's device kernels: conv2 dW by the kernel: "
          f"{json.dumps(ours)}; library kernels that only the dw_impl='cudnn' "
          f"run launches (or launches more often): {json.dumps(only_cudnn)}")
    if (sorted(ours.values()) != [1, 1] or any("conv_dw" in n for n in names["cudnn"])
            or not only_cudnn):
        fail("the default AM step does not take conv2's dW from the kernel alone: "
             f"{ours}, only with cudnn: {only_cudnn}")
    del state

    variants = [(b, {}) for b in TRAIN_BATCHES]
    variants.append((BWD_B, {"spec_augment": True, "distill_lambda": 0.5}))
    for b, extra in variants:
        cfg_b = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=b, **extra))
        state = init_state(cfg_b, cfg.train.seed, device, am_seed=0)
        anchor = (copy.deepcopy(state.am).requires_grad_(False)
                  if extra.get("distill_lambda") else None)
        step_b = make_train_step(cfg_b, anchor_am=anchor)
        batch = am_batch(b, gen, [N], device)
        torch.cuda.reset_peak_memory_stats()
        walls = []

        def timed():
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, aux = step_b(state, batch)
                torch.cuda.synchronize()
                if i >= 2:
                    walls.append(time.perf_counter() - t0)
            return aux

        aux = {}
        per_step = {k: v / 7 for k, v in counted(
            AM_KERNELS, lambda: aux.update(timed())).items()}
        wall = statistics.median(walls)
        if not all(abs(float(v)) < float("inf") for v in aux.values()):
            fail(f"non-finite AM metrics at B={b}: {aux}")
        if extra and set(aux) != {"loss_ctc_am", "loss_distill", "loss_am_total",
                                  "am_grad_norm"}:
            fail(f"the anchored AM step's metrics are {sorted(aux)}")
        what = "AM step" + (" with SpecAugment and the KL anchor (lambda 0.5)" if extra else "")
        print(f"[train_am] B={b} x {SECONDS} s {what} on {card}, TF32 off: "
              f"{wall * 1e3:.2f} ms/step, {b / wall:.2f} utterances/s, "
              f"{b * SECONDS / wall:.1f} s of audio per s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches per step "
              f"{json.dumps(per_step)} (median of {len(walls)} after 2 warmups; walls ms "
              f"{[round(w * 1e3, 2) for w in walls]})")
        del state, batch, anchor
    return launches


# Data parallelism (phase dp): 2 ranks on one card over gloo against 1 rank.
DP_RANKS = 2
DP_B = 8                               # the global batch: 4 rows a rank
DP_STEPS = 3
DP_TOL = (1e-4, "the same step on 4 rows a rank, its gradients summed by one all-reduce "
          "a network, against 8 rows in one process: cuBLAS / cuDNN may pick other "
          "algorithms at another batch, and the sums run in another order")
# Each gradient tensor against its own max|g|, by the step's dtype.  Measured
# on an H100: f32 2.0e-05 (AAS), 2.3e-06 (AM), bf16 4.2e-03 (AM).
DP_GRAD_TOL = {
    "float32": (1e-3, "as the card-vs-CPU step limits: f32 sums of 3208-6408 frames' "
                "products that cancel, in two halves here"),
    "bfloat16": (2.0 ** -6, "bf16 gradients: a rank's share is rounded to bf16 (one ulp "
                 "2^-8 of its value) before the all-reduce sums the two, the 1-rank "
                 "gradient once; 4 ulps at the top")}
DP_CASES = {"aas": ("stft", "gn_act", "lstm", "lstm_bwd", "gru", "gru_bwd", "gn_bwd"),
            "am": ("stft", "gn_act", "gru", "gru_bwd", "gn_bwd", "conv_dw"),
            # am's step at f32, the same batch and SpecAugment: the DP path
            # without bf16 rounding, held to the f32 limit.
            "am_f32": ("stft", "gn_act", "gru", "gru_bwd", "gn_bwd", "conv_dw")}


def dp_case(name: str):
    """(config, global CPU batch) of the [dp] phase's ``name`` run: ``aas`` at
    f32, ``am`` at bf16 with SpecAugment, ``am_f32`` as ``am`` at f32; full
    width, B=DP_B x 8 s, ragged, the same in every process (a fixed seed)."""
    import torch
    from aas_enhancement_tpu_torch.config import Config
    cfg = Config()
    objective = name.split("_")[0]
    train = dataclasses.replace(cfg.train, objective=objective, batch_size=DP_B,
                                spec_augment=objective == "am")
    cfg = cfg.replace(train=train)
    if name == "am":
        cfg = bf16_config(cfg)
    batch = train_batch(DP_B, torch.Generator().manual_seed(21), LENGTHS)
    if objective == "am":
        batch = {k: v for k, v in batch.items() if not k.startswith("clean")}
    return cfg, batch


def dp_steps(step, state, batch) -> tuple[dict, list[float]]:
    """DP_STEPS steps, each wall on the host clock around a synchronized call."""
    import torch
    walls = []
    for _ in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, aux = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    if not all(abs(float(v)) < float("inf") for v in aux.values()):
        fail(f"non-finite metrics {aux}")
    return aux, walls


def dp_rank(rank: str, store: str, out: str) -> int:
    """One rank of phase dp, on cuda:0 with gloo (``chip_smoke.py --dp-rank``):
    both runs through make_mesh, replicate_state, shard_batch and the step;
    its gradients and metrics of step 1, the launches of DP_STEPS steps, the
    walls, the all-reduce's bytes and time, the final parameters -> ``out``."""
    sys.path.insert(0, HERE)
    import torch
    from aas_enhancement_tpu_torch.config import MeshConfig
    from aas_enhancement_tpu_torch.parallel.mesh import (all_reduce_grads, make_mesh,
                                                         replicate_state, shard_batch)
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MeshConfig(num_devices=DP_RANKS), "cuda:0", backend="gloo",
                     init_method=f"file://{store}", rank=int(rank), world_size=DP_RANKS)
    res = {}
    try:
        for name, kernels in DP_CASES.items():
            cfg, batch = dp_case(name)
            state = init_state(cfg, cfg.train.seed, mesh.device, am_seed=0)
            replicate_state(mesh, state)
            step = make_train_step(cfg, mesh=mesh)
            local = shard_batch(mesh, batch, cfg.train.grad_accum)
            grads, aux = step.batch_grads(state, local)        # step 1's, and a warmup
            walls = []
            launches = counted(kernels, lambda: walls.extend(dp_steps(step, state, local)[1]))
            if name == "am":
                check_bf16_launches(f"dp rank {rank} am", launches, BF16_STEP_STREAMS["am"])
            reduce_ms = []
            for _ in range(5):
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                all_reduce_grads(mesh, grads, aux)
                torch.cuda.synchronize()
                reduce_ms.append((time.perf_counter() - t0) * 1e3)
            res[name] = {
                "rows": local["wav"].shape[0], "launches": launches, "walls": walls,
                "aux": {k: float(v) for k, v in aux.items()},
                "grads": {net: {n: g.detach().cpu() for n, g in gs.items()}
                          for net, gs in grads.items()},
                "reduce_ms": reduce_ms,
                "reduce_bytes": sum(g.numel() * g.element_size()
                                    for gs in grads.values() for g in gs.values()),
                "params": {net: {n: p.detach().cpu() for n, p in
                                 getattr(state, net).named_parameters()}
                           for net in ("g", "d", "am") if getattr(state, net) is not None},
                "devices": sorted({str(p.device) for net in ("g", "d", "am")
                                   if getattr(state, net) is not None
                                   for p in getattr(state, net).parameters()})}
            del state, step, local, grads
    finally:
        mesh.close()
    res["imported"] = [m for m in sys.modules
                       if m.split(".")[0] in ("jax", "flax", "aas_enhancement_tpu")]
    torch.save(res, out)
    return 0


def phase_dp(device, card):
    """Phase dp: DP_RANKS processes on this one card over gloo (nccl needs a
    card a rank), full width, against one process on the card; then the
    train CLI under torchrun with nccl (one rank)."""
    import torch
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.steps import make_train_step

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
             os.path.join(tmp, "store"), os.path.join(tmp, f"rank{r}.pt")],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_RANKS)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=400)[0])
        except subprocess.TimeoutExpired:
            logs.append("timed out after 400 s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if [p.returncode for p in procs] != [0] * DP_RANKS:
            fail(f"a dp rank failed ({[p.returncode for p in procs]}):\n"
                 + "\n---\n".join(log[-3000:] for log in logs))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(DP_RANKS)]

    by_path = {}
    for name, kernels in DP_CASES.items():
        cfg, batch = dp_case(name)
        what = (f"{name} step at {cfg.am.dtype}"
                + (" with SpecAugment" if cfg.train.spec_augment else "")
                + f", B={DP_B} x {SECONDS} s")
        for r, res in enumerate(ranks):
            got = res[name]
            by_path[f"dp_{name}_rank{r}"] = got["launches"]
            print(f"[dp] rank {r} of {DP_RANKS} on {got['devices']} over gloo, {got['rows']} "
                  f"rows, {what}: launches of {DP_STEPS} steps {json.dumps(got['launches'])}")
            if got["devices"] != ["cuda:0"] or any(got["launches"][k] < 1 for k in kernels):
                fail(f"dp rank {r} {name}: not every kernel ran on the card: {got}")
            if res["imported"]:
                fail(f"dp rank {r} imported {res['imported'][:5]}")
        for net in ranks[0][name]["params"]:
            for n, p in ranks[0][name]["params"][net].items():
                if not torch.equal(p, ranks[1][name]["params"][net][n]):
                    fail(f"dp {name}: {net} {n} differs between the ranks after "
                         f"{DP_STEPS} steps")
        print(f"[dp] {name}: the parameters of both ranks are equal, bit for bit, after "
              f"{DP_STEPS} steps")

        # One rank on the card: step 1's metrics and gradients, then the walls.
        state = init_state(cfg, cfg.train.seed, device, am_seed=0)
        step = make_train_step(cfg)
        whole = {k: v.to(device) for k, v in batch.items()}
        grads, aux = step.batch_grads(state, whole)
        grads = {net: {n: g.cpu() for n, g in gs.items()} for net, gs in grads.items()}
        _, walls1 = dp_steps(step, state, whole)
        got = ranks[0][name]
        check_step("dp", f"one {what}", aux, got["aux"], grads, got["grads"],
                   {net: DP_GRAD_TOL[cfg.am.dtype] for net in grads}, DP_TOL,
                   sides=f"{DP_RANKS} ranks vs 1 on the card")
        ms = [statistics.median(res[name]["reduce_ms"]) for res in ranks]
        print(f"[dp] {what} on {card}, TF32 off: 1 rank at B={DP_B} walls ms "
              f"{[round(w, 2) for w in walls1]}; {DP_RANKS} ranks at B={DP_B // DP_RANKS} "
              f"sharing the card, walls ms "
              f"{[[round(w, 2) for w in res[name]['walls']] for res in ranks]}; "
              f"all-reduce of the gradients and metrics {got['reduce_bytes'] / 1e6:.2f} MB "
              f"a step, {[round(m, 3) for m in ms]} ms (median of 5 a rank; gloo, through "
              f"host copies)")
        del state, step, whole

    with tempfile.TemporaryDirectory() as tmp:
        manifests = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                                    word_len=(2, 6))
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
             "1", "-m", "aas_enhancement_tpu_torch.cli.train", "--objective", "am",
             "--noisy-manifest", manifests["clean"], "--steps", "2", "--batch-size", "4",
             "--am-checkpoint", "seed:0", "--dist-backend", "nccl"],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    lines = r.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if r.returncode == 0 and lines else {}
    print(f"[dp] torchrun --standalone --nproc_per_node 1 -m aas_enhancement_tpu_torch.cli."
          f"train --objective am --steps 2 --batch-size 4 --dist-backend nccl: "
          f"{json.dumps(line)} in {time.perf_counter() - t0:.1f} s")
    if line.get("final_step") != 2:
        fail(f"the nccl torchrun run exited {r.returncode}: {r.stdout[-2000:]} "
             f"{r.stderr[-3000:]}")
    return by_path


CKPT_KERNELS = ("stft", "istft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd",
                "gn_bwd", "conv_dw")


def _cli_run(tag: str, main, argv: list[str], phase: str = "checkpoint",
             names: tuple = CKPT_KERNELS) -> tuple[dict, list[dict], dict]:
    """Drive one CLI with the launches of ``names`` counted -> (last stdout
    line, stderr records, launches)."""
    out, err = io.StringIO(), io.StringIO()

    def run():
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main(argv)

    t0 = time.perf_counter()
    launches = counted(names, run)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    records = [json.loads(r) for r in err.getvalue().splitlines() if r.startswith("{")]
    print(f"[{phase}] {tag}: {time.perf_counter() - t0:.2f} s, {json.dumps(line)[:400]} "
          f"| launches {json.dumps(launches)}")
    return line, records, launches


def phase_checkpoint(device, card):
    """The CLIs with real checkpoints at full width on the card: AM
    pre-training saved at step 2 and resumed to 4 (against an uninterrupted
    run), the saved AM on the card against the CPU, AAS fine-tuning from it
    with validation, then evaluate and enhance from both directories."""
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
    from aas_enhancement_tpu_torch.cli import evaluate as eval_cli
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.evaluation import make_eval_forward
    from aas_enhancement_tpu_torch.train.loop import init_state, load_state
    from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

    total: dict = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def mb(path):
        return os.path.getsize(os.path.join(path, ckpt.STATE_FILE)) / 1e6

    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                            word_len=(2, 6))
        am_dir, g_dir = os.path.join(tmp, "am"), os.path.join(tmp, "g")
        am = ["--objective", "am", "--noisy-manifest", m["clean"], "--batch-size", str(B),
              "--log-every", "1", "--am-checkpoint", "seed:0", "--device", "cuda"]
        _, full, n = _cli_run("cli.train --objective am --steps 4 (uninterrupted)",
                              train_cli.main, [*am, "--steps", "4"])
        add(n)
        _, _, n = _cli_run("cli.train --objective am --steps 2 --checkpoint-dir",
                           train_cli.main, [*am, "--steps", "2", "--checkpoint-dir", am_dir])
        add(n)
        line, resumed, n = _cli_run(
            "cli.train --objective am --steps 4 --checkpoint-dir --continue-from",
            train_cli.main, [*am, "--steps", "4", "--checkpoint-dir", am_dir,
                             "--continue-from"])
        add(n)
        if line.get("final_step") != 4 or sorted(os.listdir(am_dir)) != ["2", "4",
                                                                         "config.json"]:
            fail(f"the resumed am run printed {line}, left {sorted(os.listdir(am_dir))}")
        tol, why = RESUME_TOL
        want = {r["step"]: r["loss_ctc_am"] for r in full}
        got = {r["step"]: r["loss_ctc_am"] for r in resumed}
        if sorted(got) != [3, 4]:
            fail(f"the resumed run logged steps {sorted(got)}, not 3 and 4")
        gap = max(abs(got[s] - want[s]) / abs(want[s]) for s in got)
        print(f"[checkpoint] resumed steps 3-4 against the uninterrupted run on {card}: "
              f"loss_ctc_am {json.dumps(got)} vs {json.dumps({s: want[s] for s in got})}, "
              f"largest relative difference {gap:.3e} (tol {tol:.0e}: {why})")
        if not gap <= tol or not all(abs(v) < float("inf") for v in got.values()):
            fail(f"resume gap {gap:.3e} > {tol:.0e}")

        # Save and load times and sizes, and the saved AM on the card vs the CPU.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, cfg = load_state(am_dir, device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        state_cpu, _ = load_state(am_dir, "cpu")
        if state.step != 4 or state.am is None:
            fail(f"load_state gave step {state.step}, AM {state.am is not None}")
        wav, lengths, _ = make_inputs("cpu")
        fwd = make_eval_forward(cfg, use_enhancer=False)
        logits_cpu, _ = fwd(state_cpu.am, None, wav, lengths)
        logits = fwd(state.am, None, wav.to(device), lengths.to(device))[0].cpu()
        err = (logits - logits_cpu).abs().max().item()
        rtol, rwhy = RECOGNIZE_TOL
        print(f"[checkpoint] the saved AM (step 4) on the card vs the CPU, B={B} x "
              f"{SECONDS} s noisy leg: logits max_abs_err {err:.3e} (tol {rtol:.0e}: {rwhy})")
        if not err <= rtol or not torch.isfinite(logits).all():
            fail(f"card vs CPU logits of the loaded AM differ by {err:.3e}")

        def timed_save(path, step, cfg_):
            """A save as training makes it: the restored state, optimizers too."""
            full_state = init_state(cfg_, 0, device)
            ckpt.restore(path, step, full_state)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(path + "_copy", step, full_state)
            return time.perf_counter() - t0

        save_s = timed_save(am_dir, 4, cfg)
        del state, state_cpu

        aas = ["--objective", "aas", "--noisy-manifest", m["noisy"], "--clean-manifest",
               m["clean"], "--batch-size", str(B), "--steps", "2", "--am-checkpoint", am_dir,
               "--checkpoint-dir", g_dir, "--val-manifest", m["noisy"], "--eval-every", "1",
               "--device", "cuda"]
        line, records, n = _cli_run("cli.train --objective aas --am-checkpoint DIR "
                                    "--val-manifest --eval-every 1", train_cli.main, aas)
        add(n)
        vals = [r for r in records if "val_wer" in r]
        if (line.get("final_step") != 2 or [r["step"] for r in vals] != [1, 2]
                or not {"val_wer", "val_wer_noisy", "loss_g"} <= set(line)
                or not all(abs(v) < float("inf") for v in line.values())
                or not os.path.exists(os.path.join(g_dir, "best.json"))):
            fail(f"the aas run printed {line}, validation records {vals}")
        t0 = time.perf_counter()
        _, g_cfg = load_state(g_dir, device)
        torch.cuda.synchronize()
        g_load_s = time.perf_counter() - t0
        g_save_s = timed_save(g_dir, 2, g_cfg)

        line, _, n = _cli_run("cli.evaluate --am-checkpoint DIR --enhancer-checkpoint DIR",
                              eval_cli.main, ["--manifest", m["noisy"], "--am-checkpoint",
                                              am_dir, "--enhancer-checkpoint", g_dir,
                                              "--device", "cuda"])
        add(n)
        if (set(line) != {"noisy", "enhanced", "wer_delta"}
                or any(line[k]["utterances"] != 6 or not 0.0 <= line[k]["wer"] < float("inf")
                       for k in ("noisy", "enhanced"))):
            fail(f"cli.evaluate printed {line}")
        line, _, n = _cli_run("cli.enhance --checkpoint DIR", enhance_cli.main,
                              ["--manifest", m["noisy"], "--out-dir", os.path.join(tmp, "enh"),
                               "--checkpoint", g_dir, "--device", "cuda"])
        add(n)
        if line.get("utterances") != 6 or len(os.listdir(os.path.join(tmp, "enh"))) != 6:
            fail(f"cli.enhance printed {line}")
        sizes = {"am": mb(os.path.join(am_dir, "4")), "aas": mb(os.path.join(g_dir, "2"))}
    val_s = [b["t"] - a["t"] for a, b in zip(records, records[1:]) if "val_wer" in b]
    print(f"[checkpoint] on {card}: save (synchronous, CPU copies, torch.save) AM + SGD "
          f"momentum {sizes['am']:.1f} MB in {save_s:.3f} s, AAS state (G + Adam, D + Adam, "
          f"frozen AM) {sizes['aas']:.1f} MB in {g_save_s:.3f} s; load_state onto the card "
          f"(init_state, then the saved networks) AM {load_s:.3f} s, AAS {g_load_s:.3f} s; "
          f"validation seconds per eval (the logger's clock, the first with the noisy "
          f"leg) {[round(v, 3) for v in val_s]}")
    print(f"[checkpoint] launches of the phase's CLI runs: {json.dumps(total)}")
    for name in ("gru", "gn_act", "stft", "lstm", "istft"):
        if not total.get(name):
            fail(f"the checkpoint phase launched no {name} kernel")
    bad = [mod for mod in sys.modules if mod.split(".")[0] in ("jax", "flax",
                                                                "aas_enhancement_tpu")]
    if bad:
        fail(f"JAX or the JAX package was imported: {bad[:5]}")
    return total


def paired_batch(b: int, gen, lengths: list[int]) -> dict:
    """A paired batch of b utterances: clean = a tone plus noise, noisy =
    clean plus more noise, both valid up to ``lengths``; all rows real."""
    import torch
    reps = -(-b // len(lengths))
    lens = torch.tensor((lengths * reps)[:b], dtype=torch.int32)
    t = torch.arange(N) / SR
    valid = torch.arange(N)[None] < lens[:, None]
    clean = (0.3 * torch.sin(2 * torch.pi * 220.0 * t)[None]
             + 0.1 * torch.randn(b, N, generator=gen)) * valid
    noisy = (clean + 0.2 * torch.randn(b, N, generator=gen)) * valid
    return {"wav": noisy, "wav_lengths": lens, "clean_wav": clean,
            "row_weights": torch.ones(b), "clean_row_weights": torch.ones(b)}


def phase_paired(device, card):
    """The paired objective: one step card vs CPU without (B=4 x 8 s) and
    with (B=8) the MR-STFT term, its launches, timed steps at B=8 and B=32, and
    the train CLI -> checkpoint -> enhance chain, with the C1 case (an am run
    keeps the --g-checkpoint's enhancer).  -> the launches of one paired step
    with the MR-STFT term (the path that runs every kernel of the objective)
    and those of the CLI runs."""
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.train.loop import init_state, load_state
    from aas_enhancement_tpu_torch.train.state import TrainState, adam
    from aas_enhancement_tpu_torch.train.steps import make_train_step

    gen = torch.Generator().manual_seed(21)
    step_launches = {}
    # Card vs CPU: without the MR-STFT term at B=4 (LENGTHS), with it at B=8
    # (BWD_FRAMES), where PAIRED_GRAD_TOL[0.5] was measured: the term's
    # conditioning depends on the batch (rows ending in long silences).
    for lam, b_check, lens in ((0.0, B, LENGTHS),
                               (0.5, BWD_B, [(f - 1) * 160 for f in BWD_FRAMES])):
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="paired",
                                                    batch_size=b_check, lambda_mrstft=lam))
        state_cpu = init_state(cfg, cfg.train.seed, "cpu")
        g_gpu = copy.deepcopy(state_cpu.g).to(device)
        state_gpu = TrainState(g=g_gpu, g_opt=adam(cfg, g_gpu.parameters(), cfg.train.lr_g))
        batch = paired_batch(b_check, gen, lens)
        batch_gpu = {k: v.to(device) for k, v in batch.items()}
        step = make_train_step(cfg)
        t0 = time.perf_counter()
        grads_cpu, aux_cpu = step.batch_grads(state_cpu, batch)
        cpu_s = time.perf_counter() - t0
        grads_gpu, aux_gpu = step.batch_grads(state_gpu, batch_gpu)
        torch.cuda.synchronize()
        check_step("paired", f"one paired step (lambda_mrstft {lam}) B={b_check} x "
                   f"{SECONDS} s (CPU plain path {cpu_s:.2f} s)", aux_cpu, aux_gpu,
                   grads_cpu, grads_gpu, {"g": PAIRED_GRAD_TOL[lam]}, PAIRED_TOL)
        aux = {}
        launches = counted(PAIRED_KERNELS, lambda: aux.update(step(state_gpu, batch_gpu)[1]))
        print(f"[paired] launches of one paired step (lambda_mrstft {lam}): "
              f"{json.dumps(launches)}")
        if launches != PAIRED_LAUNCHES[lam]:
            fail(f"a paired step (lambda_mrstft {lam}) launched {launches}, not "
                 f"{PAIRED_LAUNCHES[lam]}")
        if not all(abs(float(v)) < float("inf") for v in aux.values()):
            fail(f"non-finite paired metrics: {aux}")
        step_launches = launches
        del state_cpu, state_gpu, grads_cpu, grads_gpu

        for b in TRAIN_BATCHES:
            cfg_b = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=b))
            state = init_state(cfg_b, cfg.train.seed, device)
            step_b = make_train_step(cfg_b)
            batch = {k: v.to(device) for k, v in paired_batch(b, gen, [N]).items()}
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, aux = step_b(state, batch)
                torch.cuda.synchronize()
                if i >= 2:
                    walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            if not all(abs(float(v)) < float("inf") for v in aux.values()):
                fail(f"non-finite paired metrics at B={b}: {aux}")
            print(f"[paired] B={b} x {SECONDS} s paired step (lambda_mrstft {lam}) on {card}, "
                  f"TF32 off: {wall * 1e3:.2f} ms/step, {b / wall:.2f} utterances/s, "
                  f"{b * SECONDS / wall:.1f} s of audio per s; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (median of "
                  f"{len(walls)} after 2 warmups; walls ms {[round(w * 1e3, 2) for w in walls]})")
            del state, batch

    # The CLIs: paired training with a checkpoint directory, enhance from it,
    # and an am run given it as --g-checkpoint (C1: its directory keeps G).
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                            word_len=(2, 6))
        cfg = Config()
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, lambda_mrstft=0.5))
        cfg_path = os.path.join(tmp, "paired.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        p_dir, am_dir = os.path.join(tmp, "paired"), os.path.join(tmp, "am")
        names = PAIRED_KERNELS + ("gru", "gru_bwd", "conv_dw")
        runs = (
            ("cli.train --objective paired (lambda_mrstft 0.5) --checkpoint-dir", train_cli.main,
             ["--objective", "paired", "--noisy-manifest", m["noisy"], "--clean-manifest",
              m["clean"], "--batch-size", str(B), "--steps", "3", "--config", cfg_path,
              "--checkpoint-dir", p_dir, "--device", "cuda"]),
            ("cli.enhance --checkpoint PAIRED_DIR", enhance_cli.main,
             ["--manifest", m["noisy"], "--out-dir", os.path.join(tmp, "enh_p"),
              "--checkpoint", p_dir, "--device", "cuda"]),
            ("cli.train --objective am --g-checkpoint PAIRED_DIR --checkpoint-dir",
             train_cli.main, ["--objective", "am", "--noisy-manifest", m["clean"],
                              "--batch-size", str(B), "--steps", "1", "--am-checkpoint",
                              "seed:0", "--g-checkpoint", p_dir, "--checkpoint-dir", am_dir,
                              "--device", "cuda"]),
            ("cli.enhance --checkpoint AM_DIR (the kept enhancer)", enhance_cli.main,
             ["--manifest", m["noisy"], "--out-dir", os.path.join(tmp, "enh_am"),
              "--checkpoint", am_dir, "--device", "cuda"]))
        lines = []
        for tag, main, argv in runs:
            line, _, n = _cli_run(tag, main, argv, phase="paired", names=names)
            lines.append(line)
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
        if (set(lines[0]) != {"final_step", "loss_paired", "loss_mrstft", "loss_paired_total"}
                or lines[0]["final_step"] != 3
                or not all(abs(v) < float("inf") for v in lines[0].values())):
            fail(f"cli.train --objective paired printed {lines[0]}")
        for line, sub in ((lines[1], "enh_p"), (lines[3], "enh_am")):
            if line.get("utterances") != 6 or len(os.listdir(os.path.join(tmp, sub))) != 6:
                fail(f"cli.enhance printed {line}")
        g_paired = load_state(p_dir, "cpu")[0].g.state_dict()
        g_kept = load_state(am_dir, "cpu")[0].g.state_dict()
        if not all(torch.equal(v, g_kept[k]) for k, v in g_paired.items()):
            fail("the am run's checkpoint does not carry the --g-checkpoint's enhancer")
    print(f"[paired] the am run's checkpoint carries the paired run's enhancer bit for bit; "
          f"launches of the phase's CLI runs: {json.dumps(total)}")
    for name in ("stft_vjp", "istft_vjp", "lstm_bwd", "istft"):
        if not total.get(name):
            fail(f"the paired CLI runs launched no {name} kernel")
    return step_launches, total


# Streaming (ROADMAP A11a, A11b): the four serving engines at TrainConfig's
# operating point (chunk 1.0 s, lookahead 0.2 s, history 1.0 s; windows of
# 35200 samples, 221 STFT frames, 111 AM frames) and the two blockwise
# fine-tuning steps (B * 9 windows of 220 frames at 8 s).
STREAM_KW = dict(chunk_seconds=1.0, lookahead_seconds=0.2, history_seconds=1.0)
STREAMS = 8                                          # the batched engines' slots
STREAM_SECONDS = (6.0, 5.35, 4.7, 4.05, 3.5, 2.9, 2.25, 0.8)   # card-vs-CPU streams
STREAM_TOL = (1e-4, "samples in [-1, 1] and log-probs O(1) after STFT, 2 conv+GN, 2 "
              "BiLSTM-256 over 221 steps (and the AM's convs, 4 BiGRU-512 over 111), "
              "each block normalized with moments the earlier blocks summed: card vs "
              "CPU sum orders")
STREAM_PATHS = {"stream_enhance": ("stft", "istft", "gn_act", "lstm"),
                "stream_batched_enhance": ("stft", "istft", "gn_act", "lstm"),
                "stream_recognize": ("stft", "gn_act", "lstm", "gru"),
                "stream_batched_recognize": ("stft", "gn_act", "lstm", "gru")}
STREAM_AAS_KERNELS = ("stft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd", "gn_bwd")


def stream_wav(seconds: float, gen):
    """Synthetic capture audio, numpy f32: a gliding tone plus noise."""
    import torch
    n = int(seconds * SR)
    t = torch.arange(n) / SR
    x = 0.4 * torch.sin(2 * torch.pi * (300.0 + 40.0 * t) * t) + 0.2 * torch.randn(
        n, generator=gen)
    return x.numpy().astype("float32")


def tap(eng, keep=None) -> list:
    """Wrap an engine's device call: one entry per call (``keep(args, out)``,
    or None), so a run's calls are counted and its outputs can be read."""
    calls, fn = [], eng._fn

    def wrapped(*args):
        out = fn(*args)
        calls.append(None if keep is None else keep(args, out))
        return out

    eng._fn = wrapped
    return calls


def drive_batched(eng, wavs, push: int) -> dict:
    """Open one slot per stream, feed every stream ``push`` samples a round,
    tick until idle after each round, end the streams and drain ->
    {slot: emitted pieces}."""
    slots = [eng.open() for _ in wavs]
    out = {s: [] for s in slots}

    def drain():
        got = eng.step()
        while got:
            for s, y in got.items():
                out[s].append(y)
            got = eng.step()

    for i in range(0, max(len(w) for w in wavs), push):
        for s, w in zip(slots, wavs):
            if i < len(w):
                eng.feed(s, w[i: i + push])
        drain()
    for s in slots:
        eng.end_stream(s)
    drain()
    return out


def clear_ids(got, ref, margin: float) -> tuple[int, int]:
    """Argmax ids of two [T, V] score arrays -> (frames where the reference's
    top-2 margin exceeds ``margin``, those of them where the ids differ)."""
    import numpy as np
    top2 = np.sort(ref, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > margin
    return int(sure.sum()), int((sure & (got.argmax(-1) != ref.argmax(-1))).sum())


def serving_timings(tag: str, card: str, call, n_streams: int, names, reps: int = 10,
                    phase: str = "streaming", chunk_s: float = STREAM_KW["chunk_seconds"]):
    """Time a steady-state chunk call ``call()`` (one device call of the
    engine, with its host work): host wall per call (median of ``reps`` after
    3 warmups), RTF (wall over the audio the call emits: n_streams chunks of
    ``chunk_s``), our kernels' launches per call, and from the profiler (3
    calls after 2 warmups, then 3 unprofiled) the device busy time, device
    events and the idle share 1 - busy / wall."""
    import numpy as np
    from aas_enhancement_tpu_torch.utils.profiling import profile_call
    for _ in range(3):
        call()
    walls = []

    def timed():
        for _ in range(reps):
            t0 = time.perf_counter()
            call()
            walls.append(time.perf_counter() - t0)

    per_call = {k: v / reps for k, v in counted(names, timed).items()}
    wall = statistics.median(walls)
    with tempfile.TemporaryDirectory() as tmp:
        prof = profile_call(call, 3, 2, os.path.join(tmp, "trace.json"))
    uneven = [n for n, _, c in prof["by_name"] if not float(c).is_integer()]
    print(f"[{phase}] {tag} on {card}, TF32 off: {wall * 1e3:.3f} ms per chunk call "
          f"({n_streams} x {chunk_s} s of audio), RTF {wall / (n_streams * chunk_s):.6f}; "
          f"device busy {prof['busy_ms']:.3f} ms, {prof['events']:.0f} device events a "
          f"call, idle share {100 * (1 - prof['busy_ms'] / (wall * 1e3)):.1f}% of the "
          f"median wall ({100 * prof['idle_wall']:.1f}% of the profiler's own unprofiled "
          f"walls, {prof['wall_ms']:.3f} ms); our kernels' launches a call "
          f"{json.dumps(per_call)}; walls ms {[round(w * 1e3, 3) for w in walls]}"
          + (f"; the profiler dropped events ({len(uneven)} names uneven)" if uneven else ""))
    top = [(n[:60], round(ms, 4)) for n, ms, _ in prof["by_name"][:6]]
    print(f"[{phase}] {tag}: device time by kernel a call (ms): {json.dumps(top)}")
    return {"wall_ms": wall * 1e3, "busy_ms": prof["busy_ms"], "launches": per_call,
            "rtf": float(np.float64(wall / (n_streams * chunk_s)))}


def rnn_waves(cell: str, h: int, rows: int, t_len: int, train: bool) -> str:
    """The route and waves of a recurrence's launch over ``rows`` sequences of
    ``t_len`` steps: tiles of 4 rows x 2 directions over the clusters the
    card runs at once (forward: the training variant when ``train``)."""
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    cluster = krnn.bwd_resident_cluster(cell, h)
    tiles = 2 * -(-rows // 4)
    parts = []
    for what, kw in (("fwd", {"save": train}), ("bwd", {"backward": True})):
        if what == "bwd" and not train:
            continue
        at_once = krnn.resident_clusters_at_once(cell, h, **kw)
        waves = -(-tiles // at_once)
        parts.append(f"{what} {at_once} clusters at once -> {waves} waves x {t_len} = "
                     f"{waves * t_len} sequential steps")
    return (f"{cell}-{h} resident in clusters of {cluster}, {rows} rows = {tiles} tiles: "
            + "; ".join(parts))


def phase_streaming(device, card):
    """Streaming enhancement and recognition on the card at the shipped widths:
    the four serving engines on 8 synthetic streams (pushes of 0.1 s) against
    the CPU, each engine's chunk call timed in steady state (ms, RTF, busy,
    idle share, launches); one ``aas`` step with ``streaming_finetune`` and
    one ``am`` step with ``streaming_finetune_am`` at B=4 x 8 s against the
    CPU, their launches, routes and waves, and both timed at B=8 and B=32
    x 8 s.  -> {path: launches}."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.enhance import init_enhancer
    from aas_enhancement_tpu_torch.evaluation import init_am
    from aas_enhancement_tpu_torch.streaming import BatchedStreamingEnhancer, StreamingEnhancer
    from aas_enhancement_tpu_torch.streaming_asr import (BatchedStreamingRecognizer,
                                                         StreamingRecognizer,
                                                         make_streaming_asr_fn)
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.train.state import TrainState
    from aas_enhancement_tpu_torch.train.steps import make_train_step
    from aas_enhancement_tpu_torch.utils.profiling import profile_call

    cfg = Config()
    gen = torch.Generator().manual_seed(31)
    enh_cpu, am_cpu = init_enhancer(cfg, 1, "cpu"), init_am(cfg, 0, "cpu")
    enh_gpu, am_gpu = copy.deepcopy(enh_cpu).to(device), copy.deepcopy(am_cpu).to(device)
    wavs = [stream_wav(s, gen) for s in STREAM_SECONDS]
    push = SR // 10
    tol, why = STREAM_TOL
    by_path = {}

    # --- serving, card vs CPU -------------------------------------------------
    def single(dev, g):
        eng = StreamingEnhancer(cfg, g, device=dev, **STREAM_KW)
        calls = tap(eng, keep=lambda args, out: out[0].cpu().numpy())
        out = [eng.feed(wavs[0][i: i + push]) for i in range(0, len(wavs[0]), push)]
        return (np.concatenate(out + [eng.flush()]), calls), len(calls)

    def batched(dev, g):
        eng = BatchedStreamingEnhancer(cfg, g, max_streams=STREAMS, device=dev, **STREAM_KW)
        calls = tap(eng)
        out = drive_batched(eng, wavs, push)
        return [np.concatenate(out[s]) for s in sorted(out)], len(calls)

    def recognizer(dev, a, g):
        rec = StreamingRecognizer(cfg, a, g, collect_logits=True, device=dev, **STREAM_KW)
        calls = tap(rec, keep=lambda args, out: out[0].cpu().numpy())
        ids = [i for k in range(0, len(wavs[0]), push) for i in rec.feed(wavs[0][k: k + push])]
        ids += rec.flush()
        return (ids, rec.log_probs(), rec.transcript(), calls), len(calls)

    def batched_recognizer(dev, a, g):
        eng = BatchedStreamingRecognizer(cfg, a, g, max_streams=STREAMS, device=dev,
                                         **STREAM_KW)
        ticks = tap(eng, keep=lambda args, out: (out[0].cpu().numpy(), args[3].cpu().numpy(),
                                                 out[1].cpu().numpy()))
        drive_batched(eng, wavs, push)
        return ([eng.transcript(s) for s in range(len(wavs))], ticks), len(ticks)

    runs = (("stream_enhance", "StreamingEnhancer, B=1", single, (enh_cpu,), (enh_gpu,)),
            ("stream_batched_enhance", f"BatchedStreamingEnhancer, {STREAMS} streams",
             batched, (enh_cpu,), (enh_gpu,)),
            ("stream_recognize", "StreamingRecognizer with the enhancer, B=1", recognizer,
             (am_cpu, enh_cpu), (am_gpu, enh_gpu)),
            ("stream_batched_recognize", f"BatchedStreamingRecognizer with the enhancer, "
             f"{STREAMS} streams", batched_recognizer, (am_cpu, enh_cpu), (am_gpu, enh_gpu)))
    for path, what, run, nets_cpu, nets_gpu in runs:
        t0 = time.perf_counter()
        ref, _ = run("cpu", *nets_cpu)
        cpu_s = time.perf_counter() - t0
        res = {}
        by_path[path] = counted(STREAM_PATHS[path],
                                lambda: res.update(zip(("got", "calls"),
                                                       run(device, *nets_gpu))))
        got, n_calls = res["got"], res["calls"]
        per_call = {k: round(v / n_calls, 3) for k, v in by_path[path].items()}
        if path == "stream_enhance":
            (got, blocks), (ref, ref_blocks) = got, ref
            if got.shape != wavs[0].shape or not np.isfinite(got).all():
                fail(f"{what}: {got.shape} samples for {wavs[0].shape}, or non-finite")
            by_call = [float(f"{np.abs(x - y).max():.2e}") for x, y in zip(blocks, ref_blocks)]
            err = float(np.abs(got - ref).max())
            detail = f"{got.size} samples (the windows, call by call: {by_call})"
        elif path == "stream_batched_enhance":
            if [g.shape for g in got] != [w.shape for w in wavs]:
                fail(f"{what}: emitted {[g.shape for g in got]}")
            err = max(float(np.abs(g - r).max()) for g, r in zip(got, ref))
            detail = f"{sum(g.size for g in got)} samples of {len(got)} streams"
        elif path == "stream_recognize":
            (ids, lp, text, logits), (ref_ids, ref_lp, ref_text, ref_logits) = got, ref
            frames = (1 + len(wavs[0]) // cfg.audio.hop_length + 1) // 2
            if lp.shape != ref_lp.shape or len(ids) != frames:
                fail(f"{what}: {len(ids)} frames for the offline {frames}")
            err = float(np.abs(lp - ref_lp).max())
            sure, differ = clear_ids(lp, ref_lp, 2 * tol)
            by_call = [float(f"{np.abs(x - y).max():.2e}") for x, y in zip(logits, ref_logits)]
            detail = (f"log-probs of {len(ids)} frames (the windows' logits, call by call: "
                      f"{by_call}); ids differ on {differ} of {sure} "
                      f"frames with a top-2 margin > {2 * tol:.0e}; transcripts "
                      f"{'equal' if text == ref_text else 'differ'}")
            if differ:
                fail(f"{what}: greedy ids differ on frames with a clear margin")
        else:
            (texts, ticks), (ref_texts, ref_ticks) = got, ref
            err, sure, differ, per_tick = 0.0, 0, 0, []
            for (lg, lens, ol), (lr, _, olr) in zip(ticks, ref_ticks):
                if not np.array_equal(ol, olr):
                    fail(f"{what}: out_lengths {ol} vs {olr}")
                busy = np.flatnonzero(lens > 0)                # the slots with a job
                per_tick.append(float(f"{np.abs(lg[busy] - lr[busy]).max():.2e}"))
                err = max(err, per_tick[-1])
                for r in busy:
                    s, d = clear_ids(lg[r, :ol[r]], lr[r, :ol[r]], 2 * tol)
                    sure, differ = sure + s, differ + d
            detail = (f"logits of {len(ticks)} ticks' busy rows ({per_tick}); ids differ on {differ} "
                      f"of {sure} frames with a top-2 margin > {2 * tol:.0e}; transcripts "
                      f"{'equal' if texts == ref_texts else 'differ'}")
            if len(ticks) != len(ref_ticks) or differ:
                fail(f"{what}: {len(ticks)} vs {len(ref_ticks)} ticks, or greedy ids "
                     "differ on frames with a clear margin")
        print(f"[streaming] {what}, card vs CPU over whole streams ({n_calls} device calls, "
              f"pushes of 0.1 s): max_abs_err {err:.3e} on {detail} (tol {tol:.0e}: {why}); "
              f"launches {json.dumps(by_path[path])}, a call {json.dumps(per_call)}; CPU "
              f"{cpu_s:.2f} s")
        if not err <= tol:
            fail(f"{what}: card vs CPU error {err:.3e} > {tol:.0e}")
        for name, count in by_path[path].items():
            if count == 0:
                fail(f"{what} launched no {name} kernel")

    # Where a stream's first window (its history is synthetic silence) parts
    # card from CPU: the enhancer's first conv and GroupNorm, windows 1 and 2.
    hist, look = (int(STREAM_KW[k] * SR) for k in ("history_seconds", "lookahead_seconds"))
    chunk = int(STREAM_KW["chunk_seconds"] * SR)
    for k in (0, 1):
        block = np.zeros((1, hist + chunk + look), np.float32)
        block[0, max(0, hist - k * chunk): hist] = wavs[0][max(0, (k - 1) * chunk): k * chunk]
        block[0, hist:] = wavs[0][k * chunk: (k + 1) * chunk + look]
        stages = {}
        for dev, (a, g) in (("cpu", (am_cpu, enh_cpu)), (device, (am_gpu, enh_gpu))):
            hooks = [m.register_forward_hook(
                lambda mod, i, o, key=(str(dev), name): stages.__setitem__(key, o.cpu()))
                for name, m in (("conv 1", g.convs[0]), ("GroupNorm 1", g.gns[0]))]
            make_streaming_asr_fn(cfg, True, dev)(
                a, g, torch.from_numpy(block), torch.tensor([block.shape[1]]),
                torch.tensor([hist // cfg.audio.hop_length]),
                torch.tensor([(hist + chunk) // cfg.audio.hop_length]),
                torch.zeros(3, 1), torch.zeros(3, 1))
            for h in hooks:
                h.remove()
        diffs = {name: f"{(stages[(str(device), name)] - stages[('cpu', name)]).abs().max():.2e}"
                 for name in ("conv 1", "GroupNorm 1")}
        print(f"[streaming] recognizer window {k + 1} ({'silent' if k == 0 else 'audio'} "
              f"history), the enhancer's outputs card vs CPU: {json.dumps(diffs)}")

    # --- serving, steady-state chunk calls on the card -------------------------
    long = stream_wav(120.0, gen)
    pos = {"i": 0}

    def next_chunk():
        i = pos["i"] % (len(long) - chunk)
        pos["i"] += chunk
        return long[i: i + chunk]

    eng = StreamingEnhancer(cfg, enh_gpu, device=device, **STREAM_KW)
    eng.feed(long[: int(STREAM_KW["lookahead_seconds"] * SR)])
    serving_timings("StreamingEnhancer B=1", card, lambda: eng.feed(next_chunk()), 1,
                    STREAM_PATHS["stream_enhance"])
    beng = BatchedStreamingEnhancer(cfg, enh_gpu, max_streams=STREAMS, device=device,
                                    **STREAM_KW)
    slots = [beng.open() for _ in range(STREAMS)]
    for s in slots:
        beng.feed(s, long[: int(STREAM_KW["lookahead_seconds"] * SR)])

    def tick(engine):
        for s in slots:
            engine.feed(s, next_chunk())
        if len(engine.step()) != STREAMS:
            fail("a batched tick did not advance every stream")

    serving_timings(f"BatchedStreamingEnhancer {STREAMS} streams", card, lambda: tick(beng),
                    STREAMS, STREAM_PATHS["stream_batched_enhance"])
    rec = StreamingRecognizer(cfg, am_gpu, enh_gpu, device=device, **STREAM_KW)
    rec.feed(long[: int(STREAM_KW["lookahead_seconds"] * SR)])
    serving_timings("StreamingRecognizer (enhancer + AM) B=1", card,
                    lambda: rec.feed(next_chunk()), 1, STREAM_PATHS["stream_recognize"])
    breng = BatchedStreamingRecognizer(cfg, am_gpu, enh_gpu, max_streams=STREAMS,
                                       device=device, **STREAM_KW)
    for s in [breng.open() for _ in range(STREAMS)]:
        breng.feed(s, long[: int(STREAM_KW["lookahead_seconds"] * SR)])
    serving_timings(f"BatchedStreamingRecognizer (enhancer + AM) {STREAMS} streams", card,
                    lambda: tick(breng), STREAMS, STREAM_PATHS["stream_batched_recognize"])
    del eng, beng, rec, breng

    # --- blockwise fine-tuning steps ---------------------------------------------
    from aas_enhancement_tpu_torch.train.objectives import stream_frames
    fr = stream_frames(cfg, 2)                          # chunk 100, lookahead 20, history 100
    nb = -(-(1 + N // cfg.audio.hop_length) // fr["chunk_f"])      # windows a row
    window = fr["hist_f"] + fr["chunk_f"] + fr["look_f"]
    steps = (("stream_aas_step", "aas step with streaming_finetune",
              dict(objective="aas", streaming_finetune=True), STREAM_AAS_KERNELS,
              {"g": TRAIN_GRAD_TOL["g"], "d": TRAIN_GRAD_TOL["d"]}),
             ("stream_am_step", "am step with streaming_finetune_am",
              dict(objective="am", streaming_finetune_am=True), AM_KERNELS,
              {"am": AM_GRAD_TOL}))
    for path, what, train_kw, names, grad_tols in steps:
        cfg_s = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=B, **train_kw))
        state_cpu = init_state(cfg_s, cfg.train.seed, "cpu", am_seed=0)
        state_gpu = TrainState(**{k: copy.deepcopy(getattr(state_cpu, k)).to(device)
                                  for k in ("g", "d", "am") if getattr(state_cpu, k) is not None})
        batch = train_batch(B, gen, LENGTHS)
        if train_kw["objective"] == "am":
            batch = {k: v for k, v in batch.items() if not k.startswith("clean")}
        step = make_train_step(cfg_s)
        t0 = time.perf_counter()
        grads_cpu, aux_cpu = step.batch_grads(state_cpu, batch)
        cpu_s = time.perf_counter() - t0
        res = {}
        by_path[path] = counted(names, lambda: res.update(zip(("grads", "aux"), step.batch_grads(
            state_gpu, {k: v.to(device) for k, v in batch.items()}))))
        torch.cuda.synchronize()
        check_step("streaming", f"one {what} B={B} x {SECONDS} s (CPU {cpu_s:.2f} s)",
                   aux_cpu, res["aux"], grads_cpu, res["grads"], grad_tols)
        print(f"[streaming] {what}: launches {json.dumps(by_path[path])}")
        for name, count in by_path[path].items():
            if count == 0:
                fail(f"the {what} launched no {name} kernel")
        del state_cpu, state_gpu, grads_cpu, res

        for b in TRAIN_BATCHES:
            cfg_b = cfg_s.replace(train=dataclasses.replace(cfg_s.train, batch_size=b))
            state = init_state(cfg_b, cfg.train.seed, device, am_seed=0)
            step_b = make_train_step(cfg_b)
            batch = {k: v.to(device) for k, v in train_batch(b, gen, [N]).items()
                     if train_kw["objective"] != "am" or not k.startswith("clean")}
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for i in range(7):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, aux = step_b(state, batch)
                torch.cuda.synchronize()
                if i >= 2:
                    walls.append(time.perf_counter() - t0)
            wall = statistics.median(walls)
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not all(abs(float(v)) < float("inf") for v in aux.values()):
                fail(f"non-finite metrics of the {what} at B={b}: {aux}")
            with tempfile.TemporaryDirectory() as tmp:
                prof = profile_call(lambda: step_b(state, batch), 2, 1,
                                    os.path.join(tmp, "trace.json"))
            uneven = [n for n, _, c in prof["by_name"] if not float(c).is_integer()]
            if train_kw["objective"] == "am":
                routes = [rnn_waves("gru", cfg.am.rnn_hidden, b * nb, window // 2, True)]
            else:
                routes = [rnn_waves("lstm", cfg.enhancer.rnn_hidden, b * nb, window, True),
                          rnn_waves("gru", cfg.am.rnn_hidden, b, AM_T, True)]
            top = [(n[:50], round(ms, 3), c) for n, ms, c in prof["by_name"][:8]]
            print(f"[streaming] B={b} {what}: device time by kernel a step (ms, launches): "
                  f"{json.dumps(top)}")
            print(f"[streaming] B={b} x {SECONDS} s {what} on {card}, TF32 off: "
                  f"{wall * 1e3:.2f} ms/step, {b / wall:.2f} utterances/s; device busy "
                  f"{prof['busy_ms']:.2f} ms ({prof['events']:.0f} device events, idle "
                  f"{100 * (1 - prof['busy_ms'] / (wall * 1e3)):.1f}% of the wall); peak "
                  f"device memory {peak:.2f} GiB; {' | '.join(routes)} (median of "
                  f"{len(walls)} after 2 warmups; walls ms {[round(w * 1e3, 2) for w in walls]})"
                  + (f"; the profiler dropped events ({len(uneven)} names uneven)"
                     if uneven else ""))
            del state, batch

    # --- the CLIs, on their default device (the card) --------------------------
    from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.data import generate_corpus, read_manifest, read_wav
    total: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=1,
                            word_len=(2, 6))
        out_dir = os.path.join(tmp, "enh")
        point = ["--stream-chunk", "1.0", "--stream-lookahead", "0.2", "--stream-history", "1.0"]
        runs = (("cli.enhance --streaming", enhance_cli.main,
                 ["--manifest", m["noisy"], "--out-dir", out_dir, "--streaming",
                  "--chunk-seconds", "1.0", "--lookahead-seconds", "0.2",
                  "--history-seconds", "1.0"], {"stft", "istft", "gn_act", "lstm"}),
                ("cli.train --objective aas --streaming-finetune", train_cli.main,
                 ["--objective", "aas", "--noisy-manifest", m["noisy"], "--clean-manifest",
                  m["clean"], "--steps", "2", "--batch-size", str(B), "--am-checkpoint",
                  "seed:0", "--streaming-finetune", *point], {"lstm_bwd", "gru_bwd", "gn_bwd"}),
                ("cli.train --objective am --streaming-finetune-am", train_cli.main,
                 ["--objective", "am", "--noisy-manifest", m["clean"], "--steps", "2",
                  "--batch-size", str(B), "--am-checkpoint", "seed:0",
                  "--streaming-finetune-am", *point], {"gru_bwd", "conv_dw"}))
        for tag, main, argv, need in runs:
            line, _, n = _cli_run(f"{tag} (no --device: the card)", main, argv,
                                  phase="streaming", names=CKPT_KERNELS)
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
            if [k for k in need if not n[k]]:
                fail(f"{tag} launched none of {sorted(k for k in need if not n[k])}")
            if main is enhance_cli.main:
                for wav_path, _ in read_manifest(m["noisy"]):
                    x, _ = read_wav(wav_path)
                    y, _ = read_wav(os.path.join(out_dir, os.path.basename(wav_path)))
                    if line.get("utterances") != 6 or len(y) != len(x):
                        fail(f"{tag}: {line}, {wav_path}: {len(y)} samples for {len(x)}")
            elif line.get("final_step") != 2 or not all(
                    abs(v) < float("inf") for v in line.values()):
                fail(f"{tag} printed {line}")
    by_path["stream_cli"] = total
    return by_path


# Serving (ROADMAP A11c) and export (A14): the serve CLI at its defaults
# (enhance: chunk 1.0, lookahead 0.2, history 0.5 s, windows of 27,200
# samples, 171 STFT frames; transcribe: lookahead 0.5, windows of 32,000
# samples, 101 AM frames) over a full-width checkpoint directory written
# here, and the exported enhancer of the same weights.
# The 25 ms / 10 ms framing (ROADMAP A1): n_fft 400, hop 160, 201 bins, a hop
# that does not divide n_fft, at the default widths (enhancer 2 x conv-32 +
# GN, 2 x BiLSTM-256 over 201 x 32 = 6432 inputs; AM convs 201 -> 101 -> 51
# bins, 4 x BiGRU-512; the default discriminator).
HOP_AUDIO = dict(window_size=0.025, window_stride=0.01)
HOP_PAIR = (400, 160)
HOP_VJP_SHAPES = {"stft_vjp": (HOP_PAIR,), "istft_vjp": (HOP_PAIR,)}
HOP_UTTS = 3                           # the CLIs' synthetic corpus
HOP_B, HOP_SECONDS = 2, 2              # card vs CPU at B=2 x 2 s
HOP_KERNELS = ("stft", "istft", "gn_act", "lstm", "gru", "lstm_bwd", "gru_bwd", "gn_bwd",
               "stft_vjp", "istft_vjp", "conv_dw")
# Kernels each 25/10 path must launch (cli.export traces with fake tensors:
# its artifact's call launches instead).
HOP_LAUNCHED = {"hop_enhance_fn": ("stft", "istft", "gn_act", "lstm"),
                "hop_stream_enhance": ("stft", "istft", "gn_act", "lstm"),
                "hop_stream_recognize": ("stft", "gn_act", "lstm", "gru"),
                "hop_cli_enhance": ("stft", "istft", "gn_act", "lstm"),
                "hop_cli_evaluate": ("stft", "gn_act", "lstm", "gru"),
                "hop_cli_paired": ("stft", "istft", "lstm_bwd", "gn_bwd", "stft_vjp",
                                   "istft_vjp"),
                "hop_cli_aas": ("stft", "lstm", "gru", "lstm_bwd", "gru_bwd", "gn_bwd"),
                "hop_export_call": ("stft", "istft", "gn_act", "lstm")}


def hop_kernels(device, results: dict) -> None:
    """B4 and B5 at (400, 160), B=4 x 8 s ragged (T = 801, 201 bins), against
    their plain versions, timed in turns beside torch.stft / torch.istft with
    their device times; then B4ᵀ and B5ᵀ at (400, 160), B=8 x 8 s, through
    ``kernels_vjp`` (plain versions, autograd.grad through torch.stft /
    torch.istft, one device kernel a call, each frame transformed once)."""
    import torch
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft

    n_fft, hop = HOP_PAIR
    wav, _, gen = make_inputs(device)
    window = torch.hann_window(n_fft, periodic=True, device=device)
    with torch.inference_mode():
        re, im = kstft.stft_plain(wav, n_fft, hop)
        gain = torch.rand(re.shape, generator=gen).to(device)
        flops = B * re.shape[1] * 5.0 * n_fft * math.log2(n_fft)
        z = torch.complex(re * gain, im * gain).transpose(1, 2)
        cases = {
            "stft": (kstft.stft, kstft.stft_plain, (wav, n_fft, hop),
                     (nbytes(wav, re, im), flops),
                     lambda: torch.stft(wav, n_fft, hop, window=window, center=True,
                                        pad_mode="reflect", return_complex=True)),
            "istft": (kstft.istft, kstft.istft_plain,
                      (re * gain, im * gain, n_fft, hop, "hann", True, N),
                      (nbytes(re, im, wav), flops),
                      lambda: torch.istft(z, n_fft, hop, window=window, center=True,
                                          length=N))}
        for name, (kernel, plain, args, work, library) in cases.items():
            k_out, p_out = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = max_err(k_out, p_out)
            route = kernel.route
            want = kstft.stft_factors(n_fft) if name == "stft" else kstft.istft_route(n_fft, hop)
            if route != want or not route[0]:
                fail(f"{name} at ({n_fft}, {hop}) took route {route}, not {want}")
            ms, plain_ms = in_turns(lambda: kernel(*args), lambda: plain(*args), 20)
            lib_ms = statistics.median(cuda_ms(library, 20))
            label = f"{name} n_fft {n_fft} hop {hop} B={B} (25/10)"
            text = keep(results, name, label, err, ms, plain_ms, work, lib_ms)
            row = results[name]["shapes"][label]
            row["kernel_route"] = f"two stages, {route[0]} x {route[1]}"
            text += f" | route {row['kernel_route']}" + device_times(
                row, lambda: kernel(*args), library)
            tol, why = TOL[name]
            print(f"[hop] {label}: max_abs_err {err:.3e} (tol {tol:.0e}: {why}) | kernel "
                  f"{ms:.4f} ms | plain {plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text}")
            if not err <= tol:
                fail(f"{label}: max abs err {err:.3e} > tol {tol:.0e}")
    kernels_vjp(device, results, HOP_VJP_SHAPES, mr_forward=False)


def phase_hop(device, card, results: dict) -> dict:
    """The main paths at 25 ms / 10 ms on the card: the four STFT kernels at
    (400, 160) (``hop_kernels``); the enhance function and the recognition
    forward card vs CPU at B=2 x 2 s; cli.enhance, cli.evaluate (greedy),
    cli.train --objective paired (lambda_mrstft 0.5, 2 steps, a checkpoint
    directory) and --objective aas (1 step) on HOP_UTTS utterances; one
    chunk call of StreamingEnhancer and of StreamingRecognizer, card vs CPU;
    cli.export of the paired directory and one artifact call against the
    live call.  Each run's launches counted; the STFT, ISTFT and VJP wrappers'
    last routes must be the (400, 160) ones.  -> {path: launches}."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.cli import enhance as enhance_cli
    from aas_enhancement_tpu_torch.cli import evaluate as eval_cli
    from aas_enhancement_tpu_torch.cli import export as export_cli
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.config import AudioConfig, Config
    from aas_enhancement_tpu_torch.data import generate_corpus
    from aas_enhancement_tpu_torch.enhance import init_enhancer, make_enhance_fn
    from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    from aas_enhancement_tpu_torch.serving import load_enhancer
    from aas_enhancement_tpu_torch.streaming import StreamingEnhancer
    from aas_enhancement_tpu_torch.streaming_asr import StreamingRecognizer
    from aas_enhancement_tpu_torch.train.loop import load_state

    hop_kernels(device, results)
    cfg = Config(audio=AudioConfig(**HOP_AUDIO))
    a = cfg.audio
    if (a.n_fft, a.hop_length, a.num_bins) != (*HOP_PAIR, 201):
        fail(f"the 25/10 config gives n_fft {a.n_fft}, hop {a.hop_length}")
    n_fft, hop = HOP_PAIR
    paths, outs = {}, {}

    def routes(tag: str, names) -> None:
        want = {"stft": kstft.stft_factors(n_fft), "istft": kstft.istft_route(n_fft, hop),
                "istft_vjp": kstft.vjp_plan(n_fft, hop)}
        got = {k: getattr(kstft, k).route for k in names if k in want}
        if any(v != want[k] for k, v in got.items()):
            fail(f"{tag}: routes {got}, not the (400, 160) ones {want}")

    # Card vs CPU, the same weights: the enhance function and the recognition forward.
    g_cpu, am_cpu = init_enhancer(cfg, 1, "cpu"), init_am(cfg, 0, "cpu")
    g_gpu, am_gpu = copy.deepcopy(g_cpu).to(device), copy.deepcopy(am_cpu).to(device)
    n = SR * HOP_SECONDS
    gen = torch.Generator().manual_seed(23)
    wav = torch.from_numpy(np.stack([stream_wav(HOP_SECONDS, gen) for _ in range(HOP_B)]))
    lens = torch.tensor([n, n - 7003])
    wav = wav * (torch.arange(n)[None] < lens[:, None])
    y_cpu = make_enhance_fn(cfg, "cpu")(g_cpu, wav, lens)
    paths["hop_enhance_fn"] = counted(SERVE_KERNELS["enhance"], lambda: outs.setdefault(
        "wave", make_enhance_fn(cfg, device)(g_gpu, wav.to(device), lens.to(device))))
    y_gpu = outs["wave"]
    routes("enhance function", ("stft", "istft"))
    err = (y_gpu.cpu() - y_cpu).abs().max().item()
    tol, why = SLICE_TOL
    print(f"[hop] enhance function B={HOP_B} x {HOP_SECONDS} s at (400, 160), card vs CPU: "
          f"shape {tuple(y_gpu.shape)}, max_abs_err {err:.3e} (tol {tol:.0e}: {why}) | "
          f"launches {json.dumps(paths['hop_enhance_fn'])}")
    if y_gpu.shape != (HOP_B, n) or not err <= tol:
        fail(f"25/10 enhance card vs CPU: shape {tuple(y_gpu.shape)}, error {err:.3e}")
    fwd = make_eval_forward(cfg, use_enhancer=True)
    ref, ref_pad = fwd(am_cpu, g_cpu, wav, lens)
    got, pad = fwd(am_gpu, g_gpu, wav.to(device), lens.to(device))
    err = (got.cpu() - ref).abs().max().item()
    tol, why = RECOGNIZE_TOL
    print(f"[hop] recognition forward B={HOP_B} x {HOP_SECONDS} s (AM over 201 -> 101 -> 51 "
          f"bins), card vs CPU: logits {tuple(got.shape)}, max_abs_err {err:.3e} (tol "
          f"{tol:.0e}: {why}); greedy ids equal: "
          f"{torch.equal(got.argmax(-1).cpu(), ref.argmax(-1))}")
    if not err <= tol or not torch.equal(pad.cpu(), ref_pad):
        fail(f"25/10 recognition card vs CPU: error {err:.3e}")

    # One chunk call of each streaming engine (chunk 1.0, lookahead 0.2,
    # history 1.0 s): 1.3 s of audio fed gives exactly one call.
    chunk = stream_wav(1.3, gen)
    for dev in ("cpu", device):
        g, am = (g_cpu, am_cpu) if dev == "cpu" else (g_gpu, am_gpu)
        enh = StreamingEnhancer(cfg, g, **STREAM_KW, device=dev)
        rec = StreamingRecognizer(cfg, am, g, **STREAM_KW, collect_logits=True, device=dev)
        runs = {"hop_stream_enhance": lambda: outs.setdefault((dev, "enh"), enh.feed(chunk)),
                "hop_stream_recognize": lambda: (rec.feed(chunk), outs.setdefault(
                    (dev, "rec"), rec.log_probs()))}
        for tag, run in runs.items():
            c = counted(STREAM_PATHS["stream_enhance"] + ("gru",), run)
            if dev != "cpu":
                paths[tag] = c
                routes(tag, [k for k in ("stft", "istft") if c[k]])
    tol, why = STREAM_TOL
    for kind in ("enh", "rec"):
        ref, got = outs[("cpu", kind)], outs[(device, kind)]
        err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
        print(f"[hop] {'StreamingEnhancer' if kind == 'enh' else 'StreamingRecognizer'} one "
              f"chunk call at 25/10, card vs CPU: out {got.shape}, max_abs_err {err:.3e} "
              f"(tol {tol:.0e}) | launches "
              f"{json.dumps(paths['hop_stream_' + ('enhance' if kind == 'enh' else 'recognize')])}")
        if not got.size or not err <= tol:
            fail(f"25/10 streaming {kind}: {got.shape} against {ref.shape}, error {err:.3e}")

    # The CLIs on the card, default widths, the 25/10 config JSON.
    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=HOP_UTTS, seed=5,
                            word_len=(2, 6))
        cfg_mr = cfg.replace(train=dataclasses.replace(cfg.train, lambda_mrstft=0.5))
        cfg_path = os.path.join(tmp, "hop.json")
        with open(cfg_path, "w") as f:
            f.write(cfg_mr.to_json())
        p_dir, art = os.path.join(tmp, "paired"), os.path.join(tmp, "artifact")
        # (path, what, CLI, argv, the wrappers whose last route must be the
        # (400, 160) one: the paired run's last STFT and B4ᵀ are the MR terms')
        runs = (
            ("hop_cli_enhance", "cli.enhance", enhance_cli.main,
             ["--manifest", m["noisy"], "--out-dir", os.path.join(tmp, "enh"), "--config",
              cfg_path, "--device", "cuda"], ("stft", "istft")),
            ("hop_cli_evaluate", "cli.evaluate (greedy)", eval_cli.main,
             ["--manifest", m["noisy"], "--clean-manifest", m["clean"], "--am-checkpoint",
              "seed:0", "--enhancer-checkpoint", "seed:1", "--config", cfg_path,
              "--device", "cuda"], ("stft", "istft")),
            ("hop_cli_paired", "cli.train --objective paired (lambda_mrstft 0.5)",
             train_cli.main,
             ["--objective", "paired", "--noisy-manifest", m["noisy"], "--clean-manifest",
              m["clean"], "--batch-size", str(HOP_B), "--steps", "2", "--config", cfg_path,
              "--checkpoint-dir", p_dir, "--device", "cuda"], ("istft", "istft_vjp")),
            ("hop_cli_aas", "cli.train --objective aas", train_cli.main,
             ["--objective", "aas", "--noisy-manifest", m["noisy"], "--clean-manifest",
              m["clean"], "--am-checkpoint", "seed:0", "--batch-size", str(HOP_B),
              "--steps", "1", "--config", cfg_path, "--device", "cuda"], ("stft",)),
            ("hop_cli_export", "cli.export --batch-sizes 1 --seconds 2", export_cli.main,
             ["--checkpoint", p_dir, "--out", art, "--batch-sizes", "1", "--seconds",
              str(HOP_SECONDS), "--device", "cuda"], ()))
        lines = {}
        for path, tag, main, argv, routed in runs:
            lines[path], _, paths[path] = _cli_run(tag + " at 25/10", main, argv, phase="hop",
                                                   names=HOP_KERNELS)
            routes(tag, [k for k in routed if paths[path][k]])
        if lines["hop_cli_enhance"].get("utterances") != HOP_UTTS:
            fail(f"cli.enhance at 25/10 printed {lines['hop_cli_enhance']}")
        ev = lines["hop_cli_evaluate"]
        if not all(ev.get(leg, {}).get("utterances") == HOP_UTTS for leg in ("noisy", "enhanced")):
            fail(f"cli.evaluate at 25/10 printed {lines['hop_cli_evaluate']}")
        for path, step, key in (("hop_cli_paired", 2, "loss_mrstft"),
                                ("hop_cli_aas", 1, "loss_g")):
            line = lines[path]
            if line.get("final_step") != step or key not in line or not all(
                    abs(v) < float("inf") for v in line.values()):
                fail(f"{path} printed {line}")

        # One artifact call against the live call on the same weights.
        served = load_enhancer(art, device)
        state_g = load_state(p_dir, device)[0].g
        x = stream_wav(HOP_SECONDS, gen)[None]
        paths["hop_export_call"] = counted(SERVE_KERNELS["enhance"], lambda: outs.setdefault(
            "art", served.enhance(x)))
        live = make_enhance_fn(cfg, device)(state_g, torch.from_numpy(x),
                                            torch.tensor([x.shape[1]])).cpu().numpy()
        err = float(np.abs(outs["art"] - live).max())
        tol, why = EXPORT_TOL
        print(f"[hop] the 25/10 artifact's call against make_enhance_fn on {card}: "
              f"max_abs_err {err:.3e} (tol {tol}: {why}) | launches "
              f"{json.dumps(paths['hop_export_call'])}")
        if outs["art"].shape != live.shape or not err <= tol:
            fail(f"the 25/10 artifact differs from the live path: {err:.3e}")
    for path, names in HOP_LAUNCHED.items():
        if not all(paths[path].get(k) for k in names):
            fail(f"{path}: launched {paths[path]}, not each of {names}, at 25/10")
    return paths


# The end-to-end quality protocol (cli/e2e.py) at a tiny size: the protocol's
# own widths (AM 3 x BiGRU-256, enhancer 2 x BiLSTM-128, 16 channels).
E2E_ARGV = ["--n-utts", "32", "--n-dev-utts", "8", "--n-test-utts", "8", "--am-steps", "40",
            "--aas-steps", "10", "--batch-size", "8"]
E2E_AAS_STEPS = int(E2E_ARGV[E2E_ARGV.index("--aas-steps") + 1])
E2E_KERNELS = ("stft", "istft", "gn_act", "lstm", "lstm_bwd", "gru", "gru_bwd", "gn_bwd",
               "conv_dw")
# The kernels' shapes at those widths in the flagship protocol's batch of 16
# from the long bucket of its corpus (6 s = 601 frames; the rows 301-542
# frames, ragged); the AM's conv1 halves the frames (ceil).
E2E_B = 16
E2E_T = 1 + 96000 // 160
E2E_AM_T = -(-E2E_T // 2)
E2E_FRAMES = [542, 512, 503, 480, 460, 440, 420, 400, 380, 360, 350, 340, 330, 320, 310, 302]


def kernels_e2e(device, results: dict) -> None:
    """The kernels at the e2e protocol's widths (E2E_*), which the other
    phases check only at 32 channels, LSTM H=256 and GRU H=512: each against
    its plain version on the same card inputs at the file's tolerances,
    timed in turns and kept as a shape of its kernel's row.  GroupNorm
    forward and backward (autograd through the wrapper's Function against
    autograd through the plain version) at the enhancer's [16, 601, 161, 16]
    leaky_relu and the AM's [16, 301, 81 | 41, 16] hardtanh; the BiLSTM-128
    and the BiGRU-256, forward and backward, each on the route RNN_ROUTES
    names; the conv weight gradient on the f32 route at the AM's conv2
    (11 x 21, stride (1, 2), x [16, 301, 81, 16]), with cuDNN's weight
    gradient timed beside it.  Fails where a wrapper did not launch its
    kernel."""
    import torch
    import torch.nn.functional as F
    from aas_enhancement_tpu_torch.ops.cuda import conv_dw as kconv
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.masking import time_mask

    gen = torch.Generator().manual_seed(21)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen)).to(device)

    frames = torch.tensor(E2E_FRAMES, device=device)
    am_frames = (frames + 1) // 2
    wrappers = kernel_counters()

    def launched(name, run):
        before = wrappers[name].launches
        out = run()
        torch.cuda.synchronize()
        if wrappers[name].launches == before:
            fail(f"{name} at the e2e widths: the wrapper launched no kernel")
        return out

    # label: (forward kernel, run(fn) -> outputs, (wrapper, plain), inputs,
    # forward work, backward work, the forward's check)
    cases = {}
    for act, t_len, f, lens in (("leaky_relu", E2E_T, 161, frames),
                                ("hardtanh", E2E_AM_T, 81, am_frames),
                                ("hardtanh", E2E_AM_T, 41, am_frames)):
        x = (0.5 + 3.0 * randn(E2E_B, t_len, f, 16)).requires_grad_()
        scale = (1 + randn(16, scale=0.1)).requires_grad_()
        bias = randn(16, scale=0.1).requires_grad_()
        kw = dict(num_groups=8, act=act, slope=0.2)
        valid = valid_share(lens, t_len)
        cases[f"{act} [{E2E_B}, {t_len}, {f}, 16]"] = (
            "gn_act", lambda fn, x=x, s=scale, b=bias, ln=lens, kw=kw: (fn(x, s, b, ln, **kw),),
            (gn.masked_group_norm_act, gn.masked_group_norm_act_plain), (x, scale, bias),
            ((valid + 1) * nbytes(x), 10.0 * valid * x.numel()),
            ((2 * valid + 1) * nbytes(x), 20.0 * valid * x.numel()), None)
    for cell, t_len, h, lens in (("lstm", E2E_T, 128, frames), ("gru", E2E_AM_T, 256, am_frames)):
        g = 4 if cell == "lstm" else 3
        gates = randn(t_len, E2E_B, 2 * g * h, scale=0.5).requires_grad_()
        wh = randn(2, h, g * h, scale=h ** -0.5).requires_grad_()
        bh = randn(2, g * h, scale=0.1).requires_grad_()
        m = time_mask(lens, t_len).T.contiguous()
        cells = 2 * t_len * E2E_B
        kernel = krnn.lstm_scan_tm if cell == "lstm" else krnn.gru_scan_tm
        plain = krnn.lstm_scan_tm_plain if cell == "lstm" else krnn.gru_scan_tm_plain
        cases[f"T={t_len} B={E2E_B} H={h} (clusters of {RNN_ROUTES[cell][h]})"] = (
            cell, _rnn_call(gates, m, wh, bh, g * h), (kernel, plain), (gates, wh, bh),
            (nbytes(gates, m, wh, bh) + cells * h * 4, 2.0 * cells * h * g * h),
            (4.0 * (cells * h * ((5 if cell == "gru" else 6) + 1 + g) + 2 * wh.numel()
                    + bh.numel()), 2.0 * 2 * cells * h * g * h), (f"{cell}_scan_tm", h))

    for label, (name, run, (kernel, plain), inputs, work, bwd_work, rnn) in cases.items():
        bwd = f"{name}_bwd" if name != "gn_act" else "gn_bwd"
        if rnn:
            kernel.route = krnn._BACKWARD[rnn[0]].route = None
        with torch.no_grad():
            k_out = launched(name, lambda: run(kernel))
            p_out = run(plain)
            ms, plain_ms = in_turns(lambda: run(kernel), lambda: run(plain),
                                    3 if rnn else 5, warmup=1)
        err = max_err(k_out, p_out)
        tol, why = TOL[name]
        text = keep(results, name, f"{name} {label} (e2e)", err, ms, plain_ms, work)
        print(f"[e2e] {name} {label}: max_abs_err {err:.3e} (tol {tol:.0e}: {why}) | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text}")
        if not err <= tol:
            fail(f"{name} {label} (e2e): max abs err {err:.3e} > tol {tol:.0e}")
        outs_k = launched(name, lambda: run(kernel))
        outs_p = run(plain)
        cots = tuple(torch.randn(o.shape, generator=gen).to(device) for o in outs_k)
        grads_k = launched(bwd, lambda: torch.autograd.grad(outs_k, inputs, cots,
                                                             retain_graph=True))
        grads_p = torch.autograd.grad(outs_p, inputs, cots, retain_graph=True)
        if rnn:
            cell, h = rnn[0].split("_")[0], rnn[1]
            routes = (kernel.route, krnn._BACKWARD[rnn[0]].route)
            if routes != (RNN_ROUTES[cell][h],) * 2:
                fail(f"{name} {label} (e2e): routes (forward, backward) {routes}, not "
                     f"clusters of {RNN_ROUTES[cell][h]}")
        err = max_err(grads_k, grads_p)
        rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(grads_k, grads_p))
        tol, why = BWD_TOL[bwd]
        ms, plain_ms = in_turns(
            lambda: torch.autograd.grad(outs_k, inputs, cots, retain_graph=True),
            lambda: torch.autograd.grad(outs_p, inputs, cots, retain_graph=True), 3, warmup=1)
        text = keep(results, bwd, f"{bwd} {label} (e2e)", err, ms, plain_ms, bwd_work,
                    rel_err=rel)
        print(f"[e2e] {bwd} {label}: grads max_abs_err {err:.3e}, relative to max|grad| "
              f"{rel:.3e} (tol {tol:.0e}: {why}) | backward pass {ms:.4f} ms | plain "
              f"backward {plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text}")
        if not rel <= tol:
            fail(f"{bwd} {label} (e2e): gradient error {rel:.3e} of max|grad| > tol {tol:.0e}")
        del outs_k, outs_p, grads_k, grads_p

    # The AM's conv2 weight gradient, dy zero past each row's frames as the
    # GroupNorm's mask leaves it.
    x = randn(E2E_B, E2E_AM_T, 81, 16)
    dy = randn(E2E_B, E2E_AM_T, 41, 16) * time_mask(am_frames, E2E_AM_T)[:, :, None, None]
    args = (x, dy, 11, 21, (1, 2))
    got = launched("conv_dw", lambda: kconv.conv_dw_same(*args))
    ref = kconv.conv_dw_same_plain(*args)
    if kconv.conv_dw_same.route != "fma":
        fail(f"conv_dw at the e2e widths took the {kconv.conv_dw_same.route!r} route, not fma")
    err = max_err(got, ref)
    rel = err / ref.abs().max().item()
    tol, why = BWD_TOL["conv_dw"]
    ms, plain_ms = in_turns(lambda: kconv.conv_dw_same(*args),
                            lambda: kconv.conv_dw_same_plain(*args), 5, warmup=1)
    # cuDNN's f32 weight gradient on the same tensors (kernels_conv_dw's NCHW
    # views), for the record only.
    pads = (*kconv.same_pad(81, 21, 2), *kconv.same_pad(E2E_AM_T, 11, 1))
    x_nchw, dy_nchw = F.pad(x.permute(0, 3, 1, 2), pads), dy.permute(0, 3, 1, 2)
    cudnn = lambda: torch.nn.grad.conv2d_weight(                           # noqa: E731
        x_nchw, (16, 16, 11, 21), dy_nchw, stride=(1, 2))
    lib_rel = (cudnn().permute(2, 3, 1, 0) - ref).abs().max().item() / ref.abs().max().item()
    lib_ms = statistics.median(cuda_ms(cudnn, 5))
    label = f"AM conv2 11x21 s(1,2) x [{E2E_B}, {E2E_AM_T}, 81, 16] (e2e)"
    text = keep(results, "conv_dw", label, err, ms, plain_ms,
                (nbytes(x, dy, ref), 2.0 * E2E_B * E2E_AM_T * 41 * 11 * 21 * 16 * 16),
                library_ms=lib_ms, rel_err=rel)
    print(f"[e2e] conv_dw {label}, f32 route fma: max_abs_err {err:.3e}, relative to "
          f"max|dW| {rel:.3e} (tol {tol:.0e}: {why}) | kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms | x{plain_ms / ms:.2f} | {text} (cuDNN's wgrad, f32, its "
          f"dW {lib_rel:.3e} of max|dW| from the plain version's; x{lib_ms / ms:.2f} the "
          f"kernel's time)")
    if not rel <= tol:
        fail(f"conv_dw {label}: error {rel:.3e} of max|dW| > tol {tol:.0e}")


def _numbers(obj, key: str = ""):
    """(key, number) of every number in a JSON-like result, nested ones too."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _numbers(v, f"{key}.{k}" if key else k)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _numbers(v, f"{key}[{i}]")
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield key, obj


def phase_e2e(device, card, results: dict, workdir: str) -> dict:
    """The kernels at the protocol's widths (``kernels_e2e``), then the
    end-to-end protocol (python -m aas_enhancement_tpu_torch.cli.e2e)
    on the card at E2E_ARGV into ``workdir`` (which ``phase_quality`` reads
    next), in this process with the kernels' launches counted: AM
    pre-training, held-out WER, AAS with the pre-trained AM frozen, the
    checkpoint, the LM-fused beams (tuned on dev), the
    train-split WERs, the streamed split, SI-SNR and STOI.  Fails unless the
    result has every key of the JAX round's e2e_result_r5.json (wall_minutes
    aside) with finite numbers, the AM's CTC fell, every kernel of the path
    launched and the host beam took the native route.  -> launches."""
    from aas_enhancement_tpu_torch.cli import e2e
    from aas_enhancement_tpu_torch.decode import beam

    kernels_e2e(device, results)
    with open(os.path.join(HERE, "e2e_result_r5.json")) as f:
        want = set(json.load(f)) - {"wall_minutes"}
    out: dict = {}
    argv = [*E2E_ARGV, "--workdir", workdir, "--device", str(device)]

    def run():
        beam.beam_decode.route = None
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            out["result"], out["walls"] = e2e.run(e2e.parse_args(argv))

    t0 = time.perf_counter()
    launches = counted(E2E_KERNELS, run)
    wall = time.perf_counter() - t0
    result, walls = out["result"], out["walls"]
    print(f"[e2e] cli.e2e {' '.join(E2E_ARGV)} on {card}: {wall:.1f} s; stages (s) "
          f"{json.dumps(walls)}; launches {json.dumps(launches)}")
    print(f"[e2e] AM CTC {result['am_ctc_first']:.3f} -> {result['am_ctc_last']:.3f}, AAS CTC "
          f"{result['aas_ctc_first']:.3f} -> {result['aas_ctc_last']:.3f}; greedy WER clean "
          f"{result['wer_clean_test']:.4f}, noisy {result['wer_noisy_test']:.4f}, enhanced "
          f"{result['wer_enhanced_test']:.4f}, streamed {result['wer_streamed_test']:.4f}; "
          f"beam wlm / clm / hybrid {result['wer_enhanced_test_beam_wlm']:.4f} / "
          f"{result['wer_enhanced_test_beam_clm']:.4f} / "
          f"{result['wer_enhanced_test_beam_hybrid']:.4f}; SI-SNR noisy / enhanced / "
          f"streamed {result['si_snr_noisy']:.3f} / {result['si_snr_enhanced']:.3f} / "
          f"{result['si_snr_streamed']:.3f} dB, STOI enhanced {result['stoi_enhanced']:.4f}; "
          f"host beam route {beam.beam_decode.route}")
    missing = sorted(want - set(result))
    if missing:
        fail(f"the e2e result lacks {missing}")
    bad = [k for k, v in _numbers(result) if not math.isfinite(v)]
    if bad:
        fail(f"the e2e result has non-finite numbers: {bad}")
    if not result["am_ctc_last"] < result["am_ctc_first"]:
        fail(f"the e2e AM's CTC did not fall: {result['am_ctc_first']} -> "
             f"{result['am_ctc_last']}")
    if beam.beam_decode.route != "native":
        fail(f"the e2e host beam took the {beam.beam_decode.route!r} route")
    idle = [k for k in E2E_KERNELS if not launches.get(k)]
    if idle:
        fail(f"the e2e path launched no {idle}: {launches}")
    return launches


# The quality protocols that read the e2e workdir (aas_enhancement_tpu_torch/
# quality/), chained on [e2e]'s tiny workdir: (label, module, argv; {wd} is
# the workdir), 3 training steps at B=8, one- or two-point grids.
QUALITY_CHAIN = (
    ("streaming_native_train", "streaming_native_train",
     ["--init", "trained", "--steps", "3", "--batch-size", "8"]),
    ("live_pipeline_eval", "live_pipeline_eval",
     ["--g-checkpoint", "{wd}/ck_g_stream_native", "--alpha-grid", "0.6", "--beta-grid",
      "0.5", "--word-alpha-grid", "0.3,0.6", "--word-beta-grid", "0.0"]),
    ("am_streaming_finetune", "am_streaming_finetune",
     ["--steps", "3", "--batch-size", "8", "--distill", "0.5"]),
    ("am_streaming_finetune_offline", "am_streaming_finetune",
     ["--steps", "3", "--batch-size", "8", "--offline"]),
    ("coadapt_alternate", "coadapt_alternate", ["--steps", "3", "--batch-size", "8"]),
    ("hybrid_fusion_eval", "hybrid_fusion_eval",
     ["--g-checkpoint", "{wd}/ck_g_coadapt", "--am-checkpoint", "{wd}/ck_am_offline_ft"]),
    ("streaming_sweep", "streaming_sweep",
     ["--chunks", "1.0", "--lookaheads", "0.2", "--histories", "0.5,1.0"]),
    ("streaming_finetune_eval", "streaming_finetune_eval",
     ["--steps", "3", "--batch-size", "8"]),
)
# The keys of each result as the port's CPU run gives them (held there to the
# JAX scripts' by tests/test_torch_quality_*.py).
_STREAM_POINT = {"chunk_s", "lookahead_s", "history_s"}
_AM_FT = {"steps", "offline", *_STREAM_POINT, "g_checkpoint", "lr_scale", "distill_lambda",
          "am_init", "ft_loss_first", "ft_loss_last", "checkpoint_dir", "wall_minutes"}
QUALITY_KEYS = {
    "streaming_native_train": {"steps", "init", *_STREAM_POINT, "wer_offline_test_anchor",
                               "wer_streamed_feats_test_anchor", "ctc_first", "ctc_last",
                               "wer_offline_test", "wer_streamed_feats_test",
                               "wer_streamed_feats_dev", "streamed_improvement_vs_offline_g",
                               "checkpoint_dir", "wall_minutes"},
    "live_pipeline_eval": {"workdir", "g_checkpoint", "am_checkpoint", *_STREAM_POINT,
                           "latency_s", "beam_width", "prune_k", "grids", "dev_greedy",
                           "tuned", "live_greedy_test", "live_greedy_test_ci95",
                           "live_hybrid_test", "utterances", "wall_minutes"},
    "am_streaming_finetune": _AM_FT | {
        "wer_streamed_feats_dev_before", "wer_streamed_feats_test_before",
        "wer_offline_test_before", "wer_streamed_feats_dev_after",
        "wer_streamed_feats_test_after", "wer_offline_test_after",
        "streamed_feats_improvement"},
    "am_streaming_finetune_offline": _AM_FT | {
        "wer_offline_dev_before", "wer_offline_test_before", "wer_offline_dev_after",
        "wer_offline_test_after", "offline_improvement"},
    "coadapt_alternate": {"steps", "am_checkpoint", "lr_scale", "g_init", "wer_test_before",
                          "wer_dev_before", "ft_loss_first", "ft_loss_last", "wer_test_after",
                          "wer_dev_after", "wer_test_gprime_base_am", "improvement",
                          "checkpoint_dir", "wall_minutes"},
    "hybrid_fusion_eval": {"workdir", "char_order", "beam_width", "prune_k", "am_checkpoint",
                           "g_checkpoint", "tuning", "wer_test_greedy", "wer_test_char",
                           "wer_test_hybrid", "utterances_test"},
    "streaming_sweep": {"wer_noisy", "wer_offline", "grid", "wall_minutes"},
    "streaming_finetune_eval": {"steps", *_STREAM_POINT, "wer_offline_before",
                                "wer_streamed_before", "ft_loss_first", "ft_loss_last",
                                "checkpoint_dir", "wer_streamed_after", "wer_offline_after",
                                "streamed_improvement", "penalty_before", "penalty_after",
                                "wall_minutes"},
}
# Each checkpoint the chain writes: (objective, the G's streaming point in
# its config, the point cli.serve --streaming-checkpoint serves it at).
QUALITY_CHECKPOINTS = {"ck_g_stream_native": ("aas", (1.0, 0.5, 0.5)),
                       "ck_am_stream_ft": ("am", None), "ck_am_offline_ft": ("am", None),
                       "ck_g_coadapt": ("acoustic", None),
                       "ck_stream_ft": ("aas", (1.0, 0.2, 1.0))}


def run_quality_chain(workdir: str, device, chain=QUALITY_CHAIN, **fields) -> tuple[dict, dict]:
    """Each protocol of ``chain`` in turn on ``workdir`` (its prints and the
    train loop's records swallowed; ``fields`` filled into its argv beside
    {wd}) -> ({label: result}, {label: seconds})."""
    import importlib

    import torch
    results, walls = {}, {}
    for label, name, argv in chain:
        mod = importlib.import_module(f"aas_enhancement_tpu_torch.quality.{name}")
        args = mod.parse_args([*(a.format(wd=workdir, **fields) for a in argv),
                               "--workdir", workdir, "--device", str(device)])
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            results[label] = mod.run(args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        walls[label] = round(time.perf_counter() - t0, 2)
    return results, walls


def phase_quality(device, card, workdir: str) -> dict:
    """The seven quality protocols of aas_enhancement_tpu_torch/quality/ on
    [e2e]'s workdir, chained as QUALITY_CHAIN (the streaming-native G into
    the live pipeline; the offline-adapted AM into the co-adaptation and the
    pair into the hybrid fusion), on the card in this process with the
    kernels' launches counted; then every checkpoint through load_state, and
    the streaming G's through cli.serve --streaming-checkpoint (start_server,
    transcribe mode at the checkpoint's point, stopped at once).  Fails unless
    each result has exactly QUALITY_KEYS' keys with finite numbers, every
    checkpoint opens with its objective, both G checkpoints serve as the
    streaming weights, the host beam took the native route and each of B1,
    B1', B2, B2', B3, B3', B4, B5 and B6 launched.  -> launches."""
    from aas_enhancement_tpu_torch.cli import serve as serve_cli
    from aas_enhancement_tpu_torch.decode import beam
    from aas_enhancement_tpu_torch.train.loop import load_state

    out: dict = {}

    def run():
        beam.beam_decode.route = None
        out["results"], out["walls"] = run_quality_chain(workdir, device)

    t0 = time.perf_counter()
    launches = counted(E2E_KERNELS, run)
    wall = time.perf_counter() - t0
    results, walls = out["results"], out["walls"]
    print(f"[quality] the chain on {card}: {wall:.1f} s; seconds a protocol "
          f"{json.dumps(walls)}; launches {json.dumps(launches)}; host beam route "
          f"{beam.beam_decode.route}")
    for label, result in results.items():
        numbers = {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in _numbers(result) if not k.startswith(("steps", "grids"))}
        print(f"[quality] {label}: {json.dumps(numbers)}")
        got, want = set(result), QUALITY_KEYS[label]
        if got != want:
            fail(f"{label}: result keys {sorted(got ^ want)} differ from the CPU run's")
        bad = [k for k, v in _numbers(result) if not math.isfinite(v)]
        if bad:
            fail(f"{label}: non-finite numbers {bad}")
    for name, (objective, point) in QUALITY_CHECKPOINTS.items():
        ck = os.path.join(workdir, name)
        state, cfg = load_state(ck, device)
        steps = 3 + (E2E_AAS_STEPS if name == "ck_stream_ft" else 0)
        if cfg.train.objective != objective or state.step != steps:
            fail(f"{name}: load_state gave objective {cfg.train.objective!r}, step "
                 f"{state.step}")
        if point is None:
            continue
        chunk, lookahead, history = (str(x) for x in point)
        with contextlib.redirect_stdout(io.StringIO()):      # its advisories
            server, line = serve_cli.start_server(
                ["--checkpoint", os.path.join(workdir, "checkpoint"), "--streaming-checkpoint",
                 ck, "--transcribe", "--weights", "streaming", "--port", "0",
                 "--max-streams", "1", "--chunk", chunk, "--lookahead", lookahead,
                 "--history", history, "--device", str(device)])
        server.stop()
        print(f"[quality] cli.serve --streaming-checkpoint {name} --transcribe at "
              f"{point}: weights {line['weights']}")
        if line["weights"] != "streaming":
            fail(f"{name}: cli.serve served the {line['weights']!r} weights")
    if beam.beam_decode.route != "native":
        fail(f"the quality chain's host beam took the {beam.beam_decode.route!r} route")
    idle = [k for k in E2E_KERNELS if not launches.get(k)]
    if idle:
        fail(f"the quality chain launched no {idle}: {launches}")
    return launches


# The quality protocols with a workdir of their own, chained in a temporary
# workdir at the 1000-word, -7...-2 dB condition, cut to 16 / 4 / 4
# utterances, 5 AM steps at B=8, 2000 LM sentences, beam 8: (label, module,
# argv; {result} the result file all three patch, {e2e} [e2e]'s workdir).
FUSION_CHAIN = (
    ("trigram_fusion_eval", "trigram_fusion_eval",
     ["--n-utts", "16", "--n-dev-utts", "4", "--n-test-utts", "4", "--am-steps", "5",
      "--batch-size", "8", "--lexicon-size", "1000", "--lm-sentences", "2000",
      "--snr-low", "-7", "--snr-high", "-2", "--beam-width", "8", "--out", "{result}"]),
    ("trigram_bigtest", "trigram_bigtest",
     ["--n-utts", "8", "--batch-size", "8", "--beam-width", "8", "--result", "{result}"]),
    ("biglex_hard_pipeline", "biglex_hard_pipeline",
     ["--flagship", "{e2e}/checkpoint", "--batch-size", "8", "--beam-width", "8",
      "--result", "{result}"]),
)
FUSION_AM_STEPS = 5
FUSION_KERNELS = ("stft", "gn_act", "lstm", "gru", "gru_bwd", "gn_bwd", "conv_dw")
# The keys each protocol writes into the result file (held to the JAX
# scripts' by tests/test_torch_quality_fusion_calls.py); a file patched in
# turn has the union of its writers'.
_FUSION_LEGS = {"lm_bi_alpha", "lm_bi_beta", "wer_dev_beam_bi", "wer_test_bi", "wer_test_bi_ci95",
                "lm_tri_alpha", "lm_tri_beta", "wer_dev_beam_tri", "wer_test_tri",
                "wer_test_tri_ci95"}
FUSION_KEYS = {
    "trigram_fusion_eval": {"n_utts", "am_steps", "tri_classes", "lexicon_size",
                            "lm_sentences", "snr_range", "heldout_logp_per_word_bi",
                            "heldout_logp_per_word_tri", "export_mb", "wer_greedy_test",
                            "wer_greedy_test_ci95", "wer_beam_nolm_test", "wer_dev_beam_no_lm",
                            *_FUSION_LEGS, "trigram_win_abs", "cli_evaluate_word_lm_tri",
                            "wall_minutes"},
    "trigram_bigtest": {"wer_test_bi_big", "wer_test_bi_big_ci95", "wer_test_tri_big",
                        "wer_test_tri_big_ci95", "big_paired", "n_big_test_utts",
                        "trigram_win_abs_big"},
    "biglex_hard_pipeline": {"wer_pipeline_noisy_greedy_test", "wer_pipeline_enh_greedy_test",
                             "wer_pipeline_enh_greedy_test_ci95", "sample_pipeline",
                             "wer_pipeline_dev_beam_no_lm",
                             *(k.replace("lm_", "pipeline_lm_").replace("wer_", "wer_pipeline_")
                               for k in _FUSION_LEGS),
                             "pipeline_paired", "pipeline_trigram_win_abs",
                             "pipeline_wall_minutes", "pipeline_flagship"},
}


def fusion_keys(*names: str) -> set:
    """The keys of a result file that the protocols ``names`` patched in turn."""
    return set().union(*(FUSION_KEYS[n] for n in names))


def phase_fusion(device, card, e2e_workdir: str) -> dict:
    """The three quality protocols with a workdir of their own, chained as
    FUSION_CHAIN in a temporary workdir, on the card in this process with
    the kernels' launches counted: trigram_fusion_eval (the corpora, the AM
    through cli.train, word{2,3}.arpa fitted and read back, greedy and
    beams tuned on dev, cli.evaluate --lm word3.arpa), trigram_bigtest on
    its workdir, biglex_hard_pipeline with [e2e]'s checkpoint as the
    flagship stack; then ckpt_am through load_state.  Fails unless each
    result has exactly the keys its writers give (FUSION_KEYS) with finite
    numbers, the trigram's held-out log-p per word is above the bigram's,
    ckpt_am opens as objective am at its step, the host beam took the
    native route and each of B1, B2, B2', B3, B3', B4 and B6 launched.
    -> launches."""
    from aas_enhancement_tpu_torch.decode import beam
    from aas_enhancement_tpu_torch.train.loop import load_state

    workdir = tempfile.mkdtemp(prefix="aas_fusion_")
    out: dict = {}

    def run():
        beam.beam_decode.route = None
        out["results"], out["walls"] = run_quality_chain(
            workdir, device, FUSION_CHAIN, result=os.path.join(workdir, "result.json"),
            e2e=e2e_workdir)

    try:
        t0 = time.perf_counter()
        launches = counted(E2E_KERNELS, run)
        wall = time.perf_counter() - t0
        state, cfg = load_state(os.path.join(workdir, "ckpt_am"), device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    results, walls = out["results"], out["walls"]
    print(f"[fusion] the chain on {card}: {wall:.1f} s; seconds a protocol "
          f"{json.dumps(walls)}; launches {json.dumps(launches)}; host beam route "
          f"{beam.beam_decode.route}")
    done = []
    for name, result in results.items():
        done.append(name)
        numbers = {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in _numbers({k: result[k] for k in sorted(FUSION_KEYS[name])
                                         if k in result})}
        print(f"[fusion] {name}: {json.dumps(numbers)}")
        got, want = set(result), fusion_keys(*done)
        if got != want:
            fail(f"{name}: result keys {sorted(got ^ want)} differ from the JAX script's")
        bad = [k for k, v in _numbers(result) if not math.isfinite(v)]
        if bad:
            fail(f"{name}: non-finite numbers {bad}")
    tri = results["trigram_fusion_eval"]
    if not tri["heldout_logp_per_word_tri"] > tri["heldout_logp_per_word_bi"]:
        fail(f"the trigram ARPA's held-out log-p per word {tri['heldout_logp_per_word_tri']} "
             f"is not above the bigram's {tri['heldout_logp_per_word_bi']}")
    if cfg.train.objective != "am" or state.step != FUSION_AM_STEPS:
        fail(f"ckpt_am: load_state gave objective {cfg.train.objective!r}, step {state.step}")
    if beam.beam_decode.route != "native":
        fail(f"the fusion chain's host beam took the {beam.beam_decode.route!r} route")
    idle = [k for k in FUSION_KERNELS if not launches.get(k)]
    if idle:
        fail(f"the fusion chain launched no {idle}: {launches}")
    return launches


SERVE_POINTS = {"enhance": (1.0, 0.2, 0.5), "transcribe": (1.0, 0.5, 0.5)}
SERVE_SLOTS = 8                          # --max-streams of the CLI runs
TICK_SLOTS = ((64, 1), (64, 8), (64, 64), (1, 1), (8, 8))   # (engine slots, busy)
SERVE_KERNELS = {"enhance": ("stft", "istft", "gn_act", "lstm"),
                 "transcribe": ("stft", "gn_act", "lstm", "gru")}
SERVE_TOL = (1e-4, "samples in [-1, 1] after STFT, 2 conv+GN, 2 BiLSTM-256 over 171 "
             "steps and ISTFT, each block normalized with running moments: the server "
             "batches 8 rows where the reference runs 1 (cuBLAS picks kernels by M) or "
             "runs on the CPU (other sum orders); the CLI's own process keeps PyTorch's "
             "defaults, so its convolutions run in TF32 (cuDNN), the references in f32")
EXPORT_TOL = (0.0, "the artifact runs the live path's operators and aten ops on the "
              "same inputs, TF32 off in both processes")
EXPORT_LENGTHS = [N, 112000, 96000, 64000, N, 120000, 80000, 40000]
SOCK_TIMEOUT = 120.0
SERVE_DEVICE_ARGS: list = []             # the CLIs' default device, the card


def serve_checkpoint(cfg, root: str) -> str:
    """A train-CLI directory (``aas``: G, D and the frozen AM) of ``cfg``
    from seeds, as the train CLI leaves it."""
    from aas_enhancement_tpu_torch.train.loop import init_state
    from aas_enhancement_tpu_torch.utils import checkpoint as ckpt
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, objective="aas"))
    d = os.path.join(root, "ck_aas")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as f:
        f.write(cfg.to_json())
    ckpt.save(d, 1, init_state(cfg, 0, "cpu", am_seed=0))
    return d


def run_sessions(address, wavs, transcribe: bool) -> tuple[list, list, bool]:
    """Connect one session per stream, then one more (all slots are taken by
    then: the server accepts in order, so it must answer with the
    end-of-stream frame), then stream every session concurrently, pushing
    4000-sample frames from a writer thread -> (outputs, seconds from each
    session's end-of-stream sent to the server's received, the extra
    session was refused)."""
    import socket
    import struct
    import threading
    import numpy as np
    from aas_enhancement_tpu_torch.serve import (_recv_exact, recv_frame, recv_frame_bytes,
                                                 send_eos, send_frame)
    socks = [socket.create_connection(address, timeout=SOCK_TIMEOUT) for _ in wavs]
    extra = socket.create_connection(address, timeout=SOCK_TIMEOUT)
    refused = _recv_exact(extra, 4) == struct.pack("<I", 0)
    extra.close()
    outs, lat = [None] * len(wavs), [None] * len(wavs)

    def session(i):
        sock, sent = socks[i], {}

        def push():
            for k in range(0, len(wavs[i]), 4000):
                send_frame(sock, wavs[i][k: k + 4000])
            send_eos(sock)
            sent["t"] = time.perf_counter()

        w = threading.Thread(target=push, daemon=True)
        w.start()
        parts = []
        while (f := (recv_frame_bytes if transcribe else recv_frame)(sock)) is not None:
            parts.append(f)
        done = time.perf_counter()
        w.join(timeout=SOCK_TIMEOUT)
        sock.close()
        outs[i] = ("".join(p.decode("utf-8") for p in parts) if transcribe
                   else np.concatenate(parts) if parts else np.zeros(0, np.float32))
        lat[i] = done - sent["t"] if "t" in sent else None

    threads = [threading.Thread(target=session, args=(i,), daemon=True)
               for i in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=SOCK_TIMEOUT)
    if any(t.is_alive() for t in threads) or None in lat:
        fail("a server session did not end within its timeout")
    return outs, lat, refused


def start_serve_cli(argv: list) -> tuple:
    """``python -m aas_enhancement_tpu_torch.cli.serve ARGV`` in a process of
    its own -> (the process, its JSON line, seconds from the start to the
    line)."""
    import queue
    import threading
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "aas_enhancement_tpu_torch.cli.serve",
                             *argv, *SERVE_DEVICE_ARGS], cwd=HERE, stdout=subprocess.PIPE,
                            text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout] + [lines.put(None)],
                     daemon=True).start()
    while True:
        try:
            line = lines.get(timeout=max(1.0, 300.0 - (time.perf_counter() - t0)))
        except queue.Empty:
            line = None
        if line is None:
            stop_process(proc)
            fail(f"cli.serve {argv} printed no JSON line (exit {proc.returncode})")
        if line.startswith("{"):
            return proc, json.loads(line), time.perf_counter() - t0
        print(f"[serve] cli.serve: {line.rstrip()}")


def stop_process(proc) -> int:
    """Ctrl-C (the CLI stops its server), else kill -> the exit code."""
    import signal
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
    return proc.returncode


def phase_serve(device, card):
    """The serve CLI on the card at full width: a checkpoint directory
    written here; ``load_state``'s seconds with and without the random draw
    it made before; ``cli.serve`` in a process of its own (start-up seconds)
    and in this one through ``start_server`` (launches counted), each with 8
    concurrent sessions (a 9th refused) of synthetic streams against the
    single-stream engine on the card and the CPU (enhance) or its transcript
    on the card (transcribe); then engine ticks timed at 1, 8 and 64 busy
    slots.  -> (launches of the in-process sessions, the directory's root,
    the checkpoint directory)."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.cli import serve as serve_cli
    from aas_enhancement_tpu_torch.config import Config
    from aas_enhancement_tpu_torch.streaming import BatchedStreamingEnhancer, StreamingEnhancer
    from aas_enhancement_tpu_torch.streaming_asr import (BatchedStreamingRecognizer,
                                                         StreamingRecognizer)
    from aas_enhancement_tpu_torch.train.loop import init_state, load_state
    from aas_enhancement_tpu_torch.utils import checkpoint as ckpt

    cfg = Config()
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    t0 = time.perf_counter()
    ck = serve_checkpoint(cfg, root)
    mb = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ck) for f in fs) / 1e6
    print(f"[serve] checkpoint directory (aas: G, D, the AM; full width) {mb:.1f} MB written "
          f"in {time.perf_counter() - t0:.2f} s")

    # --- load_state: the draw it made before (init_state + load_state_dict,
    # what the function did up to this change) against the build without it
    def drawn():
        with open(os.path.join(ck, "config.json")) as f:
            c = Config.from_json(f.read())
        st = init_state(c, 0, device)
        blob = ckpt.read(ck, ckpt.latest_step(ck), device)
        for name in ("g", "d", "am"):
            getattr(st, name).load_state_dict(blob[name])
        return st

    secs = {"drawn": [], "load_state": []}
    for what in ("drawn", "load_state", "load_state", "drawn"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = drawn() if what == "drawn" else load_state(ck, device)[0]
        torch.cuda.synchronize()
        secs[what].append(time.perf_counter() - t0)
    a, b = (statistics.median(v) for v in (secs["drawn"], secs["load_state"]))
    if not all(torch.equal(x, y) for x, y in zip(drawn().am.state_dict().values(),
                                                  st.am.state_dict().values())):
        fail("load_state's AM differs from the drawn-then-loaded one")
    print(f"[serve] load_state onto {card} (one aas directory: G, D, the AM): the draw it "
          f"made before (init_state + load_state_dict) {a:.3f} s, without it {b:.3f} s "
          f"(median of 2, in turns; {json.dumps({k: [round(x, 3) for x in v] for k, v in secs.items()})})")

    state, _ = load_state(ck, device)
    state_cpu, _ = load_state(ck, "cpu")
    gen = torch.Generator().manual_seed(37)
    wavs = [stream_wav(sec, gen) for sec in STREAM_SECONDS]
    hop = cfg.audio.hop_length
    by_mode: dict = {}
    for mode, (chunk, look, hist) in SERVE_POINTS.items():
        kw = dict(chunk_seconds=chunk, lookahead_seconds=look, history_seconds=hist)
        transcribe = mode == "transcribe"
        window = int((chunk + look + hist) * SR)
        # References: each stream alone through the single-stream engine.
        refs, t0 = {}, time.perf_counter()
        if transcribe:
            frames_lp = []
            for w in wavs:
                rec = StreamingRecognizer(cfg, state.am, state.g, collect_logits=True,
                                          device=device, **kw)
                rec.feed(w)
                rec.flush()
                frames_lp.append(rec.log_probs())
                refs.setdefault("card", []).append(rec.transcript())
        else:
            for tag, (dev, g) in (("card", (device, state.g)), ("CPU", ("cpu", state_cpu.g))):
                refs[tag] = []
                for w in wavs:
                    eng = StreamingEnhancer(cfg, g, device=dev, **kw)
                    refs[tag].append(np.concatenate([eng.feed(w), eng.flush()]))
        ref_s = time.perf_counter() - t0
        argv = ["--checkpoint", ck, "--port", "0", "--max-streams", str(SERVE_SLOTS),
                *(["--transcribe"] if transcribe else [])]
        runs = {}
        proc, line, startup = start_serve_cli(argv)
        try:
            addr = line["serving"].rsplit(":", 1)
            runs["cli.serve process"] = run_sessions((addr[0], int(addr[1])), wavs, transcribe)
        finally:
            code = stop_process(proc)
        if code != 0:
            fail(f"cli.serve ({mode}) exited {code} after Ctrl-C")
        want = {"mode": mode, "chunk_s": chunk, "lookahead_s": look, "history_s": hist,
                "max_streams": SERVE_SLOTS, "latency_s": chunk + look}
        if any(line.get(k) != v for k, v in want.items()):
            fail(f"cli.serve ({mode}) printed {line}")
        print(f"[serve] cli.serve {mode} (its own process, no --device: the card): start-up "
              f"{startup:.2f} s from the process start to its JSON line {json.dumps(line)}")
        res = {}

        def in_process():
            t0 = time.perf_counter()
            server, _ = serve_cli.start_server(argv + SERVE_DEVICE_ARGS)
            print(f"[serve] {mode}: start_server in this process (load_state, engine, one "
                  f"warm call over idle rows) {time.perf_counter() - t0:.3f} s")
            try:
                res["out"] = run_sessions(server.address, wavs, transcribe)
            finally:
                server.stop()

        by_mode[mode] = counted(SERVE_KERNELS[mode], in_process)
        runs["start_server in this process"] = res["out"]
        for where, (outs, lat, refused) in runs.items():
            if not refused:
                fail(f"{mode} server ({where}): a 9th session while 8 were open was not refused")
            if transcribe:
                differ = [i for i, (o, r) in enumerate(zip(outs, refs["card"])) if o != r]
                small = [clear_ids(lp, lp, 2 * STREAM_TOL[0]) for lp in frames_lp]
                unsure = [len(lp) - s for lp, (s, _) in zip(frames_lp, small)]
                detail = (f"transcripts equal to StreamingRecognizer's on the card for "
                          f"{len(outs) - len(differ)} of {len(outs)} sessions (differ: "
                          f"{differ}); ids with a top-2 margin under {2 * STREAM_TOL[0]:.0e} "
                          f"per session {unsure}")
                if any(unsure[i] == 0 for i in differ):
                    fail(f"{mode} server ({where}): a transcript differs with no small-margin id")
            else:
                if [o.shape for o in outs] != [w.shape for w in wavs]:
                    fail(f"{mode} server ({where}): emitted {[o.shape for o in outs]}")
                errs = {tag: max(float(np.abs(o - r).max()) for o, r in zip(outs, refs[tag]))
                        for tag in ("card", "CPU")}
                detail = (f"max_abs_err against StreamingEnhancer on the card "
                          f"{errs['card']:.3e}, on the CPU {errs['CPU']:.3e} (tol "
                          f"{SERVE_TOL[0]:.0e}: {SERVE_TOL[1]})")
                if not max(errs.values()) <= SERVE_TOL[0]:
                    fail(f"{mode} server ({where}): {errs}")
            print(f"[serve] {mode}, {where}, {len(wavs)} concurrent sessions of "
                  f"{list(STREAM_SECONDS)} s, a 9th refused: {detail}; seconds from a "
                  f"session's end-of-stream sent to received {[round(x, 4) for x in lat]} "
                  f"(references {ref_s:.2f} s)")
        print(f"[serve] {mode}: launches of the in-process sessions {json.dumps(by_mode[mode])}")
        for name, count in by_mode[mode].items():
            if count == 0:
                fail(f"the {mode} server launched no {name} kernel")

        # --- ticks: one engine step over `busy` ready slots of `slots`
        long = stream_wav(60.0, gen)
        chunk_n, look_n = int(chunk * SR), int(look * SR)
        for slots, busy in TICK_SLOTS:
            if transcribe:
                eng = BatchedStreamingRecognizer(cfg, state.am, state.g, max_streams=slots,
                                                 device=device, **kw)
            else:
                eng = BatchedStreamingEnhancer(cfg, state.g, max_streams=slots,
                                               device=device, **kw)
            ids = [eng.open() for _ in range(busy)]
            for s in ids:
                eng.feed(s, long[:look_n])
            pos = {"i": look_n}

            def tick():
                i = pos["i"] % (len(long) - chunk_n)
                pos["i"] += chunk_n
                for s in ids:
                    eng.feed(s, long[i: i + chunk_n])
                if len(eng.step()) != busy:
                    fail("a tick did not advance every busy slot")

            r = serving_timings(f"{mode} tick, {busy} busy of {slots} slots", card, tick, busy,
                                SERVE_KERNELS[mode], phase="serve", chunk_s=chunk)
            waves = [rnn_waves("lstm", cfg.enhancer.rnn_hidden, slots, window // hop + 1,
                               False)]
            if transcribe:
                waves.append(rnn_waves("gru", cfg.am.rnn_hidden, slots,
                                       (window // hop + 2) // 2, False))
            print(f"[serve] {mode} tick, {busy} busy of {slots} slots on {card}: "
                  f"{r['wall_ms']:.3f} ms, headroom {chunk * 1e3 / r['wall_ms']:.1f}x "
                  f"(chunk / tick), busy {r['busy_ms']:.3f} ms, idle "
                  f"{100 * (1 - r['busy_ms'] / r['wall_ms']):.1f}%; {' | '.join(waves)}")
            del eng
    operator_dispatch(device, card, cfg)
    total = {}
    for counts in by_mode.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total, root, ck


def operator_dispatch(device, card, cfg) -> None:
    """Host time a call of each operator of ``ops/library.py`` against its
    launcher called directly, on the inputs of a 1-slot enhance tick (the
    AM's GRU at its window): the calls are enqueued behind a sleeping kernel,
    so the host clock reads the Python and dispatch work alone."""
    import torch
    from aas_enhancement_tpu_torch.ops import library
    from aas_enhancement_tpu_torch.ops.cuda import gn
    from aas_enhancement_tpu_torch.ops.cuda import rnn as krnn
    from aas_enhancement_tpu_torch.ops.cuda import stft as kstft
    gen = torch.Generator().manual_seed(43)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(device)   # noqa: E731
    t, f, c, h = 171, cfg.audio.num_bins, cfg.enhancer.conv_channels, cfg.enhancer.rnn_hidden
    x, re, im = rnd(1, 27200), rnd(1, t, f), rnd(1, t, f)
    xg, lengths = rnd(1, t, f, c), torch.tensor([t], device=device)
    scale, bias = torch.ones(c, device=device), torch.zeros(c, device=device)
    gl, wl, bl = rnd(t, 1, 8 * h), 0.1 * rnd(2, h, 4 * h), rnd(2, 4 * h)
    ha = cfg.am.rnn_hidden
    gg, wg, bg = rnd(101, 1, 6 * ha), 0.1 * rnd(2, ha, 3 * ha), rnd(2, 3 * ha)
    m, ma = torch.ones(t, 1, device=device), torch.ones(101, 1, device=device)
    cases = {
        "stft": (lambda: library.stft(x, 320, 160, "hann", True),
                 lambda: kstft.stft_kernel(x, 320, 160, "hann", True)),
        "istft": (lambda: library.istft(re, im, 320, 160, "hann", True, 27200),
                  lambda: kstft.istft_kernel(re, im, 320, 160, "hann", True, 27200)),
        "masked_group_norm_act": (
            lambda: library.masked_group_norm_act(xg, scale, bias, lengths, 8, 1e-5,
                                                  "leaky_relu", 0.2),
            lambda: gn.gn_kernel(xg, scale, bias, lengths, 8, 1e-5, "leaky_relu", 0.2)),
        "lstm_scan_tm": (lambda: library.lstm_scan_tm(gl[..., :4 * h], gl[..., 4 * h:], m, wl, bl),
                         lambda: krnn.scan_kernel("lstm_scan_tm", (gl[..., :4 * h],
                                                  gl[..., 4 * h:]), m, wl, bl)),
        "gru_scan_tm": (lambda: library.gru_scan_tm(gg[..., :3 * ha], gg[..., 3 * ha:], ma, wg, bg),
                        lambda: krnn.scan_kernel("gru_scan_tm", (gg[..., :3 * ha],
                                                 gg[..., 3 * ha:]), ma, wg, bg)),
    }

    def host_us(fn, n: int = 100) -> float:
        torch.cuda.synchronize()
        torch.cuda._sleep(int(2e8))          # ~0.1 s of device time ahead of the calls
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return host

    out = {}
    with torch.inference_mode():
        for name, (op, launcher) in cases.items():
            op(), launcher()
            a, b = host_us(op), host_us(launcher)
            a, b = (a + host_us(op)) / 2, (b + host_us(launcher)) / 2
            out[name] = {"operator_us": round(a, 2), "launcher_us": round(b, 2)}
    print(f"[serve] host time a call (us), operator vs its launcher called directly, at a "
          f"1-slot enhance tick's shapes (GRU at the AM's 101 frames), calls enqueued behind "
          f"a sleeping kernel, on {card}: {json.dumps(out)}")


EXPORT_SCRIPT = r'''
import time
t_start = time.perf_counter()
import json, sys
import numpy as np
import torch
t_torch = time.perf_counter()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from aas_enhancement_tpu_torch.ops.cuda import gn, rnn, stft
from aas_enhancement_tpu_torch.serving import load_enhancer
t_port = time.perf_counter()
art, inputs, outputs = sys.argv[1:4]
torch.zeros(1, device=sys.argv[4] if sys.argv[4:] else "cuda")
t_ctx = time.perf_counter()
t0 = time.perf_counter()
served = load_enhancer(art, *sys.argv[4:])
load_s = time.perf_counter() - t0
startup = {"import torch": t_torch - t_start, "import the port": t_port - t_torch,
           "device context": t_ctx - t_port, "load_enhancer": load_s}
counters = {"stft": stft.stft, "istft": stft.istft, "gn_act": gn.masked_group_norm_act,
            "lstm": rnn.lstm_scan_tm}
x = np.load(inputs)
out, launches = {}, {}
for case in ("b1", "b8", "pad"):
    before = {k: c.launches for k, c in counters.items()}
    t0 = time.perf_counter()
    out[case] = served.enhance(x[case + "_wav"], x[case + "_len"])
    startup[f"first {case} call"] = time.perf_counter() - t0
    launches[case] = {k: c.launches - before[k] for k, c in counters.items()}
try:
    served.enhance(np.zeros((1, 200000), np.float32))
    uncovered = None
except ValueError as e:
    uncovered = str(e)
np.savez(outputs, **out)
bad = [m for m in sys.modules if m.startswith(("aas_enhancement_tpu_torch.models",
       "aas_enhancement_tpu_torch.train", "jax", "flax", "aas_enhancement_tpu."))]
t0 = time.perf_counter()
served.enhance(x["b8_wav"], x["b8_len"])
startup["second B=8 call"] = time.perf_counter() - t0
print(json.dumps({"load_s": load_s, "launches": launches, "uncovered": uncovered,
                  "buckets": served.buckets(), "imported": bad, "startup_s": startup}))
'''


def phase_export(device, card, root: str, ck: str):
    """``cli.export --batch-sizes 1,8 --seconds 8`` on the card from the serve
    phase's directory; the artifact in a fresh process with no model code
    and no checkpoint at B=1 and B=8 x 8 s and a (1, 10000) input (the
    (1, 128000) bucket) against ``make_enhance_fn`` on the same weights, its
    launches a call, load seconds and MB, an uncovered shape refused; then
    artifact and live calls timed in turns.  -> launches of one B=8 artifact
    call."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.cli import export as export_cli
    from aas_enhancement_tpu_torch.enhance import make_enhance_fn
    from aas_enhancement_tpu_torch.serving import load_enhancer
    from aas_enhancement_tpu_torch.train.loop import load_state

    art = os.path.join(root, "artifact")
    t0 = time.perf_counter()
    line, _, n = _cli_run("cli.export --batch-sizes 1,8 --seconds 8 (no --device: the card)",
                          export_cli.main, ["--checkpoint", ck, "--out", art, "--batch-sizes",
                                            "1,8", "--seconds", "8", *SERVE_DEVICE_ARGS],
                          phase="export", names=SERVE_KERNELS["enhance"])
    export_s = time.perf_counter() - t0
    if line.get("buckets") != [[1, N], [8, N]]:
        fail(f"cli.export printed {line}")
    files = {f: os.path.getsize(os.path.join(art, f)) / 1e6 for f in sorted(os.listdir(art))}
    print(f"[export] {export_s:.2f} s; artifact files (MB) {json.dumps(files)}, "
          f"{sum(files.values()):.1f} MB; launches while exporting {json.dumps(n)} "
          "(export traces with fake tensors: none expected)")

    gen = torch.Generator().manual_seed(41)
    lens8 = np.array(EXPORT_LENGTHS, np.int64)
    b8 = stream_wav(8.0 * 8, gen).reshape(8, N) * (np.arange(N)[None] < lens8[:, None])
    inputs = {"b1_wav": stream_wav(8.0, gen)[None], "b1_len": np.array([N], np.int64),
              "b8_wav": b8.astype(np.float32), "b8_len": lens8,
              "pad_wav": stream_wav(10000 / SR, gen)[None], "pad_len": np.array([10000])}
    in_path, out_path = os.path.join(root, "inputs.npz"), os.path.join(root, "outputs.npz")
    np.savez(in_path, **inputs)
    script = os.path.join(root, "load_artifact.py")
    with open(script, "w") as f:
        f.write(EXPORT_SCRIPT)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, script, art, in_path, out_path,
                          *SERVE_DEVICE_ARGS[1:]], cwd=HERE, capture_output=True, text=True,
                         timeout=600, env={**os.environ, "PYTHONPATH": HERE})
    if res.returncode != 0:
        fail(f"the artifact's fresh process exited {res.returncode}: {res.stderr[-3000:]}")
    sub = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"[export] fresh process ({time.perf_counter() - t0:.2f} s with its start): "
          f"load_enhancer {sub['load_s']:.3f} s, buckets {sub['buckets']}, modules of "
          f"models/, train/ or JAX imported: {sub['imported']}; launches per call "
          f"{json.dumps(sub['launches'])}; uncovered (1, 200000): {sub['uncovered']!r}; "
          f"seconds {json.dumps({k: round(v, 3) for k, v in sub['startup_s'].items()})}")
    if sub["imported"] or not sub["uncovered"] or "no exported bucket" not in sub["uncovered"]:
        fail("the artifact's process imported model code, or an uncovered shape ran")
    for case, counts in sub["launches"].items():
        if counts != {"stft": 1, "istft": 1, "gn_act": 2, "lstm": 2}:
            fail(f"an artifact call ({case}) launched {counts}, not STFT 1, ISTFT 1, GN 2, "
                 "LSTM 2")

    state, cfg = load_state(ck, device)
    fn = make_enhance_fn(cfg, device)
    got = np.load(out_path)
    tol, why = EXPORT_TOL
    errs = {}
    for case in ("b1", "b8", "pad"):
        wav, lens = inputs[case + "_wav"], inputs[case + "_len"]
        n = wav.shape[1]
        padded = np.zeros((wav.shape[0], N), np.float32)
        padded[:, :n] = wav
        live = fn(state.g, torch.from_numpy(padded), torch.from_numpy(lens))
        live = live[:, :n].cpu().numpy()
        if got[case].shape != live.shape or not np.isfinite(got[case]).all():
            fail(f"artifact {case}: {got[case].shape} for {live.shape}, or non-finite")
        errs[case] = float(np.abs(got[case] - live).max())
    print(f"[export] artifact (fresh process) against make_enhance_fn on {card} with the "
          f"same weights: max_abs_err {json.dumps(errs)} (B=1, B=8 ragged x 8 s; (1, 10000) "
          f"in the (1, {N}) bucket against the live path at the padded shape, stripped) "
          f"(tol {tol}: {why})")
    if not max(errs.values()) <= tol:
        fail(f"the artifact differs from the live path: {errs}")

    t0 = time.perf_counter()
    served = load_enhancer(art, *SERVE_DEVICE_ARGS[1:])
    load_here = time.perf_counter() - t0
    for b in (1, 8):
        wav_d = torch.from_numpy(inputs[f"b{b}_wav"]).to(device)
        len_d = torch.from_numpy(inputs[f"b{b}_len"]).to(device)
        program = served._programs[(b, N)]

        def artifact():
            with torch.inference_mode():
                program(wav_d, len_d)

        k_ms, live_ms = in_turns(artifact, lambda: fn(state.g, wav_d, len_d), 10)
        print(f"[export] B={b} x {SECONDS} s on {card}, TF32 off: artifact call "
              f"{k_ms:.3f} ms, live make_enhance_fn {live_ms:.3f} ms (CUDA events, medians, "
              f"in turns; inputs on the card); load_enhancer in this process "
              f"{load_here:.3f} s")
    launches = counted(SERVE_KERNELS["enhance"],
                       lambda: served.enhance(inputs["b8_wav"], inputs["b8_len"]))
    print(f"[export] one B=8 artifact call in this process: launches {json.dumps(launches)}")
    return launches


DEVICE_BEAM_TOL = (1e-3, "relative to max(1, |score|): f32 beam scores are sums of up to "
                   "401 frames' log-probs (|score| ~1e3) through ~800 logaddexp a frame, "
                   "exp and log1p rounded by each device's library")
DECODE_KERNELS = ("stft", "gn_act", "lstm", "gru")
_BEAM_PROFILE = """
import json, sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
from aas_enhancement_tpu_torch.decode.device_beam import device_beam_decode_raw
from aas_enhancement_tpu_torch.utils.profiling import profile_call
d = np.load({path!r})
lp = torch.from_numpy(d["lp"]).cuda()
out = []
for kw in ({{}}, dict(lm_table=d["table"], lm_order=3, lm_alpha=0.5, lm_beta=0.5)):
    s = profile_call(lambda: device_beam_decode_raw(lp, d["lens"], beam_width=32,
                                                    prune_k=16, **kw), 1, 1, {trace!r})
    out.append({{k: s[k] for k in ("busy_ms", "events", "wall_ms", "idle_wall")}})
print(json.dumps(out))
"""


def device_beam_profile(tmp: str, lp, lens, table) -> list[dict]:
    """The device beam's busy time, device events and idle share for one
    batch (after one warm call), without and with the char LM ``table``,
    profiled in a fresh process: a long process's torch.profiler drops
    records, and a session of 50,000 events left a later phase's session
    short of its records."""
    import numpy as np
    path, trace = os.path.join(tmp, "beam_in.npz"), os.path.join(tmp, "beam_trace.json")
    np.savez(path, lp=lp, lens=lens, table=table)
    proc = subprocess.run([sys.executable, "-c", _BEAM_PROFILE.format(
        root=HERE, path=path, trace=trace)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"profiling the device beam in a fresh process: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def phase_decode(device, card):
    """Beam decoding with LM fusion on one full-width AM and enhancer (random
    weights from seeds): the recognition forward of B=4 x 8 s, ragged; the
    host beam (native C++) at W=32 with no LM, a char 3-gram, a word LM and
    both, against beam_search_python on two rows; the device beam at W=32,
    prune 16, with no LM and the char 3-gram, card vs CPU, timed beside the
    native batch decoder; cli.evaluate --decoder beam (hybrid, tuned) and
    --decoder device; cli.train with the worker loader; a batch through the
    native wav decoder.  -> ({kernel: launches} of the forward and the
    evaluate CLIs, those of the train CLI)."""
    import numpy as np
    import torch
    from aas_enhancement_tpu_torch.cli import evaluate as eval_cli
    from aas_enhancement_tpu_torch.cli import train as train_cli
    from aas_enhancement_tpu_torch.cli import train_lm
    from aas_enhancement_tpu_torch.config import Config, DataConfig
    from aas_enhancement_tpu_torch.data import AudioDataset, generate_corpus, native_audio
    from aas_enhancement_tpu_torch.decode import beam
    from aas_enhancement_tpu_torch.decode.device_beam import device_beam_decode_raw
    from aas_enhancement_tpu_torch.decode.lm import load_lm
    from aas_enhancement_tpu_torch.enhance import init_enhancer
    from aas_enhancement_tpu_torch.evaluation import init_am, make_eval_forward

    def host_walls(fn, reps: int = 5, warmup: int = 2) -> list[float]:
        walls = []
        for i in range(warmup + reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= warmup:
                walls.append(time.perf_counter() - t0)
        return walls

    cfg = Config()
    am, enh = init_am(cfg, 0, device), init_enhancer(cfg, 1, device)
    wav, lengths, _ = make_inputs(device)
    fwd = make_eval_forward(cfg, use_enhancer=True)
    with tempfile.TemporaryDirectory() as tmp:
        m = generate_corpus(os.path.join(tmp, "corpus"), n_utts=6, seed=2,
                            word_len=(2, 6))
        char_lm, word_lm = os.path.join(tmp, "char.json"), os.path.join(tmp, "word.json")
        word_arpa = os.path.join(tmp, "word.arpa")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            train_lm.main(["--manifest", m["clean"], "--level", "char", "--order", "3",
                           "--out", char_lm])
            train_lm.main(["--manifest", m["clean"], "--level", "word", "--out", word_lm,
                           "--arpa", word_arpa])
        print(f"[decode] cli.train_lm: {' | '.join(out.getvalue().split(chr(10))[:2])}")
        char, word = load_lm(char_lm), load_lm(word_arpa)
        lines = {}

        def main_path():
            logits, pads = fwd(am, enh, wav, lengths)
            lines["log_probs"] = torch.log_softmax(logits, -1)
            lines["lens"] = (pads < 0.5).sum(1).cpu().numpy().astype(np.int32)
            for tag, argv in (
                    ("beam", ["--decoder", "beam", "--lm", char_lm, "--word-lm", word_arpa,
                              "--tune-lm-manifest", m["clean"]]),
                    ("device", ["--decoder", "device", "--lm", char_lm])):
                with contextlib.redirect_stdout(io.StringIO()) as o:
                    t0 = time.perf_counter()
                    eval_cli.main(["--manifest", m["noisy"], "--am-checkpoint", "seed:0",
                                   "--enhancer-checkpoint", "seed:1", *argv])
                lines[tag] = (json.loads(o.getvalue().strip().splitlines()[-1]),
                              time.perf_counter() - t0)
                if tag == "beam":
                    lines["beam_route"] = beam.beam_decode.route

        launches = counted(DECODE_KERNELS, main_path)
        print(f"[decode] main path (the B={B} x {SECONDS} s recognition forward, "
              f"cli.evaluate --decoder beam and --decoder device on 6 utterances): "
              f"launches {json.dumps(launches)}")
        for name, count in launches.items():
            if count == 0:
                fail(f"the decode path launched no {name} kernel")
        for tag in ("beam", "device"):
            line, took = lines[tag]
            print(f"[decode] cli.evaluate --decoder {tag} ({took:.2f} s): "
                  f"{json.dumps(line)[:700]}")
            want = {"noisy", "enhanced", "wer_delta"} | (
                {"lm_tuning"} if tag == "beam" else set())
            if set(line) != want or any(
                    line[leg]["utterances"] != 6 or not 0.0 <= line[leg]["wer"] < float("inf")
                    for leg in ("noisy", "enhanced")):
                fail(f"cli.evaluate --decoder {tag} printed {line}")
        grid = lines["beam"][0]["lm_tuning"]["grid"]
        print(f"[decode] lm_tuning: {len(grid)} grid cells, best "
              f"{json.dumps({k: v for k, v in lines['beam'][0]['lm_tuning'].items() if k != 'grid'})}")
        if lines["beam_route"] != "native":
            fail(f"cli.evaluate --decoder beam took the {lines['beam_route']} route")

        # The host beam at W=32 on the forward's log-probs, every fusion mode.
        lp = lines["log_probs"].cpu().numpy()
        lens = lines["lens"]
        modes = {"none": {}, "char 3-gram": dict(lm=char, lm_alpha=0.5, lm_beta=0.5),
                 "word": dict(lm=word, lm_alpha=0.5, lm_beta=1.0),
                 "hybrid": dict(lm=char, lm_alpha=0.5, lm_beta=0.5, word_lm=word,
                                word_alpha=0.5, word_beta=1.0)}
        for mode, kw in modes.items():
            t0 = time.perf_counter()
            hyps = beam.beam_decode(lp, lens, beam_width=32, **kw)
            print(f"[decode] beam_decode W=32 ({mode}): route {beam.beam_decode.route}, "
                  f"{time.perf_counter() - t0:.3f} s, hypotheses "
                  f"{json.dumps([h[:40] for h in hyps])}")
            if beam.beam_decode.route != "native":
                fail(f"beam_decode ({mode}) took the {beam.beam_decode.route} route")
        native = beam.beam_search_native_batch(lp, lens, 32)
        for r in (3, 2):
            t0 = time.perf_counter()
            py_ids, py_score = beam.beam_search_python(lp[r, : lens[r]], 32)
            print(f"[decode] row {r} ({lens[r]} frames): native batch ids == "
                  f"beam_search_python's: {native[r][0] == py_ids} (scores "
                  f"{native[r][1]:.4f} / {py_score:.4f}; Python {time.perf_counter() - t0:.2f} s)")
            if native[r][0] != py_ids:
                fail(f"row {r}: the native batch decoder's ids differ from beam_search_python's")

        # The device beam, card vs CPU, timed beside the native batch decoder;
        # its device events, busy time and idle share from a fresh process.
        table = char.dense_table()
        lm_kw = dict(lm_table=table, lm_order=3, lm_alpha=0.5, lm_beta=0.5)
        profs = device_beam_profile(tmp, lp, lens, table)
        tol, why = DEVICE_BEAM_TOL
        for mode, kw in (("no LM", {}), ("char 3-gram", lm_kw)):
            def dev_run():
                return device_beam_decode_raw(lines["log_probs"], lens, beam_width=32,
                                              prune_k=16, **kw)

            def host_run():
                return beam.beam_search_native_batch(lp, lens, 32, prune_k=16, **kw)

            ids, olens, scores = dev_run()
            t0 = time.perf_counter()
            ref = device_beam_decode_raw(lp, lens, beam_width=32, prune_k=16, device="cpu",
                                         **kw)
            cpu_s = time.perf_counter() - t0
            rel = float(np.max(np.abs(scores - ref[2]) / np.maximum(1.0, np.abs(ref[2]))))
            host = host_run()
            same_host = sum(list(ids[r, : olens[r]]) == host[r][0] for r in range(B))
            print(f"[decode] device beam W=32 prune 16 ({mode}): ids and lengths equal to "
                  f"the CPU run: {bool(np.array_equal(ids, ref[0]))}, "
                  f"{bool(np.array_equal(olens, ref[1]))}; scores {scores.tolist()}, max "
                  f"|diff| {float(np.max(np.abs(scores - ref[2]))):.3e}, relative "
                  f"{rel:.3e} (tol {tol:.0e}: {why}); rows equal to the native decoder's "
                  f"ids: {same_host} of {B}; CPU run {cpu_s:.2f} s")
            if not (np.array_equal(ids, ref[0]) and np.array_equal(olens, ref[1])):
                fail(f"device beam ({mode}): card ids or lengths differ from the CPU run")
            if not rel <= tol:
                fail(f"device beam ({mode}): scores differ by {rel:.3e} relative")
            walls, nat, prof = host_walls(dev_run), host_walls(host_run), profs[mode != "no LM"]
            print(f"[decode] device beam ({mode}) on {card}: {1e3 * statistics.median(walls):.1f} "
                  f"ms a B={B} x {AM_T}-frame batch (median of 5 after 2; walls ms "
                  f"{[round(w * 1e3, 1) for w in walls]}); in a fresh process: device busy "
                  f"{prof['busy_ms']:.1f} ms, {prof['events']:.0f} device events (launches) "
                  f"a batch = {prof['events'] / AM_T:.1f} a frame, idle share "
                  f"{100 * prof['idle_wall']:.1f}% of its unprofiled wall "
                  f"({prof['wall_ms']:.1f} ms); native batch decoder (host, "
                  f"{os.cpu_count()} CPUs): {1e3 * statistics.median(nat):.1f} ms (walls ms "
                  f"{[round(w * 1e3, 1) for w in nat]})")

        # A batch through the native wav decoder against the Python reader.
        ds = {flag: AudioDataset(m["noisy"], cfg.audio, DataConfig(native_decode=flag))
              for flag in (True, False)}
        nb = next(ds[True].batches(B))
        route = native_audio.batch_decode.route
        pb = next(ds[False].batches(B))
        same = all(np.array_equal(getattr(nb, k), getattr(pb, k))
                   for k in ("wav", "wav_lengths", "labels"))
        print(f"[decode] a batch with native_decode: route {route}, equal to the Python "
              f"reader's: {same}")
        if route != "native" or not same:
            fail(f"native_decode batch: route {route}, equal {same}")

        # The train CLI with the worker loader (2 spawned workers).
        cfg_path = os.path.join(tmp, "grain.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.replace(data=dataclasses.replace(cfg.data, use_grain=True,
                                                         grain_workers=2)).to_json())
        t0 = time.perf_counter()
        line, _, grain_launches = _cli_run(
            "cli.train --objective am --steps 2, use_grain (2 workers)", train_cli.main,
            ["--objective", "am", "--noisy-manifest", m["clean"], "--steps", "2",
             "--batch-size", str(B), "--am-checkpoint", "seed:0", "--config", cfg_path],
            phase="decode", names=AM_KERNELS)
        if line.get("final_step") != 2 or not grain_launches.get("gru"):
            fail(f"cli.train with use_grain printed {line}, launches {grain_launches}")
    return launches, grain_launches


def main() -> int:
    sys.path.insert(0, HERE)
    name, smi = phase_device()
    import torch
    device = torch.device("cuda", 0)
    took = {}

    def timed(what: str, phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        took[what] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    results = timed("kernels", phase_kernels, device)
    # Each path's launches: counts set to 0 just before it, read just after.
    by_path = {"enhance": timed("enhance", phase_slice, device, smi),   # the enhance CLI run
               "recognize": timed("recognize", phase_recognize, device, smi)}   # evaluate CLI
    # The bf16 models' forwards: the CLIs, the engines and an artifact.
    by_path.update(timed("bf16", phase_bf16, device, smi, results))
    # Training at bf16: the backward kernels on bf16 streams, the steps, the CLI.
    by_path.update(timed("train_bf16", phase_train_bf16, device, smi, results))
    # The beam decoders and LM fusion (evaluate CLI), the worker loader (train CLI).
    by_path["decode"], by_path["decode_grain_train"] = timed("decode", phase_decode,
                                                             device, smi)
    by_path["aas_step"] = timed("aas_step", phase_train, device, smi)   # train CLI, aas
    by_path["birnn_batch_major"] = timed("birnn", phase_birnn, device)
    by_path["am_step"] = timed("am_step", phase_train_am, device, smi)   # train CLI, am
    by_path.update(timed("dp", phase_dp, device, smi))   # 2 ranks, and torchrun (nccl)
    by_path["checkpoint"] = timed("checkpoint", phase_checkpoint, device, smi)   # CLIs, dirs
    paired_step, by_path["paired_cli"] = timed("paired", phase_paired, device, smi)
    by_path["paired_step"] = paired_step      # the JSON's launches of stft_vjp, istft_vjp
    by_path.update(timed("streaming", phase_streaming, device, smi))
    # The 25 ms / 10 ms framing (hop 160 does not divide n_fft 400): the STFT
    # kernels there, and the enhance, recognition, training, streaming and
    # export paths at full width.
    by_path.update(timed("hop", phase_hop, device, smi, results))
    # The end-to-end quality protocol (cli.e2e) at a tiny size, then the
    # quality protocols that read its workdir, chained, then those with a
    # workdir of their own (the last on [e2e]'s checkpoint).
    e2e_workdir = tempfile.mkdtemp(prefix="aas_e2e_")
    try:
        by_path["e2e"] = timed("e2e", phase_e2e, device, smi, results, e2e_workdir)
        by_path["quality"] = timed("quality", phase_quality, device, smi, e2e_workdir)
        by_path["fusion"] = timed("fusion", phase_fusion, device, smi, e2e_workdir)
    finally:
        shutil.rmtree(e2e_workdir, ignore_errors=True)
    by_path["serve"], root, ck = timed("serve", phase_serve, device, smi)   # cli.serve
    try:
        by_path["export"] = timed("export", phase_export, device, smi, root, ck)   # artifact
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[time] seconds per phase: {json.dumps(took)}; in all {sum(took.values()):.1f} "
          f"= {100 * sum(took.values()) / SCRIPT_LIMIT_S:.1f}% of the script's "
          f"{SCRIPT_LIMIT_S:.0f} s limit")
    launches = {}
    for counts in by_path.values():        # the last path that runs a kernel
        launches.update({k: v for k, v in counts.items() if v})

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "flax", "aas_enhancement_tpu")]
    if bad:
        fail(f"JAX or the JAX package was imported: {bad[:5]}")
    meta = {
        "stft": ("cuda", "aas_enhancement_tpu_torch/csrc/stft.cu",
                 "aas_enhancement_tpu/ops/pallas/stft_kernel.py:71"),
        "istft": ("cuda", "aas_enhancement_tpu_torch/csrc/istft.cu",
                  "aas_enhancement_tpu/ops/pallas/stft_kernel.py:160"),
        "gn_act": ("cuda", "aas_enhancement_tpu_torch/csrc/gn.cu",
                   "aas_enhancement_tpu/ops/pallas/gn_kernel.py:311"),
        "lstm": ("cuda", "aas_enhancement_tpu_torch/csrc/lstm_tm.cu",
                 "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:692"),
        "gru": ("cuda", "aas_enhancement_tpu_torch/csrc/gru_tm.cu",
                "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:892"),
        "lstm_bwd": ("cuda", "aas_enhancement_tpu_torch/csrc/lstm_tm.cu",
                     "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:640"),
        "gru_bwd": ("cuda", "aas_enhancement_tpu_torch/csrc/gru_tm.cu",
                    "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:846"),
        "gn_bwd": ("cuda", "aas_enhancement_tpu_torch/csrc/gn.cu",
                   "aas_enhancement_tpu/ops/pallas/gn_kernel.py:272"),
        "conv_dw": ("cuda", "aas_enhancement_tpu_torch/csrc/conv_dw.cu",
                    "aas_enhancement_tpu/ops/pallas/conv_dw_kernel.py:161"),
        "lstm_stacked": ("cuda", "aas_enhancement_tpu_torch/csrc/lstm_tm.cu",
                         "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:258"),
        "gru_stacked": ("cuda", "aas_enhancement_tpu_torch/csrc/gru_tm.cu",
                        "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:452"),
        "lstm_stacked_bwd": ("cuda", "aas_enhancement_tpu_torch/csrc/lstm_tm.cu",
                             "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:210"),
        "gru_stacked_bwd": ("cuda", "aas_enhancement_tpu_torch/csrc/gru_tm.cu",
                            "aas_enhancement_tpu/ops/pallas/rnn_kernel.py:406"),
        # No TPU kernel: the JAX package differentiates its matmul-DFT with XLA.
        "stft_vjp": ("cuda", "aas_enhancement_tpu_torch/csrc/stft_vjp.cu",
                     "aas_enhancement_tpu/dsp/stft.py:78 (no TPU kernel: XLA's VJP of stft)"),
        "istft_vjp": ("cuda", "aas_enhancement_tpu_torch/csrc/stft_vjp.cu",
                      "aas_enhancement_tpu/dsp/stft.py:139 (no TPU kernel: XLA's VJP of istft)"),
    }
    kernels = [{"name": k, "route": r, "source": s, "replaces": rep,
                "launches": launches.get(k, 0), **results[k],
                "launches_by_path": {p: c[k] for p, c in by_path.items() if k in c}}
               for k, (r, s, rep) in meta.items()]
    for k in kernels:
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was launched on no path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:                 # a rank of phase dp
        sys.exit(dp_rank(*sys.argv[2:]))
    sys.exit(main())
