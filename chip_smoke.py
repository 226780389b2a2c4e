"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port (``chainer_speech_recognition_tpu_torch``) at the full
width of the ``bigru`` preset (phases 3-9), of the ``bilstm_deep`` preset
(phases 10-14), of both streaming paths, the forward-only ``uni_gru``
preset and ``bilstm_deep`` with causal CMVN (phases 15-17), of the
attention family, ``conformer`` and ``conformer_stream`` offline (phases
18-21), the parity path of ``bigru`` (phase 22: data tools, training
from a pack, the evaluate CLI), config 4 on ``bigru`` (phase 23:
prefix beam search with LM fusion, offline and streaming), training
from the device-resident corpus, the default data mode (phase 24), and
data-parallel training, config 5 (phase 25), the online presets end
to end (phases 26-28: the one-direction training forms, uni_gru training,
conformer_stream streaming), the flash kernels at every head width the
reference takes, conformer at dh 128 and 256, and ``glu_conv`` (phases
29-31), the recurrences past H = 512 (phases 32-33), and the beam at
every width and LM order the reference takes (phase 34), with random
weights made from a seed, and fails (exit code != 0, no result line) if
any phase fails:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel in ``csrc/`` from the checkout (nvcc);
3. decode kernels: each against its plain PyTorch version at the decode
   path's shapes (32 wavs of 10 s), with the stated tolerances, timed with
   CUDA events (warm, median) beside the library call that computes the
   same function (where there is one) and the least time the card could
   take (bytes over HBM rate or operations over peak, the larger); the
   front-end kernel, its plain version and the cuFFT chain as alternating
   rounds of CUDA-graph replays (device time only, the replays equal to
   the eager outputs bitwise; ``frontend_timing``), the eager figures
   printed beside them; the bf16 GRU forward's cluster plan
   (``print_rnn_plan``) and its time beside cuDNN's GRU in alternating
   rounds of graph replays (``rnn_graph_rounds``), fp32 timed eagerly;
   the greedy decode, one launch (argmax, keep mask and compaction),
   exactly equal to ``compact_kept(*best_keep_plain(...))`` at T' = 251
   and the long-form T' = 701, both timed as alternating rounds of graph
   replays (``greedy_check``);
4. inputs: a ``bigru`` checkpoint (config.json + msgpack params written by
   the port's own writer), a 63-symbol vocab and 64 synthetic wavs of
   8-10 s;
5. decode: the port's decode CLI on the 64 wavs (two chunks of 32) on the
   card with the exact launches of every kernel; a second, warm run gives
   utterances per second and the real-time factor;
6. CPU parity: 4 of the wavs through the same checkpoint on the CPU (the
   kernels' plain versions): finite logits of the same shape within the
   bf16 bar of the card's;
7. training kernels: the GRU training forward and backward (on the plain
   forward's residuals and on the kernel's own) and the CTC alpha and beta
   kernels against their plain versions (every output) at the training
   path's shapes (24 utterances of 9-10 s in the 1024-frame bucket), timed
   as in phase 3: the GRU pair's plans printed and both timed beside
   cuDNN's training forward and backward (its forward+backward less its
   training forward) in alternating rounds of graph replays; the CTC pair's
   launch plans (``ctc_plan``) printed, whether they equal the plain
   recursions bit for bit, and both timed as graph replays beside
   F.ctc_loss's forward and backward (eager: its lengths pass through the
   host) in alternating rounds (``ctc_rounds``), with the eager figures
   and the microseconds a step; the dW kernel on the GRU kernels' own ys
   and gradients (dxs[..., :2H] and dhn in one launch) against the fp64
   sum of the same bf16 operands at K·2^-23·Σ|h·g|, the plain version at
   twice that and itself bitwise, timed as graph replays beside the
   parent's chain and cuBLAS's bmm (``dw_check``);
8. train: a synthetic corpus (192 + 24 utterances of 9-10 s) through the
   port's train CLI on the card, 16 steps with dev eval and checkpoints
   every 8; every training kernel must show its exact launches from that
   run (dw: one a layer a step); the
   last checkpoint decodes through the decode CLI; a second run resumes at
   step 16 and stops at 20; prints the warm step time, utterances per
   second, the device's busy share over the profiled steps 10-14 (counted
   from 0) beside the profiler's overhead, and the peak memory;
9. train parity: one step from the same weights and batch on the card and
   on the CPU: loss within rtol 1e-4, per-parameter gradients within the
   bf16 bar;
10. LSTM kernels: the residual-free BiLSTM forward in fp32 and bf16
    against its plain version at the decode shapes (B = 32, T' = 251);
    the bf16 cluster kernel's plan (C, M, shared memory, clusters the
    card holds: ``print_rnn_plan``) and its time beside cuDNN's LSTM in
    9 alternating rounds of CUDA-graph replays (device time only, the
    replays equal to the eager outputs bitwise: ``rnn_graph_rounds``),
    the eager figures beside; fp32 timed eagerly;
11. LSTM training kernels: the training forward (ys, cs, gates) and the
    backward (dxs, on the plain forward's residuals and on the kernel's
    own) against their plain versions at the training shapes (B = 24,
    T' = 256), both plans printed, timed as in phase 10 beside cuDNN's
    training forward and backward (its forward+backward less its training
    forward); the dW kernel on their ys and dxs as in phase 7 (the kernel
    line's dw entry);
12. bilstm_deep decode: a checkpoint of random weights through the decode
    CLI on the 64 wavs with exact launch counts, a warm
    rerun's utterances per second and real-time factor, and 4 wavs' logits
    card vs CPU;
13. bilstm_deep train: the corpus of phase 8 through the train CLI with
    SpecAugment on, 16 steps with dev eval and checkpoints every 8, exact
    launch counts, the warm step time, utterances per second, busy share
    and peak memory; the last checkpoint decodes through the decode CLI;
14. bilstm_deep train parity: one step card vs CPU from the same weights,
    batch and SpecAugment draws (bars as in phase 9);
15. stream kernels: the GRU and LSTM stream forms against their plain
    versions at the stream windows' shapes (B = 32; uni_gru at chunk 64,
    right 0: T = 16; bilstm_deep at chunk 64, right 16: T = 20), fp32 and
    bf16, emit_t 0, C/s and T, ragged lengths with an empty row, nonzero
    h0, and the R = 1 forward-only launch; in bf16 with h0 = 0 the stream
    form's ys bitwise equal to the residual-free form's (the cluster
    kernels share the product and the gate math); the two windows (bf16,
    emit_t = C/s) with their cluster plans, timed beside the bound and
    cuDNN with hx = h0 in alternating rounds of graph replays as in phase
    10, the eager figure (20 calls back to back) on a line of its own, and
    the fixed cost of a launch as the intercept of its device time over
    T in {1, 4, 16, 20, 64}; the forward-only gru_fwd at uni_gru's decode
    shape, its plan and its time beside cuDNN's forward-only GRU as in
    phase 3;
16. uni_gru streaming: a random-weight checkpoint through the stream CLI
    (--batch 32 --chunk-frames 64 --right-frames 0 --timing) on the 64
    wavs with exact launch counts from the stream geometry and the wav
    lengths, a warm rerun's utt/s, RTF and window latency; the same
    checkpoint through the decode CLI (the forward-only gru_fwd); the
    chained window logits of 4 wavs against the offline ones; transcript
    agreement and CER of the two CLIs (printed); one wav through --raw
    (batch 1, R = 1);
17. bilstm_deep streaming (causal CMVN, chunk 64, right 16): the stream
    CLI with exact launch counts and a warm rerun, and 4 wavs' chained
    window logits card vs CPU;
18. attention kernels: flash forward, dQ and dK/dV against their plain
    versions in fp32 and bf16 at the long-form decode shape (B = 32,
    T' = 701, h = 4, dh = 64), the training shape (B = 24, T' = 256) and
    chunk 16 / left 4 at T' = 701 (key tiles skipped), ragged lengths with
    1 and T', q/k/v strided as the fused qkv projection gives them; the
    bf16 gradients held to 2^-7·|b| + 1e-3 plus the rounding room of p
    and ds (``attention_cuda.bwd_rounding_room``), their share of the old
    bar without it printed beside, and two faults planted in them (p at 3
    mantissa bits, one 64-row tile skipped:
    ``attention_cuda.bwd_planted_faults``) must exceed it; timed (bf16)
    beside the bound, the
    plain versions and ``F.scaled_dot_product_attention`` with the same
    boolean mask (the three kernels, SDPA's forward and its backward in 9
    alternating rounds of CUDA graph replays, device time only: medians,
    the forward's and the pair's ratios to SDPA with their spread, each
    kernel's share of its bound; the eager figures beside), and the port's
    einsum path at T' = 256 and 701 (the flash/einsum crossover);
    the framed-input front-end kernel (row 2) at B = 32, T = 1001 beside
    cuFFT (timed as in phase 3), and one call of its entry point
    ``cuda_frontend.fused_logmel``;
19. conformer decode: a random-weight checkpoint through the decode CLI
    on 32 long-form wavs of 22-28 s under ``auto`` (exactly one flash_fwd
    launch a block), a warm rerun's utt/s and RTF, 4 wavs' logits card vs
    CPU at fp32 compute and at bf16 (``phase_parity``); the 64 short
    wavs under ``auto`` (no flash launch: the reference's T' > 512 gate)
    and with ``--set model.attn_impl=flash`` (one a block and chunk);
20. conformer_stream offline decode: the long-form wavs with the
    chunk-causal mask in the kernel, exact launches, a warm rerun, logits
    card vs CPU as in phase 19;
21. conformer training with ``--set model.attn_impl=flash``: the corpus of
    phase 8 through the train CLI (SpecAugment on), 16 steps, dev eval and
    checkpoints every 8, exact flash_fwd/dq/dkv launches, warm step time,
    utt/s, busy share, peak memory; one step card vs CPU from the same
    weights, batch and SpecAugment draws, at fp32 compute (the bars of
    phase 9) and at bf16 (loss rtol 4e-4: bf16's own noise over eight
    blocks reaches the 1e-4 bar).
22. the parity path (PARITY.md §1's commands, cut to 48 confusable
    utterances of 2-4 s, V = 82, one 512-frame bucket of 12): the port's
    make_synthetic and preprocess --dev-fraction 0.25 --pack; the train
    CLI from train.pack, 16 steps with one dev eval and a checkpoint,
    exact launches of the training kernels, every training batch int16 on
    the card (``train.loop.to_device`` watched by the phase); the evaluate
    CLI on the trained checkpoint, then on a random-weight causal-CMVN
    checkpoint with ``--index dev_index.jsonl,dev.pack``: identical
    hypotheses, edits and loss for the two sets (the pack holds the wavs'
    int16 samples), exact launches (front-end, gru_fwd, ctc_fwd, greedy a
    batch), the mean loss card vs a ``--device cpu`` run within the bar
    of ``phase_parity`` (3e-2, relative); ``evaluate --streaming
    --stream-chunk 64 --stream-right 16`` with its --hyp-out equal to the
    stream CLI's transcripts of the same wavs at the same batch and
    gru_fwd_stream launches from ``stream_geometry``. Random-weight CERs
    are printed, not gated; so is the phase's wall against its 30 s
    budget.
23. config 4, prefix beam search with n-gram LM fusion: the beam kernel
    (``csrc/beam.cu``, one launch a batch or a streaming chunk) against
    its plain version at B = 32, T' = 251, K = 8 — V = 64 without an LM,
    with the dense 3-gram and with a hashed 4-gram of fp16 rows, V = 2048
    without an LM; ids, n-best rows, counts, parent beams and the hash
    state exact, scores within 1e-4 — in its offline 1-best, n-best and
    chunk forms; 16-frame chunks equal the offline 1-best on the card,
    one launch a chunk; the kernel timed as graph replays in alternating
    rounds with the plain version (eager); then the decode CLI with
    ``--beam 8 --lm`` (3-gram ARPA, dense) and the stream CLI with
    ``--beam 8 --lm`` on a causal-CMVN checkpoint over the 64 wavs, exact
    launches (one beam launch a decode chunk and a stream window), every
    beam launch held to the plain version on its own inputs
    (``beam_checked``), warm walls. Its wall is printed against a 30 s
    budget.
24. the device cache, the default ``train.data_mode``: bigru, bilstm_deep
    (SpecAugment on) and conformer (``attn_impl=flash``) train phase 8's
    corpus through the train CLI with no data-mode override, 24 steps:
    the log line must say ``device_cache``, bf16 features, K = 8, graphs
    on; exact launches (the front-end ⌈rows/32⌉ times at the cache's
    build and never in a step, every training kernel its count a step
    times 24, the dev eval's forward); the busy share over the profiled
    replay of steps 8-15 and the step wall of the third dispatch, printed
    beside phases 8, 13 and 21's stream-mode figures; bigru and
    bilstm_deep resume a copy of a run's step-16 checkpoint to 24, bitwise
    equal to that run's end (the run's own step-16 checkpoint, copied).
    In process, from one feature cache, the same 2 dispatches of K = 8
    eagerly (twice for bigru and bilstm_deep), each run bitwise equal to
    the CLI run's first 16 steps (its first dispatch eager, the second one
    replay: its step-16 checkpoint and logged metrics; the CTC
    emission gather sums its gradient by a product, not with atomics;
    bigru's model backward and CTC gradient run twice each on the same
    inputs must agree bitwise). PCM-mode cached steps (the front-end in
    the step) equal stream steps on the same rows; a rotating run (3
    windows, K = 8, 24 steps) holds each later window's fetch inside a
    graph capture, with exact launches; 6 windows at K = 2 with the
    training stream asleep ~0.25 s before each dispatch, through graphs
    equal to eager and with a planted race (the window fetch skips its
    wait for the set's last replay) unequal. Its wall is printed against
    a 45 s budget.
25. config 5, data parallelism: (a) the train CLI as the one rank of an
    NCCL group (the environment ``torchrun --nproc_per_node=1`` gives)
    with phase 24's bigru program (default data mode, 24 steps): the
    all-reduces of every step captured in the K = 8 graph (16 captured:
    the weight sum before the backward, the gradients after it),
    launches exact, metrics, eval and the checkpoints at 16 and 24
    bitwise equal to phase 24's run without a group, the all-reduce's
    device time in the profiled replay and the warm step beside phase
    24's; (b) two ranks on the one card (NCCL refuses two ranks on one
    device: a gloo group over the card's tensors), the train CLI in
    stream mode, 4 steps of bigru, against one rank over the same global
    batches: each rank's launches exact, losses at the train-loss bar,
    parameters within the bf16 gradient bar. A failure of the group, of
    NCCL or of the capture fails the run. Its wall is printed against a
    30 s budget, and the whole run's wall on a line before the kernel
    table.
26. the one-direction training forms (ndir = 1, a forward-only layer's
    one W over its B rows): the GRU training forward and backward at
    uni_gru's training shape (B = 24, T' = 256, H = 256) and the LSTM's
    at H = 384, each against its plain version at the bars of phases 7
    and 11 (the gradients' plus 2^-7 of their largest |value|), dW on
    their own ys and gradients (``dw_check``), both plans,
    and the pair timed beside cuDNN's unidirectional training forward and
    backward in alternating rounds of graph replays (the kernel line's
    ``ndir1`` sub-entries);
27. the forward-only presets' training: uni_gru through the train CLI in
    the default data mode as phase 24 runs its presets (24 steps, exact
    launches: 4 gru_fwd_train, 4 gru_bwd and 4 dw a step, the dev eval,
    the step-16 checkpoint resumed to 24 bitwise), one step card vs CPU
    at phase 9's bars, and bilstm_deep with
    ``model.rnn_bidirectional=false`` for one dispatch of 8 steps with
    exact launches;
28. conformer_stream online: a random-weight full-width checkpoint (8
    blocks, d = 256, chunk 16, left 4, causal CMVN) through the stream CLI
    (--batch 32 --chunk-frames 64, default --right-frames), greedy and
    --beam 8 --lm with every beam launch held to the plain version, exact
    launches (the front-end and the beam once a window; the streaming
    step takes no flash launch), warm reruns' utt/s and window latency;
    the chained window logits of 4 wavs against the offline chunk-masked
    logits (einsum) at the bf16 bar of phase 16 and, at fp32 compute, at
    phase 19's fp32 bar, and the streamed transcripts equal to the offline
    argmax's wherever it has no near-tie.
    Phases 26-28's walls are printed against a 40 s budget.
29. the flash widths: forward, dQ and dK/dV at every head width the
    kernels take (dh = 64, 128, ..., 512: the reference's set; dh > 64
    splits the head dim over blocks in 64-column slices), fp32 and bf16,
    against their plain versions at phase 18's decode (B = 32, T' = 701)
    and training (B = 24, T' = 256) shapes, h = 4, 2, 1 where dh divides
    256 (``width_heads``) and 1 elsewhere, chunk 16 / left 4 at dh 128 and
    512, ragged lengths 1 and T', q/k/v strided as the fused qkv gives
    them; the bf16 gradients at phase 18's derived bar, both planted
    faults beyond it at every dh; the bf16 forward at the decode shape and
    the backward pair at the training shape timed in 5 alternating rounds
    of graph replays beside SDPA with the same boolean mask (the backend
    it picks named), the plain versions and the bound (the kernel line's
    ``dh`` sub-entries);
30. conformer at ``model.attn_heads`` 2 and 1 (dh 128, 256; every
    parameter's shape as in the preset): the decode CLI on phase 19's 32
    long-form wavs under ``auto`` with exactly one flash_fwd a block (the
    reference's gate at dh != 64), 4 wavs' logits card vs CPU at phase
    19's bars; the train CLI in the default data mode with
    ``attn_impl=flash``, 24 steps, exact flash_fwd / flash_bwd_dq /
    flash_bwd_dkv launches; one step card vs CPU at phase 21's bars;
31. glu_conv (the subsampler and six GLU conv blocks of 256, conv-only
    CTC): a random-weight checkpoint through the decode CLI on the 64 wavs
    (exact front-end and greedy launches), 4 wavs' logits card vs CPU at
    fp32 (1e-4) and bf16 (as phase 19: six gated residual convolutions);
    24 training steps in the default data mode (exact ctc_fwd / ctc_bwd
    launches, the step-16 checkpoint resumed to 24 bitwise) and 4 steps in
    stream mode (exact launches); one step card vs CPU at phase 9's bars;
    the stream CLI with causal CMVN at
    --right-frames 48 (its right reach: conv_exact, printed in the
    --timing line) with exact launches, the chained window logits of 4
    wavs against the offline ones at phase 16's bar, and at 16 (the
    default) the error printed; the decode CLI with --beam 8 --lm once,
    every beam launch held to the plain version.
    Phases 29-31's walls are printed against a 60 s budget.
32. the recurrences past H = 512 (``phase_rnn_widths``; W streamed from
    global memory a step in bf16, 2 or 4 units a thread in fp32): rows
    3-8 of both cells at H = 640, 768, 1024 and 2048, ndir 2 and 1, in
    bf16 at the decode (B = 32, T' = 251), training (B = 24, T' = 256)
    and stream-window (B = 32, T = 20) shapes and in fp32 at B = 8,
    T' = 32, against their plain versions: the forward forms at 3e-2 /
    1e-4, the bf16 backward at phase 26's 5e-2 + 2^-7·max|b| (on the plain
    forward's residuals and on its own), the stream form at emit_t 0, C/s
    and T; each call exactly one launch; four planted faults in the
    streamed operand fragments beyond the bars at every H; both plans;
    the four bf16 forms in 5 alternating rounds of graph replays beside
    cuDNN's GRU or LSTM at the same H (the kernel line's ``H``
    sub-entries);
33. the wide path through the CLIs at ``model.rnn_hidden=1024``
    (``phase_rnn_wide_path``): bilstm_deep decode (64 wavs, exact
    launches, 4 wavs card vs CPU), training in the default data mode (24
    steps, the step-16 checkpoint resumed to 24 bitwise), one step card
    vs CPU, evaluate (exact launches) and the stream CLI
    from a causal-CMVN checkpoint; uni_gru training with resume, one step
    card vs CPU and its stream CLI, decode CLI and --raw; no layer call
    on the plain scan (``rnn_cuda.ROUTED``).
    Phases 32-33's walls are printed against a 60 s budget.
34. the beam's wide form (``phase_beam_widths``: K > 32 or an LM context
    past 8 lanes; a radix-select top-K, its workspace in shared or global
    memory) against its plain version at phase 23's decode shape (B = 32,
    T' = 251, V = 64): K = 33, 64, 128 and 256 without an LM and with the
    dense 3-gram, a hashed 10-gram of fp16 rows at K = 64, V = 2048
    without an LM at K = 64, and the narrow form at K = 32 beside them;
    the n-best form with ids, counts, parents and the hash state exact,
    scores within 1e-4, one launch of the case's form and none of the
    other; 16-frame chunks equal to the offline 1-best at K = 64, one wide
    launch a chunk; each case's 1-best form timed by graph replays in
    alternating rounds (the plain version: its check's one eager call);
    then the decode CLI and the stream CLI (causal CMVN) with ``--beam 64
    --lm`` over the 64 wavs, exact launches, every launch held to the
    plain version (``beam_cli_runs``, as phase 23's). Its wall is printed
    against a 40 s budget.

The last two lines of stdout are the kernel table and the device line as
JSON. Nothing of JAX or of the JAX package is imported; the run checks at
the end that no such module was loaded.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

PRESET = "bigru"
LSTM_PRESET = "bilstm_deep"
UNI_PRESET = "uni_gru"                # the online preset: forward-only GRU
STREAM_CHUNK = 64                     # --chunk-frames of the stream runs
STREAM_CALLS = 20                     # back-to-back calls a stream timing
STREAM_SWEEP = (1, 4, 16, 20, 64)     # window steps of the fixed-cost fit
# stream CLI flags: uni_gru at zero lookahead; bilstm_deep (trained with
# causal CMVN) at the default lookahead of 16 frames
STREAM_ARGS = {UNI_PRESET: ["--right-frames", "0"], LSTM_PRESET: []}
CONF_PRESET, CONF_STREAM = "conformer", "conformer_stream"
GLU_PRESET = "glu_conv"               # conv-only CTC: six GLU conv blocks
LONG_WAVS, LONG_SECONDS = 32, (22.0, 28.0)   # long-form: T' 551-701 > 512
SEED = 0
N_WAVS, BATCH = 64, 32
WAV_SECONDS = (8.0, 10.0)
CHECK_B, CHECK_SECONDS = 32, 10.0     # decode kernel checks: one full chunk
PARITY_WAVS = 4
TRAIN_UTTS, DEV_UTTS = 192, 24        # 9-10 s: all in the 1024-frame bucket
TRAIN_SECONDS = (9.0, 10.0)
TRAIN_B, TRAIN_FRAMES = 24, 1024      # that bucket's batch and frame count
TRAIN_STEPS, RESUME_STEPS, EVERY = 16, 20, 8
TOL = {"frontend_logmel": 5e-4,       # tests/test_pallas_frontend.py:34
       "gru_bf16": 3e-2,              # tests/test_rnn_pallas.py:81
       "gru_fp32": 1e-4,
       "gru_grad_bf16": 5e-2,         # tests/test_rnn_pallas.py:88
       "ctc_loss_rtol": 1e-5,         # tests/test_ctc_pallas.py:35-42
       "ctc_alpha_atol": 1e-4,
       "ctc_grad": 2e-4,
       "train_loss_rtol": 1e-4,       # ~80x the 1.2e-6 measured on an H100
       "greedy": 0,                   # exact
       # flash kernels vs their plain versions, elementwise
       # |a - b| <= atol + rtol·s as (rtol, atol), s = |b| unless stated:
       # fp32 at the JAX suite's bars (tests/test_attention_pallas.py:58,
       # 79); bf16 against the bf16 plain version on the same inputs (the
       # suite's 5e-2 at :127 holds bf16 to an fp32 oracle): the forward's
       # out at s = |b| + Σ p·|v| / l (both sides round p and out to half
       # a bf16 ulp, 2^-8), the gradients one ulp + 1e-3 plus the rounding
       # room of p and ds (the tensor cores may round either one bf16 ulp
       # the other way: attention_cuda.bwd_rounding_room)
       "flash_fp32": (2e-5, 2e-5),
       "flash_grad_fp32": (3e-4, 3e-4),
       "flash_bf16": (2 ** -7, 1e-5),
       "flash_grad_bf16": (2 ** -7, 1e-3),
       # conformer logits card vs CPU: fp32 at the port's fp32 bar against
       # flax (3.8e-6 and 1.6e-5 measured on an H100); bf16 card vs CPU at
       # the larger of gru_bf16 and the CPU's own bf16-vs-fp32 gap, and the
       # card's bf16 gap to fp32 against the CPU's (1.03x and 0.94x measured)
       "attn_fp32": 1e-4,
       "attn_bf16_ratio": 1.25,
       # conformer step loss in bf16: 3x the 1.34e-4 an H100 gave, the
       # CPU's own bf16 noise over eight blocks (1.5e-7 at fp32 compute)
       "attn_loss_bf16_rtol": 4e-4,
       # the beam: ids, counts and hashes exact; scores at the JAX beam
       # tests' 1e-4 (tests/test_torch_beam.py)
       "beam_score": 1e-4}
# decode CLI, 64 wavs in two chunks: the launches of each decode kernel
DECODE_LAUNCHES = {
    PRESET: {"frontend_logmel": 2, "gru_fwd": 6, "greedy": 2},
    LSTM_PRESET: {"frontend_logmel": 2, "lstm_fwd": 10, "greedy": 2},
    UNI_PRESET: {"frontend_logmel": 2, "gru_fwd": 8, "greedy": 2}}
# stream CLI, 64 wavs in two lockstep batches: at least one window a batch
# (phase 16 checks the exact counts)
MIN_LAUNCHES = {f"{UNI_PRESET} stream": {"frontend_logmel": 2,
                                         "gru_fwd_stream": 8},
                f"{LSTM_PRESET} stream": {"frontend_logmel": 2,
                                          "lstm_fwd_stream": 10}}
SOURCES = {
    "frontend_logmel": (
        "chainer_speech_recognition_tpu_torch/csrc/frontend_logmel.cu",
        "chainer_speech_recognition_tpu/frontend/pallas_frontend.py:116"),
    "gru_fwd": (
        "chainer_speech_recognition_tpu_torch/csrc/gru_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:79"),
    "greedy": (
        "chainer_speech_recognition_tpu_torch/csrc/greedy.cu",
        "chainer_speech_recognition_tpu/decode/greedy_pallas.py:26"),
    "gru_fwd_train": (
        "chainer_speech_recognition_tpu_torch/csrc/gru_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:79"),
    "gru_bwd": (
        "chainer_speech_recognition_tpu_torch/csrc/gru_bwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:103"),
    "ctc_fwd": (
        "chainer_speech_recognition_tpu_torch/csrc/ctc.cu",
        "chainer_speech_recognition_tpu/ops/ctc_pallas.py:59"),
    "ctc_bwd": (
        "chainer_speech_recognition_tpu_torch/csrc/ctc.cu",
        "chainer_speech_recognition_tpu/ops/ctc_pallas.py:101"),
    "lstm_fwd": (
        "chainer_speech_recognition_tpu_torch/csrc/lstm_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:150"),
    "lstm_fwd_train": (
        "chainer_speech_recognition_tpu_torch/csrc/lstm_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:150"),
    "lstm_bwd": (
        "chainer_speech_recognition_tpu_torch/csrc/lstm_bwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:177"),
    "gru_fwd_stream": (
        "chainer_speech_recognition_tpu_torch/csrc/gru_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:227"),
    "lstm_fwd_stream": (
        "chainer_speech_recognition_tpu_torch/csrc/lstm_fwd.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:249"),
    "frontend_logmel_frames": (
        "chainer_speech_recognition_tpu_torch/csrc/frontend_logmel.cu",
        "chainer_speech_recognition_tpu/frontend/pallas_frontend.py:111"),
    "flash_fwd": (
        "chainer_speech_recognition_tpu_torch/csrc/attention_fwd.cu",
        "chainer_speech_recognition_tpu/ops/attention_pallas.py:126"),
    "flash_bwd_dq": (
        "chainer_speech_recognition_tpu_torch/csrc/attention_bwd.cu",
        "chainer_speech_recognition_tpu/ops/attention_pallas.py:222"),
    "flash_bwd_dkv": (
        "chainer_speech_recognition_tpu_torch/csrc/attention_bwd.cu",
        "chainer_speech_recognition_tpu/ops/attention_pallas.py:254"),
    "dw": (
        "chainer_speech_recognition_tpu_torch/csrc/dw.cu",
        "chainer_speech_recognition_tpu/ops/rnn_pallas.py:408"),
    "beam": (
        "chainer_speech_recognition_tpu_torch/csrc/beam.cu",
        "chainer_speech_recognition_tpu/decode/beam.py:342"),
    "beam_wide": (
        "chainer_speech_recognition_tpu_torch/csrc/beam.cu",
        "chainer_speech_recognition_tpu/decode/beam.py:342"),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the kernels line's notes: dw replaces an XLA einsum, not a Pallas call
NOTES = {"dw": "replaces _dw_einsum, an XLA einsum (not a Pallas call); "
               "timed at bilstm_deep's training layer, launches from its "
               "training run; ndir1_gru / ndir1_lstm: the one-direction "
               "form at uni_gru's layer and a forward-only LSTM layer of "
               "384, launches from phase 27's runs",
         **{name: "ndir1: the one-direction training form (a forward-only "
                  "layer's one W over its B rows), timed at B = 24, T' = "
                  "256 (H 256 GRU, 384 LSTM) beside cuDNN's unidirectional "
                  "training call, launches from phase 27's forward-only "
                  "runs" for name in ("gru_fwd_train", "gru_bwd",
                                      "lstm_fwd_train", "lstm_bwd")},
         **{name: "dh: the kernel at each head width of the reference's "
                  "set, timed in phase 29 (forward at B = 32, T' = 701, the "
                  "backward at B = 24, T' = 256, h = 4, 2 or 1) beside SDPA "
                  "(sdpa_backend: the backend it picks); launches from the "
                  "main path's runs at dh 64 (phases 19, 21), 128 and 256 "
                  "(phase 30), 0 where no preset reaches the width"
            for name in FLASH},
         "beam": "replaces _beam_step in the lax.scan of _beam_decode_jit "
                 "and _beam_chunk_jit (not a Pallas call); timed at the "
                 "decode shape with the dense 3-gram, launches from the "
                 "decode CLI's --beam 8 --lm run; no PyTorch call computes "
                 "a prefix beam",
         "beam_wide": "the beam's wide form (K > 32 or an LM context past "
                      "8 lanes: a radix-select top-K, its workspace in "
                      "shared or global memory; beam_wide_kernel in "
                      "csrc/beam.cu), replacing the same _beam_step; timed "
                      "in phase 34 at the decode shape with the dense "
                      "3-gram at K = 64 (cases: every K and LM of phase 34, "
                      "the plain version one eager call), launches from the "
                      "decode CLI's --beam 64 --lm run; no PyTorch call "
                      "computes a prefix beam"}
# the recurrences' "H" sub-entries (phase 32), beside any note above
WIDE_NOTE = ("H: the kernel at hidden sizes 640, 768, 1024 and 2048 (W "
             "streamed from global memory at each step), timed in phase 32 "
             "in bf16 (the residual-free form at B = 32, T' = 251, the "
             "training pair at B = 24, T' = 256, the window at B = 32, T = "
             "20, the GRU's forward-only) beside cuDNN at the same H; "
             "launches from phase 33's CLI runs at H = 1024, 0 at the other "
             "widths")
NOTES.update({name: "; ".join(filter(None, [NOTES.get(name), WIDE_NOTE]))
              for name in ("gru_fwd", "gru_fwd_train", "gru_bwd",
                           "gru_fwd_stream", "lstm_fwd", "lstm_fwd_train",
                           "lstm_bwd", "lstm_fwd_stream")})
NOTES["dw"] += ("; H: on phase 32's wide LSTM training layer (B = 24, T' = "
                "256) at H = 1024 and 2048, launches from phase 33's "
                "bilstm_deep run at H = 1024")
GRAPH_CALLS = 10        # calls in one CUDA graph of phase 18's rounds
# phase 22: a confusable corpus of short utterances (PARITY.md §1's
# synthesizer, cut to 48 utterances of 2-4 s), one 512-frame bucket
PARITY_SYNTH = ["--style", "confusable", "--utts", "48", "--vocab", "82",
                "--min-labels", "10", "--max-labels", "30", "--min-seconds",
                "2", "--max-seconds", "4", "--seed", str(SEED)]
PARITY_BUCKET_B = 12
PARITY_BUCKETS = ["buckets.boundaries=[512]",
                  f"buckets.batch_sizes=[{PARITY_BUCKET_B}]",
                  "buckets.max_label_len=40"]
PARITY_BUDGET_S = 30.0
# phase 23, config 4: the prefix beam at the decode shape (one 10 s chunk:
# T' = 251), PARITY.md §3's K = 8, alpha = 0.5, beta = 1.0
BEAM_FRAMES, BEAM_WIDTH, BEAM_ALPHA, BEAM_BETA = 251, 8, 0.5, 1.0
BEAM_CHUNK = 16                       # frames a chunk of the chunked check
BEAM_ROUNDS = 5                       # alternating timing rounds
BEAM_BUDGET_S = 30.0


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def time_ms(fn, warmup: int = 2, reps: int = 7, calls: int = 1) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, warm). With
    ``calls`` > 1 each timing spans that many back-to-back calls and is
    divided by it, so the host's enqueue of one call overlaps the device
    work of the one before: the time of a short kernel without the
    wrapper's host time, unless the host is the slower of the two."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bound(nbytes: float, flops: float, kind: str) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak of their type, whichever is larger, on the
    H100 SXM's datasheet peaks (``utils/flops.CARDS``)."""
    from chainer_speech_recognition_tpu_torch.utils.flops import (
        CARDS, H100_SXM)

    card = CARDS[H100_SXM]
    peak = {"bf16": card.bf16_tflops, "fp32": card.fp32_tflops}[kind]
    t_bytes = nbytes / (card.hbm_tbs * 1e12) * 1e3
    t_ops = flops / (peak * 1e12) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def frontend_ops(frames: int) -> int:
    """The fewest operations of the front-end's function on ``frames``
    frames, counted so the bound is not set high: the window (400
    products); the 512-point real FFT as a 256-point complex one by
    split radix (4·N·log₂N − 6·N + 8 real operations, N = 256) and the
    post-twiddle, whose bins k and 256 − k share their sums and one
    complex product (14 a pair, the halvings folded into the mel weights,
    2 for bins 0 and 256); the power (3 a bin); the sparse mel sum (2 a
    weight of ``fft_tables``) and the log (1 a filter)."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
        fft_tables)

    n, bins = C.N_FFT // 2, C.N_FFT // 2 + 1
    n_weights = int(fft_tables()[1][-1])
    fft = 4 * n * int(np.log2(n)) - 6 * n + 8
    return frames * (C.WIN_LENGTH + fft + 14 * (n // 2 - 1) + 2 + 3 * bins
                     + 2 * n_weights + C.N_MELS)


def frontend_timing(phase, name, err, kernel, plain, library, n_bytes,
                    frames) -> dict:
    """The front-end kernel, its plain version and the cuFFT chain timed
    as alternating rounds of CUDA-graph replays (device time only; each
    replay must equal its eager output bit for bit), with the eager
    (``time_ms``) figures printed beside them, and the bound of the FFT
    design's own work (``n_bytes``, ``frontend_ops``) → the kernel line's
    timings."""
    import torch

    fns = {"kernel": kernel, "plain": plain, "cuFFT chain": library}
    graphs = {n: graph_of(fn, mode="relaxed") for n, fn in fns.items()}
    rounds = alternating_ms({n: g[0] for n, g in graphs.items()})
    for n, fn in fns.items():
        check(torch.equal(graphs[n][1], fn()),
              f"{name}: the {n}'s replay differs from its eager output")
    med = {n: statistics.median(r) for n, r in rounds.items()}
    ratio = [a / b for a, b in zip(rounds["kernel"], rounds["cuFFT chain"])]
    eager = {n: time_ms(fn) for n, fn in fns.items()}
    t = dict(max_abs_err=err, ms=med["kernel"], plain_ms=med["plain"],
             library_ms=med["cuFFT chain"],
             **bound(n_bytes, frontend_ops(frames), "fp32"))
    share = t["bound_ms"] / t["ms"]
    print(f"[{phase}] {name}, {len(ratio)} alternating rounds of graph "
          f"replays (medians): " + ", ".join(f"{n} {m:.4f} ms" for n, m in
                                             med.items())
          + f"; kernel / cuFFT chain {statistics.median(ratio):.3f} (rounds "
          f"{min(ratio):.3f}-{max(ratio):.3f}); bound {t['bound_ms']:.5f} ms"
          f" ({t['bound_by']}), share {share:.3f}; replays equal the eager "
          f"outputs. Eager (host time in it): " + ", ".join(
              f"{n} {m:.4f} ms" for n, m in eager.items()))
    check(share <= 1, f"{name}: share of the bound {share:.3f} > 1")
    return t


def excess(got, want, rtol: float, atol: float, scale=None,
           extra=0.0) -> float:
    """max over the elements of |got − want| / (atol + rtol·scale + extra),
    in fp32, ``scale`` |want| by default: at most 1 where numpy's
    ``assert_allclose(rtol, atol)`` holds (``extra`` 0)."""
    a, b = got.float(), want.float()
    s = b.abs() if scale is None else scale
    return float(((a - b).abs() / (atol + rtol * s + extra)).max())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def synth_signal(rng, seconds: float, vocab_size: int) -> np.ndarray:
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        make_utterance)

    n = int(round(seconds * 10))            # 1600-sample tones: 10 per s
    ids = [int(k) for k in rng.integers(1, vocab_size, n)]
    return make_utterance(rng, ids, tone_len=1600, vocab_size=vocab_size)[0]


def random_state_dict(model, rng) -> dict:
    """Fan-in-scaled normal weights (biases 0.1·normal) for every tensor
    of the port's state_dict, from the numpy seed."""
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith(".bias"):
            sd[k] = 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:                 # LayerNorm scale
            sd[k] = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if k.endswith(".rec") else int(
                np.prod(shape[1:]))
            sd[k] = rng.standard_normal(shape) / np.sqrt(fan_in)
        sd[k] = sd[k].astype(np.float32)
    return sd


def rnn_rows(lens_f, T: int, dev):
    """(lo, hi) [2B, 1] of a BiRNN layer for subsampled lengths."""
    import torch

    B = lens_f.shape[0]
    lo = torch.cat([torch.zeros(B), T - lens_f])[:, None].to(dev)
    hi = torch.cat([lens_f, torch.full((B,), float(T))])[:, None].to(dev)
    return lo, hi


def _cudnn(cell: str, dev, in_dim: int, H: int, bidirectional: bool, dtype):
    """cuDNN's GRU or LSTM with b_hh = 0 (the GRU's gate order r, z, n and
    r ⊙ (W_hn h) are the port's, the LSTM has no +1 forget bias) and its
    weights flattened once, bf16 included."""
    import torch

    cls = {"gru": torch.nn.GRU, "lstm": torch.nn.LSTM}[cell]
    rnn = cls(in_dim, H, bidirectional=bidirectional).to(dev, dtype)
    with torch.no_grad():
        for name, p in rnn.named_parameters():
            if name.startswith("bias_hh"):
                p.zero_()
    # flatten_parameters() skips the dtypes torch.backends.cudnn.is_acceptable
    # does not list (bf16), which leaves cuDNN to compact the weights into
    # one buffer at every call; flatten them once, for bf16 too
    acceptable = torch.backends.cudnn.is_acceptable
    torch.backends.cudnn.is_acceptable = lambda t: t.is_cuda
    try:
        rnn.flatten_parameters()
    finally:
        torch.backends.cudnn.is_acceptable = acceptable
    return rnn


def _check_no_compaction(cell: str, *fns) -> None:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for fn in fns:
            fn()
    compacted = [w for w in caught if "contiguous chunk" in str(w.message)]
    check(not compacted, f"cuDNN {cell} yardstick: weights compacted at "
          f"every call ({compacted[:1]})")


def library_rnn_fns(cell: str, dev, T: int, B: int, H: int, lens,
                    dtype, ndir: int = 2) -> dict:
    """cuDNN's GRU or LSTM (bidirectional when ndir = 2) over packed
    sequences (``_cudnn``): the yardstick for the recurrence kernels, input
    projection included. → {"forward", "training forward",
    "forward+backward": callable}; the backward is the last less the
    second."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    rnn = _cudnn(cell, dev, ndir * H, H, ndir == 2, dtype)
    x = torch.randn(T, B, ndir * H, device=dev, dtype=dtype)
    packed = pack_padded_sequence(x, lens.cpu(), enforce_sorted=False)
    packed_g = packed._replace(data=packed.data.clone().requires_grad_())

    def fwd():
        with torch.no_grad():
            return rnn(packed)[0].data

    def fwd_train():
        return rnn(packed_g)[0].data

    def fwd_bwd():
        out, _ = rnn(packed_g)
        return torch.autograd.grad(out.data.sum(), [packed_g.data])[0]

    _check_no_compaction(cell, fwd, fwd_bwd)
    return {"forward": fwd, "training forward": fwd_train,
            "forward+backward": fwd_bwd}


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors or tuples of tensors (bf16 compared
    as int16, so -0.0 and NaN payloads count too)."""
    import torch

    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(
        a.view(view.get(a.dtype, a.dtype)), b.view(view.get(b.dtype, b.dtype)))


def rnn_graph_rounds(tag: str, kernels: dict, library: dict,
                     rounds: int = 9, calls: int = GRAPH_CALLS) -> dict:
    """The recurrence kernels (name → call) and cuDNN's calls (``library_
    rnn_fns``) in ``rounds`` alternating rounds of CUDA-graph replays of
    ``calls`` calls (device time only), each kernel's replay equal to its
    eager output bit for bit; the eager (``time_ms``) figures printed beside
    → {name: [ms a round]}, cuDNN's backward as "cuDNN backward" where both
    its calls are given."""
    fns = {**kernels, **{f"cuDNN {n}": f for n, f in library.items()}}
    graphs = {n: graph_of(fn, calls=calls, mode="relaxed")
              for n, fn in fns.items()}
    rounds = alternating_ms({n: g[0] for n, g in graphs.items()}, rounds,
                            calls)
    for n, fn in kernels.items():
        check(same_bits(graphs[n][1], fn()),
              f"{tag}: the {n} replay differs from its eager output")
    if "forward+backward" in library:
        rounds["cuDNN backward"] = [a - b for a, b in zip(
            rounds["cuDNN forward+backward"],
            rounds["cuDNN training forward"])]
    eager = {n: time_ms(fn) for n, fn in fns.items()}
    print(f"[{tag}] {len(next(iter(rounds.values())))} alternating rounds "
          f"of graph replays (medians): " + ", ".join(
              f"{n} {statistics.median(r):.4f} ms" for n, r in
              rounds.items()) + "; replays equal the eager outputs. Eager "
          f"(host time in it): " + ", ".join(
              f"{n} {m:.4f} ms" for n, m in eager.items()))
    return rounds


def print_rnn_plan(cell: str, tag: str, H: int, B: int, ndir: int,
                   form: str) -> None:
    """The bf16 cluster kernel's plan of ``cell`` ("gru" or "lstm") at
    this shape, as the library and the card take it."""
    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda

    p = getattr(rnn_cuda, f"{cell}_plan")(H, B, ndir, form)
    smem, n = getattr(rnn_cuda, f"{cell}_occupancy")(H, form)
    U = (rnn_cuda.gru_units(H, form) if cell == "gru"
         else rnn_cuda.lstm_units(H))
    print(f"[{tag}] {cell} {form} plan at H={H}, B={B}, ndir={ndir}: "
          f"cluster C = "
          f"{p.cluster} blocks of {U} units"
          + (f" (W streamed; the last block {H - U * (p.cluster - 1)})"
             if H > rnn_cuda.RESIDENT_MAX else "")
          + f", M = {p.rows} rows,"
          f" {p.smem} bytes of shared memory a block, {p.clusters} "
          f"clusters; "
          f"the card holds {n} at once")
    check(smem == p.smem, f"{tag}: the library's shared memory {smem} != "
          f"the plan's {p.smem}")
    check(n >= 1, f"{tag}: the card cannot hold one {form} cluster")


def library_stream(cell: str, dev, T: int, B: int, H: int, ndir: int, lens,
                   h0, dtype):
    """cuDNN's GRU or LSTM (bidirectional when ndir = 2) over the same
    window, packed, its initial state hx taken from h0 (the port's rows
    [d·B, (d+1)·B) are direction d): the same work as a stream launch,
    input projection included, but not the same function (no carry at
    emit_t; a length-0 row runs one step). → its forward, a callable."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    rnn = _cudnn(cell, dev, ndir * H, H, ndir == 2, dtype)
    x = torch.randn(T, B, ndir * H, device=dev, dtype=dtype)
    packed = pack_padded_sequence(x, lens.clamp(min=1).cpu(),
                                  enforce_sorted=False)
    h = h0[:, :H].reshape(ndir, B, H).to(dtype).contiguous()
    hx = h if cell == "gru" else (
        h, h0[:, H:].reshape(ndir, B, H).to(dtype).contiguous())

    def fwd():
        with torch.no_grad():
            return rnn(packed, hx)[0].data

    _check_no_compaction(cell, fwd)
    return fwd


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    import torch

    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s): {name}")
    return name, smi


def phase_build() -> None:
    from chainer_speech_recognition_tpu_torch import _kernels

    t0 = time.perf_counter()
    so = _kernels.build()
    _kernels.library()
    info = _kernels.build_info
    print(f"[build] {os.path.basename(so)} in "
          f"{time.perf_counter() - t0:.3f} s (nvcc {info['seconds']:.3f} s, "
          f"cached={info['cached']})")
    # one line a kernel instantiation: registers and spill stores (ptxas)
    entry = None
    for line in info.get("log", "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?E", m.group(1))
            entry = k.group(1) + (k.group(2) or "") if k else m.group(1)
            spill = ""
        elif entry and "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif entry and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            print(f"[build] {entry}: {regs} registers, {spill}")
            entry = None


def phase_kernels(dev, rng) -> dict:
    """Each decode-path kernel vs its plain version at the decode shapes."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode.greedy import (
        best_keep_plain)
    from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
        fused_logmel_rows_cuda)
    from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
        _K, _tables, extend_signal, logmel_from_extended)
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        gru_scan_cuda, gru_scan_plain)

    mcfg = preset_config(PRESET).model
    out = {}

    # front-end: one full chunk of 10 s wavs (the last one 8 s: ragged)
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    sigs = np.zeros((CHECK_B, n), np.float32)
    lens = np.full(CHECK_B, n, np.int32)
    lens[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE)
    for i in range(CHECK_B):
        s = synth_signal(rng, lens[i] / C.SAMPLE_RATE, mcfg.vocab_size)
        sigs[i, : len(s)] = s
        lens[i] = len(s)
    T = C.num_frames(n)
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.from_numpy(lens).to(dev), T + _K + 1)
    got = fused_logmel_rows_cuda(ext, T)
    want = logmel_from_extended(ext, T)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[kernels] frontend_logmel ext {tuple(ext.shape)} -> "
          f"{tuple(got.shape)}: max abs {err:.3e} (tol {TOL['frontend_logmel']})")
    check(bool(torch.isfinite(got).all()), "frontend_logmel: non-finite")
    check(err <= TOL["frontend_logmel"], "frontend_logmel disagrees")
    # yardstick: cuFFT's rfft of the windowed frames, power, the mel matmul
    # and the log (the frames are cut and windowed outside the timing)
    win, mel = _tables(dev)
    frames = (ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :T] * win).contiguous()

    def library_logmel():
        spec = torch.fft.rfft(frames, n=C.N_FFT, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(power @ mel, min=C.LOG_EPS))

    lib_err = float((library_logmel() - want).abs().max())
    print(f"[kernels] frontend_logmel: cuFFT rfft + mel + log on windowed "
          f"frames, max abs vs plain {lib_err:.3e}")
    out["frontend_logmel"] = frontend_timing(
        "kernels", "frontend_logmel", err,
        lambda: fused_logmel_rows_cuda(ext, T),
        lambda: logmel_from_extended(ext, T), library_logmel,
        nbytes(ext, got), CHECK_B * T)

    # GRU: [T', 2B, 3H] at the subsampled length of 10 s
    Tp = T
    for s in mcfg.conv_stride_time:
        Tp = -(-Tp // s)
    H, B = mcfg.rnn_hidden, CHECK_B
    flen = torch.from_numpy(lens // C.HOP_LENGTH + 1)
    for s in mcfg.conv_stride_time:
        flen = conv_out_length(flen, s)
    lo, hi = rnn_rows(flen.to(torch.float32), Tp, dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs32 = torch.from_numpy(rng.standard_normal(
        (Tp, 2 * B, 3 * H)).astype(np.float32)).to(dev)
    live = 2 * int(flen.sum())               # live (row, step) pairs
    lib = library_rnn_fns("gru", dev, Tp, B, H, flen, torch.bfloat16)
    print_rnn_plan("gru", "kernels", H, B, 2, "fwd")
    for tag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xs = xs32.to(torch.bfloat16) if tag == "bf16" else xs32
        got = gru_scan_cuda(xs, w, lo, hi, cdt)
        want = gru_scan_plain(xs, w, lo, hi, cdt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL[f"gru_{tag}"]
        print(f"[kernels] gru_fwd {tag} xs {tuple(xs.shape)}: max abs "
              f"{err:.3e} (tol {tol})")
        check(bool(torch.isfinite(got).all()), f"gru_fwd {tag}: non-finite")
        check(err <= tol, f"gru_fwd {tag} disagrees")
        xs_live = live * 3 * H * xs.element_size()
        w_bytes = w.numel() * xs.element_size()
        kernel = lambda: gru_scan_cuda(xs, w, lo, hi, cdt)
        timing = dict(
            max_abs_err=err,
            plain_ms=time_ms(lambda: gru_scan_plain(xs, w, lo, hi, cdt),
                             warmup=1, reps=3),
            **bound(xs_live + w_bytes + nbytes(got, lo, hi),
                    2 * live * H * 3 * H, tag))
        if cdt == torch.bfloat16:       # the preset's compute dtype
            # the kernel and cuDNN's forward (bf16, with its input
            # projection) in alternating rounds of graph replays
            rounds = rnn_graph_rounds("kernels", {"gru_fwd": kernel},
                                      {"forward": lib["forward"]})
            timing["ms"] = statistics.median(rounds["gru_fwd"])
            timing["library_ms"] = statistics.median(rounds["cuDNN forward"])
            out["gru_fwd"] = timing
        else:
            timing["ms"] = time_ms(kernel)
            timing["library_ms"] = None
        print(f"[kernels] gru_fwd {tag}: {timing['ms']:.4f} ms"
              f"{' (graph)' if tag == 'bf16' else ' (eager)'}, plain "
              f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.5f} "
              f"ms ({timing['bound_by']})" + (
                  f", cuDNN GRU (bf16, with input projection) "
                  f"{timing['library_ms']:.4f} ms (graph)"
                  if timing["library_ms"] is not None else ""))

    # greedy: random logits + planted ties, NaN frames, lengths 0, 1, T'
    V = mcfg.vocab_size
    logits = rng.standard_normal((B, Tp, V)).astype(np.float32)
    logits[0, 3, [5, 9]] = 7.0              # tie → first index
    logits[0, 4, [9, 5]] = 7.0              # same tie: a repeat
    logits[1, 2, 7] = np.nan                # one NaN in a frame → blank
    logits[1, 2, 3] = 50.0
    logits[1, 5, :] = np.nan                # all-NaN frame → blank
    logits[2, 6, :] = 1.0                   # all-equal frame → index 0
    glens = flen.clone().to(torch.int32)
    glens[3], glens[4], glens[5] = 0, 1, Tp
    lg = torch.from_numpy(logits).to(dev)
    gl = glens.to(dev)
    out["greedy"] = greedy_check("kernels", lg, gl, Tp)
    pb, _ = best_keep_plain(lg, gl)
    check(int(pb[1, 2]) == 0 and int(pb[1, 5]) == 0 and int(pb[0, 3]) == 5,
          "greedy: NaN/tie rule broken")
    # the long-form shape (T' = 701): timed and held to the plain version
    T_long = 701
    llg = torch.from_numpy(rng.standard_normal((B, T_long, V)).astype(
        np.float32)).to(dev)
    lgl = torch.from_numpy(rng.integers(T_long // 2, T_long + 1, B).astype(
        np.int32)).to(dev)
    greedy_check("kernels", llg, lgl, T_long)
    return out


def greedy_check(tag: str, lg, gl, max_len: int) -> dict:
    """The one-launch greedy decode against compact_kept(*best_keep_plain
    (...)) (exact: ids and lengths), then both timed as alternating rounds
    of graph replays (device time only; the replays equal the eager
    outputs) → the kernel line's timings. Bound: the live frames' logits
    read once, ids and lengths written once; a comparison an element."""
    import torch

    from chainer_speech_recognition_tpu_torch.decode.greedy import (
        best_keep_plain, compact_kept, greedy_decode_cuda)

    B, T, V = lg.shape
    plain = lambda: compact_kept(*best_keep_plain(lg, gl), max_len)
    kernel = lambda: greedy_decode_cuda(lg, gl, max_len)
    ids, lens = kernel()
    pids, plens = plain()
    torch.cuda.synchronize()
    mism = int((ids != pids).sum() + (lens != plens).sum())
    print(f"[{tag}] greedy logits {tuple(lg.shape)} max_len {max_len}: "
          f"{mism} mismatches in ids and lengths (exact), kept "
          f"{int(lens.min())}..{int(lens.max())}")
    check(mism == 0, "greedy disagrees with its plain version")
    fns = {"greedy": kernel, "plain": plain}
    graphs = {n: graph_of(fn, mode="relaxed") for n, fn in fns.items()}
    rounds = alternating_ms({n: g[0] for n, g in graphs.items()})
    for n, fn in fns.items():
        check(same_bits(graphs[n][1], fn()),
              f"{tag}: the greedy {n} replay differs from its eager output")
    med = {n: statistics.median(r) for n, r in rounds.items()}
    live = int(gl.clamp(0, T).sum())
    t = dict(max_abs_err=float(mism), ms=med["greedy"],
             plain_ms=med["plain"], library_ms=None,
             **bound(live * V * 4 + nbytes(gl, ids, lens), live * V, "fp32"))
    ratio = [b / a for a, b in zip(rounds["greedy"], rounds["plain"])]
    print(f"[{tag}] greedy T' = {T}: {len(ratio)} alternating rounds of "
          f"graph replays (medians): kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms (plain / kernel "
          f"{statistics.median(ratio):.2f}, rounds {min(ratio):.2f}-"
          f"{max(ratio):.2f}); bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']}), share {t['bound_ms'] / t['ms']:.4f}; eager "
          f"(host time in it): kernel {time_ms(kernel):.5f} ms")
    return t


def dw_check(tag: str, dev, ys, gates, B: int) -> dict:
    """The dW kernel on a training layer's own ys and gate gradients:
    against the fp64 sum of the same bf16 operands at |Δ| ≤ K·2⁻²³·Σ|h·g|
    (K = T·B products an element, each exact in fp32, summed in fp32),
    against the plain version at twice that bar, bitwise against a second
    run; then timed in alternating rounds of graph replays beside the
    parent's chain (shift_prev, dw_matmul per gate tensor, cat) and cuBLAS
    (``torch.bmm`` of bf16 operands laid out per direction beforehand,
    fp32 output) → the kernel line's timings, the chain as plain_ms."""
    import torch

    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        dw_cuda, dw_matmul, dw_plain, dw_plan, shift_prev)

    T, R, H = ys.shape
    N = sum(g.shape[2] for g in gates)
    dirs = range(R // B)                 # 2, or 1 for a forward-only layer
    got = dw_cuda(ys, gates, B)
    again = dw_cuda(ys, gates, B)
    plain = torch.cat([dw_plain(ys, g, B, torch.bfloat16) for g in gates],
                      dim=2)
    hp = shift_prev(ys).to(torch.bfloat16)
    g64 = torch.cat([g.double() for g in gates], dim=2)
    ops = [(hp[:, d * B:(d + 1) * B].reshape(-1, H).double(),
            g64[:, d * B:(d + 1) * B].reshape(-1, N)) for d in dirs]
    ref = torch.stack([a.T @ b for a, b in ops])
    bar = T * B * 2.0 ** -23 * torch.stack([a.abs().T @ b.abs()
                                            for a, b in ops])
    tiny = torch.finfo(torch.float64).tiny
    ex_ref = float(((got.double() - ref).abs() / (bar + tiny)).max())
    ex_plain = float(((got.double() - plain.double()).abs()
                      / (2 * bar + tiny)).max())
    err = float((got - plain).abs().max())
    print(f"[{tag}] dw ys {tuple(ys.shape)}, gates "
          f"{[tuple(g.shape) for g in gates]} -> {tuple(got.shape)}: |Δ| / "
          f"bar {ex_ref:.3e} vs the fp64 sum (bar K·2^-23·Σ|h·g|, K = "
          f"{T * B}), {ex_plain:.3e} vs the plain version (2·bar; max abs "
          f"{err:.3e}); two runs bitwise equal: {same_bits(got, again)}; "
          f"plan {dw_plan(T, B, H, N, len(dirs))}")
    check(bool(torch.isfinite(got).all()), "dw: non-finite")
    check(ex_ref <= 1 and ex_plain <= 1, "dw disagrees")
    check(same_bits(got, again), "dw: two runs differ")

    def chain():
        h_prev = shift_prev(ys)
        d = [dw_matmul(h_prev, g, B, torch.bfloat16) for g in gates]
        return d[0] if len(d) == 1 else torch.cat(d, dim=2)

    a = torch.stack([hp[:, d * B:(d + 1) * B].reshape(-1, H)
                     for d in dirs]).transpose(1, 2)          # [ndir, H, K]
    gb = torch.cat(list(gates), dim=2)
    b = torch.stack([gb[:, d * B:(d + 1) * B].reshape(-1, N)
                     for d in dirs]).contiguous()              # [ndir, K, N]
    library = lambda: torch.bmm(a, b, out_dtype=torch.float32)
    lib_err = float((library() - plain).abs().max())
    fns = {"dw": lambda: dw_cuda(ys, gates, B), "parent chain": chain,
           "cuBLAS bmm": library}
    graphs = {n: graph_of(fn, mode="relaxed") for n, fn in fns.items()}
    rounds = alternating_ms({n: g[0] for n, g in graphs.items()})
    check(same_bits(graphs["dw"][1], got),
          f"{tag}: the dw replay differs from its eager output")
    med = {n: statistics.median(r) for n, r in rounds.items()}
    # what the product needs: ys at frames 0..T-2, the gate columns at
    # frames 1..T-1, dW written once
    need = (T - 1) * R * (H * 4 + N * 2) + nbytes(got)
    t = dict(max_abs_err=err, ms=med["dw"], plain_ms=med["parent chain"],
             library_ms=med["cuBLAS bmm"],
             **bound(need, 2 * 2 * H * N * (T - 1) * B, "bf16"))
    ratio = [c / k for k, c in zip(rounds["dw"], rounds["parent chain"])]
    print(f"[{tag}] dw: {len(ratio)} alternating rounds of graph replays "
          f"(medians): kernel {t['ms']:.5f} ms, parent chain "
          f"{t['plain_ms']:.5f} ms (chain / kernel "
          f"{statistics.median(ratio):.2f}, rounds {min(ratio):.2f}-"
          f"{max(ratio):.2f}), cuBLAS bmm (bf16 in, fp32 out; max abs vs "
          f"plain {lib_err:.3e}) {t['library_ms']:.5f} ms; bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']}), share "
          f"{t['bound_ms'] / t['ms']:.4f}; eager (host time in it): kernel "
          f"{time_ms(fns['dw']):.5f} ms")
    return t


def phase_train_kernels(dev, rng) -> dict:
    """The four training kernels vs their plain versions at the training
    path's shapes: 24 utterances of 9-10 s padded to the 1024-frame
    bucket (T' = 256, S = 2·128 + 1)."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.ctc import (
        ctc_alpha_plain, ctc_beta_grad_plain)
    from chainer_speech_recognition_tpu_torch.ops.ctc_cuda import (
        ctc_bwd_cuda, ctc_fwd_cuda)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        gru_bwd_cuda, gru_bwd_plain, gru_scan_train_cuda,
        gru_scan_train_plain, shift_prev)

    cfg = preset_config(PRESET)
    H, V, B = cfg.model.rnn_hidden, cfg.model.vocab_size, TRAIN_B
    L = cfg.buckets.max_label_len
    samples = rng.uniform(*TRAIN_SECONDS, B) * C.SAMPLE_RATE
    flen = torch.from_numpy((samples.astype(np.int64) // C.HOP_LENGTH) + 1)
    T = TRAIN_FRAMES
    for s in cfg.model.conv_stride_time:
        flen = conv_out_length(flen, s)
        T = -(-T // s)
    out = {}
    cdt = torch.bfloat16

    # GRU training forward and backward (bf16 streams, the preset's dtype)
    lo, hi = rnn_rows(flen.to(torch.float32), T, dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, 3 * H)).astype(np.float32)).to(dev).to(cdt)
    g = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, H)).astype(np.float32)).to(dev)
    ys, gates = gru_scan_train_cuda(xs, w, lo, hi, cdt)
    ys_p, gates_p = gru_scan_train_plain(xs, w, lo, hi, cdt)
    torch.cuda.synchronize()
    err = max(float((ys - ys_p).abs().max()),
              float((gates.float() - gates_p.float()).abs().max()))
    print(f"[train-kernels] gru_fwd_train xs {tuple(xs.shape)} -> ys, gates "
          f"{tuple(gates.shape)}: max abs {err:.3e} (tol {TOL['gru_bf16']})")
    check(bool(torch.isfinite(ys).all() and torch.isfinite(gates).all()),
          "gru_fwd_train: non-finite")
    check(err <= TOL["gru_bf16"], "gru_fwd_train disagrees")
    # the kernel reads h_prev from ys in place; the plain version takes
    # shift_prev(ys)
    args = (gates_p, w, lo, hi, ys_p, g, cdt)
    plain_args = (gates_p, w, lo, hi, shift_prev(ys_p), g, cdt)
    dxs_p, dhn_p = gru_bwd_plain(*plain_args)
    gerr = 0.0
    # once on the plain forward's residuals (the kernel alone), once on the
    # forward kernel's own (the training path)
    for gt, y in ((gates_p, ys_p), (gates, ys)):
        dxs, dhn = gru_bwd_cuda(gt, w, lo, hi, y, g, cdt)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(dxs.float()).all()
                   and torch.isfinite(dhn.float()).all()),
              "gru_bwd: non-finite")
        gerr = max(gerr, float((dxs.float() - dxs_p.float()).abs().max()),
                   float((dhn.float() - dhn_p.float()).abs().max()))
    print(f"[train-kernels] gru_bwd gates {tuple(gates.shape)} -> dxs "
          f"{tuple(dxs.shape)}, dhn: max abs {gerr:.3e} "
          f"(tol {TOL['gru_grad_bf16']}; on the plain and the kernel's "
          f"residuals)")
    check(gerr <= TOL["gru_grad_bf16"], "gru_bwd disagrees")
    # dW of the layer, on the kernels' own ys and gradients: the GRU's two
    # products (dxs[..., :2H], row stride 3H, and dhn) in one launch
    out["dw_bigru"] = dw_check("train-kernels", dev, ys,
                               (dxs[..., :2 * H], dhn), B)
    live = 2 * int(flen.sum())
    esz = xs.element_size()
    print_rnn_plan("gru", "train-kernels", H, B, 2, "fwd")
    print_rnn_plan("gru", "train-kernels", H, B, 2, "bwd")
    lib = library_rnn_fns("gru", dev, T, B, H, flen, cdt)
    # both kernels and cuDNN's training forward and forward+backward in
    # alternating rounds of graph replays (device time only)
    rounds = rnn_graph_rounds(
        "train-kernels",
        {"gru_fwd_train": lambda: gru_scan_train_cuda(xs, w, lo, hi, cdt),
         "gru_bwd": lambda: gru_bwd_cuda(*args)},
        {n: lib[n] for n in ("training forward", "forward+backward")})
    med = {n: statistics.median(r) for n, r in rounds.items()}
    out["gru_fwd_train"] = dict(
        max_abs_err=err, ms=med["gru_fwd_train"],
        plain_ms=time_ms(lambda: gru_scan_train_plain(xs, w, lo, hi, cdt),
                         warmup=1, reps=3),
        library_ms=med["cuDNN training forward"],
        **bound(live * 3 * H * esz + w.numel() * esz + nbytes(ys, gates, lo,
                                                               hi),
                2 * live * H * 3 * H, "bf16"))
    out["gru_bwd"] = dict(
        max_abs_err=gerr, ms=med["gru_bwd"],
        plain_ms=time_ms(lambda: gru_bwd_plain(*plain_args), warmup=1,
                         reps=3),
        library_ms=med["cuDNN backward"],
        **bound(live * (4 * H * esz + 2 * H * 4) + w.numel() * esz
                + nbytes(dxs, dhn, lo, hi), 2 * live * 3 * H * H, "bf16"))

    # CTC alpha and beta: 90-100 labels an utterance (10 symbols a second)
    logits, labels, lab_len = ctc_draws(rng, samples / C.SAMPLE_RATE, T, L,
                                        V)
    (lp_ext, allow2, t_len, lab_len_t), lib = ctc_setup(dev, logits, flen,
                                                        labels, lab_len)
    alphas, loss = ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len_t)
    alphas_p, loss_p = ctc_alpha_plain(lp_ext, allow2, t_len, lab_len_t)
    torch.cuda.synchronize()
    a = ctc_alpha_check(alphas, loss, alphas_p, loss_p)
    print(f"[train-kernels] ctc_fwd lp_ext {tuple(lp_ext.shape)}: loss max "
          f"rel {a['rel']:.3e} (rtol {TOL['ctc_loss_rtol']}), loss "
          f"{float(loss.min()):.2f}..{float(loss.max()):.2f}; alphas max abs "
          f"{a['aerr']:.3e} over {a['live']} live states (atol "
          f"{TOL['ctc_alpha_atol']} + rtol {TOL['ctc_loss_rtol']}), "
          f"{a['sent']} LOG_ZERO states equal: {a['sent_ok']}; alphas and "
          f"loss bitwise the plain recursion's: "
          f"{same_bits((alphas, loss), (alphas_p, loss_p))}")
    check(bool(torch.isfinite(loss).all()), "ctc_fwd: non-finite loss")
    check(a["rel"] <= TOL["ctc_loss_rtol"], "ctc_fwd loss disagrees")
    check(a["sent_ok"] and a["alpha_ok"], "ctc_fwd alphas disagree")
    gl = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).to(dev)
    grad_p = ctc_beta_grad_plain(lp_ext, allow2, t_len, lab_len_t, alphas_p,
                                 loss_p, gl)
    cerr = 0.0
    # once on the plain alphas (the kernel alone), once on the forward
    # kernel's own (the training path)
    for al, l in ((alphas_p, loss_p), (alphas, loss)):
        grad = ctc_bwd_cuda(lp_ext, allow2, t_len, lab_len_t, al, l, gl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(grad).all()), "ctc_bwd: non-finite")
        cerr = max(cerr, float((grad - grad_p).abs().max()))
        if al is alphas_p:
            grad_bits = same_bits(grad, grad_p)
    print(f"[train-kernels] ctc_bwd: grad max abs {cerr:.3e} "
          f"(tol {TOL['ctc_grad']}; on the plain and the kernel's alphas); "
          f"bitwise the plain recursion's on the plain alphas: {grad_bits}")
    check(cerr <= TOL["ctc_grad"], "ctc_bwd disagrees")
    # both kernels as graph replays and F.ctc_loss (eager) in alternating
    # rounds; the eager kernel figures (host time in them) beside
    bwd_args = (lp_ext, allow2, t_len, lab_len_t, alphas_p, loss_p, gl)
    kernels = {"ctc_fwd": lambda: ctc_fwd_cuda(lp_ext, allow2, t_len,
                                               lab_len_t),
               "ctc_bwd": lambda: ctc_bwd_cuda(*bwd_args)}
    rounds = ctc_rounds("train-kernels", kernels, lib)
    med = {n: statistics.median(r) for n, r in rounds.items()}
    eager = {n: time_ms(fn) for n, fn in kernels.items()}
    print(f"[train-kernels] ctc: {len(rounds['ctc_fwd'])} alternating rounds"
          f" (medians): " + ", ".join(f"{n} {m:.4f} ms" for n, m in
                                      med.items())
          + f"; a step (ms / T' = {T}): " + ", ".join(
              f"{n} {med[n] / T * 1e3:.4f} us" for n in kernels)
          + "; eager, one call (host time in it): " + ", ".join(
              f"{n} {m:.4f} ms" for n, m in eager.items()))
    print_ctc_plan("train-kernels", lp_ext.shape[2])
    # the recursions need lp (and alphas) at live frames and valid states
    S = lp_ext.shape[2]
    need = int((t_len.long() * (2 * lab_len_t.long() + 1)).sum()) * 4
    cells = need // 4
    out["ctc_fwd"] = dict(
        max_abs_err=max(a["aerr"], float((loss - loss_p).abs().max())),
        ms=med["ctc_fwd"],
        plain_ms=time_ms(lambda: ctc_alpha_plain(lp_ext, allow2, t_len,
                                                 lab_len_t), warmup=1,
                         reps=3),
        library_ms=med["F.ctc_loss forward"],
        **bound(need + nbytes(allow2, t_len, lab_len_t, alphas, loss),
                12 * cells, "fp32"))
    out["ctc_bwd"] = dict(
        max_abs_err=cerr, ms=med["ctc_bwd"],
        plain_ms=time_ms(lambda: ctc_beta_grad_plain(*bwd_args), warmup=1,
                         reps=3),
        library_ms=med["F.ctc_loss backward"],
        **bound(2 * need + nbytes(allow2, t_len, lab_len_t, loss, gl, grad),
                16 * cells, "fp32"))
    for name in ("gru_fwd_train", "gru_bwd", "ctc_fwd", "ctc_bwd"):
        t = out[name]
        print(f"[train-kernels] {name}: {t['ms']:.4f} ms (graph), plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    print(f"[train-kernels] S = {S}, T' = {T}, B = {B}")
    return out


def phase_lstm_kernels(dev, rng) -> dict:
    """The residual-free BiLSTM kernel vs its plain version at the decode
    shapes of bilstm_deep: a chunk of 32 wavs of 10 s (the last one 8 s),
    T' = 251, in fp32 and bf16 (the preset's dtype, whose timing is kept)."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        lstm_scan_cuda, lstm_scan_plain)

    mcfg = preset_config(LSTM_PRESET).model
    H, B = mcfg.rnn_hidden, CHECK_B
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    lens = np.full(B, n, np.int64)
    lens[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE)
    flen = torch.from_numpy(lens // C.HOP_LENGTH + 1)
    Tp = C.num_frames(n)
    for s in mcfg.conv_stride_time:
        flen = conv_out_length(flen, s)
        Tp = -(-Tp // s)
    lo, hi = rnn_rows(flen.to(torch.float32), Tp, dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs32 = torch.from_numpy(rng.standard_normal(
        (Tp, 2 * B, 4 * H)).astype(np.float32)).to(dev)
    live = 2 * int(flen.sum())               # live (row, step) pairs
    lib = library_rnn_fns("lstm", dev, Tp, B, H, flen, torch.bfloat16)
    print_rnn_plan("lstm", "lstm-kernels", H, B, 2, "fwd")
    out = {}
    for tag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xs = xs32.to(torch.bfloat16) if tag == "bf16" else xs32
        got = lstm_scan_cuda(xs, w, lo, hi, cdt)
        want = lstm_scan_plain(xs, w, lo, hi, cdt)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        tol = TOL[f"gru_{tag}"]
        print(f"[lstm-kernels] lstm_fwd {tag} xs {tuple(xs.shape)}: max abs "
              f"{err:.3e} (tol {tol})")
        check(bool(torch.isfinite(got).all()), f"lstm_fwd {tag}: non-finite")
        check(err <= tol, f"lstm_fwd {tag} disagrees")
        esz = xs.element_size()
        kernel = lambda: lstm_scan_cuda(xs, w, lo, hi, cdt)
        timing = dict(
            max_abs_err=err,
            plain_ms=time_ms(lambda: lstm_scan_plain(xs, w, lo, hi, cdt),
                             warmup=1, reps=3),
            **bound(live * 4 * H * esz + w.numel() * esz
                    + nbytes(got, lo, hi), 2 * live * H * 4 * H, tag))
        if cdt == torch.bfloat16:       # the preset's compute dtype
            # the kernel and cuDNN's forward (bf16, with its input
            # projection) in alternating rounds of graph replays
            rounds = rnn_graph_rounds("lstm-kernels", {"lstm_fwd": kernel},
                                      {"forward": lib["forward"]})
            timing["ms"] = statistics.median(rounds["lstm_fwd"])
            timing["library_ms"] = statistics.median(rounds["cuDNN forward"])
            out["lstm_fwd"] = timing
        else:
            timing["ms"] = time_ms(kernel)
            timing["library_ms"] = None
        print(f"[lstm-kernels] lstm_fwd {tag}: {timing['ms']:.4f} ms"
              f"{' (graph)' if tag == 'bf16' else ' (eager)'}, plain "
              f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.5f} "
              f"ms ({timing['bound_by']})" + (
                  f", cuDNN LSTM (bf16, with input projection) "
                  f"{timing['library_ms']:.4f} ms (graph)"
                  if timing["library_ms"] is not None else ""))
    print(f"[lstm-kernels] T' = {Tp}, B = {B}, H = {H}")
    return out


def phase_lstm_train_kernels(dev, rng) -> dict:
    """The BiLSTM training forward and backward vs their plain versions at
    bilstm_deep's training shapes (24 utterances of 9-10 s in the
    1024-frame bucket, T' = 256, bf16)."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        lstm_bwd_cuda, lstm_bwd_plain, lstm_scan_train_cuda,
        lstm_scan_train_plain)

    cfg = preset_config(LSTM_PRESET)
    H, B = cfg.model.rnn_hidden, TRAIN_B
    samples = rng.uniform(*TRAIN_SECONDS, B) * C.SAMPLE_RATE
    flen = torch.from_numpy((samples.astype(np.int64) // C.HOP_LENGTH) + 1)
    T = TRAIN_FRAMES
    for s in cfg.model.conv_stride_time:
        flen = conv_out_length(flen, s)
        T = -(-T // s)
    cdt = torch.bfloat16
    lo, hi = rnn_rows(flen.to(torch.float32), T, dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, 4 * H)).astype(np.float32)).to(dev).to(cdt)
    g = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, H)).astype(np.float32)).to(dev)
    ys, cs, gates = lstm_scan_train_cuda(xs, w, lo, hi, cdt)
    ys_p, cs_p, gates_p = lstm_scan_train_plain(xs, w, lo, hi, cdt)
    torch.cuda.synchronize()
    err = max(float((ys - ys_p).abs().max()), float((cs - cs_p).abs().max()),
              float((gates.float() - gates_p.float()).abs().max()))
    print(f"[lstm-train-kernels] lstm_fwd_train xs {tuple(xs.shape)} -> ys, "
          f"cs, gates {tuple(gates.shape)}: max abs {err:.3e} "
          f"(tol {TOL['gru_bf16']})")
    check(bool(torch.isfinite(ys).all() and torch.isfinite(cs).all()
               and torch.isfinite(gates).all()), "lstm_fwd_train: non-finite")
    check(err <= TOL["gru_bf16"], "lstm_fwd_train disagrees")
    args = (gates_p, w, lo, hi, cs_p, g, cdt)
    dxs_p = lstm_bwd_plain(*args)
    gerr = 0.0
    # once on the plain forward's residuals (the kernel alone), once on the
    # forward kernel's own (the training path)
    for gt, c in ((gates_p, cs_p), (gates, cs)):
        dxs = lstm_bwd_cuda(gt, w, lo, hi, c, g, cdt)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(dxs.float()).all()), "lstm_bwd: non-finite")
        gerr = max(gerr, float((dxs.float() - dxs_p.float()).abs().max()))
    print(f"[lstm-train-kernels] lstm_bwd gates {tuple(gates.shape)} -> dxs "
          f"{tuple(dxs.shape)}: max abs {gerr:.3e} (tol "
          f"{TOL['gru_grad_bf16']}; on the plain and the kernel's residuals)")
    check(gerr <= TOL["gru_grad_bf16"], "lstm_bwd disagrees")
    # dW of the layer, on the kernels' own ys and dxs (the kernel line's
    # dw entry)
    dw = dw_check("lstm-train-kernels", dev, ys, (dxs,), B)

    live = 2 * int(flen.sum())
    esz = xs.element_size()
    w_bytes = w.numel() * esz
    print_rnn_plan("lstm", "lstm-train-kernels", H, B, 2, "fwd")
    print_rnn_plan("lstm", "lstm-train-kernels", H, B, 2, "bwd")
    lib = library_rnn_fns("lstm", dev, T, B, H, flen, cdt)
    # both kernels and cuDNN's training forward and forward+backward in
    # alternating rounds of graph replays (device time only)
    rounds = rnn_graph_rounds(
        "lstm-train-kernels",
        {"lstm_fwd_train": lambda: lstm_scan_train_cuda(xs, w, lo, hi, cdt),
         "lstm_bwd": lambda: lstm_bwd_cuda(*args)},
        {n: lib[n] for n in ("training forward", "forward+backward")})
    med = {n: statistics.median(r) for n, r in rounds.items()}
    out = {
        "lstm_fwd_train": dict(
            max_abs_err=err, ms=med["lstm_fwd_train"],
            plain_ms=time_ms(lambda: lstm_scan_train_plain(xs, w, lo, hi,
                                                           cdt),
                             warmup=1, reps=3),
            library_ms=med["cuDNN training forward"],
            **bound(live * 4 * H * esz + w_bytes
                    + nbytes(ys, cs, gates, lo, hi),
                    2 * live * H * 4 * H, "bf16")),
        "lstm_bwd": dict(
            max_abs_err=gerr, ms=med["lstm_bwd"],
            plain_ms=time_ms(lambda: lstm_bwd_plain(*args), warmup=1,
                             reps=3),
            library_ms=med["cuDNN backward"],
            # gates, cs (read once: c_{t-1} is the step before's c) and g
            **bound(live * (4 * H * esz + 2 * H * 4) + w_bytes
                    + nbytes(dxs, lo, hi), 2 * live * 4 * H * H, "bf16")),
        "dw": dw,
    }
    for name in ("lstm_fwd_train", "lstm_bwd"):
        t = out[name]
        print(f"[lstm-train-kernels] {name}: {t['ms']:.4f} ms (graph), plain "
              f"{t['plain_ms']:.4f} ms, cuDNN LSTM {t['library_ms']:.4f} ms "
              f"(graph), bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"share {t['bound_ms'] / t['ms']:.4f}")
    print(f"[lstm-train-kernels] T' = {T}, B = {B}, H = {H}")
    return out


def phase_uni_train_kernels(dev, rng) -> dict:
    """Phase 26: the one-direction training forms (ndir = 1: a forward-only
    layer's one W over its B rows) of the GRU at uni_gru's training shape
    and of the LSTM at bilstm_deep's width (B = 24, T' = 256, bf16): the
    training forward and the backward (on the plain forward's residuals
    and on the kernel's own) against their plain versions at the bars of
    phases 7 and 11 (the gradients' 5e-2 plus 2^-7 of their largest |value|:
    over 256 steps the bf16-rounded carries drift in proportion to the
    gradients' scale), dW on the kernels' own ys and gradients
    (``dw_check``), both plans printed, and the pair timed beside cuDNN's
    unidirectional training forward and backward in alternating rounds of
    graph replays → {"gru": {...}, "lstm": {...}} of the kernel line's
    ``ndir1`` timings (dw under "dw")."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    t_phase = time.perf_counter()
    cdt, B = torch.bfloat16, TRAIN_B
    out = {}
    for cell, preset in (("gru", UNI_PRESET), ("lstm", LSTM_PRESET)):
        tag = f"uni-train-kernels {cell}"
        cfg = preset_config(preset)
        H, G = cfg.model.rnn_hidden, 3 if cell == "gru" else 4
        fwd, fwd_p = (getattr(rc, f"{cell}_scan_train_cuda"),
                      getattr(rc, f"{cell}_scan_train_plain"))
        bwd, bwd_p = getattr(rc, f"{cell}_bwd_cuda"), getattr(
            rc, f"{cell}_bwd_plain")
        samples = rng.uniform(*TRAIN_SECONDS, B) * C.SAMPLE_RATE
        flen = torch.from_numpy((samples.astype(np.int64) // C.HOP_LENGTH)
                                + 1)
        T = TRAIN_FRAMES
        for st in cfg.model.conv_stride_time:
            flen = conv_out_length(flen, st)
            T = -(-T // st)
        lo = torch.zeros(B, 1, device=dev)
        hi = flen.to(torch.float32)[:, None].to(dev)
        w = torch.from_numpy((rng.standard_normal((1, H, G * H))
                              / np.sqrt(H)).astype(np.float32)).to(dev)
        xs = torch.from_numpy(rng.standard_normal(
            (T, B, G * H)).astype(np.float32)).to(dev).to(cdt)
        g = torch.from_numpy(rng.standard_normal(
            (T, B, H)).astype(np.float32)).to(dev)
        res = fwd(xs, w, lo, hi, cdt)
        res_p = fwd_p(xs, w, lo, hi, cdt)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all()) for t in res),
              f"{cell} ndir 1 training forward: non-finite")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(res, res_p))
        print(f"[{tag}] {cell}_fwd_train ndir 1 xs {tuple(xs.shape)} -> "
              f"{[tuple(t.shape) for t in res]}: max abs {err:.3e} (tol "
              f"{TOL['gru_bf16']})")
        check(err <= TOL["gru_bf16"], f"{cell} ndir 1 training forward "
              "disagrees")
        ys, ys_p = res[0], res_p[0]
        # the backward's arguments: the GRU reads h_prev from ys in place
        # (the plain version takes shift_prev), the LSTM reads cs
        if cell == "gru":
            args = (res_p[1], w, lo, hi, ys_p, g, cdt)
            plain_args = (res_p[1], w, lo, hi, rc.shift_prev(ys_p), g, cdt)
            own = (res[1], w, lo, hi, ys, g, cdt)
        else:
            args = plain_args = (res_p[2], w, lo, hi, res_p[1], g, cdt)
            own = (res[2], w, lo, hi, res[1], g, cdt)
        want = bwd_p(*plain_args)
        want = want if cell == "gru" else (want,)
        # the bf16 gradients: TOL's 5e-2 plus 2^-7 of the gradient's
        # largest |value|: each step rounds the carried gradient's operands
        # to bf16 on both sides, so over T' = 256 steps they drift apart in
        # proportion to the gradients' scale (|dxs| passes 16: ulp 0.125)
        gerr = gex = 0.0
        for a in (args, own):
            got = bwd(*a)
            got = got if cell == "gru" else (got,)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(t.float()).all()) for t in got),
                  f"{cell} ndir 1 backward: non-finite")
            gerr = max([gerr] + [float((x.float() - y.float()).abs().max())
                                 for x, y in zip(got, want)])
            gex = max([gex] + [excess(x, y, 2 ** -7, TOL["gru_grad_bf16"],
                                      scale=y.float().abs().max())
                               for x, y in zip(got, want)])
        print(f"[{tag}] {cell}_bwd ndir 1 -> {[tuple(t.shape) for t in got]}"
              f": max abs {gerr:.3e}, {gex:.3f} of the bar "
              f"{TOL['gru_grad_bf16']} + 2^-7·max|b| (on the plain and the "
              f"kernel's residuals); |dxs| max "
              f"{float(want[0].float().abs().max()):.3f}")
        check(gex <= 1, f"{cell} ndir 1 backward disagrees")
        dgates = (got[0][..., :2 * H], got[1]) if cell == "gru" else got
        dw = dw_check(tag, dev, ys, dgates, B)
        print_rnn_plan(cell, tag, H, B, 1, "fwd")
        print_rnn_plan(cell, tag, H, B, 1, "bwd")
        lib = library_rnn_fns(cell, dev, T, B, H, flen, cdt, ndir=1)
        rounds = rnn_graph_rounds(
            tag, {"fwd_train": lambda: fwd(xs, w, lo, hi, cdt),
                  "bwd": lambda: bwd(*args)},
            {n: lib[n] for n in ("training forward", "forward+backward")})
        med = {n: statistics.median(r) for n, r in rounds.items()}
        live = int(flen.sum())
        esz = xs.element_size()
        w_bytes = w.numel() * esz
        n_res = 4 * H * esz + (4 * H if cell == "lstm" else 0)
        # the forward reads xs and W and writes ys and the residuals; the
        # backward reads the residuals (gates; cs or h_prev) and g, writes
        # the gate gradients
        f_bytes = live * (G * H * esz + 4 * H + n_res) + w_bytes + nbytes(
            lo, hi)
        b_bytes = live * (n_res + (0 if cell == "lstm" else 4 * H) + 4 * H
                          + G * H * esz + (H * esz if cell == "gru" else 0)
                          ) + w_bytes + nbytes(lo, hi)
        out[cell] = {
            "fwd_train": dict(
                max_abs_err=err, ms=med["fwd_train"],
                plain_ms=time_ms(lambda: fwd_p(xs, w, lo, hi, cdt),
                                 warmup=1, reps=3),
                library_ms=med["cuDNN training forward"],
                **bound(f_bytes, 2 * live * H * G * H, "bf16")),
            "bwd": dict(
                max_abs_err=gerr, ms=med["bwd"],
                plain_ms=time_ms(lambda: bwd_p(*plain_args), warmup=1,
                                 reps=3),
                library_ms=med["cuDNN backward"],
                **bound(b_bytes, 2 * live * G * H * H, "bf16")),
            "dw": dw}
        for name in ("fwd_train", "bwd"):
            t = out[cell][name]
            print(f"[{tag}] {cell}_{name} ndir 1: {t['ms']:.4f} ms (graph), "
                  f"plain {t['plain_ms']:.4f} ms, cuDNN unidirectional "
                  f"{t['library_ms']:.4f} ms (graph), bound "
                  f"{t['bound_ms']:.5f} ms ({t['bound_by']}), share "
                  f"{t['bound_ms'] / t['ms']:.4f}")
        print(f"[{tag}] T' = {T}, B = {B}, H = {H}, ndir = 1")
    print(f"[uni-train-kernels] phase 26 took "
          f"{time.perf_counter() - t_phase:.3f} s")
    return out


def stream_shapes(preset: str, right: int) -> tuple[int, int, int, int]:
    """(T, emit_t, layers, ndir) of one stream window of ``preset`` at
    chunk STREAM_CHUNK, from ``stream_geometry``: T = (C + R)/s subsampled
    steps, of which the first emit_t = C/s carry over."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode.streaming import (
        stream_geometry)
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    mcfg = preset_config(preset).model
    g = stream_geometry(build_model(mcfg), STREAM_CHUNK, right)
    return ((g["C"] + g["R"]) // g["s"], g["C"] // g["s"], mcfg.rnn_layers,
            2 if mcfg.rnn_bidirectional else 1)


TIMED_STREAM = ("gru_fwd_stream", "lstm_fwd_stream")   # the two windows


def stream_cases() -> list:
    """Phase 15's cases, (tag, cell, ndir, B, T, emit_t, H): the streaming
    paths' two windows (``TIMED_STREAM``: uni_gru's forward-only GRU at
    chunk 64, right 0, T = 16; bilstm_deep's BiLSTM at chunk 64, right
    16, T = 20; B = 32), the bidirectional GRU at bigru's width over the
    second window's steps, and the R = 1 launch of one forward-only
    stream of each cell."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    uT, u_emit, _, _ = stream_shapes(UNI_PRESET, 0)
    bT, b_emit, _, _ = stream_shapes(LSTM_PRESET, 16)
    uH, gH, lH = (preset_config(p).model.rnn_hidden
                  for p in (UNI_PRESET, PRESET, LSTM_PRESET))
    return [("gru_fwd_stream", "gru", 1, CHECK_B, uT, u_emit, uH),
            ("gru_fwd_stream bidirectional", "gru", 2, CHECK_B, bT, b_emit,
             gH),
            ("lstm_fwd_stream", "lstm", 2, CHECK_B, bT, b_emit, lH),
            ("gru_fwd_stream R=1", "gru", 1, 1, uT, u_emit, uH),
            ("lstm_fwd_stream R=1", "lstm", 1, 1, bT, b_emit, lH)]


def stream_inputs(rng, dev, cell: str, ndir: int, B: int, T: int,
                  emit: int, H: int):
    """One window's inputs: lengths T but row 1 ending before emit_t
    (emit_t / 2) and row 2 empty (B > 2), the backward rows' live window
    at the right edge; W; xs fp32; h0 nonzero on the forward rows, zero on
    the backward ones (``models/rnn.py``). → (lens [B] CPU, lo, hi, w,
    xs, h0)."""
    import torch

    G, Cw = (3, H) if cell == "gru" else (4, 2 * H)
    R = ndir * B
    lens = torch.full((B,), float(T))
    if B > 2:
        lens[1], lens[2] = emit // 2, 0
    lo, hi = torch.zeros(B), lens
    if ndir == 2:
        lo, hi = torch.cat([lo, T - lens]), torch.cat(
            [hi, torch.full((B,), float(T))])
    lo, hi = lo[:, None].to(dev), hi[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((ndir, H, G * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, R, G * H)).astype(np.float32)).to(dev)
    h0 = torch.zeros(R, Cw, device=dev)
    h0[:B] = torch.from_numpy(
        0.5 * rng.standard_normal((B, Cw)).astype(np.float32)).to(dev)
    return lens, lo, hi, w, xs, h0


def stream_intercept(tag: str, kernel, cell: str, ndir: int, B: int, H: int,
                     emit: int, w, h0, rng) -> tuple[float, float]:
    """Device time of one bf16 stream launch over T in STREAM_SWEEP (every
    row live, emit_t = min(C/s, T)), the T values in alternating rounds of
    graph replays; → (a, b) of the least-squares line ms = a + b·T: a is
    the fixed cost of a launch (the launch, the W slice's copy into shared
    memory, the first cluster barrier), b the cost of a step."""
    import torch

    G = 3 if cell == "gru" else 4
    fns = {}
    for T in STREAM_SWEEP:
        xs = torch.from_numpy(rng.standard_normal(
            (T, ndir * B, G * H)).astype(np.float32)).to(h0.device).to(
                torch.bfloat16)
        lo = torch.zeros(ndir * B, 1, device=h0.device)
        hi = torch.full_like(lo, float(T))
        fns[T] = (lambda xs=xs, lo=lo, hi=hi, e=min(emit, T):
                  kernel(xs, w, lo, hi, h0, torch.bfloat16, e))
    rounds = alternating_ms({T: graph_of(fn, mode="relaxed")[0]
                             for T, fn in fns.items()})
    ms = [statistics.median(rounds[T]) for T in STREAM_SWEEP]
    b, a = np.polyfit(STREAM_SWEEP, ms, 1)
    print(f"[stream-kernels] {tag} bf16 over T (graph replays, medians of "
          f"{len(rounds[STREAM_SWEEP[0]])} alternating rounds): " + ", ".join(
              f"T={T} {m:.4f} ms" for T, m in zip(STREAM_SWEEP, ms))
          + f"; fixed cost (intercept) {a:.4f} ms, {1e3 * b:.3f} us a step")
    return float(a), float(b)


def phase_stream_kernels(dev, rng) -> dict:
    """The stream kernels vs their plain versions at the streaming paths'
    window shapes (``stream_cases``), each in fp32 and bf16 at emit_t 0,
    C/s and T, with ragged lengths and a nonzero h0 on the forward rows;
    in bf16 with h0 = 0 their ys bitwise equal to the residual-free
    form's; the two windows (bf16, emit_t = C/s) timed beside the bound
    and cuDNN over the same window with hx = h0 in alternating rounds of
    graph replays, with their plans and the fixed cost of a launch
    (``stream_intercept``). Also the forward-only inference form of
    gru_fwd at uni_gru's decode shape."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        gru_scan_cuda, gru_scan_plain, gru_scan_stream_cuda,
        gru_scan_stream_plain, lstm_scan_cuda, lstm_scan_stream_cuda,
        lstm_scan_stream_plain)

    fns = {"gru": (3, gru_scan_stream_cuda, gru_scan_stream_plain,
                   gru_scan_cuda),
           "lstm": (4, lstm_scan_stream_cuda, lstm_scan_stream_plain,
                    lstm_scan_cuda)}
    out = {}
    # the fixed-cost sweep draws from a stream of its own, so the later
    # cases' and the streaming phases' inputs stay what they were
    sweep_rng = np.random.default_rng(SEED + 4)
    for tag, cell, ndir, B, T, emit, H in stream_cases():
        G, kernel, plain, scan = fns[cell]
        lens, lo, hi, w, xs32, h0 = stream_inputs(rng, dev, cell, ndir, B, T,
                                                  emit, H)
        for dtag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            xs = xs32.to(torch.bfloat16) if dtag == "bf16" else xs32
            err = 0.0
            for emit_t in (0, emit, T):
                ys, carry = kernel(xs, w, lo, hi, h0, cdt, emit_t)
                ys_p, carry_p = plain(xs, w, lo, hi, h0, cdt, emit_t)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(ys).all()
                           and torch.isfinite(carry).all()),
                      f"{tag} {dtag}: non-finite")
                check(emit_t or torch.equal(carry, h0),
                      f"{tag}: emit_t = 0 does not carry h0")
                err = max(err, float((ys - ys_p).abs().max()),
                          float((carry - carry_p).abs().max()))
            tol = TOL[f"gru_{dtag}"]
            print(f"[stream-kernels] {tag} {dtag} xs {tuple(xs.shape)}, "
                  f"emit_t 0/{emit}/{T}: ys and carry max abs {err:.3e} "
                  f"(tol {tol})")
            check(err <= tol, f"{tag} {dtag} disagrees")
            if cdt != torch.bfloat16:
                continue
            zero = kernel(xs, w, lo, hi, torch.zeros_like(h0), cdt, emit)[0]
            check(same_bits(zero, scan(xs, w, lo, hi, cdt)),
                  f"{tag}: at h0 = 0 the stream form's ys differ from the "
                  f"residual-free form's")
            print(f"[stream-kernels] {tag} bf16 at h0 = 0: ys bitwise equal "
                  f"to the residual-free form's")
            if tag not in TIMED_STREAM:
                continue
            print_rnn_plan(cell, "stream-kernels", H, B, ndir, "fwd")
            call = lambda: kernel(xs, w, lo, hi, h0, cdt, emit)
            eager = time_ms(call, calls=STREAM_CALLS)
            one = time_ms(call)
            rounds = rnn_graph_rounds(
                f"stream-kernels {tag}", {tag: call},
                {"forward (hx = h0)": library_stream(
                    cell, dev, T, B, H, ndir, lens.long(), h0, cdt)})
            live = int((hi - lo).sum())       # live (row, step) pairs
            esz = xs.element_size()
            t = dict(
                max_abs_err=err, ms=statistics.median(rounds[tag]),
                plain_ms=time_ms(lambda: plain(xs, w, lo, hi, h0, cdt, emit),
                                 warmup=1, reps=3),
                library_ms=statistics.median(
                    rounds["cuDNN forward (hx = h0)"]),
                **bound(live * G * H * esz + w.numel() * esz
                        + nbytes(ys, carry, lo, hi, h0),
                        2 * live * H * G * H, "bf16"))
            out[tag] = t
            print(f"[stream-kernels] {tag} eager: {eager:.4f} ms a call over "
                  f"{STREAM_CALLS} back to back, {one:.4f} ms for one call "
                  f"(the wrapper's host time included)")
            print(f"[stream-kernels] {tag}: {t['ms']:.4f} ms (graph), plain "
                  f"{t['plain_ms']:.4f} ms, cuDNN {cell.upper()} (hx = h0, "
                  f"with input projection, graph) {t['library_ms']:.4f} ms, "
                  f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
            a, _ = stream_intercept(tag, kernel, cell, ndir, B, H, emit, w,
                                    h0, sweep_rng)
            print(f"[stream-kernels] {tag}: the fixed cost is "
                  f"{a / t['ms']:.3f} of the window's {t['ms']:.4f} ms")

    # gru_fwd's forward-only inference form at uni_gru's decode shape (one
    # chunk of 32 wavs of 10 s, the last one 8 s): T' = 251, ndir = 1
    mcfg = preset_config(UNI_PRESET).model
    H, B = mcfg.rnn_hidden, CHECK_B
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    flen = torch.full((B,), n // C.HOP_LENGTH + 1)
    flen[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE) // C.HOP_LENGTH + 1
    Tp = C.num_frames(n)
    for st in mcfg.conv_stride_time:
        flen = conv_out_length(flen, st)
        Tp = -(-Tp // st)
    lo = torch.zeros(B, 1, device=dev)
    hi = flen.to(torch.float32)[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((1, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal((Tp, B, 3 * H)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    got = gru_scan_cuda(xs, w, lo, hi, torch.bfloat16)
    want = gru_scan_plain(xs, w, lo, hi, torch.bfloat16)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), "gru_fwd ndir=1: non-finite")
    check(err <= TOL["gru_bf16"], "gru_fwd ndir=1 disagrees")
    live = int(flen.sum())
    print_rnn_plan("gru", "stream-kernels", H, B, 1, "fwd")
    # the kernel and cuDNN's forward-only GRU in alternating rounds of
    # graph replays, as phase 3
    lib = library_rnn_fns("gru", dev, Tp, B, H, flen, torch.bfloat16, ndir=1)
    rounds = rnn_graph_rounds(
        "stream-kernels",
        {"gru_fwd ndir=1": lambda: gru_scan_cuda(xs, w, lo, hi,
                                                 torch.bfloat16)},
        {"forward": lib["forward"]})
    t = dict(max_abs_err=err, ms=statistics.median(rounds["gru_fwd ndir=1"]),
             library_ms=statistics.median(rounds["cuDNN forward"]),
             **bound(live * 3 * H * 2 + w.numel() * 2 + nbytes(got, lo, hi),
                     2 * live * H * 3 * H, "bf16"))
    print(f"[stream-kernels] gru_fwd ndir=1 bf16 xs {tuple(xs.shape)}: max "
          f"abs {err:.3e} (tol {TOL['gru_bf16']}), {t['ms']:.4f} ms (graph),"
          f" cuDNN GRU (forward-only, with input projection) "
          f"{t['library_ms']:.4f} ms (graph), bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']})")
    return out


def write_checkpoint(root: str, preset: str, rng,
                     overrides: dict | None = None,
                     name: str | None = None) -> str:
    """A params-only checkpoint of ``preset`` (with dotted config
    ``overrides``) with random weights from ``rng``, written by the port's
    own writer into ``ckpt_{name}``; → its directory."""
    from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
    from chainer_speech_recognition_tpu_torch.checkpoint import save_params
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    cfg = preset_config(preset)
    if overrides:
        cfg = cfg.override(overrides)
    model = build_model(cfg.model)
    ckpt = os.path.join(root, f"ckpt_{name}" if name else
                        f"ckpt_{preset}{'_stream' if overrides else ''}")
    path = save_params(ckpt, state_dict_to_flax(
        random_state_dict(model, rng)), cfg)
    print(f"[inputs] {preset} checkpoint {os.path.basename(path)} "
          f"({sum(p.numel() for p in model.parameters())} params)")
    return ckpt


def phase_inputs(root: str, rng) -> tuple[str, str, list[str], float]:
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.utils.wav import write_wav
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    ckpt = write_checkpoint(root, PRESET, rng)
    V = preset_config(PRESET).model.vocab_size
    vocab = os.path.join(root, "vocab.txt")
    Vocab(["<blank>"] + [chr(0x3042 + i) for i in range(V - 1)]).save(vocab)
    wavs, total = [], 0.0
    for i in range(N_WAVS):
        sig = synth_signal(rng, rng.uniform(*WAV_SECONDS), V)
        wavs.append(os.path.join(root, f"utt{i:03d}.wav"))
        write_wav(wavs[-1], sig)
        total += len(sig) / C.SAMPLE_RATE
    print(f"[inputs] {V - 1}-symbol vocab, {N_WAVS} wavs, {total:.3f} s of "
          f"audio")
    return ckpt, vocab, wavs, total


def run_cli(main, args: list[str]) -> tuple[list[str], str, float]:
    """→ (stdout lines, stderr, wall seconds) of one in-process CLI run,
    ending after the card is idle."""
    import torch

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        main(args)
    torch.cuda.synchronize()
    return out.getvalue().splitlines(), err.getvalue(), \
        time.perf_counter() - t0


def run_decode(args: list[str]) -> tuple[list[str], float]:
    from chainer_speech_recognition_tpu_torch.cli import decode

    lines, _, wall = run_cli(decode.main, args)
    return lines, wall


def phase_decode(tag: str, ckpt, vocab, wavs, audio_s, want: dict,
                 sets: tuple = ()) -> tuple[dict, list[str]]:
    """The decode CLI (--batch 32, ``--set`` ``sets``) on ``wavs`` with
    exactly ``want`` launches (every other kernel 0) and the MHSA routing
    log to match, a warm rerun's utt/s and RTF, and the checkpoint load's
    time; → (the cold run's launches, its lines)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.ops.attention_cuda import ROUTED

    args = [*(["--set", *sets] if sets else []), "--ckpt-dir", ckpt,
            "--vocab", vocab, "--batch", str(BATCH), "--device", "cuda",
            *wavs]
    _kernels.reset_launches()
    routed = dict(ROUTED)
    lines, cold = run_decode(args)
    launches = _kernels.launches()
    calls = {k: ROUTED[k] - routed[k] for k in ROUTED}
    print(f"[{tag}] cold run {cold:.3f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }, MHSA calls {calls}")
    check(len(lines) == len(wavs), f"decode printed {len(lines)} lines")
    check([l.split("\t")[0] for l in lines] == wavs,
          "decode output is not in input order")
    check(all(len(l.split("\t")) == 2 for l in lines), "malformed lines")
    full = {name: 0 for name in _kernels.KERNELS}
    full.update(want)
    for name, n in full.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the {tag} path, expected {n}")
    check(calls["flash"] == want.get("flash_fwd", 0),
          f"routing log {calls} disagrees with the flash launches")
    for l in lines[:2]:
        print(f"[{tag}] {os.path.basename(l.split(chr(9))[0])}: "
              f"{l.split(chr(9))[1][:40]!r}")
    lines2, warm = run_decode(args)
    check(lines2 == lines, "warm decode differs from the cold one")
    print(f"[{tag}] warm run {warm:.3f} s: {len(wavs) / warm:.3f} utt/s, "
          f"RTF {warm / audio_s:.6f} ({audio_s:.3f} s of audio)")
    t0 = time.perf_counter()
    load_model(ckpt, device=torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"[{tag}] of which the checkpoint load (cli.decode.load_model) "
          f"takes {time.perf_counter() - t0:.3f} s")
    return launches, lines


def phase_parity(ckpt, wavs, dev, tag: str) -> None:
    """Logits and output lengths of 4 wavs card vs CPU, the model built as
    ``cli.decode.load_model`` builds it. An RNN checkpoint is held at its
    compute dtype to 3e-2. An attention or GLU checkpoint, whose bf16 noise
    over its residual blocks (eight of LayerNorms, softmaxes and sums; six
    gated convolutions) is as large as that bar, runs at fp32 and at bf16
    compute on both: fp32 card vs CPU to
    1e-4 (the port's fp32 bar against flax); bf16 card vs CPU to the larger
    of 3e-2 and the CPU's own bf16 gap to its fp32 logits; and the card's
    bf16 logits no farther from the CPU's fp32 ones than
    ``attn_bf16_ratio`` times the CPU's bf16 logits are."""
    import torch

    from chainer_speech_recognition_tpu_torch.bridge import load_flax_params
    from chainer_speech_recognition_tpu_torch.checkpoint import (
        load_config, load_params)
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav

    cfg = load_config(ckpt)
    params, _ = load_params(ckpt, 1)
    attention = cfg.model.attn_blocks > 0 or cfg.model.glu_blocks > 0
    dtypes = ("float32", "bfloat16") if attention else (
        cfg.model.compute_dtype,)
    sigs = [read_wav(w) for w in wavs[:PARITY_WAVS]]
    x = np.zeros((len(sigs), max(len(s) for s in sigs)), np.float32)
    for i, s in enumerate(sigs):
        x[i, : len(s)] = s
    lens = np.asarray([len(s) for s in sigs], np.int32)
    logits, olens = {}, {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        for dt in dtypes:
            model = build_model(
                cfg.override({"model.compute_dtype": dt}).model)
            load_flax_params(model, params)
            model = model.to(d).eval()
            with torch.inference_mode():
                feats, fl = select_frontend(cfg.features)(
                    torch.from_numpy(x).to(d), torch.from_numpy(lens).to(d),
                    apply_cmvn=cfg.features.cmvn_arg)
                lg, ol = model(feats, fl)
            logits[where, dt], olens[where, dt] = lg.float().cpu(), ol.cpu()
            check(bool(torch.isfinite(logits[where, dt]).all()),
                  f"{tag}: non-finite {where} {dt} logits")
    for dt in dtypes:
        check(logits["card", dt].shape == logits["cpu", dt].shape
              and torch.equal(olens["card", dt], olens["cpu", dt]),
              f"{tag}: {dt} shapes or output lengths differ")
    gap = lambda a, b: float((logits[a] - logits[b]).abs().max())
    direct = gap(("card", dtypes[-1]), ("cpu", dtypes[-1]))
    head = (f"[{tag}] logits {tuple(logits['cpu', dtypes[-1]].shape)}, "
            f"|logits| max {float(logits['cpu', dtypes[-1]].abs().max()):.3f}")
    if not attention:
        print(f"{head}: card vs CPU max abs {direct:.3e} (tol "
              f"{TOL['gru_bf16']})")
        check(direct <= TOL["gru_bf16"], "card and CPU logits disagree")
        return
    fp32 = gap(("card", "float32"), ("cpu", "float32"))
    card = gap(("card", "bfloat16"), ("cpu", "float32"))
    cpu = gap(("cpu", "bfloat16"), ("cpu", "float32"))
    bar = max(TOL["gru_bf16"], cpu)
    print(f"{head}: fp32 card vs CPU max abs {fp32:.3e} (tol "
          f"{TOL['attn_fp32']}); bf16 card vs CPU {direct:.3e} (tol {bar:.3e},"
          f" the larger of {TOL['gru_bf16']} and the CPU's bf16 gap); bf16 vs"
          f" the CPU's fp32: card {card:.3e}, CPU {cpu:.3e} (ratio "
          f"{card / max(cpu, 1e-12):.3f}, tol {TOL['attn_bf16_ratio']})")
    check(fp32 <= TOL["attn_fp32"], f"{tag}: fp32 card and CPU logits "
          "disagree")
    check(direct <= bar, f"{tag}: bf16 card and CPU logits disagree")
    check(card <= TOL["attn_bf16_ratio"] * cpu, f"{tag}: the card's bf16 "
          "logits are farther from fp32 than bf16 rounding explains")


def stream_window_logits(model, cfg, sigs, right: int) -> list:
    """Stream ``sigs`` in one lockstep batch through ``StreamingRecognizer``
    (buffered, flushed with their true lengths) and chain each stream's
    emit-region logits over the windows: → one [T', V] fp32 CPU tensor a
    stream, read where the recognizer hands them to its greedy collapse."""
    import torch

    from chainer_speech_recognition_tpu_torch.decode import streaming

    taken = []
    collapse = streaming._emit_greedy

    def spy(logits, lens, prev_id, C_s):
        taken.append((logits[:, :C_s].float().cpu(),
                      torch.clamp(lens, 0, C_s).cpu()))
        return collapse(logits, lens, prev_id, C_s)

    ns = np.asarray([len(x) for x in sigs], np.int64)
    pcm = np.zeros((len(sigs), int(ns.max())), np.float32)
    for i, x in enumerate(sigs):
        pcm[i, : len(x)] = x
    streaming._emit_greedy = spy
    try:
        rec = streaming.StreamingRecognizer(
            model, cfg, batch=len(sigs), chunk_frames=STREAM_CHUNK,
            right_frames=right)
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
    finally:
        streaming._emit_greedy = collapse
    return [torch.cat([lg[b, : int(n[b])] for lg, n in taken])
            for b in range(len(sigs))]


def phase_stream(root, vocab, wavs, audio_s, preset: str, dev, rng,
                 overrides: dict | None = None,
                 tag: str | None = None) -> dict:
    """``preset`` served online through the port's stream CLI on the card:
    a random-weight checkpoint with causal CMVN, the 64 wavs in lockstep
    batches of 32 at chunk 64 (``STREAM_ARGS`` sets the lookahead), exact
    launch counts from ``stream_geometry`` and the wav lengths, a warm
    rerun's utt/s, RTF and window latency. uni_gru (zero lookahead) also
    decodes offline through the decode CLI (the forward-only gru_fwd),
    compares its chained window logits with the offline ones on 4 wavs (the
    same function), prints how many transcripts agree and their CER, and
    streams one wav as int16 PCM through --raw (batch 1: R = 1).
    bilstm_deep compares its chained window logits card vs CPU on 4 wavs.
    ``overrides`` (dotted config keys) widen the checkpoint (phase 33);
    ``tag`` then names its logs and checkpoint. → the cold stream run's
    launches."""
    import wave

    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.cli import stream
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.decode.metrics import (
        CERAccumulator)
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav

    uni = preset == UNI_PRESET
    tag = tag or ("uni-stream" if uni else "lstm-stream")
    right = 0 if uni else 16
    ckpt = write_checkpoint(root, preset, rng,
                            {"features.cmvn_mode": "causal",
                             "features.cmvn": True, **(overrides or {})},
                            name=tag if overrides else None)
    cell = "gru" if uni else "lstm"
    T, emit, layers, ndir = stream_shapes(preset, right)
    # exact launches: windows of a lockstep batch = ceil(longest stream's
    # frames / C); one front-end launch and one stream launch a layer each
    lens = []
    for w in wavs:
        with wave.open(w, "rb") as f:
            lens.append(f.getnframes())
    order = sorted(lens)
    windows = sum(-(-C.num_frames(max(order[i : i + BATCH])) // STREAM_CHUNK)
                  for i in range(0, len(order), BATCH))
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"frontend_logmel": windows,
                 f"{cell}_fwd_stream": layers * windows})
    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cuda",
            "--batch", str(BATCH), "--chunk-frames", str(STREAM_CHUNK),
            "--timing", *STREAM_ARGS[preset], *wavs]
    _kernels.reset_launches()
    lines, err, cold = run_cli(stream.main, args)
    launches = _kernels.launches()
    print(f"[{tag}] cold run {cold:.3f} s, {windows} windows (T = {T} steps "
          f"a window, carry at {emit}, ndir {ndir}), launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(len(lines) == len(wavs), f"stream printed {len(lines)} lines")
    check([l.split("\t")[0] for l in lines] == wavs,
          "stream output is not in input order")
    check(all(len(l.split("\t")) == 2 for l in lines), "malformed lines")
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the {preset} stream path, expected {n}")
    for name, need in MIN_LAUNCHES[f"{preset} stream"].items():
        check(launches[name] >= need, f"{name}: below {need} launches")
    lines2, err2, warm = run_cli(stream.main, args)
    check(lines2 == lines, "warm stream run differs from the cold one")
    timing = [l for l in err2.splitlines() if "window latency" in l]
    check(len(timing) == 1, f"no --timing line in {err2!r}")
    print(f"[{tag}] warm run {warm:.3f} s: {len(wavs) / warm:.3f} utt/s, RTF "
          f"{warm / audio_s:.6f}; {timing[0]}")
    for l in lines[:2]:
        print(f"[{tag}] {os.path.basename(l.split(chr(9))[0])}: "
              f"{l.split(chr(9))[1][:40]!r}")

    sigs = [read_wav(w) for w in wavs[:PARITY_WAVS]]
    cfg, model, _ = load_model(ckpt, device=dev)
    got = stream_window_logits(model, cfg, sigs, right)
    if uni:
        # offline decode of the same checkpoint: the ndir = 1 gru_fwd
        _, off_lines = phase_decode(
            f"{tag}-decode" if overrides else "uni-decode", ckpt, vocab,
            wavs, audio_s, DECODE_LAUNCHES[UNI_PRESET])
        cer = CERAccumulator()
        cer.add_batch([l.split("\t")[1] for l in lines],
                      [l.split("\t")[1] for l in off_lines])
        same = sum(a == b for a, b in zip(lines, off_lines))
        print(f"[{tag}] stream vs offline CLI: {same}/{len(lines)} "
              f"transcripts equal, CER {cer.cer:.6f} (not gated: bf16 "
              f"near-ties under random weights may flip an argmax)")
        n = np.asarray([len(x) for x in sigs], np.int32)
        x = np.zeros((len(sigs), int(n.max())), np.float32)
        for i, sg in enumerate(sigs):
            x[i, : len(sg)] = sg
        with torch.inference_mode():
            feats, fl = select_frontend(cfg.features)(
                torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev),
                apply_cmvn=cfg.features.cmvn_arg)
            logits, ol = model(feats, fl)
        want_l = [logits[b, : int(ol[b])].float().cpu()
                  for b in range(len(sigs))]
        what = "offline"
    else:
        ccfg, cmodel, _ = load_model(ckpt, device=torch.device("cpu"))
        want_l = stream_window_logits(cmodel, ccfg, sigs, right)
        what = "CPU"
    check([g.shape for g in got] == [w.shape for w in want_l],
          f"chained window logits {[tuple(g.shape) for g in got]} vs "
          f"{what} {[tuple(w.shape) for w in want_l]}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "non-finite stream logits")
    lerr = max(float((g - w).abs().max()) for g, w in zip(got, want_l))
    print(f"[{tag}] chained window logits of {len(sigs)} wavs "
          f"{[tuple(g.shape) for g in got]} card vs {what}: max abs "
          f"{lerr:.3e} (tol {TOL['gru_bf16']}), |logits| max "
          f"{max(float(w.abs().max()) for w in want_l):.3f}")
    check(lerr <= TOL["gru_bf16"], f"{preset} stream logits disagree with "
          f"the {what} ones")

    if uni:
        # live mode: one wav as int16 PCM on stdin, eager draining, batch 1
        pcm = (np.clip(sigs[0], -1, 1) * 32767).astype("<i2")
        nw = -(-C.num_frames(len(pcm)) // STREAM_CHUNK)
        stdin = sys.stdin
        sys.stdin = io.TextIOWrapper(io.BytesIO(pcm.tobytes()))
        _kernels.reset_launches()
        try:
            raw, _, wall = run_cli(stream.main, [
                "--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cuda",
                "--chunk-frames", str(STREAM_CHUNK), "--raw",
                *STREAM_ARGS[preset]])
        finally:
            sys.stdin = stdin
        rl = _kernels.launches()
        print(f"[{tag}] --raw: {len(pcm)} samples in {wall:.3f} s, {nw} "
              f"windows at batch 1 (R = 1), launches "
              f"{ {k: v for k, v in rl.items() if v} }, transcript "
              f"{raw[-1][:40]!r} (wav mode: {lines[0].split(chr(9))[1][:40]!r})")
        check(rl["frontend_logmel"] == nw and rl["gru_fwd_stream"]
              == layers * nw, "--raw launch counts")
    return launches


def _events(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f]


def _busy_share(trace_path: str) -> tuple[float, float, list]:
    """(device busy share, window ms, every kernel's device time, largest
    first) of a torch.profiler chrome trace: the union of device
    kernel/copy intervals over the span of all events."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    check(bool(events), f"{trace_path}: empty trace")
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    check(bool(dev), "the profiled window shows no device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -1e30
    for a, b, _ in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return busy / (t1 - t0), (t1 - t0) / 1e3, ranked


def write_corpus(root: str, rng) -> str:
    """The synthetic training corpus of phases 8 and 13; → its directory."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        write_tone_corpus)

    data = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    write_tone_corpus(data, rng, {"train": TRAIN_UTTS, "dev": DEV_UTTS},
                      preset_config(PRESET).model.vocab_size, TRAIN_SECONDS)
    print(f"[train] corpus of {TRAIN_UTTS} + {DEV_UTTS} utterances of "
          f"{TRAIN_SECONDS[0]}-{TRAIN_SECONDS[1]} s written in "
          f"{time.perf_counter() - t0:.1f} s")
    return data


def phase_train(root: str, data: str, preset: str,
                resume_to: int | None = None,
                extra_sets: tuple = ()) -> tuple[dict, str]:
    """Train the full-width preset through the CLI on the card (``--set``
    also takes ``extra_sets``): exact launches, finite metrics, checkpoint
    decode and (``resume_to``) a resumed run; → (the training run's
    launches, the train index path)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.checkpoint import (
        list_checkpoints)
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli
    from chainer_speech_recognition_tpu_torch.config import preset_config

    tag = {PRESET: "train", LSTM_PRESET: "lstm-train",
           CONF_PRESET: "conformer-train"}[preset]
    cfg = preset_config(preset)
    ckpt = os.path.join(root, f"train_ckpt_{preset}")
    metrics = os.path.join(root, f"train_{preset}.jsonl")
    prof = os.path.join(root, f"prof_{preset}")
    sets = ["train.data_mode=stream", "train.log_every=1",
            f"train.eval_every={EVERY}", f"train.checkpoint_every={EVERY}",
            "optim.warmup_steps=4", *extra_sets]
    cfg = cfg.override(dict(kv.split("=", 1) for kv in extra_sets))
    args = ["--data-dir", data, "--preset", preset, "--device", "cuda",
            "--ckpt-dir", ckpt, "--metrics", metrics]

    _kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(args + ["--profile-dir", prof, "--set", *sets,
                               f"train.total_steps={TRAIN_STEPS}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    ev = _events(metrics)
    train = [e for e in ev if e["kind"] == "train"]
    evals = [e for e in ev if e["kind"] == "eval"]
    print(f"[{tag}] {preset} (SpecAugment "
          f"{'on' if cfg.specaugment.enabled else 'off'}): {TRAIN_STEPS} "
          f"steps in {wall:.3f} s (kernel build, corpus reads and 2 evals "
          f"included), launches {launches}")
    for e in train[:: max(len(train) // 4, 1)] + evals:
        print(f"[{tag}] {json.dumps(e)}")
    check([e["step"] for e in train] == list(range(1, TRAIN_STEPS + 1)),
          "train steps missing from the metrics")
    check(all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
              and e["grad_norm"] > 0 for e in train),
          "non-finite loss or zero grad norm")
    check([e["step"] for e in evals] == [EVERY, 2 * EVERY], "dev evals")
    check(all(e["num_utts"] == DEV_UTTS and np.isfinite(e["loss"])
              for e in evals), "dev eval results")
    n_eval = len(evals) * (-(-DEV_UTTS // TRAIN_B))   # eval batches run
    layers = cfg.model.rnn_layers
    cell = cfg.model.rnn_type
    want = {name: 0 for name in _kernels.KERNELS}
    if cell != "none":
        want.update({f"{cell}_fwd_train": layers * TRAIN_STEPS,
                     f"{cell}_bwd": layers * TRAIN_STEPS,
                     f"{cell}_fwd": layers * n_eval})
        if cfg.model.compute_dtype == "bfloat16":   # one dW launch a layer
            want["dw"] = layers * TRAIN_STEPS
    if cfg.model.attn_impl == "flash":      # every block, eval included
        blocks = cfg.model.attn_blocks
        want.update({"flash_fwd": blocks * (TRAIN_STEPS + n_eval),
                     "flash_bwd_dq": blocks * TRAIN_STEPS,
                     "flash_bwd_dkv": blocks * TRAIN_STEPS})
    want.update({"ctc_bwd": TRAIN_STEPS,
                 "ctc_fwd": TRAIN_STEPS + n_eval,
                 "frontend_logmel": TRAIN_STEPS + n_eval,
                 "greedy": n_eval})
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the {preset} training path, expected {n}")
    check(list_checkpoints(ckpt)[-1] == f"step_{TRAIN_STEPS:08d}.msgpack",
          "no final checkpoint")

    # warm step time: host clock between consecutive (synced) step logs,
    # over steps with no eval, checkpoint or profiler in between
    t = {e["step"]: e["t"] for e in train}
    clean = [t[k] - t[k - 1] for k in range(3, EVERY + 1)]
    step_s = statistics.median(clean)
    # the profiler's cost: steps wholly inside its window (logged 12-14;
    # it opens before logged step 11 and closes after 15)
    prof_s = statistics.median(t[k] - t[k - 1] for k in range(12, 15))
    busy, window_ms, top = _busy_share(os.path.join(prof, "trace.json"))
    print(f"[{tag}] warm step {step_s * 1e3:.3f} ms (median of steps 3-"
          f"{EVERY}), {TRAIN_B / step_s:.3f} utt/s; device busy "
          f"{busy:.4f} of the {window_ms:.3f} ms profiled window (steps "
          f"10-14 counted from 0), whose steps take {prof_s * 1e3:.3f} ms "
          f"(profiler overhead {prof_s / step_s - 1:+.1%}); peak memory "
          f"{peak:.3f} GiB")
    for name, us in top[:8]:
        print(f"[{tag}] device time {us / 1e3:9.3f} ms  {name[:90]}")
    if want.get("dw"):
        dw_us = sum(us for name, us in top if "dw_kernel" in name)
        print(f"[{tag}] device time {dw_us / 1e3:9.3f} ms  the dW kernel "
              f"(csrc/dw.cu) in the same window")

    # the last checkpoint decodes through the decode CLI
    dev_wavs = [json.loads(l)["wav"] for l in open(
        os.path.join(data, "dev_index.jsonl"))][:4]
    lines, _ = run_decode(["--ckpt-dir", ckpt, "--vocab",
                           os.path.join(data, "vocab.txt"), "--device",
                           "cuda", *dev_wavs])
    check([l.split("\t")[0] for l in lines] == dev_wavs,
          "decode of the trained checkpoint")
    print(f"[{tag}] trained checkpoint decodes: "
          f"{lines[0].split(chr(9))[1][:40]!r}")

    if resume_to is not None:
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(args + ["--set", *sets,
                                   f"train.total_steps={resume_to}"])
        ev = _events(metrics)[len(ev):]
        resume = [e for e in ev if e["kind"] == "resume"]
        steps = [e["step"] for e in ev if e["kind"] == "train"]
        check(len(resume) == 1 and resume[0]["step"] == TRAIN_STEPS,
              f"resume event {resume}")
        check(steps == list(range(TRAIN_STEPS + 1, resume_to + 1)),
              f"resumed steps {steps}")
        check(list_checkpoints(ckpt)[-1] == f"step_{resume_to:08d}.msgpack",
              "no checkpoint at the resumed run's end")
        print(f"[{tag}] resumed at step {resume[0]['step']}, stopped at "
              f"{steps[-1]}")
    return launches, os.path.join(data, "train_index.jsonl"), (step_s, busy)


def phase_train_parity(dev, index: str, preset: str,
                       overrides: dict | None = None,
                       tag: str | None = None) -> None:
    """One step's loss and gradients, card (kernels) vs CPU (plain
    versions), from the same weights, batch of 2 utterances and, where the
    preset enables it, SpecAugment draws; ``overrides`` are dotted config
    overrides of the preset, ``tag`` the log's (by the preset)."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import load_index
    from chainer_speech_recognition_tpu_torch.data.sampler import BatchLoader
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model, init_parameters)
    from chainer_speech_recognition_tpu_torch.ops.specaugment import (
        specaugment_draws, step_generator)
    from chainer_speech_recognition_tpu_torch.train.step import forward_loss
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    tag = tag or {PRESET: "train-parity", LSTM_PRESET: "lstm-train-parity",
                  CONF_PRESET: "conformer-train-parity",
                  UNI_PRESET: "uni-train-parity",
                  GLU_PRESET: "glu-train-parity"}[preset]
    cfg = preset_config(preset).override(overrides or {})
    utts = load_index(index)
    vocab = Vocab.load(os.path.join(os.path.dirname(index), "vocab.txt"))
    batch = BatchLoader(utts, vocab, cfg.buckets).load(3, np.arange(2))
    draws = None
    if cfg.specaugment.enabled:
        draws = specaugment_draws(step_generator(
            np.asarray([0, SEED], np.uint32), 0), 2, cfg.specaugment)
    runs = [(cfg, TOL["train_loss_rtol"])]
    if cfg.model.attn_blocks:
        # bf16 noise of eight blocks is as large as the loss bar (rel
        # 1.3e-4 on an H100, 1.5e-7 at fp32): the algorithm is held at fp32
        # compute to the bars, the working type bf16 to 3x that noise
        runs = [(cfg.override({"model.compute_dtype": "float32"}),
                 TOL["train_loss_rtol"]), (cfg, TOL["attn_loss_bf16_rtol"])]
    for rcfg, loss_rtol in runs:
        res = []
        for d in (dev, torch.device("cpu")):
            model = build_model(rcfg.model)
            init_parameters(model, SEED)
            model.to(d)
            b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()
                 if k != "bucket_id"}
            loss, _, _, _ = forward_loss(
                model, rcfg, b, None if draws is None else draws.to(d))
            loss.backward()
            res.append((float(loss.detach()), {
                k: p.grad.float().cpu() for k, p in model.named_parameters()}))
        (lc, gc), (lp, gp) = res
        rel = abs(lc - lp) / abs(lp)
        worst = max((float((gc[k] - gp[k]).abs().max())
                     / max(float(gp[k].abs().max()), 1e-12), k) for k in gp)
        print(f"[{tag}] {preset} {rcfg.model.compute_dtype} (SpecAugment "
              f"{'on' if draws is not None else 'off'}): loss card {lc:.5f} "
              f"CPU {lp:.5f} (rel {rel:.3e}, tol {loss_rtol}); worst "
              f"gradient max abs diff / max abs {worst[0]:.3e} ({worst[1]}, "
              f"tol {TOL['gru_grad_bf16']})")
        check(np.isfinite(lc) and rel <= loss_rtol,
              f"{preset} train loss parity")
        check(worst[0] <= TOL["gru_grad_bf16"],
              f"{preset} train gradient parity")


def subsampled(num_samples, frames: int, strides) -> tuple:
    """(subsampled lengths [B] int64 CPU tensor, T') of utterances of
    ``num_samples`` samples padded to ``frames`` feature frames."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)

    flen = torch.from_numpy(np.asarray(num_samples, np.int64)
                            // C.HOP_LENGTH + 1)
    T = frames
    for s in strides:
        flen = conv_out_length(flen, s)
        T = -(-T // s)
    return flen, T


def graph_of(fn, calls: int = GRAPH_CALLS, mode: str = "global"):
    """``calls`` back-to-back calls of ``fn`` captured in one CUDA graph
    (warmed up on a side stream first, as capture asks; ``mode`` is the
    capture's error mode) → (the graph's replay, the last captured call's
    result, which each replay rewrites)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode=mode):
        for _ in range(calls):
            res = fn()
    return graph.replay, res


def alternating_ms(replays: dict, rounds: int = 9,
                   calls: int = GRAPH_CALLS) -> dict:
    """Device time (ms) of one call of each ``graph_of`` graph's function,
    the graphs replayed in turn ``rounds`` times (CUDA events, warm): no
    host time enters, and drift between rounds moves all of them alike.
    → {name: [ms a round]}."""
    out = {n: [] for n in replays}
    for _ in range(rounds):
        for n, replay in replays.items():
            out[n].append(time_ms(replay, warmup=0, reps=1) / calls)
    return out


def flash_bound(B, T, h, dh, pairs, n_read, n_write, n_rows, ops_per_pair):
    """The least time of one flash kernel (bf16): ``n_read`` + ``n_write``
    [B, T, h, dh] bf16 tensors, ``n_rows`` [B, h, T] fp32 rows (lse, D)
    and the lengths, against ``ops_per_pair``·dh operations for each
    allowed (query, key) pair of every head (the data's own count)."""
    n = B * T * h * dh * 2
    return bound((n_read + n_write) * n + n_rows * B * h * T * 4 + B * 4,
                 ops_per_pair * pairs * dh, "bf16")


def lstm_cases(rng) -> list:
    """The bf16 LSTM kernels' shapes in phases 10-11, (tag, B, T', lengths
    [B] int64 CPU, training): a decode chunk of 32 wavs of 10 s (the last
    8 s), T' = 251, for the residual-free form (row 6); 24 training
    utterances of 9-10 s in the 1024-frame bucket, T' = 256, for the
    training form (row 6) and the backward (row 7)."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config

    strides = preset_config(LSTM_PRESET).model.conv_stride_time
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    dec = np.full(CHECK_B, n, np.int64)
    dec[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE)
    dec_len, T_dec = subsampled(dec, C.num_frames(n), strides)
    tr_len, T_tr = subsampled(
        rng.uniform(*TRAIN_SECONDS, TRAIN_B) * C.SAMPLE_RATE, TRAIN_FRAMES,
        strides)
    return [("row 6 decode", CHECK_B, T_dec, dec_len, False),
            ("rows 6-7 train", TRAIN_B, T_tr, tr_len, True)]


def gru_cases(rng) -> list:
    """The bf16 GRU kernels' shapes in phases 3, 7 and 15, (tag, B, T',
    lengths [B] int64 CPU, training, ndir): a decode chunk of 32 wavs of
    10 s (the last 8 s), T' = 251, for the residual-free form (row 3) of
    bigru (ndir 2) and of uni_gru (ndir 1); 24 training utterances of
    9-10 s in the 1024-frame bucket, T' = 256, for the training form (row
    4) and the backward (row 5)."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config

    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    dec = np.full(CHECK_B, n, np.int64)
    dec[-1] = int(WAV_SECONDS[0] * C.SAMPLE_RATE)
    out = []
    for preset, ndir in ((PRESET, 2), (UNI_PRESET, 1)):
        strides = preset_config(preset).model.conv_stride_time
        dec_len, T_dec = subsampled(dec, C.num_frames(n), strides)
        out.append((f"row 3 decode ndir={ndir}", CHECK_B, T_dec, dec_len,
                    False, ndir))
    tr_len, T_tr = subsampled(
        rng.uniform(*TRAIN_SECONDS, TRAIN_B) * C.SAMPLE_RATE, TRAIN_FRAMES,
        preset_config(PRESET).model.conv_stride_time)
    return out + [("rows 4-5 train", TRAIN_B, T_tr, tr_len, True, 2)]


CTC_RATE = 10           # labels a second of the CTC checks' utterances
LONG_LABELS = 300       # label width of the long-form CTC case: S = 601


def ctc_cases(rng) -> list:
    """The CTC kernels' shapes in ``tools/kernel_ab.py``, (tag, seconds
    [B], T', lengths [B] int64 CPU, label width L): phase 7's 24 training
    utterances of 9-10 s in the 1024-frame bucket (T' = 256, S = 2·128 +
    1), and 24 long-form ones of 22-28 s (the last 28 s: T' = 701, S =
    2·300 + 1), bigru's subsampling."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config

    cfg = preset_config(PRESET)
    strides = cfg.model.conv_stride_time
    tr = rng.uniform(*TRAIN_SECONDS, TRAIN_B)
    tr_len, T_tr = subsampled(tr * C.SAMPLE_RATE, TRAIN_FRAMES, strides)
    lo = rng.uniform(*LONG_SECONDS, TRAIN_B)
    lo[-1] = LONG_SECONDS[1]
    n = int(LONG_SECONDS[1] * C.SAMPLE_RATE)
    lo_len, T_lo = subsampled(lo * C.SAMPLE_RATE, C.num_frames(n), strides)
    return [("rows 9-10 train", tr, T_tr, tr_len,
             cfg.buckets.max_label_len),
            ("rows 9-10 long-form", lo, T_lo, lo_len, LONG_LABELS)]


def ctc_draws(rng, seconds, T: int, L: int, V: int) -> tuple:
    """Labels and logits of utterances of ``seconds``: CTC_RATE labels a
    second, at most L (padded with -1; the first utterance's second label
    repeats its first), logits 2·N(0, 1) [B, T, V] → (logits, labels,
    lab_len) as numpy arrays."""
    B = len(seconds)
    lab_len = np.minimum((seconds * CTC_RATE).astype(np.int64), L)
    labels = np.full((B, L), -1, np.int64)
    for i, n in enumerate(lab_len):
        labels[i, :n] = rng.integers(1, V, n)
    labels[0, 1] = labels[0, 0]                       # a repeat
    logits = 2 * rng.standard_normal((B, T, V)).astype(np.float32)
    return logits, labels, lab_len


def ctc_setup(dev, logits, flen, labels, lab_len) -> tuple:
    """(the kernels' inputs (lp_ext, allow2, t_len, lab_len) on the card,
    {"forward", "forward+backward"}: F.ctc_loss (blank 0) on the same
    log-probabilities, its lengths on the host as it takes them)."""
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch.ops.ctc import ctc_inputs

    lg = torch.from_numpy(logits).to(dev)
    args = ctc_inputs(lg, flen.to(dev), torch.from_numpy(labels).to(dev),
                      torch.from_numpy(lab_len).to(dev))
    lpt = torch.log_softmax(lg, -1).transpose(0, 1).detach()
    lpt.requires_grad_()
    tg = torch.from_numpy(np.maximum(labels, 0)).to(dev)
    il, tl = flen.clone(), torch.from_numpy(lab_len)

    def fwd():
        return F.ctc_loss(lpt, tg, il, tl, blank=0, reduction="none")

    def fwd_bwd():
        return torch.autograd.grad(fwd().sum(), lpt)

    return args, {"forward": fwd, "forward+backward": fwd_bwd}


def ctc_alpha_check(alphas, loss, alphas_p, loss_p) -> dict:
    """The forward against the plain recursion over all of [B, T', S]: the
    LOG_ZERO states and frozen rows exactly, the live alphas at the loss's
    rtol (the loss is their logsumexp) plus ``ctc_alpha_atol``, the loss
    at ``ctc_loss_rtol``."""
    from chainer_speech_recognition_tpu_torch.ops.ctc import LOG_ZERO

    sent = alphas_p <= LOG_ZERO / 2
    sent_ok = bool((alphas <= LOG_ZERO / 2).equal(sent)
                   and alphas[sent].equal(alphas_p[sent]))
    adiff = (alphas - alphas_p).abs()[~sent]
    return {"rel": float(((loss - loss_p).abs() / loss_p.abs()).max()),
            "aerr": float(adiff.max()), "live": adiff.numel(),
            "sent": int(sent.sum()), "sent_ok": sent_ok,
            "alpha_ok": bool((adiff <= TOL["ctc_alpha_atol"]
                              + TOL["ctc_loss_rtol"]
                              * alphas_p[~sent].abs()).all())}


def ctc_library_replay(fn):
    """F.ctc_loss's call ``fn`` GRAPH_CALLS times back to back: its lengths
    pass through the host, so no CUDA graph holds it; ``alternating_ms``
    times it eagerly beside the kernels' replays."""
    def replay():
        for _ in range(GRAPH_CALLS):
            fn()
    return replay


def ctc_rounds(tag: str, kernels: dict, library: dict) -> dict:
    """The CTC kernels (name → call) as CUDA-graph replays, each equal to
    its eager output bit for bit, and F.ctc_loss's calls (``ctc_setup``)
    eagerly, in alternating rounds → {name: [ms a round]}, with
    "F.ctc_loss backward" as its forward+backward less its forward."""
    graphs = {n: graph_of(fn, mode="relaxed") for n, fn in kernels.items()}
    replays = {n: g[0] for n, g in graphs.items()}
    replays.update({f"F.ctc_loss {n}": ctc_library_replay(f)
                    for n, f in library.items()})
    rounds = alternating_ms(replays)
    for n, fn in kernels.items():
        check(same_bits(graphs[n][1], fn()),
              f"{tag}: the {n} replay differs from its eager output")
    rounds["F.ctc_loss backward"] = [
        a - b for a, b in zip(rounds["F.ctc_loss forward+backward"],
                              rounds["F.ctc_loss forward"])]
    return rounds


def print_ctc_plan(tag: str, S: int) -> None:
    """The CTC kernels' launch shape at S extended states."""
    from chainer_speech_recognition_tpu_torch.ops.ctc_cuda import ctc_plan

    for form in ("fwd", "bwd"):
        p = ctc_plan(S, form)
        print(f"[{tag}] ctc_{form} plan at S = {S}: "
              + (f"{p.states} states a thread, {p.warps} warps an utterance"
                 if p.states else f"wide, {p.warps * 32} threads")
              + f", {p.smem} bytes of shared memory a block")


def attention_cases(rng) -> list:
    """Phase 18's three cases, (tag, B, T', lengths [B] int64 CPU, chunk,
    left): 32 long-form wavs of 22-28 s in one decode chunk (T' = 701 at
    28 s), whole and in the conformer_stream preset's chunk window; 24
    training utterances of 9-10 s in the 1024-frame bucket. Ragged: the
    first two rows have lengths T' and 1."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config

    strides = preset_config(CONF_PRESET).model.conv_stride_time
    smcfg = preset_config(CONF_STREAM).model
    n_long = int(LONG_SECONDS[1] * C.SAMPLE_RATE)
    dec_len, T_dec = subsampled(
        rng.uniform(*LONG_SECONDS, CHECK_B) * C.SAMPLE_RATE,
        C.num_frames(n_long), strides)
    tr_len, T_tr = subsampled(
        rng.uniform(*TRAIN_SECONDS, TRAIN_B) * C.SAMPLE_RATE, TRAIN_FRAMES,
        strides)
    for lens, T in ((dec_len, T_dec), (tr_len, T_tr)):
        lens[0], lens[1] = T, 1
    return [("decode", CHECK_B, T_dec, dec_len, 0, 0),
            ("decode chunk 16/4", CHECK_B, T_dec, dec_len, smcfg.attn_chunk,
             smcfg.attn_left_chunks),
            ("train", TRAIN_B, T_tr, tr_len, 0, 0)]


def sdpa_backend(q, k, v, mask) -> str:
    """The backend ``F.scaled_dot_product_attention`` picks for these
    operands and boolean mask: the first of the fused backends, in the
    dispatcher's priority order, that takes them alone, else "math"."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]
    if hasattr(torch._C, "_get_sdp_priority_order"):
        prio = list(torch._C._get_sdp_priority_order())
        order.sort(key=lambda b: prio.index(int(b)) if int(b) in prio
                   else len(prio))
    for backend in order:
        try:
            with sdpa_kernel([backend]), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            return backend.name.lower()
        except RuntimeError:
            continue
    return "math"


def flash_case(dev, rng, tag, B, T, lens_cpu, chunk, left, h, dh,
               timed=FLASH, crossover=False, n_rounds: int = 9) -> dict:
    """The three flash kernels vs their plain versions in fp32 and bf16 on
    one case (phases 18 and 29): outputs finite, rows with no allowed key
    exact, each output within its elementwise bar, the bf16 gradients'
    planted faults beyond theirs. Where ``timed`` names kernels, the bf16
    forward (and with "flash_bwd_dq" in it the backward pair) in
    alternating rounds of graph replays beside SDPA's forward (and
    backward) in ``n_rounds`` rounds → {kernel: its timing entry}, else {};
    ``crossover`` adds the einsum path's eager time beside flash_fwd's."""
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch.models.attention import (
        einsum_attention)
    from chainer_speech_recognition_tpu_torch.models.rnn import time_mask
    from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac

    lens = lens_cpu.to(torch.int32).to(dev)
    d = h * dh
    f32 = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    qkv32, do32 = f32(B, T, 3 * d), f32(B, T, h, dh)
    ok = ac.allowed_mask(T, lens, chunk, left)            # [B, 1, T, T]
    pairs = int(ok.expand(B, 1, T, T).sum()) * h
    t = {}
    for dtag, cdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        qkv, do = qkv32.to(cdt), do32.to(cdt)
        # strided views of the fused projection, as the model has them
        q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, T, h, dh)
                   for i in range(3))
        o, lse = ac.flash_fwd_cuda(q, k, v, lens, chunk, left)
        o_p, lse_p = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
        d_rows = (do.float() * o_p.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
        dq, (dk, dv) = (ac.flash_bwd_dq_cuda(*args),
                        ac.flash_bwd_dkv_cuda(*args))
        dq_p, (dk_p, dv_p) = (ac.flash_bwd_dq_plain(*args),
                              ac.flash_bwd_dkv_plain(*args))
        torch.cuda.synchronize()
        for name, x in (("out", o), ("lse", lse), ("dq", dq), ("dk", dk),
                        ("dv", dv)):
            check(bool(torch.isfinite(x.float()).all()),
                  f"flash {tag} {dtag}: non-finite {name}")
        live = lse_p > ac.NEG / 2
        check(torch.equal(lse[~live], lse_p[~live]),
              f"flash {tag} {dtag}: rows with no allowed key")
        ftol, gtol = TOL[f"flash_{dtag}"], TOL[f"flash_grad_{dtag}"]
        o_scale = o_p.float().abs()
        room = (0.0, 0.0, 0.0)
        if cdt == torch.bfloat16:         # + Σ p·|v| / l (see TOL)
            o_scale += ac.flash_fwd_plain(q, k, v.abs(), lens, chunk,
                                          left)[0].float()
            # the gradients' bar adds the rounding room of p and ds
            room = ac.bwd_rounding_room(*args)
        grads = (("dq", dq, dq_p, room[0]), ("dk", dk, dk_p, room[1]),
                 ("dv", dv, dv_p, room[2]))
        # (max abs error, max of |a - b| / (atol + rtol·s + room)):
        # each output passes where the second is at most 1
        err = {n: (float((a.float() - b.float()).abs().max()),
                   excess(a, b, *tol, s, x))
               for n, a, b, tol, s, x in (
                   ("out", o, o_p, ftol, o_scale, 0.0),
                   ("lse", lse[live], lse_p[live], TOL["flash_fp32"],
                    None, 0.0),
                   *((n, a, b, gtol, None, x) for n, a, b, x in grads))}
        bf = cdt == torch.bfloat16
        print(f"[attn-kernels] {tag} {dtag} B={B} T'={T} h={h} dh={dh}"
              f" ({int((~live).sum())} rows with no allowed key): max abs"
              f" (share of the elementwise bar) " + ", ".join(
                  f"{n} {a:.3e} ({x:.3f})" for n, (a, x) in err.items())
              + f"; bars (rtol, atol): out {ftol}"
              f"{' of |b| + Σp|v|/l' if bf else ''}"
              f", lse {TOL['flash_fp32']}, gradients {gtol}"
              f"{' + the rounding room of p and ds' if bf else ''}")
        if bf:
            print(f"[attn-kernels] {tag} bf16 gradients' share of the old"
                  f" bar 2^-7·|b| + 1e-3 (no rounding room): " + ", ".join(
                      f"{n} {excess(a, b, *gtol):.3f}"
                      for n, a, b, _ in grads))
            # the bar's power: each planted fault, added to the
            # kernels' own gradients, must exceed it somewhere
            planted = {
                f: [excess((a.float() + dd).to(cdt), b, *gtol, None, x)
                    for (_, a, b, x), dd in zip(grads, deltas)]
                for f, deltas in ac.bwd_planted_faults(*args).items()}
            print(f"[attn-kernels] {tag} bf16 planted faults' share of "
                  f"the derived bar (each must exceed 1): " + "; ".join(
                      f"{f}: " + ", ".join(
                          f"{n} {s:.3f}" for n, s in zip(
                              ("dq", "dk", "dv"), sh))
                      for f, sh in planted.items()))
            check(all(max(sh) > 1 for sh in planted.values()),
                  f"flash backward {tag}: a planted fault passes the "
                  "derived bar")
        check(err["out"][1] <= 1 and err["lse"][1] <= 1,
              f"flash_fwd {tag} {dtag} disagrees")
        check(max(err[n][1] for n in ("dq", "dk", "dv")) <= 1,
              f"flash backward {tag} {dtag} disagrees")
        ferr = max(err["out"][0], err["lse"][0])
        gerr = {n: err[n][0] for n in ("dq", "dk", "dv")}
        if cdt != torch.bfloat16 or not timed:   # time the working type
            continue
        # yardstick: PyTorch's SDPA with the same boolean mask, heads
        # second; its backward computes dq, dk and dv in one call
        qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
        leaves = [x.detach().clone().requires_grad_() for x in
                  (qh, kh, vh)]
        backend = sdpa_backend(qh, kh, vh, ok)

        def sdpa_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=ok)

        def sdpa_train():
            return F.scaled_dot_product_attention(*leaves, attn_mask=ok)

        # the kernels and SDPA's forward and backward in alternating
        # rounds of CUDA-graph replays, device time only on both sides;
        # SDPA's backward is its forward and backward less its training
        # forward, the two captured alike
        fns = {"flash_fwd": lambda: ac.flash_fwd_cuda(
            q, k, v, lens, chunk, left), "sdpa_fwd": sdpa_fwd}
        bwd = "flash_bwd_dq" in timed
        if bwd:
            fns.update({
                "flash_bwd_dq": lambda: ac.flash_bwd_dq_cuda(*args),
                "flash_bwd_dkv": lambda: ac.flash_bwd_dkv_cuda(*args),
                "sdpa_fwd_bwd": lambda: torch.autograd.grad(
                    sdpa_train(), leaves, doh),
                "sdpa_train": sdpa_train})
        graphs = {n: graph_of(fn) for n, fn in fns.items()}
        rounds = alternating_ms({n: g[0] for n, g in graphs.items()},
                                rounds=n_rounds)
        replayed = [graphs["flash_fwd"][1]]
        eager_out = [(o, lse)]
        if bwd:
            replayed += [graphs["flash_bwd_dq"][1],
                         graphs["flash_bwd_dkv"][1]]
            eager_out += [dq, (dk, dv)]
        check(same_bits(replayed, eager_out), f"flash kernels {tag}: a "
              "replay differs from the eager call (not deterministic)")
        med = {n: statistics.median(r) for n, r in rounds.items()}
        fwd_ratio = [a / b for a, b in zip(rounds["flash_fwd"],
                                           rounds["sdpa_fwd"])]
        t = {"flash_fwd": dict(
            max_abs_err=ferr, ms=med["flash_fwd"],
            plain_ms=time_ms(lambda: ac.flash_fwd_plain(
                q, k, v, lens, chunk, left), warmup=1, reps=3),
            library_ms=med["sdpa_fwd"], sdpa_backend=backend,
            **flash_bound(B, T, h, dh, pairs, 3, 1, 1, 4))}
        eager = {"flash_fwd": time_ms(fns["flash_fwd"]),
                 "SDPA forward": time_ms(sdpa_fwd)}
        print(f"[attn-kernels] {tag} dh={dh} forward, {len(fwd_ratio)} "
              f"alternating rounds of graph replays (medians): flash_fwd "
              f"{med['flash_fwd']:.4f} ms ("
              f"{t['flash_fwd']['bound_ms'] / med['flash_fwd']:.3f} of its "
              f"bound), SDPA forward ({backend}) {med['sdpa_fwd']:.4f} ms; "
              f"flash_fwd / SDPA {statistics.median(fwd_ratio):.3f} "
              f"(rounds {min(fwd_ratio):.3f}-{max(fwd_ratio):.3f}); "
              f"eager (host time in it): " + ", ".join(
                  f"{n} {m:.4f} ms" for n, m in eager.items()))
        if bwd:
            rounds["sdpa_bwd"] = [a - b for a, b in zip(
                rounds["sdpa_fwd_bwd"], rounds["sdpa_train"])]
            med["sdpa_bwd"] = statistics.median(rounds["sdpa_bwd"])
            ratio = [(a + b) / c for a, b, c in zip(
                rounds["flash_bwd_dq"], rounds["flash_bwd_dkv"],
                rounds["sdpa_bwd"])]
            t["flash_bwd_dq"] = dict(
                max_abs_err=gerr["dq"], ms=med["flash_bwd_dq"],
                plain_ms=time_ms(lambda: ac.flash_bwd_dq_plain(*args),
                                 warmup=1, reps=3),
                library_ms=med["sdpa_bwd"], sdpa_backend=backend,
                **flash_bound(B, T, h, dh, pairs, 4, 1, 2, 6))
            t["flash_bwd_dkv"] = dict(
                max_abs_err=max(gerr["dk"], gerr["dv"]),
                ms=med["flash_bwd_dkv"],
                plain_ms=time_ms(lambda: ac.flash_bwd_dkv_plain(*args),
                                 warmup=1, reps=3),
                library_ms=med["sdpa_bwd"], sdpa_backend=backend,
                **flash_bound(B, T, h, dh, pairs, 4, 2, 2, 8))
            pair = med["flash_bwd_dq"] + med["flash_bwd_dkv"]
            share = {n: t[n]["bound_ms"] / med[n] for n in FLASH[1:]}
            print(f"[attn-kernels] {tag} dh={dh} backward, same rounds "
                  f"(medians): dq {med['flash_bwd_dq']:.4f} ms "
                  f"({share['flash_bwd_dq']:.3f} of its bound), dkv "
                  f"{med['flash_bwd_dkv']:.4f} ms "
                  f"({share['flash_bwd_dkv']:.3f} of its bound), pair "
                  f"{pair:.4f} ms; SDPA backward "
                  f"{med['sdpa_bwd']:.4f} ms (forward and backward "
                  f"{med['sdpa_fwd_bwd']:.4f} ms); pair / SDPA "
                  f"{statistics.median(ratio):.3f} (rounds {min(ratio):.3f}"
                  f"-{max(ratio):.3f}); replays equal the eager outputs")
        for name, r in t.items():
            both = " (dq, dk, dv together)" if name != "flash_fwd" else ""
            print(f"[attn-kernels] {tag} dh={dh} {name}: {r['ms']:.4f} ms, "
                  f"plain (eager) {r['plain_ms']:.4f} ms, SDPA "
                  f"{r['library_ms']:.4f} ms{both}, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}), "
                  f"{pairs} allowed (query, key) pairs")
        if crossover and chunk == 0:
            # the port's einsum path on the same q, k, v beside the
            # eager flash_fwd: the card's flash/einsum crossover
            # (recorded, not acted on)
            mask = time_mask(T, lens)
            ein = time_ms(lambda: einsum_attention(q, k, v, mask))
            print(f"[attn-kernels] {tag} einsum path {ein:.4f} ms vs "
                  f"flash_fwd {eager['flash_fwd']:.4f} ms at T'={T} "
                  f"(both eager)")
    return t


def phase_attention_kernels(dev, rng) -> dict:
    """The three flash kernels vs their plain versions (phase 18) at the
    presets' head width."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    mcfg = preset_config(CONF_PRESET).model
    h, dh = mcfg.attn_heads, mcfg.attn_dim // mcfg.attn_heads
    out = {}
    for tag, B, T, lens_cpu, chunk, left in attention_cases(rng):
        t = flash_case(dev, rng, tag, B, T, lens_cpu, chunk, left, h, dh,
                       crossover=True)
        if tag == "decode":
            out["flash_fwd"] = t["flash_fwd"]
        elif tag == "train":
            out["flash_bwd_dq"] = t["flash_bwd_dq"]
            out["flash_bwd_dkv"] = t["flash_bwd_dkv"]
    return out


WIDTH_ROUNDS = 5          # phase 29's alternating rounds a case


def width_heads(dh: int) -> int:
    """Phase 29's heads at head width dh: the presets' d = 256 where dh
    divides it (h = 4, 2, 1 at dh = 64, 128, 256), else one head."""
    return max(1, 256 // dh) if 256 % dh == 0 else 1


def phase_flash_widths(dev, rng) -> dict:
    """Phase 29: the three flash kernels at every head width the kernels
    take (``attention_cuda.KERNEL_DHS``, the reference's set), fp32 and
    bf16, against their plain versions at the decode and training shapes
    of phase 18 (ragged lengths 1 and T', q/k/v strided as the fused qkv
    gives them; h from ``width_heads``), chunk 16 / left 4 at dh 128 and
    512; the bf16 forward timed at the decode shape and the backward pair
    at the training shape beside SDPA (``WIDTH_ROUNDS`` alternating rounds)
    → {kernel: {dh: timing entry}}."""
    from chainer_speech_recognition_tpu_torch.ops.attention_cuda import (
        KERNEL_DHS)

    cases = {c[0]: c for c in attention_cases(rng)}
    out = {name: {} for name in FLASH}
    for dh in KERNEL_DHS:
        h = width_heads(dh)
        tag, B, T, lens, chunk, left = cases["decode"]
        fwd = flash_case(dev, rng, f"width {tag}", B, T, lens, chunk, left,
                         h, dh, timed=("flash_fwd",), n_rounds=WIDTH_ROUNDS)
        tag, B, T, lens, chunk, left = cases["train"]
        bwd = flash_case(dev, rng, f"width {tag}", B, T, lens, chunk, left,
                         h, dh, timed=FLASH, n_rounds=WIDTH_ROUNDS)
        if dh in (128, 512):
            tag, B, T, lens, chunk, left = cases["decode chunk 16/4"]
            flash_case(dev, rng, f"width {tag}", B, T, lens, chunk, left, h,
                       dh, timed=())
        for name, r in (("flash_fwd", fwd["flash_fwd"]),
                        ("flash_bwd_dq", bwd["flash_bwd_dq"]),
                        ("flash_bwd_dkv", bwd["flash_bwd_dkv"])):
            out[name][str(dh)] = {"h": h, **r}
    print("[flash-widths] bf16 medians (ms; forward at B=32 T'=701, the "
          "backward at B=24 T'=256): " + "; ".join(
              f"dh {dh}: fwd {out['flash_fwd'][str(dh)]['ms']:.4f} (SDPA "
              f"{out['flash_fwd'][str(dh)]['library_ms']:.4f} "
              f"{out['flash_fwd'][str(dh)]['sdpa_backend']}, bound "
              f"{out['flash_fwd'][str(dh)]['bound_ms']:.4f}), dq+dkv "
              f"{out['flash_bwd_dq'][str(dh)]['ms'] + out['flash_bwd_dkv'][str(dh)]['ms']:.4f}"
              f" (SDPA {out['flash_bwd_dq'][str(dh)]['library_ms']:.4f})"
              for dh in KERNEL_DHS))
    return out


def phase_frames_kernel(dev, rng) -> tuple[dict, int]:
    """The framed-input front-end kernel (row 2) vs its plain version on
    the frames of 32 wavs of 10 s (the last 8 s), T = 1001, timed beside
    cuFFT; then one call of its entry point ``fused_logmel`` with the
    launch counts reset before it. → (timings, launches of that call)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
        fused_logmel, fused_logmel_cuda)
    from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
        _K, _tables, extend_signal, logmel_from_frames)

    V = preset_config(PRESET).model.vocab_size
    n = int(CHECK_SECONDS * C.SAMPLE_RATE)
    sigs = np.zeros((CHECK_B, n), np.float32)
    lens = np.full(CHECK_B, n, np.int32)
    for i in range(CHECK_B):
        s = synth_signal(rng, WAV_SECONDS[0] if i == CHECK_B - 1
                         else CHECK_SECONDS, V)
        sigs[i, : len(s)] = s
        lens[i] = len(s)
    T = C.num_frames(n)
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.from_numpy(lens).to(dev), T + _K + 1)
    frames = ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :T].contiguous()
    got = fused_logmel_cuda(frames)
    want = logmel_from_frames(frames)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    print(f"[frames-kernel] frontend_logmel_frames frames "
          f"{tuple(frames.shape)} -> {tuple(got.shape)}: max abs {err:.3e} "
          f"(tol {TOL['frontend_logmel']})")
    check(bool(torch.isfinite(got).all()), "frontend_logmel_frames: "
          "non-finite")
    check(err <= TOL["frontend_logmel"], "frontend_logmel_frames disagrees")
    win, mel = _tables(dev)

    def library_logmel():
        spec = torch.fft.rfft(frames * win, n=C.N_FFT, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(power @ mel, min=C.LOG_EPS))

    # the bytes the function needs: the 400 windowed samples of each frame
    # (the window zeroes the other 112) and the output
    t = frontend_timing("frames-kernel", "frontend_logmel_frames", err,
                        lambda: fused_logmel_cuda(frames),
                        lambda: logmel_from_frames(frames), library_logmel,
                        CHECK_B * T * C.WIN_LENGTH * 4 + nbytes(got),
                        CHECK_B * T)
    _kernels.reset_launches()
    feats = fused_logmel(frames)
    torch.cuda.synchronize()
    launches = _kernels.launches()
    check(launches["frontend_logmel_frames"] == 1 and sum(
        launches.values()) == 1, f"fused_logmel launches {launches}")
    check(torch.equal(feats, got), "fused_logmel differs from the kernel")
    print(f"[frames-kernel] fused_logmel (the entry point): 1 launch")
    return t, launches["frontend_logmel_frames"]


def write_long_wavs(root: str, rng, V: int) -> tuple[list[str], float]:
    """32 long-form wavs of 22-28 s (the last one 28 s: T' = 701)."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.utils.wav import write_wav

    wavs, total = [], 0.0
    for i in range(LONG_WAVS):
        sec = LONG_SECONDS[1] if i == LONG_WAVS - 1 else rng.uniform(
            *LONG_SECONDS)
        sig = synth_signal(rng, sec, V)
        wavs.append(os.path.join(root, f"long{i:03d}.wav"))
        write_wav(wavs[-1], sig)
        total += len(sig) / C.SAMPLE_RATE
    print(f"[inputs] {LONG_WAVS} long-form wavs, {total:.3f} s of audio")
    return wavs, total


def phase_conformer_decode(root, vocab, wavs, audio_s, long_wavs, long_s,
                           dev, rng) -> dict:
    """Phase 19: conformer through the decode CLI; → the long-form run's
    launches."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    blocks = preset_config(CONF_PRESET).model.attn_blocks
    ckpt = write_checkpoint(root, CONF_PRESET, rng)
    base = {"frontend_logmel": 1, "greedy": 1}
    launches, _ = phase_decode("conformer-decode long-form auto", ckpt,
                               vocab, long_wavs, long_s,
                               {**base, "flash_fwd": blocks})
    phase_parity(ckpt, long_wavs, dev, "conformer-parity")
    chunks = -(-len(wavs) // BATCH)
    short = {k: chunks * v for k, v in base.items()}
    phase_decode("conformer-decode short auto", ckpt, vocab, wavs, audio_s,
                 short)
    phase_decode("conformer-decode short flash", ckpt, vocab, wavs, audio_s,
                 {**short, "flash_fwd": chunks * blocks},
                 sets=("model.attn_impl=flash",))
    return launches


def phase_conformer_stream_decode(root, vocab, long_wavs, long_s, dev,
                                  rng) -> dict:
    """Phase 20: conformer_stream offline, the chunk mask in the kernel."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    blocks = preset_config(CONF_STREAM).model.attn_blocks
    ckpt = write_checkpoint(root, CONF_STREAM, rng)
    launches, _ = phase_decode(
        "conformer_stream-decode long-form auto", ckpt, vocab, long_wavs,
        long_s, {"frontend_logmel": 1, "greedy": 1, "flash_fwd": blocks})
    phase_parity(ckpt, long_wavs, dev, "conformer_stream-parity")
    return launches


def near_tie_free(logits, lens, gap: float) -> list[bool]:
    """Per utterance: whether every live frame's best logit leads the
    second by more than ``gap`` (no argmax a small error could flip)."""
    import torch

    top2 = torch.topk(logits, 2, dim=-1).values
    lead = (top2[..., 0] - top2[..., 1]).cpu()
    return [bool((lead[b, : int(lens[b])] > gap).all())
            for b in range(logits.shape[0])]


def phase_conformer_stream_online(root, vocab, wavs, audio_s, dev,
                                  rng) -> dict:
    """Phase 28: conformer_stream served online through the stream CLI on
    the card: a random-weight full-width checkpoint (8 blocks, d = 256,
    chunk 16, left 4, causal CMVN), the 64 wavs in lockstep batches of 32
    at --chunk-frames 64 with the default --right-frames (0: the lookahead
    lives inside the chunk), greedy, then --beam 8 --lm (the dense 3-gram)
    with every beam launch held to the plain version; exact launches (the
    front-end once a window, the beam once a window, nothing else: the
    streaming step takes the einsum path); warm reruns' utt/s and window
    latency; the chained window logits of 4 wavs against the offline
    chunk-masked logits (``attn_impl=einsum``) of the same checkpoint at
    the bf16 bar of phase 16, and at fp32 compute (the same weights) at
    the fp32 bar of phase 19; the streamed transcripts equal the offline
    argmax's wherever it has no near-tie. → the greedy run's launches."""
    import wave

    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.cli import stream
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.decode.greedy import (
        greedy_decode)
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.ops import attention_cuda
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    t_phase = time.perf_counter()
    tag = "cstream-online"
    ckpt = write_checkpoint(root, CONF_STREAM, rng,
                            {"features.cmvn_mode": "causal",
                             "features.cmvn": True})
    lens = []
    for w in wavs:
        with wave.open(w, "rb") as f:
            lens.append(f.getnframes())
    order = sorted(lens)
    windows = sum(-(-C.num_frames(max(order[i : i + BATCH])) // STREAM_CHUNK)
                  for i in range(0, len(order), BATCH))
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cuda",
            "--batch", str(BATCH), "--chunk-frames", str(STREAM_CHUNK),
            "--timing", *wavs]
    walls = {}
    results = {}
    arpa = train_arpa(root, vocab, rng, 3)
    for mode, extra in (("greedy", []), ("beam", [
            "--beam", str(BEAM_WIDTH), "--lm", arpa, "--lm-alpha",
            str(BEAM_ALPHA), "--lm-beta", str(BEAM_BETA)])):
        want = {k: 0 for k in _kernels.KERNELS}
        want["frontend_logmel"] = windows
        if mode == "beam":
            want["beam"] = windows
        diffs: list = []
        routed = dict(attention_cuda.ROUTED)
        _kernels.reset_launches()
        with beam_checked(diffs):
            lines, err, cold = run_cli(stream.main, base + extra)
        launches = _kernels.launches()
        check_launches(f"{tag} {mode}", launches, want)
        check(attention_cuda.ROUTED["flash"] == routed["flash"],
              "a streaming step took the flash kernels")
        check(len(diffs) == want["beam"], "not every stream beam launch was "
              "checked")
        check([l.split("\t")[0] for l in lines] == wavs and all(
            len(l.split("\t")) == 2 for l in lines), f"{mode} stream output")
        check(any(l.split("\t")[1] for l in lines),
              f"every {mode} transcript is empty")
        check("effective geometry" not in err, f"default geometry: {err!r}")
        lines2, err2, warm = run_cli(stream.main, base + extra)
        check(lines2 == lines, f"warm {mode} stream differs from the cold")
        timing = [l for l in err2.splitlines() if "window latency" in l]
        check(len(timing) == 1, f"no --timing line in {err2!r}")
        walls[mode] = (cold, warm)
        results[mode] = (launches, lines)
        print(f"[{tag}] {mode}: {windows} windows (chunk {STREAM_CHUNK} = "
              f"one attention chunk of 16, right 0), launches exact "
              f"{ {k: v for k, v in launches.items() if v} }"
              + (f" (each beam launch equal to the plain version)"
                 if mode == "beam" else "")
              + f"; cold {cold:.3f} s, warm {warm:.3f} s: "
              f"{len(wavs) / warm:.3f} utt/s, RTF {warm / audio_s:.6f}; "
              f"{timing[0]}")
    # the chained window logits against the offline chunk-masked logits
    cfg, model, _ = load_model(ckpt, device=dev)
    for i in range(cfg.model.attn_blocks):
        getattr(model, f"conformer{i}").mhsa.impl = "einsum"
    sigs = [read_wav(w) for w in wavs]
    got = stream_window_logits(model, cfg, sigs[:PARITY_WAVS], 0)
    offline, off_lens = [], []
    fe = select_frontend(cfg.features)
    for i in range(0, len(sigs), BATCH):
        part = sigs[i : i + BATCH]
        n = np.asarray([len(x) for x in part], np.int32)
        x = np.zeros((len(part), int(n.max())), np.float32)
        for j, sg in enumerate(part):
            x[j, : len(sg)] = sg
        with torch.inference_mode():
            feats, fl = fe(torch.from_numpy(x).to(dev),
                           torch.from_numpy(n).to(dev),
                           apply_cmvn=cfg.features.cmvn_arg)
            lg, ol = model(feats, fl)
        offline += [lg[b, : int(ol[b])].float() for b in range(len(part))]
        off_lens += [int(v) for v in ol]
    want_l = [o.cpu() for o in offline[:PARITY_WAVS]]
    check([g.shape for g in got] == [w.shape for w in want_l],
          f"chained window logits {[tuple(g.shape) for g in got]} vs "
          f"offline {[tuple(w.shape) for w in want_l]}")
    check(all(bool(torch.isfinite(g).all()) for g in got),
          "non-finite stream logits")
    lerr = max(float((g - w).abs().max()) for g, w in zip(got, want_l))
    print(f"[{tag}] chained window logits of {len(got)} wavs "
          f"{[tuple(g.shape) for g in got]} card vs the offline chunk-masked"
          f" logits (einsum): max abs {lerr:.3e} (tol {TOL['gru_bf16']}), "
          f"|logits| max {max(float(w.abs().max()) for w in want_l):.3f}")
    check(lerr <= TOL["gru_bf16"], "conformer_stream window logits disagree "
          "with the offline ones")
    # the same weights at fp32 compute: the stream is the offline function,
    # so its window logits meet the fp32 bar
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    cfg32 = cfg.override({"model.compute_dtype": "float32",
                          "model.attn_residual_dtype": "float32",
                          "model.attn_impl": "einsum"})
    model32 = build_model(cfg32.model)
    model32.load_state_dict(model.state_dict())
    model32.to(dev).eval()
    got32 = stream_window_logits(model32, cfg32, sigs[:PARITY_WAVS], 0)
    err32 = 0.0
    for j, sg in enumerate(sigs[:PARITY_WAVS]):
        with torch.inference_mode():
            feats, fl = fe(torch.from_numpy(sg[None]).to(dev),
                           torch.tensor([len(sg)], dtype=torch.int32,
                                        device=dev),
                           apply_cmvn=cfg32.features.cmvn_arg)
            lg, ol = model32(feats, fl)
        want32 = lg[0, : int(ol[0])].float().cpu()
        check(got32[j].shape == want32.shape, "fp32 stream logits' shape")
        err32 = max(err32, float((got32[j] - want32).abs().max()))
    print(f"[{tag}] at fp32 compute, the same weights: window logits vs "
          f"offline max abs {err32:.3e} (tol {TOL['attn_fp32']})")
    check(err32 <= TOL["attn_fp32"], "conformer_stream fp32 window logits "
          "disagree with the offline ones")
    # greedy transcripts against the offline argmax, where it has no
    # near-tie (a lead of more than twice the bar)
    vocab_obj = Vocab.load(vocab)
    Tmax = max(off_lens)
    padded = torch.zeros(len(offline), Tmax, offline[0].shape[1],
                         device=dev)
    for b, o in enumerate(offline):
        padded[b, : o.shape[0]] = o
    olens = torch.tensor(off_lens, device=dev)
    ids, n_ids = greedy_decode(padded, olens.to(torch.int32))
    texts = [vocab_obj.decode(ids[b, : int(n_ids[b])].tolist())
             for b in range(len(offline))]
    clean = near_tie_free(padded, olens, 2 * TOL["gru_bf16"])
    streamed = [l.split("\t")[1] for l in results["greedy"][1]]
    same = [a == b for a, b in zip(streamed, texts)]
    print(f"[{tag}] streamed vs offline greedy transcripts: "
          f"{sum(same)}/{len(same)} equal; {sum(clean)} utterances without "
          f"a near-tie (lead > {2 * TOL['gru_bf16']}), all of them equal: "
          f"{all(s for s, c in zip(same, clean) if c)}")
    check(all(s for s, c in zip(same, clean) if c),
          "a streamed transcript without a near-tie differs from offline")
    took = time.perf_counter() - t_phase
    print(f"[{tag}] phase 28 took {took:.3f} s (greedy cold/warm "
          f"{walls['greedy'][0]:.3f}/{walls['greedy'][1]:.3f} s, beam "
          f"{walls['beam'][0]:.3f}/{walls['beam'][1]:.3f} s)")
    return results["greedy"][0]


# phases 29-31: the flash kernels' head widths, conformer at dh 128 and
# 256, and glu_conv
WIDTHS_BUDGET_S = 60.0    # phases 29-31 together
WIDTH_HEADS = (2, 1)      # conformer's attn_heads in phase 30: dh 128, 256
GLU_RIGHT = 48            # glu_conv's right reach: its exact lookahead
GLU_STREAM_STEPS = 4      # glu_conv's steps in stream mode


def phase_conformer_widths(root, vocab, long_wavs, long_s, data, index,
                           dev, rng) -> dict:
    """Phase 30: conformer (8 blocks, d = 256) at ``model.attn_heads`` 2 and
    1, head widths 128 and 256 (every parameter's shape as in the preset):
    a random-weight checkpoint decoding phase 19's 32 long-form wavs under
    ``auto`` (exactly one flash_fwd a block: the reference's gate at dh ≠
    64) with 4 wavs' logits card vs CPU at phase 19's bars; training in
    the default data mode with ``attn_impl=flash`` (24 steps, exact
    flash_fwd, flash_bwd_dq and flash_bwd_dkv launches) and one step card
    vs CPU at phase 21's bars → {dh: {kernel: launches}}."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    mcfg = preset_config(CONF_PRESET).model
    out = {}
    for heads in WIDTH_HEADS:
        dh = mcfg.attn_dim // heads
        name = f"{CONF_PRESET}_h{heads}"
        over = {"model.attn_heads": heads}
        ckpt = write_checkpoint(root, CONF_PRESET, rng, over, name=name)
        dec, _ = phase_decode(
            f"conformer-dh{dh}-decode long-form auto", ckpt, vocab,
            long_wavs, long_s, {"frontend_logmel": 1, "greedy": 1,
                                "flash_fwd": mcfg.attn_blocks})
        phase_parity(ckpt, long_wavs, dev, f"conformer-dh{dh}-parity")
        sets = (f"model.attn_heads={heads}", "model.attn_impl=flash")
        step_s, busy, tr = phase_cached_preset(root, data, CONF_PRESET, sets,
                                               resume=False, name=name)
        phase_train_parity(dev, index, CONF_PRESET,
                           {**over, "model.attn_impl": "flash"},
                           tag=f"conformer-dh{dh}-train-parity")
        out[dh] = {"flash_fwd": dec["flash_fwd"],
                   "flash_bwd_dq": tr["flash_bwd_dq"],
                   "flash_bwd_dkv": tr["flash_bwd_dkv"]}
        print(f"[conformer-dh{dh}] attn_heads={heads}: decode and training "
              f"through the kernels at dh = {dh}, launches {out[dh]}; warm "
              f"step {step_s * 1e3:.3f} ms, busy {busy:.4f}")
    return out


def phase_glu(root, vocab, wavs, audio_s, data, index, dev, rng) -> None:
    """Phase 31: glu_conv (the conv subsampler and six GLU conv blocks of
    256, conv-only CTC) at full width: a random-weight checkpoint through
    the decode CLI on the 64 wavs (exact front-end and greedy launches), 4
    wavs' logits card vs CPU; 24 training steps in the default data mode
    (exact ctc_fwd / ctc_bwd launches, the step-16 checkpoint resumed to 24
    bitwise) and 4 in stream mode (exact launches); one step card vs CPU
    at phase 9's bars; the stream CLI with
    causal CMVN at --right-frames 48 (exact: conv_exact) with exact
    launches, the chained window logits of 4 wavs against the offline
    ones at phase 16's bar, and at 16 (the default) the error printed;
    the decode CLI with --beam 8 --lm once, every beam launch held to the
    plain version."""
    import wave

    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.cli import stream
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav

    ckpt = write_checkpoint(root, GLU_PRESET, rng)
    chunks = -(-len(wavs) // BATCH)
    want = {"frontend_logmel": chunks, "greedy": chunks}
    phase_decode("glu-decode", ckpt, vocab, wavs, audio_s, want)
    phase_parity(ckpt, wavs, dev, "glu-parity")
    step_s, busy, tr = phase_cached_preset(root, data, GLU_PRESET)
    # the other data mode: host batches a step
    ev, sl, swall, _ = cached_train(
        data, "glu_stream_mode", root, GLU_PRESET, GLU_STREAM_STEPS,
        ["train.data_mode=stream", "train.log_every=1",
         "train.eval_every=100", "train.checkpoint_every=100"])
    steps = [e for e in ev if e["kind"] == "train"]
    check([e["step"] for e in steps] == list(range(1, GLU_STREAM_STEPS + 1))
          and all(np.isfinite(e["loss"]) for e in steps),
          f"glu_conv stream mode: metrics {steps}")
    swant = {k: 0 for k in _kernels.KERNELS}
    swant.update({k: GLU_STREAM_STEPS for k in ("frontend_logmel",
                                                "ctc_fwd", "ctc_bwd")})
    check_launches("glu-train stream mode", sl, swant)
    print(f"[glu-train] data_mode=stream: {GLU_STREAM_STEPS} steps in "
          f"{swall:.3f} s, losses "
          f"{[round(e['loss'], 4) for e in steps]}, launches exact")
    phase_train_parity(dev, index, GLU_PRESET)

    sckpt = write_checkpoint(root, GLU_PRESET, rng,
                             {"features.cmvn_mode": "causal"})
    lens = []
    for w in wavs:
        with wave.open(w, "rb") as f:
            lens.append(f.getnframes())
    order = sorted(lens)
    windows = sum(-(-C.num_frames(max(order[i : i + BATCH])) // STREAM_CHUNK)
                  for i in range(0, len(order), BATCH))
    args = ["--ckpt-dir", sckpt, "--vocab", vocab, "--device", "cuda",
            "--batch", str(BATCH), "--chunk-frames", str(STREAM_CHUNK),
            "--right-frames", str(GLU_RIGHT), "--timing", *wavs]
    _kernels.reset_launches()
    lines, err, wall = run_cli(stream.main, args)
    launches = _kernels.launches()
    swant = {k: 0 for k in _kernels.KERNELS}
    swant["frontend_logmel"] = windows
    check_launches("glu-stream", launches, swant)
    check([l.split("\t")[0] for l in lines] == wavs and all(
        len(l.split("\t")) == 2 for l in lines), "glu stream output")
    timing = [l for l in err.splitlines() if "window latency" in l]
    check(len(timing) == 1 and "conv_exact True" in timing[0],
          f"glu stream --timing line {timing}")
    print(f"[glu-stream] stream CLI, chunk {STREAM_CHUNK} + "
          f"{GLU_RIGHT}: {windows} windows in {wall:.3f} s (cold), launches "
          f"exact {{'frontend_logmel': {windows}}}; {timing[0]}")
    sigs = [read_wav(w) for w in wavs[:PARITY_WAVS]]
    cfg, model, _ = load_model(sckpt, device=dev)
    n = np.asarray([len(x) for x in sigs], np.int32)
    x = np.zeros((len(sigs), int(n.max())), np.float32)
    for i, sg in enumerate(sigs):
        x[i, : len(sg)] = sg
    with torch.inference_mode():
        feats, fl = select_frontend(cfg.features)(
            torch.from_numpy(x).to(dev), torch.from_numpy(n).to(dev),
            apply_cmvn=cfg.features.cmvn_arg)
        logits, ol = model(feats, fl)
    offline = [logits[b, : int(ol[b])].float().cpu()
               for b in range(len(sigs))]
    errs = {}
    for right in (GLU_RIGHT, 16):
        got = stream_window_logits(model, cfg, sigs, right)
        check([g.shape for g in got] == [w.shape for w in offline],
              f"glu stream at right {right}: logits shapes")
        errs[right] = max(float((g - w).abs().max())
                          for g, w in zip(got, offline))
    print(f"[glu-stream] chained window logits of {len(sigs)} wavs vs the "
          f"offline ones (card): right {GLU_RIGHT} max abs "
          f"{errs[GLU_RIGHT]:.3e} (tol {TOL['gru_bf16']}); right 16 (the "
          f"default, conv_exact False) {errs[16]:.3e} (not gated), |logits| "
          f"max {max(float(w.abs().max()) for w in offline):.3f}")
    check(errs[GLU_RIGHT] <= TOL["gru_bf16"], "glu stream logits at the "
          "exact lookahead disagree with the offline ones")

    arpa = train_arpa(root, vocab, rng, 3)
    bargs = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", str(BATCH),
             "--device", "cuda", "--beam", str(BEAM_WIDTH), "--lm", arpa,
             "--lm-alpha", str(BEAM_ALPHA), "--lm-beta", str(BEAM_BETA),
             *wavs]
    diffs: list = []
    _kernels.reset_launches()
    with beam_checked(diffs):
        blines, bwall = run_decode(bargs)
    bl = _kernels.launches()
    bwant = {k: 0 for k in _kernels.KERNELS}
    bwant.update({"frontend_logmel": chunks, "beam": chunks})
    check_launches("glu-beam", bl, bwant)
    check(len(diffs) == chunks, "not every glu beam launch was checked")
    check([l.split("\t")[0] for l in blines] == wavs, "glu beam output")
    print(f"[glu-beam] decode --beam {BEAM_WIDTH} --lm (3-gram): "
          f"{bwall:.3f} s (cold), launches exact "
          f"{ {k: v for k, v in bl.items() if v} }, each beam launch equal "
          f"to the plain version (max score diff {max(diffs):.3e})")
    print(f"[glu] train: warm step {step_s * 1e3:.3f} ms, busy {busy:.4f}, "
          f"launches {tr['ctc_fwd']} ctc_fwd, {tr['ctc_bwd']} ctc_bwd")


# ---------------------------------------------------------------------------
# phases 32-33: the recurrences past H = 512 (W streamed)
# ---------------------------------------------------------------------------

WIDE_H = (640, 768, 1024, 2048)   # phase 32's hidden sizes
WIDE_ROUNDS, WIDE_CALLS = 5, 3    # phase 32's alternating rounds, calls a graph
WIDE_FP32 = (8, 32)               # (B, T') of the fp32 checks: the FMA
                                  # kernels read all of W a row a step
WIDE_PATH_H = 1024                # phase 33's model.rnn_hidden
WIDE_DW_H = (1024, 2048)          # dW checked on phase 32's wide LSTM
WIDE_BUDGET_S = 60.0              # phases 32-33 together
# the kernels phase 32 holds, by cell: (residual-free, training, backward,
# stream), the kernel line's names
WIDE_KERNELS = {cell: (f"{cell}_fwd", f"{cell}_fwd_train", f"{cell}_bwd",
                       f"{cell}_fwd_stream") for cell in ("gru", "lstm")}


def wide_faults(rc) -> dict:
    """Phase 32's planted faults, each a wrong layout of the streamed-W
    operand fragments as a kernel bug would read them: ``ks-ring`` the B
    fragments one k-step late (an off-by-one in the prefetch ring), and
    ``neighbour`` a unit block's (forward) or an n-group's (backward)
    fragments swapped with the next one's (a wrong warp-to-units map).
    → {name: (form, the faulty layout function)}."""
    import torch

    fwd, bwd = rc.wide_fwd_weights, rc.wide_bwd_weights

    def swap(t, dim):
        idx = list(range(t.shape[dim]))
        idx[0], idx[1] = 1, 0
        return t.index_select(dim, torch.tensor(idx, device=t.device))

    return {"fwd ks-ring": ("fwd", lambda w: fwd(w).roll(1, dims=2)),
            "fwd neighbour": ("fwd", lambda w: swap(fwd(w), 1)),
            "bwd ks-ring": ("bwd", lambda w: bwd(w).roll(1, dims=3)),
            "bwd neighbour": ("bwd", lambda w: swap(bwd(w), 2))}


def wide_rows(lens_f, T: int, ndir: int, dev):
    """(lo, hi) [ndir·B, 1] of a layer: the bidirectional rows of
    ``rnn_rows``, or the forward rows alone."""
    import torch

    if ndir == 2:
        return rnn_rows(lens_f, T, dev)
    return (torch.zeros(len(lens_f), 1, device=dev),
            lens_f[:, None].to(dev))


def wide_case(rc, dev, rng, cell: str, H: int, ndir: int, cdt, shapes: dict,
              counts: dict) -> dict:
    """Rows 3-8 of ``cell`` at hidden size H, direction count ``ndir`` and
    compute dtype ``cdt`` against their plain versions: the residual-free
    form at shapes["decode"], the training forward and the backward (on
    the plain forward's residuals and on the kernel's own) at
    shapes["train"], the stream form at shapes["stream"] (emit_t 0, C/s
    and T, h0 nonzero on the forward rows); each shape (B, T', lengths).
    Each kernel call must launch its kernel exactly once (``counts`` adds
    them up). → {kernel name: (max abs error, share of its bar), ...} and
    the inputs under "inputs"."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels

    G = 3 if cell == "gru" else 4
    bf16 = cdt == torch.bfloat16
    tol = TOL["gru_bf16" if bf16 else "gru_fp32"]
    names = WIDE_KERNELS[cell]
    f32 = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dev)
    w = f32(ndir, H, G * H) / np.sqrt(H)
    out, inputs = {}, {"w": w}

    def once(name, fn):
        before = _kernels.KERNELS[name].launches
        res = fn()
        check(_kernels.KERNELS[name].launches == before + 1,
              f"{name} H={H}: not one launch a call")
        counts[name] = counts.get(name, 0) + 1
        return res

    def held(name, got, want, gbar: bool = False):
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all()) for t in got),
              f"{name} H={H} ndir={ndir}: non-finite")
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
        if gbar and bf16:       # phase 26's bar: + 2^-7 of max |b|
            ex = max(excess(a, b, 2 ** -7, TOL["gru_grad_bf16"],
                            scale=b.float().abs().max())
                     for a, b in zip(got, want))
        else:
            bar = TOL["gru_grad_bf16"] if gbar and bf16 else tol
            ex = err / bar
        prev = out.get(name, (0.0, 0.0))
        out[name] = (max(prev[0], err), max(prev[1], ex))

    B, T, lens = shapes["decode"]
    lo, hi = wide_rows(lens.to(torch.float32), T, ndir, dev)
    xs = f32(T, ndir * B, G * H).to(rc.stream_dtype(cdt))
    held(names[0], once(names[0], lambda: getattr(rc, f"{cell}_scan_cuda")(
        xs, w, lo, hi, cdt)), getattr(rc, f"{cell}_scan_plain")(
        xs, w, lo, hi, cdt))
    inputs["decode"] = (xs, lo, hi)

    B, T, lens = shapes["train"]
    lo, hi = wide_rows(lens.to(torch.float32), T, ndir, dev)
    xs = f32(T, ndir * B, G * H).to(rc.stream_dtype(cdt))
    g = f32(T, ndir * B, H)
    fwd = getattr(rc, f"{cell}_scan_train_cuda")
    res = once(names[1], lambda: fwd(xs, w, lo, hi, cdt))
    res_p = getattr(rc, f"{cell}_scan_train_plain")(xs, w, lo, hi, cdt)
    held(names[1], res, res_p)
    bwd, bwd_p = getattr(rc, f"{cell}_bwd_cuda"), getattr(
        rc, f"{cell}_bwd_plain")
    if cell == "gru":     # the kernel reads h_prev from ys in place
        args_p = (res_p[1], w, lo, hi, res_p[0], g, cdt)
        own = (res[1], w, lo, hi, res[0], g, cdt)
        want = bwd_p(res_p[1], w, lo, hi, rc.shift_prev(res_p[0]), g, cdt)
    else:
        args_p = (res_p[2], w, lo, hi, res_p[1], g, cdt)
        own = (res[2], w, lo, hi, res[1], g, cdt)
        want = bwd_p(*args_p)
    for a in (args_p, own):
        held(names[2], once(names[2], lambda a=a: bwd(*a)), want, gbar=True)
    inputs["train"] = (xs, lo, hi, g, res_p, args_p, want)

    B, T, emit = shapes["stream"]
    lens = torch.full((B,), float(T))
    if B > 2:
        lens[1], lens[2] = emit // 2, 0
    lo, hi = wide_rows(lens, T, ndir, dev)
    xs = f32(T, ndir * B, G * H).to(rc.stream_dtype(cdt))
    Cw = H if cell == "gru" else 2 * H
    h0 = torch.zeros(ndir * B, Cw, device=dev)
    h0[:B] = 0.5 * f32(B, Cw)
    kernel = getattr(rc, f"{cell}_scan_stream_cuda")
    plain = getattr(rc, f"{cell}_scan_stream_plain")
    for e in (0, emit, T):
        held(names[3], once(names[3], lambda e=e: kernel(
            xs, w, lo, hi, h0, cdt, e)), plain(xs, w, lo, hi, h0, cdt, e))
    inputs["stream"] = (xs, lo, hi, h0, emit, lens)
    out["inputs"] = inputs
    return out


def phase_rnn_widths(dev, rng) -> dict:
    """Phase 32: rows 3-8 past H = 512, W streamed. At each H in ``WIDE_H``
    and for both cells: every form (residual-free, training forward,
    backward on the plain forward's residuals and on its own, stream at
    emit_t 0, C/s and T) against its plain version, ndir 2 and 1, in bf16
    at the decode (B = 32, T' = 251), training (B = 24, T' = 256) and
    stream-window (B = 32, T = 20) shapes and in fp32 at B = 8, T' = 32
    (the FMA kernels read all of W a row a step); bars: the forward forms
    3e-2 (bf16) and 1e-4 (fp32), the bf16 backward phase 26's 5e-2 +
    2^-7·max|b|, the fp32 backward 1e-4; each call one launch, exactly;
    the planted faults (``wide_faults``) beyond the bars in bf16 at every
    H; both plans of each cell printed; the four bf16 forms timed in
    ``WIDE_ROUNDS`` alternating rounds of graph replays beside cuDNN's
    GRU or LSTM at the same H and shape (bidirectional, the GRU's window
    forward-only as uni_gru's) → {kernel name: {H: the kernel line's
    timings}}."""
    import torch

    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    t_phase = time.perf_counter()
    cases = lstm_cases(rng)
    dec, tr = cases[0], cases[1]
    wT, w_emit, _, _ = stream_shapes(LSTM_PRESET, 16)
    bf_shapes = {"decode": (dec[1], dec[2], dec[3]),
                 "train": (tr[1], tr[2], tr[3]),
                 "stream": (CHECK_B, wT, w_emit)}
    fB, fT = WIDE_FP32
    f_lens = torch.from_numpy(rng.integers(fT // 2, fT + 1, fB))
    f_lens[0] = fT
    fp_shapes = {"decode": (fB, fT, f_lens), "train": (fB, fT, f_lens),
                 "stream": (fB, fT // 2, fT // 4)}
    out = {n: {} for names in WIDE_KERNELS.values() for n in names}
    out["dw"] = {}
    counts: dict = {}
    faults = wide_faults(rc)
    for H in WIDE_H:
        for cell in ("gru", "lstm"):
            G = 3 if cell == "gru" else 4
            names = WIDE_KERNELS[cell]
            errs = {}
            for ndir in (2, 1):
                for dtag, cdt, shapes in (
                        ("bf16", torch.bfloat16, bf_shapes),
                        ("fp32", torch.float32, fp_shapes)):
                    r = wide_case(rc, dev, rng, cell, H, ndir, cdt, shapes,
                                  counts)
                    inputs = r.pop("inputs")
                    print(f"[rnn-widths] {cell} H={H} ndir={ndir} {dtag}: "
                          + ", ".join(f"{n} max abs {e:.3e} ({x:.3f} of the "
                                      f"bar)" for n, (e, x) in r.items()))
                    for n, (e, x) in r.items():
                        check(x <= 1, f"{n} H={H} ndir={ndir} {dtag}: "
                              f"{x:.3f} of its bar")
                        if dtag == "bf16":
                            errs[n] = max(errs.get(n, 0.0), e)
                    if dtag == "bf16" and ndir == 2:
                        kept = inputs
            # planted faults, bf16, ndir 2, at the training shape
            xs, lo, hi, g, res_p, args_p, want = kept["train"]
            w = kept["w"]
            fres = []
            for fname, (form, layout) in faults.items():
                attr = f"wide_{form}_weights"
                orig = getattr(rc, attr)
                setattr(rc, attr, layout)
                try:
                    if form == "fwd":
                        got = getattr(rc, f"{cell}_scan_train_cuda")(
                            xs, w, lo, hi, torch.bfloat16)
                        ex = max(excess(a, b, 0.0, TOL["gru_bf16"])
                                 for a, b in zip(got, res_p))
                    else:
                        got = getattr(rc, f"{cell}_bwd_cuda")(*args_p)
                        got = got if cell == "gru" else (got,)
                        wl = want if cell == "gru" else (want,)
                        ex = max(excess(a, b, 2 ** -7, TOL["gru_grad_bf16"],
                                        scale=b.float().abs().max())
                                 for a, b in zip(got, wl))
                    torch.cuda.synchronize()
                finally:
                    setattr(rc, attr, orig)
                fres.append(f"{fname} {ex:.2f}x")
                check(ex > 1, f"{cell} H={H}: the planted fault {fname} "
                      f"stays within the bar ({ex:.3f})")
            print(f"[rnn-widths] {cell} H={H} planted faults (bf16, ndir 2, "
                  f"training shape), share of the bar: " + ", ".join(fres))
            for form in ("fwd", "bwd"):
                print_rnn_plan(cell, "rnn-widths", H, tr[1], 2, form)
            if cell == "lstm" and H in WIDE_DW_H:
                # dW (not a new kernel) on the wide layer's own ys and dxs
                ys_k, cs_k, gates_k = rc.lstm_scan_train_cuda(
                    xs, w, lo, hi, torch.bfloat16)
                dxs_k = rc.lstm_bwd_cuda(gates_k, w, lo, hi, cs_k, g,
                                         torch.bfloat16)
                out["dw"][str(H)] = dw_check(f"rnn-widths dw H={H}", dev,
                                             ys_k, (dxs_k,), tr[1])
                del ys_k, cs_k, gates_k, dxs_k
            # timing, bf16: the residual-free form at the decode shape,
            # the training pair at the training shape, the window; beside
            # cuDNN at the same shapes (the GRU's window forward-only)
            cdt = torch.bfloat16
            dxs, dlo, dhi = kept["decode"]
            txs, tlo, thi = kept["train"][:3]
            sxs, slo, shi, sh0, s_emit, s_lens = kept["stream"]
            lib = library_rnn_fns(cell, dev, dec[2], dec[1], H, dec[3], cdt)
            libt = library_rnn_fns(cell, dev, tr[2], tr[1], H, tr[3], cdt)
            # the stream window: the GRU's forward-only, as uni_gru's
            s_ndir = 1 if cell == "gru" else 2
            if s_ndir == 1:
                sxs = sxs[:, :CHECK_B].contiguous()
                slo, shi, sh0 = slo[:CHECK_B], shi[:CHECK_B], sh0[:CHECK_B]
                sw = kept["w"][:1].contiguous()
            else:
                sw = kept["w"]
            libs = library_stream(cell, dev, wT, CHECK_B, H, s_ndir,
                                  s_lens.long(), sh0, cdt)
            kfns = {
                names[0]: lambda: getattr(rc, f"{cell}_scan_cuda")(
                    dxs, w, dlo, dhi, cdt),
                names[1]: lambda: getattr(rc, f"{cell}_scan_train_cuda")(
                    txs, w, tlo, thi, cdt),
                names[2]: lambda: getattr(rc, f"{cell}_bwd_cuda")(*args_p),
                names[3]: lambda: getattr(rc, f"{cell}_scan_stream_cuda")(
                    sxs, sw, slo, shi, sh0, cdt, s_emit)}
            rounds = rnn_graph_rounds(
                f"rnn-widths {cell} H={H}", kfns,
                {"forward": lib["forward"],
                 "training forward": libt["training forward"],
                 "forward+backward": libt["forward+backward"],
                 "window (hx = h0)": libs},
                rounds=WIDE_ROUNDS, calls=WIDE_CALLS)
            med = {n: statistics.median(r) for n, r in rounds.items()}
            pfns = {
                names[0]: lambda: getattr(rc, f"{cell}_scan_plain")(
                    dxs, w, dlo, dhi, cdt),
                names[1]: lambda: getattr(rc, f"{cell}_scan_train_plain")(
                    txs, w, tlo, thi, cdt),
                names[2]: (lambda: rc.gru_bwd_plain(
                    args_p[0], w, tlo, thi, rc.shift_prev(args_p[4]),
                    args_p[5], cdt)) if cell == "gru" else (
                    lambda: rc.lstm_bwd_plain(*args_p)),
                names[3]: lambda: getattr(rc, f"{cell}_scan_stream_plain")(
                    sxs, sw, slo, shi, sh0, cdt, s_emit)}
            esz = 2
            w_bytes = lambda nd: nd * H * G * H * esz
            live_d = 2 * int(dec[3].sum())
            live_t = 2 * int(tr[3].sum())
            live_s = int((shi - slo).sum())
            n_res = 4 * H * esz + (4 * H if cell == "lstm" else 0)
            bounds = {
                names[0]: bound(live_d * (G * H * esz + 4 * H) + w_bytes(2),
                                2 * live_d * H * G * H, "bf16"),
                names[1]: bound(live_t * (G * H * esz + 4 * H + n_res)
                                + w_bytes(2), 2 * live_t * H * G * H,
                                "bf16"),
                names[2]: bound(live_t * (n_res + (0 if cell == "lstm"
                                                   else 4 * H) + 4 * H
                                          + G * H * esz
                                          + (H * esz if cell == "gru"
                                             else 0)) + w_bytes(2),
                                2 * live_t * G * H * H, "bf16"),
                names[3]: bound(live_s * (G * H * esz + 4 * H)
                                + w_bytes(s_ndir), 2 * live_s * H * G * H,
                                "bf16")}
            libms = {names[0]: med["cuDNN forward"],
                     names[1]: med["cuDNN training forward"],
                     names[2]: med["cuDNN backward"],
                     names[3]: med["cuDNN window (hx = h0)"]}
            for n in names:
                t = dict(max_abs_err=errs[n], ms=med[n],
                         plain_ms=time_ms(pfns[n], warmup=0, reps=1),
                         library_ms=libms[n], **bounds[n])
                out[n][str(H)] = t
                print(f"[rnn-widths] {n} H={H} bf16: {t['ms']:.4f} ms "
                      f"(graph), plain {t['plain_ms']:.3f} ms, cuDNN "
                      f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} "
                      f"ms ({t['bound_by']}), share "
                      f"{t['bound_ms'] / t['ms']:.4f}, cuDNN / kernel "
                      f"{t['library_ms'] / t['ms']:.3f}")
    print(f"[rnn-widths] every checked call launched its kernel exactly "
          f"once: {counts}; phase 32 took "
          f"{time.perf_counter() - t_phase:.3f} s")
    return out


def phase_rnn_wide_path(root, vocab, wavs, audio_s, data, index, dev,
                        rng) -> dict:
    """Phase 33: the wide recurrences through the CLIs at
    ``model.rnn_hidden`` = ``WIDE_PATH_H`` (W streamed), ``auto`` routing:
    bilstm_deep (five BiLSTM layers of 1024) through the decode CLI on the
    64 wavs with exact launches and 4 wavs' logits card vs CPU; through
    the train CLI in the default data mode (``phase_cached_preset``: 24
    steps, K = 8 a CUDA-graph replay, exact launches, the step-16
    checkpoint resumed to 24 bitwise), one step card vs CPU; the evaluate
    CLI on that run's checkpoint (exact launches); the stream CLI from a
    causal-CMVN checkpoint
    (``phase_stream``: exact launches, window logits card vs CPU); then
    uni_gru (four forward-only GRU layers of 1024): its training in the
    default data mode with resume, one step card vs CPU, and its stream
    CLI, decode CLI and --raw (``phase_stream``). No layer call takes the
    plain scan (``rnn_cuda.ROUTED["scan"]`` unchanged). → {kernel name:
    its launches on this path}."""
    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.cli import evaluate
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda

    t_phase = time.perf_counter()
    routed = dict(rnn_cuda.ROUTED)
    over = {"model.rnn_hidden": WIDE_PATH_H}
    sets = (f"model.rnn_hidden={WIDE_PATH_H}",)
    check(rnn_cuda.kernel_takes(WIDE_PATH_H)
          and WIDE_PATH_H > rnn_cuda.RESIDENT_MAX,
          "phase 33's width is not one of the streamed-W form's")
    out = {}
    ckpt = write_checkpoint(root, LSTM_PRESET, rng, over, name="lstm_wide")
    dec, _ = phase_decode("wide-lstm-decode", ckpt, vocab, wavs, audio_s,
                          DECODE_LAUNCHES[LSTM_PRESET])
    out["lstm_fwd"] = dec["lstm_fwd"]
    phase_parity(ckpt, wavs, dev, "wide-lstm-parity")
    step_s, busy, tr = phase_cached_preset(root, data, LSTM_PRESET, sets,
                                           name="lstm_wide")
    out.update({k: tr[k] for k in ("lstm_fwd_train", "lstm_bwd", "dw")})
    phase_train_parity(dev, index, LSTM_PRESET, over,
                       tag="wide-lstm-train-parity")
    # evaluate: the trained run's last checkpoint on the dev set, card and
    # CPU
    run_ckpt = os.path.join(root, "cache_ckpt_lstm_wide_run")
    layers = preset_config(LSTM_PRESET).model.rnn_layers
    n_batches = -(-DEV_UTTS // TRAIN_B)
    _kernels.reset_launches()
    lines, _, wall = run_cli(evaluate.main, [
        "--ckpt-dir", run_ckpt, "--data-dir", data, "--index",
        "dev_index.jsonl"])
    got = _kernels.launches()
    res = _result_line(lines)[""]
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"frontend_logmel": n_batches, "ctc_fwd": n_batches,
                 "greedy": n_batches, "lstm_fwd": layers * n_batches})
    check_launches("wide-lstm-evaluate", got, want)
    check(res[2] == DEV_UTTS and np.isfinite(res[1]),
          f"wide evaluate: {lines}")
    print(f"[wide-lstm-evaluate] {lines[-1]} ({wall:.3f} s, launches "
          f"exact)")
    st = phase_stream(root, vocab, wavs, audio_s, LSTM_PRESET, dev, rng,
                      over, tag="wide-lstm-stream")
    out["lstm_fwd_stream"] = st["lstm_fwd_stream"]
    ustep, ubusy, utr = phase_cached_preset(root, data, UNI_PRESET, sets,
                                            name="uni_wide")
    out.update({k: utr[k] for k in ("gru_fwd", "gru_fwd_train", "gru_bwd")})
    phase_train_parity(dev, index, UNI_PRESET, over,
                       tag="wide-uni-train-parity")
    ust = phase_stream(root, vocab, wavs, audio_s, UNI_PRESET, dev, rng,
                       over, tag="wide-uni-stream")
    out["gru_fwd_stream"] = ust["gru_fwd_stream"]
    calls = {k: rnn_cuda.ROUTED[k] - routed[k] for k in routed}
    print(f"[wide-path] H = {WIDE_PATH_H}: bilstm_deep warm step "
          f"{step_s * 1e3:.3f} ms (busy {busy:.4f}), uni_gru "
          f"{ustep * 1e3:.3f} ms (busy {ubusy:.4f}); layer calls by path "
          f"{calls}; launches on the path {out}; phase 33 took "
          f"{time.perf_counter() - t_phase:.3f} s")
    check(calls["scan"] == 0 and calls["kernel"] > 0,
          f"phase 33: a layer call took the plain scan ({calls})")
    check(all(n > 0 for n in out.values()), f"phase 33: a wide kernel not "
          f"launched on the path: {out}")
    return out


def _result_line(lines: list[str], prefix: str = "") -> dict:
    """The evaluate CLI's result line(s) → {tag: (CER, loss, utts, edits,
    ref chars)}, tag "" for a one-set run."""
    out = {}
    for l in lines:
        m = re.match(r"(?:\[(\S+)\] )?CER(?:\[streaming\])? ([0-9.]+) \| "
                     r"(?:loss ([0-9.]+) \| )?(\d+) utts \| (\d+) edits / "
                     r"(\d+) ref chars", l)
        if m:
            out[m.group(1) or ""] = (
                float(m.group(2)), None if m.group(3) is None
                else float(m.group(3)), int(m.group(4)), int(m.group(5)),
                int(m.group(6)))
    return out


def phase_parity_path(root: str, dev, rng) -> None:
    """Phase 22, the parity path at the full width of ``PRESET``: a
    confusable corpus from make_synthetic, preprocess --pack, training from
    train.pack (exact launches, every batch int16 on the card), evaluate
    on the index and the pack of the dev set (identical hypotheses and
    edits, exact launches a batch, the mean loss card vs CPU) and evaluate
    --streaming against the stream CLI on the same wavs (identical
    transcripts, stream launches from ``stream_geometry``). The CERs of
    random weights are printed, not gated."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.cli import (
        evaluate, make_synthetic, preprocess, stream)
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import load_index
    from chainer_speech_recognition_tpu_torch.decode.streaming import (
        stream_geometry)
    from chainer_speech_recognition_tpu_torch.train import loop
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    t_phase = time.perf_counter()
    corpus, prep = os.path.join(root, "parity_corpus"), os.path.join(
        root, "parity_prep")
    run_cli(make_synthetic.main, ["--out", corpus, *PARITY_SYNTH])
    run_cli(preprocess.main, ["--corpus", corpus, "--out", prep,
                              "--dev-fraction", "0.25", "--pack"])
    vocab_path = os.path.join(prep, "vocab.txt")
    V = len(Vocab.load(vocab_path))
    dev_utts = load_index(os.path.join(prep, "dev_index.jsonl"))
    n_dev = len(dev_utts)
    print(f"[parity-path] {PARITY_SYNTH[3]} confusable utterances "
          f"({n_dev} dev), V = {V}, synthesized, indexed and packed in "
          f"{time.perf_counter() - t_phase:.3f} s")

    # train from train.pack; every training batch crosses as int16
    wire: list = []
    to_device = loop.to_device

    def watched(batch, device):
        out = to_device(batch, device)
        if "signals_i16" in out:
            wire.append((out["signals_i16"].dtype, out["signals_i16"].device))
        return out

    ckpt = os.path.join(root, "parity_train_ckpt")
    metrics = os.path.join(root, "parity_train.jsonl")
    _kernels.reset_launches()
    loop.to_device = watched
    t0 = time.perf_counter()
    try:
        run_cli(train_cli.main, [
            "--data-dir", prep, "--preset", PRESET, "--device", "cuda",
            "--ckpt-dir", ckpt, "--metrics", metrics, "--set",
            "train.data_mode=stream", "train.log_every=1",
            f"train.total_steps={TRAIN_STEPS}",
            f"train.eval_every={TRAIN_STEPS}",
            f"train.checkpoint_every={TRAIN_STEPS}", "optim.warmup_steps=4",
            *PARITY_BUCKETS])
    finally:
        loop.to_device = to_device
    train_s = time.perf_counter() - t0
    launches = _kernels.launches()
    ev = _events(metrics)
    steps = [e for e in ev if e["kind"] == "train"]
    evals = [e for e in ev if e["kind"] == "eval"]
    print(f"[parity-path] train from train.pack: {TRAIN_STEPS} steps in "
          f"{train_s:.3f} s, loss {steps[0]['loss']:.3f} -> "
          f"{steps[-1]['loss']:.3f}, dev eval {evals}, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check([e["step"] for e in steps] == list(range(1, TRAIN_STEPS + 1))
          and all(np.isfinite(e["loss"]) for e in steps),
          "parity-path training steps")
    check(len(wire) == TRAIN_STEPS and all(
        d == torch.int16 and v.type == dev.type for d, v in wire),
        f"packed batches on the card: {wire[:3]} ({len(wire)} of "
        f"{TRAIN_STEPS})")
    print(f"[parity-path] all {len(wire)} training batches crossed as "
          f"{wire[0][0]} on {wire[0][1]}")
    layers = preset_config(PRESET).model.rnn_layers
    n_eval = len(evals) * -(-n_dev // PARITY_BUCKET_B)
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"gru_fwd_train": layers * TRAIN_STEPS,
                 "gru_bwd": layers * TRAIN_STEPS, "dw": layers * TRAIN_STEPS,
                 "gru_fwd": layers * n_eval, "ctc_bwd": TRAIN_STEPS,
                 "ctc_fwd": TRAIN_STEPS + n_eval,
                 "frontend_logmel": TRAIN_STEPS + n_eval, "greedy": n_eval})
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the parity-path training run, expected {n}")

    # evaluate: the trained checkpoint on the pack, then a random-weight
    # causal-CMVN checkpoint (whose hypotheses are not empty) on both sets
    lines, _, _ = run_cli(evaluate.main, [
        "--ckpt-dir", ckpt, "--data-dir", prep, "--index", "dev.pack"])
    res = _result_line(lines)[""]
    check(res[2] == n_dev and np.isfinite(res[1]),
          f"evaluate of the trained checkpoint: {lines}")
    print(f"[parity-path] trained checkpoint: {lines[-1]} (16 steps: not "
          f"gated)")
    rckpt = write_checkpoint(root, PRESET, rng, {
        "model.vocab_size": V, "features.cmvn_mode": "causal",
        **{k: json.loads(v) for k, v in (kv.split("=", 1)
                                         for kv in PARITY_BUCKETS)}})
    hyp = os.path.join(root, "parity_hyp.txt")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    lines, err, wall = run_cli(evaluate.main, [
        "--ckpt-dir", rckpt, "--data-dir", prep, "--index",
        "dev_index.jsonl,dev.pack", "--hyp-out", hyp])
    launches = _kernels.launches()
    res = _result_line(lines)
    print(f"[parity-path] evaluate (card, random weights) in {wall:.3f} s, "
          f"launches { {k: v for k, v in launches.items() if v} }")
    for l in lines + err.splitlines():
        print(f"[parity-path]   {l}")
    a, b = res.get("dev_index"), res.get("dev")
    check(a is not None and b is not None and a == b and a[2] == n_dev,
          f"index and pack sets score differently: {res}")
    hyps = [open(f"{os.path.splitext(hyp)[0]}.{s}.txt",
                 encoding="utf-8").read() for s in ("dev_index", "dev")]
    check(hyps[0] == hyps[1] and hyps[0].count("\n") == n_dev,
          "index and pack hypotheses differ")
    check(any(l.split("\t")[1] for l in hyps[0].splitlines()),
          "every hypothesis is empty: the comparison would be vacuous")
    n_batches = 2 * -(-n_dev // PARITY_BUCKET_B)
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"frontend_logmel": n_batches, "ctc_fwd": n_batches,
                 "greedy": n_batches, "gru_fwd": layers * n_batches})
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches in "
              f"evaluate, expected {n}")
    clines, _, cwall = run_cli(evaluate.main, [
        "--ckpt-dir", rckpt, "--data-dir", prep, "--index", "dev.pack",
        "--device", "cpu"])
    cres = _result_line(clines)[""]
    rel = abs(b[1] - cres[1]) / abs(cres[1])
    print(f"[parity-path] mean loss card {b[1]:.4f} CPU {cres[1]:.4f} (rel "
          f"{rel:.3e}, tol {TOL['gru_bf16']}); CER card {b[0]:.4f} CPU "
          f"{cres[0]:.4f} ({cwall:.3f} s on the CPU)")
    check(rel <= TOL["gru_bf16"], "evaluate's loss, card vs CPU")

    # evaluate --streaming against the stream CLI on the same wavs and batch
    model = load_model(rckpt, device=dev)[1]
    geo = stream_geometry(model, STREAM_CHUNK, 16)
    B = min(16, n_dev)
    order = sorted(u.num_samples for u in dev_utts)
    windows = sum(-(-C.num_frames(max(order[i : i + B])) // geo["C"])
                  for i in range(0, n_dev, B))
    shyp = os.path.join(root, "parity_stream_hyp.txt")
    _kernels.reset_launches()
    lines, _, wall = run_cli(evaluate.main, [
        "--ckpt-dir", rckpt, "--data-dir", prep, "--streaming",
        "--stream-chunk", str(STREAM_CHUNK), "--stream-right", "16",
        "--stream-batch", str(B), "--hyp-out", shyp])
    launches = _kernels.launches()
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"frontend_logmel": windows,
                 "gru_fwd_stream": layers * windows})
    print(f"[parity-path] evaluate --streaming in {wall:.3f} s: "
          f"{lines[1]}; {windows} windows, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches in "
              f"evaluate --streaming, expected {n}")
    slines, _, _ = run_cli(stream.main, [
        "--ckpt-dir", rckpt, "--vocab", vocab_path, "--batch", str(B),
        "--chunk-frames", str(STREAM_CHUNK), "--right-frames", "16",
        *[u.wav for u in dev_utts]])
    by_wav = dict(l.split("\t") for l in slines)
    got = [l.split("\t") for l in open(shyp, encoding="utf-8").read()
           .splitlines()]
    check([g[0] for g in got] == [u.utt_id for u in dev_utts]
          and [g[1] for g in got] == [by_wav[u.wav] for u in dev_utts],
          "evaluate --streaming and the stream CLI transcribe differently")
    check(any(g[1] for g in got), "every streaming hypothesis is empty")
    took = time.perf_counter() - t_phase
    print(f"[parity-path] evaluate --streaming equals the stream CLI on all "
          f"{n_dev} wavs; phase 22 took {took:.3f} s (budget "
          f"{PARITY_BUDGET_S} s: {'within' if took <= PARITY_BUDGET_S else 'OVER'})")


def train_arpa(root: str, vocab_path: str, rng, order: int,
               n_texts: int = 400) -> str:
    """An ``order``-gram LM trained (``NGramLM.train``) on ``n_texts``
    random strings over the vocab's symbols and written as ARPA; → its
    path."""
    from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    vocab = Vocab.load(vocab_path)
    syms = vocab.symbols[1:]
    texts = ["".join(rng.choice(syms, size=int(rng.integers(5, 40))))
             for _ in range(n_texts)]
    path = os.path.join(root, f"lm_{order}gram.arpa")
    NGramLM.train(texts, vocab, order=order).to_arpa(path, vocab)
    return path


def beam_same(tag: str, got, want) -> float:
    """One beam launch's outputs against the plain version's: chars,
    counts, parent0 and the integer state exactly, the final scores and
    the state's pb / pnb within ``TOL["beam_score"]``; → the largest score
    difference."""
    import torch

    for name, a, b in zip(("chars", "counts", "parent0"), got[:3], want[:3]):
        check(torch.equal(a, b), f"{tag}: {name} differ from the plain "
              f"version's")
    for i, (a, b) in enumerate(zip(got[4][2:], want[4][2:])):
        check(torch.equal(a, b), f"{tag}: state array {i + 2} (hashes, "
              "parent hashes, last, LM context) differs from the plain "
              "version's")
    err = max(float((a - b).abs().max()) for a, b in (
        (got[3], want[3]), (got[4][0], want[4][0]), (got[4][1], want[4][1])))
    check(err <= TOL["beam_score"], f"{tag}: scores differ by {err:.3e}")
    return err


@contextlib.contextmanager
def beam_checked(log: list):
    """Within the block every beam launch on the card (``decode.beam.
    beam_chunk``) is held to the plain version on the same inputs
    (``beam_same``; the plain version launches nothing); ``log`` gets one
    score difference a launch."""
    from chainer_speech_recognition_tpu_torch.decode import beam

    orig = beam.beam_chunk

    def checked(lp, lengths, state, dlm, alpha, beta, keep, width, ordered):
        got = orig(lp, lengths, state, dlm, alpha, beta, keep, width,
                   ordered)
        want = beam.beam_chunk_plain(lp, lengths, state, dlm, alpha, beta,
                                     keep, width, ordered)
        log.append(beam_same("beam on the CLI path", got, want))
        return got

    beam.beam_chunk = checked
    try:
        yield
    finally:
        beam.beam_chunk = orig


def beam_cli_runs(ckpt, sckpt, vocab, wavs, audio_s, K: int, arpa: str,
                  kernel: str) -> int:
    """The decode CLI with ``--beam K --lm arpa`` (``ckpt``) and the stream
    CLI with the same (``sckpt``, causal CMVN, chunk 64 + 16) over the
    wavs: every beam launch held to the plain version on its inputs
    (``beam_checked``), exact launches (the beam form ``kernel`` once a
    decode chunk and a stream window, the other form never), warm reruns
    equal to the cold runs; → the decode CLI's launches of ``kernel``."""
    import wave

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.cli import stream
    from chainer_speech_recognition_tpu_torch.config import preset_config

    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch",
            str(BATCH), "--device", "cuda", "--beam", str(K), "--lm", arpa,
            "--lm-alpha", str(BEAM_ALPHA), "--lm-beta", str(BEAM_BETA),
            *wavs]
    diffs: list = []
    _kernels.reset_launches()
    with beam_checked(diffs):
        lines, cold = run_decode(args)
    launches = _kernels.launches()
    decode_launches = launches[kernel]
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({**DECODE_LAUNCHES[PRESET], "greedy": 0,
                 kernel: -(-len(wavs) // BATCH)})
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the --beam {K} decode path, expected {n}")
    check(len(diffs) == want[kernel], "not every beam launch was checked")
    check([l.split("\t")[0] for l in lines] == wavs and all(
        len(l.split("\t")) == 2 for l in lines), "beam decode output")
    check(any(l.split("\t")[1] for l in lines), "every transcript is empty")
    lines2, warm = run_decode(args)
    check(lines2 == lines, "warm beam decode differs from the cold one")
    print(f"[beam-decode] decode --beam {K} --lm (3-gram, dense): cold "
          f"{cold:.3f} s (launches "
          f"{ {k: v for k, v in launches.items() if v} }, each beam launch "
          f"equal to the plain version on its logits), warm {warm:.3f} s: "
          f"{len(wavs) / warm:.3f} utt/s, RTF {warm / audio_s:.6f}")

    lens_w = []
    for w in wavs:
        with wave.open(w, "rb") as f:
            lens_w.append(f.getnframes())
    order = sorted(lens_w)
    windows = sum(-(-C.num_frames(max(order[i : i + BATCH])) // STREAM_CHUNK)
                  for i in range(0, len(order), BATCH))
    layers = preset_config(PRESET).model.rnn_layers
    sargs = ["--ckpt-dir", sckpt, "--vocab", vocab, "--device", "cuda",
             "--batch", str(BATCH), "--chunk-frames", str(STREAM_CHUNK),
             "--right-frames", "16", "--beam", str(K), "--lm", arpa,
             "--lm-alpha", str(BEAM_ALPHA), "--lm-beta", str(BEAM_BETA),
             *wavs]
    diffs = []
    _kernels.reset_launches()
    with beam_checked(diffs):
        slines, _, swall = run_cli(stream.main, sargs)
    launches = _kernels.launches()
    want = {k: 0 for k in _kernels.KERNELS}
    want.update({"frontend_logmel": windows, "gru_fwd_stream":
                 layers * windows, kernel: windows})
    for name, n in want.items():
        check(launches[name] == n, f"{name}: {launches[name]} launches on "
              f"the --beam {K} stream path, expected {n}")
    check(len(diffs) == windows, "not every stream beam launch was checked")
    check([l.split("\t")[0] for l in slines] == wavs, "stream output order")
    check(any(l.split("\t")[1] for l in slines), "every streamed transcript "
          "is empty")
    slines2, _, swarm = run_cli(stream.main, sargs)
    check(slines2 == slines, "warm beam stream differs from the cold one")
    print(f"[beam-stream] stream --beam {K} --lm, chunk {STREAM_CHUNK} + "
          f"16: {windows} windows (one beam launch each, equal to the plain "
          f"version on its logits), cold {swall:.3f} s, warm {swarm:.3f} s: "
          f"{len(wavs) / swarm:.3f} utt/s, RTF {swarm / audio_s:.6f}")
    for l in slines[:2]:
        print(f"[beam-stream] {os.path.basename(l.split(chr(9))[0])}: "
              f"{l.split(chr(9))[1][:40]!r}")
    return decode_launches


def phase_beam(root, ckpt, vocab, wavs, audio_s, dev,
               rng) -> tuple[dict, int]:
    """Phase 23, config 4: the prefix beam kernel against its plain version
    at the decode shape (B = 32, T' = 251, K = 8; V = 64 with no LM, the
    dense 3-gram and a hashed 4-gram with fp16 rows; V = 2048 without an
    LM), chunked decoding equal to offline on the card with one launch a
    chunk, the kernel timed by graph replays in alternating rounds with
    the plain version (eager), then the decode CLI (--beam 8 --lm) and the
    stream CLI (--beam 8 --lm, causal CMVN) on the 64 wavs with exact
    launches and every launch held to the plain version on its inputs.
    → (the kernel line's timings, the decode CLI's beam launches)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode import beam
    from chainer_speech_recognition_tpu_torch.decode.lm import (
        HashedLM, NGramLM, device_lm)
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    t_phase = time.perf_counter()
    B, T, K = CHECK_B, BEAM_FRAMES, BEAM_WIDTH
    V = preset_config(PRESET).model.vocab_size
    vocab_obj = Vocab.load(vocab)
    arpa3, arpa4 = (train_arpa(root, vocab, rng, n) for n in (3, 4))
    dense = device_lm(NGramLM.from_arpa(arpa3, vocab_obj), "auto")
    h = NGramLM.from_arpa(arpa4, vocab_obj).to_hashed()
    hashed16 = HashedLM(h.table, h.rows.astype(np.float16), h.order,
                        h.max_probes)
    check(isinstance(dense, tuple), "the 3-gram should take the dense table")
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype(np.int32))
    lens[0] = T
    lens = lens.to(dev)

    def logits_of(V_):
        x = rng.standard_normal((B, T, V_)).astype(np.float32) * 2
        path = rng.integers(0, V_, (B, T))
        for b in range(B):
            x[b, np.arange(T), path[b]] += 3.0
        return torch.from_numpy(x).to(dev)

    errs, case = {}, {}
    for name, V_, lm in (("V=64 no LM", V, None), ("V=64 dense 3-gram", V,
                                                   dense),
                         ("V=64 hashed 4-gram fp16", V, hashed16),
                         ("V=2048 no LM", 2048, None)):
        logits = logits_of(V_)
        lp = beam._log_probs(logits)
        dlm = beam.lm_on_device(lm, V_, dev)
        a, b = BEAM_ALPHA, BEAM_BETA
        for ordered, keep in ((True, 1), (True, K), (False, K)):
            s0 = beam.beam_stream_init(B, K, dlm.ctx_len, dev)
            got = beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, keep, T,
                                            ordered)
            torch.cuda.synchronize()
            want = beam.beam_chunk_plain(lp, lens, s0, dlm, a, b, keep, T,
                                         ordered)
            errs[(name, ordered, keep)] = beam_same(f"beam {name}", got,
                                                    want)
        case[name] = (logits, lp, dlm, a, b)
    print(f"[beam] kernel = plain version at B={B}, T'={T}, K={K} (ids, "
          f"n-best, counts, parent beams, hash state exact; offline 1-best, "
          f"offline n-best and the chunk form): max score difference "
          + ", ".join(f"{n} {max(e for k, e in errs.items() if k[0] == n):.2e}"
                      for n in case))

    # chunked == offline on the card, one launch a chunk
    logits, lp, dlm, a, b = case["V=64 dense 3-gram"]
    _kernels.reset_launches()
    offline = beam.beam_decode(logits, lens, beam=K, lm=dense,
                               alpha=BEAM_ALPHA, beta=BEAM_BETA)
    check(_kernels.BEAM.launches == 1, "offline beam: "
          f"{_kernels.BEAM.launches} launches, expected 1")
    dec = beam.BeamStreamDecoder(B, beam=K, lm=dense, alpha=BEAM_ALPHA,
                                 beta=BEAM_BETA)
    n_chunks = 0
    for c0 in range(0, T, BEAM_CHUNK):
        n = torch.clamp(lens - c0, 0, BEAM_CHUNK)
        dec.step(logits[:, c0 : c0 + BEAM_CHUNK], n)
        n_chunks += 1
    check(_kernels.BEAM.launches == 1 + n_chunks,
          f"chunked beam: {_kernels.BEAM.launches - 1} launches for "
          f"{n_chunks} chunks")
    check(dec.finish() == offline, "chunked beam differs from offline")
    print(f"[beam] {n_chunks} chunks of {BEAM_CHUNK} frames, one launch "
          "each, equal the offline 1-best (one launch) on all "
          f"{B} rows")

    # time: the kernel as graph replays, the plain version eagerly, in turns
    s0 = beam.beam_stream_init(B, K, dlm.ctx_len, dev)
    kernel = lambda: beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, 1, T,
                                               True)[0]
    plain = lambda: beam.beam_chunk_plain(lp, lens, s0, dlm, a, b, 1, T,
                                          True)[0]
    replay, res = graph_of(kernel)
    replay()
    torch.cuda.synchronize()
    check(torch.equal(res, plain()), "the beam's replay differs from the "
          "plain version")
    rounds = {"kernel": [], "plain": []}
    for _ in range(BEAM_ROUNDS):
        rounds["kernel"].append(time_ms(replay, warmup=0, reps=1)
                                / GRAPH_CALLS)
        rounds["plain"].append(time_ms(plain, warmup=0, reps=1))
    med = {n: statistics.median(r) for n, r in rounds.items()}
    # bytes: the live frames' log-probs, every LM row the hypotheses read
    # (distinct rows, by content), the outputs
    rows: list = []
    lm_rows = beam._lm_rows

    def collect(dlm_, ctx, V_):
        out = lm_rows(dlm_, ctx, V_)
        rows.append(out.reshape(-1, V_))
        return out

    beam._lm_rows = collect
    try:
        beam.beam_chunk_plain(lp, lens, s0, dlm, a, b, 1, T, True)
    finally:
        beam._lm_rows = lm_rows
    n_rows = torch.unique(torch.cat(rows), dim=0).shape[0]
    live = int(lens.sum())
    n_bytes = (live * V + n_rows * V) * 4 + B * (T + 2 + K * 8 + K * 2) * 4
    t = dict(max_abs_err=max(errs.values()), ms=med["kernel"],
             plain_ms=med["plain"], library_ms=None,
             **bound(n_bytes, 0, "fp32"))
    print(f"[beam] main-path shape (V={V}, dense 3-gram, K={K}, 1-best), "
          f"{BEAM_ROUNDS} alternating rounds (kernel: graph replays, plain: "
          f"eager), medians: kernel {med['kernel']:.4f} ms "
          f"({med['kernel'] / T * 1e3:.3f} us a frame; rounds "
          f"{min(rounds['kernel']):.4f}-{max(rounds['kernel']):.4f}), plain "
          f"{med['plain']:.3f} ms ({med['plain'] / med['kernel']:.1f}x); "
          f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}: {live} live "
          f"frames, {n_rows} distinct LM rows), share "
          f"{t['bound_ms'] / t['ms']:.4f}: the frame chain, not the bytes, "
          "sets the pace; no PyTorch call computes a prefix beam")
    logits2, lp2, dlm2, a2, b2 = case["V=2048 no LM"]
    s2 = beam.beam_stream_init(B, K, dlm2.ctx_len, dev)
    k2 = time_ms(lambda: beam_cuda.beam_chunk_cuda(
        lp2, lens, s2, dlm2, a2, b2, 1, T, True), warmup=1, reps=3)
    print(f"[beam] V=2048, no LM: kernel {k2:.4f} ms eager "
          f"({k2 / T * 1e3:.3f} us a frame), plan "
          f"{beam_cuda.beam_plan(T, 2048, K)}")

    sckpt = write_checkpoint(root, PRESET, rng,
                             {"features.cmvn_mode": "causal"})
    decode_launches = beam_cli_runs(ckpt, sckpt, vocab, wavs, audio_s, K,
                                    arpa3, "beam")
    took = time.perf_counter() - t_phase
    print(f"[beam] phase 23 took {took:.3f} s (budget {BEAM_BUDGET_S} s: "
          f"{'within' if took <= BEAM_BUDGET_S else 'OVER'})")
    return t, decode_launches


# phase 34: the beam's wide form (K > 32 or an LM context past 8 lanes) at
# phase 23's decode shape; K = 32 is the narrow form's, beside it
BEAM_WIDE_KS = (32, 33, 64, 128, 256)
BEAM_WIDE_K = 64                      # the CLIs' and the chunked check's
BEAM_WIDE_ORDER = 10                  # the hashed LM: 9 context lanes
BEAM_WIDE_TEXTS = 60                  # its training strings (~7 k contexts)
BEAM_WIDE_BUDGET_S = 40.0


def beam_bytes(lens, V: int, K: int, CL: int, n_rows: int, row_bytes: int,
               keep: int, width: int) -> int:
    """Bytes one beam launch must move: the live frames' log-probs, each
    distinct LM row its hypotheses read, the lengths, the state in and out,
    the final scores and the kept beams' chars, counts and parents."""
    B = lens.shape[0]
    state = B * K * (7 + CL) * 4
    return (int(lens.sum()) * V * 4 + n_rows * V * row_bytes + B * 4
            + 2 * state + B * K * 4 + B * keep * (width + 2) * 4)


def phase_beam_widths(root, ckpt, vocab, wavs, audio_s, dev,
                      rng) -> tuple[dict, int]:
    """Phase 34: the beam kernel's wide form against its plain version at
    the decode shape (B = 32, T' = 251, V = 64) at K = 33, 64, 128, 256
    without an LM and with the dense 3-gram, at K = 64 with a hashed
    10-gram of fp16 rows and at V = 2048 without an LM, and the narrow
    form at K = 32 beside them: the n-best form, ids, counts, parents and
    the hash state exact, scores within ``TOL["beam_score"]``, each case
    one launch of its form and none of the other; 16-frame chunks equal
    the offline 1-best at K = 64, one launch a chunk; each case's 1-best
    form timed by graph replays in alternating rounds (the plain version:
    the one eager call of its check); then the decode and stream CLIs with
    ``--beam 64 --lm`` (``beam_cli_runs``). → (the kernel line's
    ``beam_wide`` entry, the decode CLI's wide launches)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode import beam
    from chainer_speech_recognition_tpu_torch.decode.lm import (
        HashedLM, NGramLM, device_lm)
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    t_phase = time.perf_counter()
    B, T, a, b = CHECK_B, BEAM_FRAMES, BEAM_ALPHA, BEAM_BETA
    V = preset_config(PRESET).model.vocab_size
    vocab_obj = Vocab.load(vocab)
    arpa3 = train_arpa(root, vocab, rng, 3)
    dense = device_lm(NGramLM.from_arpa(arpa3, vocab_obj), "auto")
    h = NGramLM.from_arpa(train_arpa(root, vocab, rng, BEAM_WIDE_ORDER,
                                     BEAM_WIDE_TEXTS), vocab_obj).to_hashed()
    hashed16 = HashedLM(h.table, h.rows.astype(np.float16), h.order,
                        h.max_probes)
    check(isinstance(dense, tuple), "the 3-gram should take the dense table")
    lens = torch.from_numpy(rng.integers(T // 2, T + 1, B).astype(np.int32))
    lens[0] = T
    lens = lens.to(dev)

    def logits_of(V_):
        x = rng.standard_normal((B, T, V_)).astype(np.float32) * 2
        path = rng.integers(0, V_, (B, T))
        for r in range(B):
            x[r, np.arange(T), path[r]] += 3.0
        return torch.from_numpy(x).to(dev)

    lg, lg2048 = logits_of(V), logits_of(2048)
    cases = [(f"K={K} {n}", K, lg, lm) for K in BEAM_WIDE_KS
             for n, lm in (("no LM", None), ("dense 3-gram", dense))]
    cases += [(f"K={BEAM_WIDE_K} hashed {BEAM_WIDE_ORDER}-gram fp16",
               BEAM_WIDE_K, lg, hashed16),
              (f"K={BEAM_WIDE_K} V=2048 no LM", BEAM_WIDE_K, lg2048, None)]
    # the distinct LM rows a plain run reads, by a checksum of each row
    sums: list = []
    lm_rows = beam._lm_rows

    def collect(dlm_, ctx, V_):
        out = lm_rows(dlm_, ctx, V_)
        w = torch.linspace(1.0, 2.0, V_, dtype=torch.float64, device=dev)
        sums.append(torch.unique(out.reshape(-1, V_).double() @ w))
        return out

    res, replays, calls, inputs = {}, {}, {}, []
    for name, K, logits, lm in cases:
        lp = beam._log_probs(logits)
        V_ = lp.shape[2]
        dlm = beam.lm_on_device(lm, V_, dev)
        s0 = beam.beam_stream_init(B, K, dlm.ctx_len, dev)
        plan = beam_cuda.beam_plan(T, V_, K, dlm.ctx_len)
        form = "beam_wide" if plan.wide else "beam"
        _kernels.reset_launches()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        got = beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, K, T, True)
        e1.record()
        torch.cuda.synchronize()
        # a graph holds ~20 ms of calls: one for the slowest cases
        calls[name] = max(1, min(GRAPH_CALLS, int(20 / e0.elapsed_time(e1))))
        launched = {k: n for k, n in _kernels.launches().items() if n}
        check(launched == {form: 1}, f"beam {name}: launches {launched}, "
              f"expected one of {form}")
        sums.clear()
        beam._lm_rows = collect
        try:
            e0.record()
            want = beam.beam_chunk_plain(lp, lens, s0, dlm, a, b, K, T, True)
            e1.record()
            torch.cuda.synchronize()
        finally:
            beam._lm_rows = lm_rows
        err = beam_same(f"beam {name}", got, want)
        n_rows = int(torch.unique(torch.cat(sums)).numel()) if sums else 0
        row_bytes = 2 if dlm.rows is not None and \
            dlm.rows.dtype == torch.float16 else 4
        n_bytes = beam_bytes(lens, V_, K, dlm.ctx_len, n_rows, row_bytes, 1, T)
        replay, out = graph_of(
            lambda lp=lp, s0=s0, dlm=dlm: beam_cuda.beam_chunk_cuda(
                lp, lens, s0, dlm, a, b, 1, T, True)[0], calls[name])
        replay()
        torch.cuda.synchronize()
        check(torch.equal(out, want[0][:, :1]), f"beam {name}: the 1-best "
              "replay differs from the plain version's best beam")
        replays[name] = replay
        inputs.append((lp, s0, dlm))      # the graph reads them at replay
        res[name] = dict(form=form, plan=tuple(plan), max_abs_err=err,
                         plain_ms=e0.elapsed_time(e1), n_rows=n_rows,
                         **bound(n_bytes, 0, "fp32"))
    rounds = {n: [] for n in replays}
    for _ in range(BEAM_ROUNDS):
        for n, replay in replays.items():
            rounds[n].append(time_ms(replay, warmup=0, reps=1) / calls[n])
    for name, r in res.items():
        r["ms"] = statistics.median(rounds[name])
        print(f"[beam-wide] {name} ({r['form']}, plan {r['plan']}): kernel "
              f"{r['ms']:.4f} ms ({r['ms'] / T * 1e3:.3f} us a frame; rounds "
              f"{min(rounds[name]):.4f}-{max(rounds[name]):.4f}), plain "
              f"{r['plain_ms']:.3f} ms (one eager call, "
              f"{r['plain_ms'] / r['ms']:.1f}x), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}, {r['n_rows']} distinct LM rows; share "
              f"{r['bound_ms'] / r['ms']:.5f}), max score difference "
              f"{r['max_abs_err']:.2e}")
    print(f"[beam-wide] every case equals the plain version (n-best ids, "
          f"counts, parents, hash state exact; scores within "
          f"{TOL['beam_score']}), one launch of its form; the 1-best "
          f"replays equal its best beam; {BEAM_ROUNDS} alternating rounds of "
          f"graph replays ({GRAPH_CALLS} calls a graph, fewer where a call "
          "takes over 2 ms); the frame chain, not the bytes, sets the pace; "
          "no PyTorch call computes a prefix beam")

    # chunked == offline on the card at K = 64, one launch a chunk
    K = BEAM_WIDE_K
    _kernels.reset_launches()
    offline = beam.beam_decode(lg, lens, beam=K, lm=dense, alpha=a, beta=b)
    dec = beam.BeamStreamDecoder(B, beam=K, lm=dense, alpha=a, beta=b)
    n_chunks = 0
    for c0 in range(0, T, BEAM_CHUNK):
        dec.step(lg[:, c0 : c0 + BEAM_CHUNK],
                 torch.clamp(lens - c0, 0, BEAM_CHUNK))
        n_chunks += 1
    launched = {k: n for k, n in _kernels.launches().items() if n}
    check(launched == {"beam_wide": 1 + n_chunks}, f"chunked beam at K={K}: "
          f"launches {launched}, expected {1 + n_chunks} of beam_wide")
    check(dec.finish() == offline, f"chunked beam at K={K} differs from "
          "offline")
    print(f"[beam-wide] K={K}, dense 3-gram: {n_chunks} chunks of "
          f"{BEAM_CHUNK} frames, one wide launch each, equal the offline "
          f"1-best (one launch) on all {B} rows")

    sckpt = write_checkpoint(root, PRESET, rng,
                             {"features.cmvn_mode": "causal"},
                             name="bigru_beam_wide")
    decode_launches = beam_cli_runs(ckpt, sckpt, vocab, wavs, audio_s, K,
                                    arpa3, "beam_wide")
    wide = {n: r for n, r in res.items() if r["form"] == "beam_wide"}
    main = wide[f"K={K} dense 3-gram"]
    t = dict(max_abs_err=max(r["max_abs_err"] for r in wide.values()),
             ms=main["ms"], plain_ms=main["plain_ms"], library_ms=None,
             bound_ms=main["bound_ms"], bound_by=main["bound_by"],
             cases={n: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "max_abs_err")}
                    for n, r in wide.items()})
    took = time.perf_counter() - t_phase
    print(f"[beam-wide] phase 34 took {took:.3f} s (budget "
          f"{BEAM_WIDE_BUDGET_S} s: "
          f"{'within' if took <= BEAM_WIDE_BUDGET_S else 'OVER'})")
    return t, decode_launches


# phase 24, the device cache: phase 8's corpus trained from the device-
# resident bf16 feature cache, CACHE_K steps a dispatch (one CUDA-graph
# replay), with the default train.data_mode
CACHE_K, CACHE_RESUME = 8, 24
CACHE_BUDGET_S = 45.0
ROTATE_GB = 0.06          # 3 windows of the corpus at the residency peak
# the planted race: 6 windows of 32 rows (2 batches), one dispatch of K = 2
# each; the training stream sleeps ~0.25 s before each dispatch, so the
# fetch of window w+2 runs while window w's replay waits in the stream
RACE_GB, RACE_K, RACE_STEPS = 0.027, 2, 12
RACE_SLEEP_CYCLES = 500_000_000
CAPTURE_WAIT_S = 20.0     # a held fetch's wait for a capture, and back


def ckpt_arrays(path: str) -> dict:
    """Every array of a checkpoint's parameters and optimizer state, by
    path in the tree."""
    from chainer_speech_recognition_tpu_torch.checkpoint import (
        msgpack_restore)

    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        else:
            out[prefix] = np.asarray(v)

    walk("", {"params": tree["params"], "opt_state": tree["opt_state"]})
    return out


def ckpt_gap(a: str, b: str) -> float:
    """Largest |difference| between two checkpoints' arrays (parameters,
    moments and counts); inf where their trees differ."""
    x, y = ckpt_arrays(a), ckpt_arrays(b)
    if set(x) != set(y):
        return float("inf")
    return max(float(np.max(np.abs(x[k].astype(np.float64)
                                    - y[k].astype(np.float64))))
               if x[k].size else 0.0 for k in x)


@contextlib.contextmanager
def cached_variant(eager: bool = False, sleep: int = 0,
                   skip_release_wait: bool = False,
                   overlap: list | None = None):
    """Run the train CLI's cached step eagerly on the card (``eager``),
    with the training stream asleep ``sleep`` cycles before each dispatch, with the planted race (the
    window fetch skips its wait for the last dispatch that read the buffer
    set it overwrites), or (``overlap``, a list) with each window fetch
    after the first held until a graph capture has begun and the capture
    held open until that fetch (its allocations, pinned copies and
    front-end launches) is done: ``overlap`` gets, for each capture,
    whether a fetch ran inside it."""
    import functools
    import threading

    import torch

    from chainer_speech_recognition_tpu_torch.data import device_cache
    from chainer_speech_recognition_tpu_torch.train import loop

    make = loop.make_cached_train_step
    wait = device_cache.RotatingDeviceCache._await_release
    fetch = device_cache.RotatingDeviceCache.fetch_window
    begin = torch.cuda.CUDAGraph.capture_begin

    def patched(*args, **kw):
        call = functools.partial(make, _eager=eager)(*args, **kw)
        if not sleep:
            return call

        def slept(state, bucket_id, slots):
            torch.cuda._sleep(sleep)
            return call(state, bucket_id, slots)

        slept.graphs = call.graphs
        return slept

    loop.make_cached_train_step = patched
    if skip_release_wait:
        device_cache.RotatingDeviceCache._await_release = (
            lambda self, s: None)
    if overlap is not None:
        opened, done, fetches = threading.Event(), threading.Event(), [0]

        def gated_fetch(self, epoch, w, s):
            fetches[0] += 1
            if fetches[0] == 1:          # the run waits for it: no capture
                return fetch(self, epoch, w, s)
            opened.wait(CAPTURE_WAIT_S)
            try:
                return fetch(self, epoch, w, s)
            finally:
                done.set()

        def gated_begin(self, *args, **kw):
            begin(self, *args, **kw)
            opened.set()
            overlap.append(done.wait(CAPTURE_WAIT_S))
            opened.clear()
            done.clear()

        device_cache.RotatingDeviceCache.fetch_window = gated_fetch
        torch.cuda.CUDAGraph.capture_begin = gated_begin
    try:
        yield
    finally:
        loop.make_cached_train_step = make
        device_cache.RotatingDeviceCache._await_release = wait
        device_cache.RotatingDeviceCache.fetch_window = fetch
        torch.cuda.CUDAGraph.capture_begin = begin


def cached_train(data: str, name: str, root: str, preset: str, steps: int,
                 sets=(), profile: bool = False, fresh: bool = True,
                 **variant) -> tuple[list[dict], dict, float, str]:
    """One in-process train CLI run on the card with the default data mode
    (dotted ``sets`` added) → (its events, the kernel launches of the run,
    its wall in s, the final checkpoint's path)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.checkpoint import (
        latest_checkpoint)
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli

    ckpt = os.path.join(root, f"cache_ckpt_{name}")
    metrics = os.path.join(root, f"cache_{name}.jsonl")
    n_before = len(_events(metrics)) if os.path.exists(metrics) else 0
    args = ["--data-dir", data, "--preset", preset, "--device", "cuda",
            "--ckpt-dir", ckpt, "--metrics", metrics]
    if profile:
        args += ["--profile-dir", os.path.join(root, f"prof_cache_{name}")]
    if not fresh:
        check(latest_checkpoint(ckpt) is not None,
              f"{name}: nothing to resume")
    _kernels.reset_launches()
    t0 = time.perf_counter()
    with cached_variant(**variant), \
            contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(args + ["--set", "optim.warmup_steps=4",
                               f"train.total_steps={steps}", *sets])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (_events(metrics)[n_before:], _kernels.launches(), wall,
            latest_checkpoint(ckpt))


def cached_want(cfg, steps: int, n_eval: int, fe_build: int) -> dict:
    """Exact kernel launches of a cached training run: ``fe_build``
    front-end launches at the cache's build (none a step in feature mode),
    each training kernel its count a step times ``steps``, and the eval
    batches' forward launches."""
    from chainer_speech_recognition_tpu_torch import _kernels

    want = {name: 0 for name in _kernels.KERNELS}
    cell, layers = cfg.model.rnn_type, cfg.model.rnn_layers
    if cell != "none":
        want.update({f"{cell}_fwd_train": layers * steps,
                     f"{cell}_bwd": layers * steps,
                     f"{cell}_fwd": layers * n_eval})
        if cfg.model.compute_dtype == "bfloat16":
            want["dw"] = layers * steps
    if cfg.model.attn_impl == "flash":
        blocks = cfg.model.attn_blocks
        want.update({"flash_fwd": blocks * (steps + n_eval),
                     "flash_bwd_dq": blocks * steps,
                     "flash_bwd_dkv": blocks * steps})
    want.update({"ctc_bwd": steps, "ctc_fwd": steps + n_eval,
                 "frontend_logmel": fe_build + n_eval, "greedy": n_eval})
    return want


def check_launches(tag: str, got: dict, want: dict) -> None:
    for name, n in want.items():
        check(got[name] == n, f"{tag}: {name} launched {got[name]} times, "
              f"expected {n}")


def third_dispatch_s(ev: list) -> float:
    """A step's wall in a cached run's third dispatch (one replay, no
    eval or profiler): from the end of the step-16 checkpoint to the log
    of step 24, over K."""
    t = {e["step"]: e["t"] for e in ev if e["kind"] == "train"}
    t.update({e["step"]: e["t"] for e in ev if e["kind"] == "checkpoint"
              and e["step"] == 2 * CACHE_K})
    return (t[3 * CACHE_K] - t[2 * CACHE_K]) / CACHE_K


def phase_cached_preset(root: str, data: str, preset: str, sets=(),
                        resume: bool = True,
                        name: str | None = None) -> tuple[float, float, dict]:
    """One preset through the train CLI in phase 24 (and uni_gru's in
    phase 27) → (warm step wall s, busy share, the run's launches). The
    default program trains 24 steps: the log line, exact launches, the
    busy share over the profiled replay of steps 8-15 and the step wall
    from the third dispatch (a replay with no eval, checkpoint or
    profiler inside it: timed from the end of the step-16 checkpoint). The run checkpoints at 16 too (the replay check and
    phase 25 hold it); with ``resume``, a copy of that checkpoint resumed
    to 24 must end bitwise where the run ended. ``name`` (the preset's by
    default) names the run's directories and its log tag."""
    import shutil

    from chainer_speech_recognition_tpu_torch.config import preset_config

    name = name or preset
    tag = f"cache-{name}"
    cfg = preset_config(preset).override(
        dict(kv.split("=", 1) for kv in sets))
    ev, launches, wall, end = cached_train(
        data, f"{name}_run", root, preset, CACHE_RESUME,
        [*sets, "train.log_every=1", f"train.eval_every={CACHE_RESUME}",
         f"train.checkpoint_every={TRAIN_STEPS}"], profile=True)
    mode = [e for e in ev if e["kind"] == "data_mode"][0]
    print(f"[{tag}] {json.dumps(mode)}")
    check(mode["mode"] == "device_cache" and mode["cache_features"]
          and mode["steps_per_dispatch"] == CACHE_K and mode["graphs"],
          f"{preset}: the default data mode is not the bf16 feature cache "
          f"at K = {CACHE_K} with graphs")
    train = [e for e in ev if e["kind"] == "train"]
    evals = [e for e in ev if e["kind"] == "eval"]
    check([e["step"] for e in train] == [CACHE_K, 2 * CACHE_K, 3 * CACHE_K]
          and all(np.isfinite(e["loss"]) and e["grad_norm"] > 0
                  for e in train), f"{preset}: dispatch metrics {train}")
    check([e["step"] for e in evals] == [CACHE_RESUME]
          and evals[0]["num_utts"] == DEV_UTTS, f"{preset}: dev eval {evals}")
    n_eval = -(-DEV_UTTS // TRAIN_B)
    fe_build = -(-TRAIN_UTTS // 32)          # one bucket holds the corpus
    check_launches(tag, launches, cached_want(cfg, CACHE_RESUME, n_eval,
                                              fe_build))
    step_s = third_dispatch_s(ev)
    busy, window_ms, top = _busy_share(os.path.join(
        root, f"prof_cache_{name}_run", "trace.json"))
    print(f"[{tag}] {CACHE_RESUME} steps in {wall:.3f} s (cache build, "
          f"capture and eval included), launches exact ({fe_build} "
          f"front-end launches at the build, none a step); warm step "
          f"{step_s * 1e3:.3f} ms (the third dispatch, one replay / "
          f"{CACHE_K}), {TRAIN_B / step_s:.3f} utt/s; device busy "
          f"{busy:.4f} of the {window_ms:.3f} ms profiled window (the "
          f"replay of steps 8-15)")
    for kernel, us in top[:6]:
        print(f"[{tag}] device time {us / 1e3:9.3f} ms  {kernel[:90]}")
    print(f"[{tag}] the run's log, s from the logger's start: " + ", ".join(
        f"{e['kind']}{'@' + str(e['step']) if 'step' in e else ''} "
        f"{e['t']:.3f}" + (f" ({e['seconds']} s)" if "seconds" in e else "")
        for e in ev if e["kind"] in ("data_mode", "compile", "train",
                                     "eval", "checkpoint", "profile"))
          + f"; the whole call {wall:.3f} s")
    if resume:
        src = os.path.dirname(end)
        check(sorted(os.listdir(src)) == [
            "config.json", f"step_{TRAIN_STEPS:08d}.msgpack",
            f"step_{CACHE_RESUME:08d}.msgpack"], f"{preset}: checkpoints "
            f"{sorted(os.listdir(src))}")
        dst = os.path.join(root, f"cache_ckpt_{name}_resumed")
        os.makedirs(dst)
        for f in os.listdir(src):
            if f != os.path.basename(end):
                shutil.copy(os.path.join(src, f), dst)
        rev, _, w_res, resumed = cached_train(
            data, f"{name}_resumed", root, preset, CACHE_RESUME, sets,
            fresh=False)
        res = [e for e in rev if e["kind"] == "resume"]
        check(len(res) == 1 and res[0]["step"] == TRAIN_STEPS,
              f"{preset}: resume events {res}")
        rgap = ckpt_gap(resumed, end)
        print(f"[{tag}] resumed at {TRAIN_STEPS} from the run's checkpoint, "
              f"stopped at {CACHE_RESUME}: max |diff| to that run's end "
              f"{rgap:.3e} (bar: bitwise) [a run of {w_res:.3f} s]")
        check(rgap == 0, f"{preset}: the resumed run differs from the "
              f"unbroken one by {rgap:.3e}")
    return step_s, busy, launches


SEEDED: dict = {}      # model config → the weights drawn from SEED (CPU)


def seeded_model(cfg, dev):
    """``cfg.model`` with the weights ``init_parameters`` draws from SEED,
    on ``dev``; the draws are made once a model config (a second at full
    width on the host)."""
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model, init_parameters)

    model = build_model(cfg.model)
    key = repr(cfg.model)
    if key not in SEEDED:
        init_parameters(model, SEED)
        SEEDED[key] = {k: v.clone() for k, v in model.state_dict().items()}
    else:
        model.load_state_dict(SEEDED[key])
    return model.to(dev)


def cached_steps(cfg, cache, plan, dev, eager: bool):
    """A model from SEED through ``plan``'s dispatches of the cached step,
    eagerly or (the first dispatch eager, then replays) through its graph
    → (state, each dispatch's metrics)."""
    import torch

    from chainer_speech_recognition_tpu_torch.train.state import init_state
    from chainer_speech_recognition_tpu_torch.train.step import (
        make_cached_train_step)

    model = seeded_model(cfg, dev)
    state = init_state(model, cfg.optim, SEED)
    step = make_cached_train_step(model, cfg, cache, CACHE_K, _eager=eager)
    check(step.graphs == (not eager), "cached step: graphs on the card")
    ms = [step(state, bid, torch.from_numpy(slots).to(dev))
          for bid, slots in plan]
    torch.cuda.synchronize()
    return state, ms


def state_gap(a, b) -> float:
    """Largest |difference| between two (state, metrics) runs: parameters,
    Adam moments and counts, and each dispatch's metrics."""
    (sa, ma), (sb, mb) = a, b
    out = [float((x.float() - y.float()).abs().max()) for x, y in zip(
        sa.model.state_dict().values(), sb.model.state_dict().values())]
    adam_a, adam_b = sa.opt_state["1"]["0"], sb.opt_state["1"]["0"]
    for key in ("mu", "nu"):
        out += [float((adam_a[key][k] - adam_b[key][k]).abs().max())
                for k in adam_a[key]]
    out.append(abs(int(adam_a["count"]) - int(adam_b["count"])))
    out += [abs(float(x[k]) - float(y[k])) for x, y in zip(ma, mb)
            for k in x]
    return max(out)


def state_arrays(state) -> dict:
    """A train state's arrays by path in the checkpoint tree, as
    ``ckpt_arrays`` reads them from a file."""
    from chainer_speech_recognition_tpu_torch.bridge import (
        opt_state_to_flax, state_dict_to_flax)

    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        else:
            out[prefix] = np.asarray(v)

    walk("", {"params": {"params": state_dict_to_flax(
        state.model.state_dict())},
              "opt_state": opt_state_to_flax(state.opt_state)})
    return out


def phase_cached_replay(root: str, dev, cache, plan) -> None:
    """The replay against eager steps, with the algorithms the program
    runs: 2 dispatches of K = 8 from the same weights at full width, in
    process eagerly, against the same 16 steps of the preset's CLI run in
    this phase (the first dispatch eager, then one replay; the cache, the
    plan, the weights and the draws are the same): parameters, Adam
    moments and counts of its step-16 checkpoint and the metrics it
    logged at steps 8 and 16, bitwise. Two eager runs of bigru and of
    bilstm_deep must be bitwise equal too (the steps are repeatable)."""
    from chainer_speech_recognition_tpu_torch.config import preset_config

    for preset, sets in ((PRESET, {}), (LSTM_PRESET, {}),
                         (CONF_PRESET, {"model.attn_impl": "flash"})):
        cfg = preset_config(preset).override(
            {"optim.warmup_steps": 4, **sets})
        t0 = time.perf_counter()
        eager = [cached_steps(cfg, cache, plan, dev, True)
                 for _ in range(1 if preset == CONF_PRESET else 2)]
        graph = ckpt_arrays(os.path.join(
            root, f"cache_ckpt_{preset}_run", f"step_{TRAIN_STEPS:08d}.msgpack"))
        mine = state_arrays(eager[0][0])
        logged = {e["step"]: e for e in _events(os.path.join(
            root, f"cache_{preset}_run.jsonl")) if e["kind"] == "train"}
        gap = max([float(np.max(np.abs(graph[k].astype(np.float64)
                                       - mine[k].astype(np.float64))))
                   if set(graph) == set(mine) else float("inf")
                   for k in mine]
                  + [abs(logged[(i + 1) * CACHE_K][k] - float(m[k]))
                     for i, m in enumerate(eager[0][1]) for k in m])
        spread = (f"eager vs eager {state_gap(*eager):.3e}, "
                  if len(eager) == 2 else "")
        print(f"[cache-replay-{preset}] {2 * CACHE_K} steps: {spread}the "
              f"CLI run's replay vs eager {gap:.3e} (bar: bitwise) "
              f"[{time.perf_counter() - t0:.3f} s]")
        check(len(eager) == 1 or state_gap(*eager) == 0,
              f"{preset}: two eager runs differ")
        check(gap == 0, f"{preset}: the replay differs from eager steps by "
              f"{gap:.3e}")


def repeatable_gradients(dev, cache, plan) -> None:
    """Why the steps are repeatable: bigru's pieces each run twice on the
    same inputs (one batch of the cache), on the card, with the default
    algorithms: the model's backward from one fixed gradient of its
    logits and the CTC loss's gradient w.r.t. fixed logits must be
    bitwise equal; beside them, the emission gather's own backward
    (``torch.gather``'s scatter-add with atomics, which ``ops/ctc`` does
    not use), printed."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops.ctc import extend_labels
    from chainer_speech_recognition_tpu_torch.train import step as step_mod

    cfg = preset_config(PRESET)
    model = seeded_model(cfg, dev)
    bid, slots = plan[0]
    batch = step_mod._gather(cache.buckets[bid],
                             torch.from_numpy(slots[0]).to(dev).long())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    names, params = zip(*model.named_parameters())

    def gap(fn) -> float:
        a, b = fn(), fn()
        return float((a - b).abs().max())

    with torch.no_grad():
        logits, olens = model(batch["features"], batch["frame_lengths"])
    dout = torch.randn(logits.shape, generator=gen, device=dev,
                       dtype=logits.dtype)

    def dparams():
        out, _ = model(batch["features"], batch["frame_lengths"])
        return torch.autograd.grad(out, params, dout, allow_unused=True)

    ga, gb = dparams(), dparams()
    differ = [n for n, x, y in zip(names, ga, gb)
              if x is not None and not torch.equal(x, y)]
    x0 = logits.detach()

    def dctc():
        x = x0.clone().requires_grad_()
        loss = step_mod._ctc(cfg)(x, olens, batch["labels"],
                                  batch["label_lengths"]).sum()
        return torch.autograd.grad(loss, x)[0]

    B, T, V = x0.shape
    ext = extend_labels(batch["labels"])[:, None, :]
    ext = ext.expand(B, T, ext.shape[-1])
    lp = torch.randn((B, T, V), generator=gen, device=dev)
    dext = torch.randn(ext.shape, generator=gen, device=dev)

    def dgather():
        x = lp.clone().requires_grad_()
        return torch.autograd.grad(torch.gather(x, 2, ext), x, dext)[0]

    ctc_gap, gather_gap = gap(dctc), gap(dgather)
    listed = f" ({', '.join(differ[:6])})" if differ else ""
    print(f"[cache-repeat] {PRESET}, each piece twice on the same inputs: "
          f"the model's backward from a fixed logits gradient: "
          f"{len(differ)} of {len(names)} parameter gradients differ"
          f"{listed}; the CTC loss's dlogits: max |diff| {ctc_gap:.3e}; "
          f"torch.gather's own backward ([{B}, {T}, {ext.shape[-1]}] into "
          f"V = {V}; not used): {gather_gap:.3e}")
    check(not differ and ctc_gap == 0, "the gradients are not repeatable")


def phase_cached_pcm(data: str, dev) -> None:
    """PCM-mode cached steps (the front-end in the step) against stream
    steps on the same rows: two dispatches of K = 8 (the warm-up and one
    replay) beside 16 stream steps, from the same weights, bitwise."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import load_index
    from chainer_speech_recognition_tpu_torch.data.device_cache import (
        DeviceCorpusCache)
    from chainer_speech_recognition_tpu_torch.data.sampler import (
        BatchLoader, BucketSampler)
    from chainer_speech_recognition_tpu_torch.train.loop import to_device
    from chainer_speech_recognition_tpu_torch.train.state import init_state
    from chainer_speech_recognition_tpu_torch.train.step import (
        make_train_step)
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    cfg = preset_config(PRESET).override({"optim.warmup_steps": 4})
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    vocab = Vocab.load(os.path.join(data, "vocab.txt"))
    loader = BatchLoader(utts, vocab, cfg.buckets)
    cache = DeviceCorpusCache(loader, BucketSampler(utts, cfg.buckets), dev)
    plan = [cache.epoch_dispatches(e, CACHE_K)[0] for e in (0, 1)]
    cached, _ = cached_steps(cfg, cache, plan, dev, eager=False)
    model = seeded_model(cfg, dev)
    state = init_state(model, cfg.optim, SEED)
    step = make_train_step(cfg)
    for bid, slots in plan:
        for row in slots:
            step(state, to_device(loader.load(
                bid, cache.utterance_indices(bid, row)), dev))
    torch.cuda.synchronize()
    gap = state_gap((cached, []), (state, []))
    print(f"[cache-pcm] {PRESET}, int16 PCM cache (front-end in the step), "
          f"2 dispatches of {CACHE_K} (the second "
          f"one replay) vs {2 * CACHE_K} stream steps on the same rows: max "
          f"|diff| of parameters, moments and counts {gap:.3e} (bar: "
          f"bitwise)")
    check(gap == 0, "PCM cached steps differ from stream steps")


def phase_rotating(root: str, data: str) -> None:
    """The rotating cache through the CLI: a budget that forces 3 windows
    trains 24 steps at K = 8 with each later window's fetch held inside a
    graph capture (launches exact: the window builds' front-end launches
    counted, the captured ones only through replays); then 6 windows at
    K = 2, 12 steps, with the training stream asleep before each dispatch, eagerly, through graphs
    and with the planted race (the fetch skips its wait): graphs equal
    eager bitwise, the race does not."""
    import math

    from chainer_speech_recognition_tpu_torch.config import preset_config

    cfg = preset_config(PRESET)
    sets = [f"train.device_cache_budget_gb={ROTATE_GB}", "train.log_every=1"]
    overlap: list = []
    ev, launches, wall, _ = cached_train(data, "rotating", root, PRESET,
                                         3 * CACHE_K, sets, overlap=overlap)
    mode = [e for e in ev if e["kind"] == "data_mode"][0]
    train = [e for e in ev if e["kind"] == "train"]
    print(f"[cache-rotating] {json.dumps(mode)}")
    check(mode["mode"] == "rotating" and mode["n_windows"] >= 3
          and mode["graphs"], "the rotating run's data mode")
    check([e["step"] for e in train] == [CACHE_K, 2 * CACHE_K, 3 * CACHE_K]
          and all(np.isfinite(e["loss"]) for e in train),
          f"rotating steps {train}")
    check(overlap == [True] * (mode["n_windows"] - 1),
          f"a window fetch inside each capture: {overlap}")
    rows = math.ceil(TRAIN_UTTS / mode["n_windows"])
    check_launches("cache-rotating", launches, cached_want(
        cfg, 3 * CACHE_K, 0, len(train) * math.ceil(rows / 32)))
    print(f"[cache-rotating] {mode['n_windows']} windows of {rows} rows, "
          f"{3 * CACHE_K} steps in {wall:.3f} s; the fetches of windows "
          f"2-{mode['n_windows']} each ran inside a graph capture (buffers, "
          f"pinned copies, front-end launches); launches exact")

    sets = [f"train.device_cache_budget_gb={RACE_GB}",
            f"train.steps_per_dispatch={RACE_K}"]
    runs = {name: cached_train(data, f"race_{name}", root, PRESET,
                               RACE_STEPS, sets, **kw)
            for name, kw in (
                ("eager", {"eager": True}),
                ("graph", {"sleep": RACE_SLEEP_CYCLES}),
                ("planted", {"sleep": RACE_SLEEP_CYCLES,
                             "skip_release_wait": True}))}
    mode = [e for e in runs["graph"][0] if e["kind"] == "data_mode"][0]
    check(mode["mode"] == "rotating" and mode["n_windows"] * RACE_K
          >= RACE_STEPS, f"race runs' data mode {mode}")
    good = ckpt_gap(runs["graph"][3], runs["eager"][3])
    bad = ckpt_gap(runs["planted"][3], runs["eager"][3])
    print(f"[cache-race] {mode['n_windows']} windows, K = {RACE_K}, "
          f"{RACE_STEPS} steps, the training stream asleep ~0.25 s a "
          f"dispatch: graphs vs eager max |diff| {good:.3e} (bar: bitwise); "
          f"with the planted race (no wait for the set's last replay) "
          f"{bad:.3e} [runs of {', '.join(f'{r[2]:.3f}' for r in runs.values())} s]")
    check(good == 0, "rotating windows differ from eager steps")
    check(bad > 0, "the planted race went unseen")


def phase_device_cache(root: str, data: str, dev,
                       stream_walls: dict) -> None:
    """Phase 24: the default data mode, the device-resident corpus."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import load_index
    from chainer_speech_recognition_tpu_torch.data.device_cache import (
        DeviceCorpusCache)
    from chainer_speech_recognition_tpu_torch.data.sampler import (
        BatchLoader, BucketSampler)
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    t_phase = time.perf_counter()
    walls = {}
    for preset, sets in ((PRESET, ()), (LSTM_PRESET, ()),
                         (CONF_PRESET, ("model.attn_impl=flash",))):
        walls[preset] = phase_cached_preset(root, data, preset, sets,
                                            resume=preset != CONF_PRESET)
    for preset, (step_s, busy, _) in walls.items():
        s_step, s_busy = stream_walls[preset]
        print(f"[cache] {preset}: step {step_s * 1e3:.3f} ms, busy "
              f"{busy:.4f} (device_cache, graphs) vs {s_step * 1e3:.3f} ms, "
              f"{s_busy:.4f} (stream, phases 8/13/21 of this run)")
    # one feature cache for the in-process runs: the three presets share
    # their buckets and front-end
    cfg = preset_config(PRESET)
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    loader = BatchLoader(utts, Vocab.load(os.path.join(data, "vocab.txt")),
                         cfg.buckets)
    cache = DeviceCorpusCache(loader, BucketSampler(utts, cfg.buckets), dev,
                              features_cfg=cfg.features)
    plan = [cache.epoch_dispatches(e, CACHE_K)[0] for e in (0, 1)]
    parts = {"the CLI runs": time.perf_counter() - t_phase}
    for name, fn in (("replay vs eager", lambda: phase_cached_replay(
                          root, dev, cache, plan)),
                     ("repeatable", lambda: repeatable_gradients(
                         dev, cache, plan)),
                     ("PCM", lambda: phase_cached_pcm(data, dev)),
                     ("rotating", lambda: phase_rotating(root, data))):
        t0 = time.perf_counter()
        fn()
        parts[name] = time.perf_counter() - t0
    print("[cache] " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
    took = time.perf_counter() - t_phase
    print(f"[cache] phase 24 took {took:.3f} s (budget {CACHE_BUDGET_S} s: "
          f"{'within' if took <= CACHE_BUDGET_S else 'OVER'})")


# phase 27: the forward-only presets' training through the train CLI
ONLINE_BUDGET_S = 40.0    # phases 26-28 together
UNI_LSTM_SETS = ("model.rnn_bidirectional=false",)   # bilstm_deep, ndir 1
UNI_LSTM_STEPS = 8                                    # one dispatch


def phase_uni_train(root: str, data: str, dev, index: str) -> dict:
    """Phase 27: uni_gru (4 forward-only GRU layers of 256, bf16) through
    the train CLI in the default data mode as phase 24 trains its presets
    (``phase_cached_preset``: 24 steps with the step-16 checkpoint, exact
    launches — 4 gru_fwd_train, 4 gru_bwd and 4 dw a step, all ndir 1 —
    the dev eval, the busy share, a copy of the step-16 checkpoint resumed
    to 24 bitwise); one step card vs CPU at phase 9's bars; then
    bilstm_deep with ``model.rnn_bidirectional=false`` (5 forward-only
    LSTM layers of 384, SpecAugment on) for one dispatch of 8 steps with
    exact launches → {"gru": the uni_gru run's launches, "lstm": the
    forward-only LSTM run's}."""
    from chainer_speech_recognition_tpu_torch.cli.common import (
        parse_overrides)
    from chainer_speech_recognition_tpu_torch.config import preset_config

    t_phase = time.perf_counter()
    step_s, busy, gru = phase_cached_preset(root, data, UNI_PRESET)
    phase_train_parity(dev, index, UNI_PRESET)
    cfg = preset_config(LSTM_PRESET).override(parse_overrides(
        list(UNI_LSTM_SETS)))
    check(cfg.model.rnn_bidirectional is False, "forward-only LSTM config")
    ev, lstm, wall, _ = cached_train(
        data, "uni_lstm", root, LSTM_PRESET, UNI_LSTM_STEPS,
        [*UNI_LSTM_SETS, "train.log_every=1",
         f"train.eval_every={UNI_LSTM_STEPS}"])
    train = [e for e in ev if e["kind"] == "train"]
    check([e["step"] for e in train] == [UNI_LSTM_STEPS]
          and np.isfinite(train[0]["loss"]) and train[0]["grad_norm"] > 0,
          f"forward-only LSTM: dispatch metrics {train}")
    check_launches("uni-lstm-train", lstm, cached_want(
        cfg, UNI_LSTM_STEPS, -(-DEV_UTTS // TRAIN_B), -(-TRAIN_UTTS // 32)))
    print(f"[uni-train] bilstm_deep forward-only ({cfg.model.rnn_layers} "
          f"layers of {cfg.model.rnn_hidden}, ndir 1): {UNI_LSTM_STEPS} "
          f"steps in {wall:.3f} s (cache build and capture included), loss "
          f"{train[0]['loss']:.4f}, launches exact "
          f"{ {k: v for k, v in lstm.items() if v} }")
    print(f"[uni-train] uni_gru warm step {step_s * 1e3:.3f} ms, busy "
          f"{busy:.4f}; phase 27 took {time.perf_counter() - t_phase:.3f} s")
    return {"gru": gru, "lstm": lstm}


# phase 25, config 5: data-parallel training on the card's one H100
DP_GLOO_STEPS = 4
DP_BUDGET_S = 30.0
DP_TIMEOUT_S = 300


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(port: int):
    """The environment ``torchrun --nproc_per_node=1`` gives its one
    rank."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def phase_dp_nccl(root: str, data: str) -> None:
    """Phase 25 (a): the train CLI as the one rank of an NCCL group, with
    phase 24's bigru program (the default data mode, 24 steps, dev eval at
    24, checkpoints at 16 and 24, the replay of steps 8-15 profiled): the
    all-reduces captured in the K = 8 replay, launches exact, the metrics,
    the eval and both checkpoints bitwise equal to phase 24's run without
    a group (an all-reduce over one rank is an identity; the rest is the
    same arithmetic); the all-reduces' device time in the profiled replay
    and the third dispatch's step wall beside phase 24's."""
    import torch
    import torch.distributed as dist

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.train import step as step_mod

    reduce_ = step_mod.all_reduce_
    captured: list = []

    def counted(mesh, t):
        if torch.cuda.is_current_stream_capturing():
            captured.append((mesh.size, dist.get_backend(mesh.group)))
        return reduce_(mesh, t)

    step_mod.all_reduce_ = counted
    try:
        with torchrun_env(_free_port()):
            ev, launches, wall, end = cached_train(
                data, "dp_nccl", root, PRESET, CACHE_RESUME,
                ["train.log_every=1", f"train.eval_every={CACHE_RESUME}",
                 f"train.checkpoint_every={TRAIN_STEPS}"], profile=True)
    finally:
        step_mod.all_reduce_ = reduce_
    check(not dist.is_initialized(), "the train CLI left its group")
    mode = [e for e in ev if e["kind"] == "data_mode"][0]
    check(mode["mode"] == "device_cache" and mode["graphs"]
          and mode["devices"] == 1, f"dp-nccl data mode {mode}")
    # two a step: the weight sum before the backward, the gradients after
    check(captured == [(1, "nccl")] * (2 * CACHE_K),
          f"all-reduces captured in the graph: {captured}")
    check_launches("dp-nccl", launches, cached_want(
        preset_config(PRESET), CACHE_RESUME, -(-DEV_UTTS // TRAIN_B),
        -(-TRAIN_UTTS // 32)))
    ref_ev = _events(os.path.join(root, f"cache_{PRESET}_run.jsonl"))
    keys = ("step", "loss", "grad_norm", "valid_frac", "cer", "num_utts")
    got, ref = ([[e.get(k) for k in keys] for e in x
                 if e["kind"] in ("train", "eval")] for x in (ev, ref_ev))
    check(got == ref, f"dp-nccl metrics {got} differ from phase 24's {ref}")
    ref_dir = os.path.join(root, f"cache_ckpt_{PRESET}_run")
    gap = max(ckpt_gap(os.path.join(os.path.dirname(end), f),
                       os.path.join(ref_dir, f))
              for f in (f"step_{TRAIN_STEPS:08d}.msgpack",
                        f"step_{CACHE_RESUME:08d}.msgpack"))
    _, window_ms, top = _busy_share(os.path.join(root, "prof_cache_dp_nccl",
                                                 "trace.json"))
    nccl = [(n, us) for n, us in top if "nccl" in n.lower()]
    nccl_ms = sum(us for _, us in nccl) / 1e3
    print(f"[dp-nccl] train CLI as rank 0 of an NCCL group of 1 (NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}), device_cache, "
          f"K = {CACHE_K}: {len(captured)} all-reduces captured in the "
          f"graph, launches exact, {CACHE_RESUME} steps in {wall:.3f} s; "
          f"metrics and eval equal phase 24's, checkpoints at "
          f"{TRAIN_STEPS} and {CACHE_RESUME} max |diff| {gap:.3e} (bar: "
          f"bitwise); warm step {third_dispatch_s(ev) * 1e3:.3f} ms vs "
          f"phase 24's {third_dispatch_s(ref_ev) * 1e3:.3f} ms (the third "
          f"dispatch, one replay / {CACHE_K})")
    print(f"[dp-nccl] the all-reduces' device time in the profiled replay "
          f"of steps 8-15 ({window_ms:.3f} ms window): {nccl_ms:.6f} ms, "
          f"{nccl_ms / CACHE_K:.6f} ms a step ({len(nccl)} NCCL kernel "
          f"names: {[n[:60] for n, _ in nccl]})")
    check(gap == 0, f"dp-nccl: the state differs from phase 24's by "
          f"{gap:.3e}")


def dp_args(data: str, root: str, name: str) -> list:
    """Phase 25 (b)'s train CLI arguments: stream mode, eager, no eval."""
    return ["--data-dir", data, "--preset", PRESET, "--device", "cuda",
            "--ckpt-dir", os.path.join(root, f"dp_{name}_ckpt"),
            "--metrics", os.path.join(root, f"dp_{name}.jsonl"), "--set",
            "train.data_mode=stream", "optim.warmup_steps=4",
            f"train.total_steps={DP_GLOO_STEPS}", "train.log_every=1",
            "train.eval_every=1000", "train.checkpoint_every=1000"]


def dp_gloo_rank(rank: int, world: int, store: str, data: str,
                 root: str) -> None:
    """One rank of phase 25 (b), in a process of its own: the train CLI
    inside a gloo group over the one card's tensors; writes its kernel
    launches to ``dp_gloo_rank{rank}.json``."""
    import torch
    import torch.distributed as dist

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli

    os.environ["LOCAL_RANK"] = "0"          # both ranks on card 0
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + store,
                            world_size=world, rank=rank)
    try:
        _kernels.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main(dp_args(data, root, "gloo"))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(root, f"dp_gloo_rank{rank}.json"), "w") as f:
        json.dump(_kernels.launches(), f)


def phase_dp_gloo(root: str, data: str) -> None:
    """Phase 25 (b): two ranks on the one card (NCCL refuses two ranks on
    one device, so a gloo group over the card's tensors), the train CLI
    in stream mode, 4 steps of bigru at full width, against one rank over
    the same global batches: each rank's launches exact, the losses at
    the train-loss bar, the parameters within the bf16 gradient bar
    (norm of the difference over the norm of the one rank's update:
    Adam may flip the update of a weight whose gradient is rounding
    noise)."""
    import multiprocessing as mp

    import torch

    from chainer_speech_recognition_tpu_torch.bridge import (
        state_dict_to_flax)
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model, init_parameters)

    ctx = mp.get_context("spawn")
    store = os.path.join(root, "dp_gloo_store")
    procs = [ctx.Process(target=dp_gloo_rank,
                         args=(r, 2, store, data, root)) for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        run_cli(train_cli.main, dp_args(data, root, "one"))   # meanwhile
        torch.cuda.synchronize()
        for p in procs:
            p.join(DP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    wall = time.perf_counter() - t0
    check(all(p.exitcode == 0 for p in procs),
          f"dp-gloo ranks exited {[p.exitcode for p in procs]}")
    cfg = preset_config(PRESET)
    want = cached_want(cfg, DP_GLOO_STEPS, 0, DP_GLOO_STEPS)
    for r in range(2):
        with open(os.path.join(root, f"dp_gloo_rank{r}.json")) as f:
            check_launches(f"dp-gloo rank {r}", json.load(f), want)
    two = [e for e in _events(os.path.join(root, "dp_gloo.jsonl"))
           if e["kind"] == "train"]
    one = [e for e in _events(os.path.join(root, "dp_one.jsonl"))
           if e["kind"] == "train"]
    check([e["step"] for e in two] == [e["step"] for e in one]
          == list(range(1, DP_GLOO_STEPS + 1)), f"dp-gloo steps {two}")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(two, one))
    x = ckpt_arrays(os.path.join(root, "dp_gloo_ckpt",
                                 f"step_{DP_GLOO_STEPS:08d}.msgpack"))
    y = ckpt_arrays(os.path.join(root, "dp_one_ckpt",
                                 f"step_{DP_GLOO_STEPS:08d}.msgpack"))
    model = build_model(cfg.model)          # the runs' initial weights
    init_parameters(model, cfg.train.seed)
    flat: dict = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, w in v.items():
                walk(f"{prefix}/{k}", w)
        else:
            flat[prefix] = np.asarray(v, np.float64)

    walk("/params/params", state_dict_to_flax(
        {k: v.numpy() for k, v in model.state_dict().items()}))
    keys = sorted(flat)
    check(set(keys) <= set(x) and set(x) == set(y),
          "dp-gloo checkpoints' parameter trees")
    diff = np.sqrt(sum(float(np.sum((x[k] - y[k]) ** 2)) for k in keys))
    step = np.sqrt(sum(float(np.sum((y[k] - flat[k]) ** 2)) for k in keys))
    worst = max(float(np.max(np.abs(x[k] - y[k]))) for k in keys)
    print(f"[dp-gloo] 2 ranks on one card (gloo over CUDA tensors), train "
          f"CLI, stream mode, {DP_GLOO_STEPS} steps of {PRESET} "
          f"(B = {TRAIN_B}, {TRAIN_B // 2} rows a rank) vs 1 rank on the "
          f"same batches: launches exact on each rank; loss rel diff "
          f"{rel:.3e} (tol {TOL['train_loss_rtol']}); parameters |diff| / "
          f"|update| {diff / step:.3e} (tol {TOL['gru_grad_bf16']}), max "
          f"|diff| {worst:.3e} [{wall:.3f} s, both runs]")
    check(rel <= TOL["train_loss_rtol"], "dp-gloo losses")
    check(diff / step <= TOL["gru_grad_bf16"], "dp-gloo parameters")


def phase_dp(root: str, data: str) -> None:
    """Phase 25, config 5: data-parallel training on the card."""
    t_phase = time.perf_counter()
    phase_dp_nccl(root, data)
    t_a = time.perf_counter() - t_phase
    phase_dp_gloo(root, data)
    took = time.perf_counter() - t_phase
    print(f"[dp] phase 25 took {took:.3f} s ((a) {t_a:.3f} s, (b) "
          f"{took - t_a:.3f} s; budget {DP_BUDGET_S} s: "
          f"{'within' if took <= DP_BUDGET_S else 'OVER'})")


def main() -> int:
    t_run = time.perf_counter()
    try:
        import torch

        kind, _ = phase_device()
        from chainer_speech_recognition_tpu_torch.config import preset_config
        dev = torch.device("cuda", 0)
        phase_build()
        rng = np.random.default_rng(SEED)
        # the bilstm_deep phases draw from a stream of their own, so the
        # bigru phases' inputs stay what they were before those phases
        lrng = np.random.default_rng(SEED + 1)
        srng = np.random.default_rng(SEED + 2)    # the streaming phases'
        timings = phase_kernels(dev, rng)
        timings.update(phase_train_kernels(dev, rng))
        timings.update(phase_lstm_kernels(dev, lrng))
        timings.update(phase_lstm_train_kernels(dev, lrng))
        # the one-direction training forms draw from a stream of their own
        t_new = time.perf_counter()
        uni_t = phase_uni_train_kernels(dev, np.random.default_rng(SEED + 6))
        new_walls = {26: time.perf_counter() - t_new}
        timings.update(phase_stream_kernels(dev, srng))
        # the attention phases draw from a stream of their own
        crng = np.random.default_rng(SEED + 3)
        timings.update(phase_attention_kernels(dev, crng))
        timings["frontend_logmel_frames"], frames_launches = \
            phase_frames_kernel(dev, crng)
        with tempfile.TemporaryDirectory() as root:
            ckpt, vocab, wavs, audio_s = phase_inputs(root, rng)
            launches, _ = phase_decode("decode", ckpt, vocab, wavs, audio_s,
                                       DECODE_LAUNCHES[PRESET])
            phase_parity(ckpt, wavs, dev, "parity")
            data = write_corpus(root, rng)
            train_launches, index, walls = phase_train(
                root, data, PRESET, resume_to=RESUME_STEPS)
            stream_walls = {PRESET: walls}
            phase_train_parity(dev, index, PRESET)
            lckpt = write_checkpoint(root, LSTM_PRESET, lrng)
            lstm_decode, _ = phase_decode("lstm-decode", lckpt, vocab, wavs,
                                          audio_s, DECODE_LAUNCHES[LSTM_PRESET])
            phase_parity(lckpt, wavs, dev, "lstm-parity")
            lstm_train, _, stream_walls[LSTM_PRESET] = phase_train(
                root, data, LSTM_PRESET)
            phase_train_parity(dev, index, LSTM_PRESET)
            uni_stream = phase_stream(root, vocab, wavs, audio_s, UNI_PRESET,
                                      dev, srng)
            lstm_stream = phase_stream(root, vocab, wavs, audio_s,
                                       LSTM_PRESET, dev, srng)
            long_wavs, long_s = write_long_wavs(
                root, crng, preset_config(CONF_PRESET).model.vocab_size)
            conf_decode = phase_conformer_decode(
                root, vocab, wavs, audio_s, long_wavs, long_s, dev, crng)
            phase_conformer_stream_decode(root, vocab, long_wavs, long_s,
                                          dev, crng)
            # conformer_stream online draws from a stream of its own
            t_new = time.perf_counter()
            cs_stream = phase_conformer_stream_online(
                root, vocab, wavs, audio_s, dev,
                np.random.default_rng(SEED + 7))
            new_walls[28] = time.perf_counter() - t_new
            conf_train, _, stream_walls[CONF_PRESET] = phase_train(
                root, data, CONF_PRESET,
                extra_sets=("model.attn_impl=flash",))
            phase_train_parity(dev, index, CONF_PRESET,
                               {"model.attn_impl": "flash"})
            # the parity path draws from a stream of its own
            phase_parity_path(root, dev, np.random.default_rng(SEED + 4))
            # so does config 4
            timings["beam"], beam_launches = phase_beam(
                root, ckpt, vocab, wavs, audio_s, dev,
                np.random.default_rng(SEED + 5))
            phase_device_cache(root, data, dev, stream_walls)
            phase_dp(root, data)
            t_new = time.perf_counter()
            uni_launches = phase_uni_train(root, data, dev, index)
            new_walls[27] = time.perf_counter() - t_new
            # phases 29-31 draw from a stream of their own
            wrng = np.random.default_rng(SEED + 8)
            t_new = time.perf_counter()
            width_t = phase_flash_widths(dev, wrng)
            width_walls = {29: time.perf_counter() - t_new}
            t_new = time.perf_counter()
            width_launches = phase_conformer_widths(
                root, vocab, long_wavs, long_s, data, index, dev, wrng)
            width_walls[30] = time.perf_counter() - t_new
            t_new = time.perf_counter()
            phase_glu(root, vocab, wavs, audio_s, data, index, dev, wrng)
            width_walls[31] = time.perf_counter() - t_new
            # phases 32-33 draw from a stream of their own
            hrng = np.random.default_rng(SEED + 9)
            t_new = time.perf_counter()
            rnn_width_t = phase_rnn_widths(dev, hrng)
            wide_walls = {32: time.perf_counter() - t_new}
            t_new = time.perf_counter()
            wide_launches = phase_rnn_wide_path(root, vocab, wavs, audio_s,
                                                data, index, dev, hrng)
            wide_walls[33] = time.perf_counter() - t_new
            # phase 34 draws from a stream of its own
            timings["beam_wide"], launches_wide = phase_beam_widths(
                root, ckpt, vocab, wavs, audio_s, dev,
                np.random.default_rng(SEED + 10))
        launches.update({k: train_launches[k] for k in (
            "gru_fwd_train", "gru_bwd", "ctc_fwd", "ctc_bwd")})
        launches["lstm_fwd"] = lstm_decode["lstm_fwd"]
        launches.update({k: lstm_train[k] for k in (
            "lstm_fwd_train", "lstm_bwd", "dw")})
        launches["gru_fwd_stream"] = uni_stream["gru_fwd_stream"]
        launches["lstm_fwd_stream"] = lstm_stream["lstm_fwd_stream"]
        launches["frontend_logmel_frames"] = frames_launches
        launches["flash_fwd"] = conf_decode["flash_fwd"]
        launches["flash_bwd_dq"] = conf_train["flash_bwd_dq"]
        launches["flash_bwd_dkv"] = conf_train["flash_bwd_dkv"]
        launches["beam"] = beam_launches
        launches["beam_wide"] = launches_wide
        check(cs_stream["frontend_logmel"] > 0, "conformer_stream online: "
              "no front-end launch")
        # the one-direction training forms: sub-entries of their kernels,
        # timed in phase 26, launched by phase 27's runs
        for name, cell, form in (("gru_fwd_train", "gru", "fwd_train"),
                                 ("gru_bwd", "gru", "bwd"),
                                 ("lstm_fwd_train", "lstm", "fwd_train"),
                                 ("lstm_bwd", "lstm", "bwd")):
            n = uni_launches[cell][name]
            check(n > 0, f"{name} ndir 1: no launch on the training path")
            timings[name]["ndir1"] = {"launches": n, **uni_t[cell][form]}
        for cell in ("gru", "lstm"):
            timings["dw"][f"ndir1_{cell}"] = {
                "launches": uni_launches[cell]["dw"], **uni_t[cell]["dw"]}
        # the head widths: sub-entries of the flash kernels, timed in phase
        # 29; launches from the main path's runs at dh 64 (phases 19, 21),
        # 128 and 256 (phase 30), none at the widths no preset reaches
        width_launches[64] = {n: launches[n] for n in FLASH}
        for name in FLASH:
            timings[name]["dh"] = {
                dh: {"launches": width_launches.get(int(dh), {}).get(name, 0),
                     **r} for dh, r in width_t[name].items()}
        for dh in (128, 256):
            check(all(width_launches[dh][n] > 0 for n in FLASH),
                  f"dh {dh}: a flash kernel not launched on the main path")
        # the hidden sizes past 512: sub-entries of the recurrence kernels,
        # timed in phase 32; launches from phase 33's runs at WIDE_PATH_H,
        # none at the widths no run reaches
        for name in [*WIDE_KERNELS["gru"], *WIDE_KERNELS["lstm"], "dw"]:
            timings[name]["H"] = {
                h: {"launches": wide_launches[name]
                    if int(h) == WIDE_PATH_H else 0, **r}
                for h, r in rnn_width_t[name].items()}
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "optax",
                                               "chainer_speech_recognition_tpu"))
        check(not loaded, f"JAX modules were imported: {loaded[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[chip_smoke] the online presets' phases: " + ", ".join(
        f"{k} {new_walls[k]:.3f} s" for k in sorted(new_walls))
        + f", together {sum(new_walls.values()):.3f} s (budget "
        f"{ONLINE_BUDGET_S} s: "
        + ("within" if sum(new_walls.values()) <= ONLINE_BUDGET_S
           else "OVER") + ")")
    print(f"[chip_smoke] the head widths and glu_conv's phases: " + ", ".join(
        f"{k} {width_walls[k]:.3f} s" for k in sorted(width_walls))
        + f", together {sum(width_walls.values()):.3f} s (budget "
        f"{WIDTHS_BUDGET_S} s: "
        + ("within" if sum(width_walls.values()) <= WIDTHS_BUDGET_S
           else "OVER") + ")")
    print(f"[chip_smoke] the recurrences past H = 512: " + ", ".join(
        f"{k} {wide_walls[k]:.3f} s" for k in sorted(wide_walls))
        + f", together {sum(wide_walls.values()):.3f} s (budget "
        f"{WIDE_BUDGET_S} s: "
        + ("within" if sum(wide_walls.values()) <= WIDE_BUDGET_S
           else "OVER") + ")")
    print(f"[chip_smoke] the whole run took {time.perf_counter() - t_run:.3f}"
          " s (the kernels' build included)")
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **timings[name],
                    **({"note": NOTES[name]} if name in NOTES else {}))
               for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
