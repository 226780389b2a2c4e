"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port (``chainer_speech_recognition_tpu_torch``) at the full
width of the ``bigru`` preset (phases 3-9), of the ``bilstm_deep`` preset
(phases 10-14), of both streaming paths, the forward-only ``uni_gru``
preset and ``bilstm_deep`` with causal CMVN (phases 15-17), and of the
attention family, ``conformer`` and ``conformer_stream`` offline (phases
18-21), with random weights made from a seed, and fails (exit code != 0,
no result line) if any phase fails:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel in ``csrc/`` from the checkout (nvcc);
3. decode kernels: each against its plain PyTorch version at the decode
   path's shapes (32 wavs of 10 s), with the stated tolerances, timed with
   CUDA events (warm, median) beside the library call that computes the
   same function (where there is one) and the least time the card could
   take (bytes over HBM rate or operations over peak, the larger);
4. inputs: a ``bigru`` checkpoint (config.json + msgpack params written by
   the port's own writer), a 63-symbol vocab and 64 synthetic wavs of
   8-10 s;
5. decode: the port's decode CLI on the 64 wavs (two chunks of 32) on the
   card with the exact launches of every kernel; a second, warm run gives
   utterances per second and the real-time factor;
6. CPU parity: 4 of the wavs through the same checkpoint on the CPU (the
   kernels' plain versions): finite logits of the same shape within the
   bf16 bar of the card's;
7. training kernels: the GRU training forward and backward and the CTC
   alpha and beta kernels against their plain versions (every output) at the training
   path's shapes (24 utterances of 9-10 s in the 1024-frame bucket), timed
   as in phase 3;
8. train: a synthetic corpus (192 + 24 utterances of 9-10 s) through the
   port's train CLI on the card, 16 steps with dev eval and checkpoints
   every 8; every training kernel must show launches from that run; the
   last checkpoint decodes through the decode CLI; a second run resumes at
   step 16 and stops at 20; prints the warm step time, utterances per
   second, the device's busy share over the profiled steps 10-14 (counted
   from 0) beside the profiler's overhead, and the peak memory;
9. train parity: one step from the same weights and batch on the card and
   on the CPU: loss within rtol 1e-4, per-parameter gradients within the
   bf16 bar;
10. LSTM kernels: the residual-free BiLSTM forward in fp32 and bf16
    against its plain version at the decode shapes (B = 32, T' = 251),
    timed as in phase 3 beside cuDNN's LSTM;
11. LSTM training kernels: the training forward (ys, cs, gates) and the
    backward (dxs, on the plain forward's residuals and on the kernel's
    own) against their plain versions at the training shapes (B = 24,
    T' = 256), timed beside cuDNN's LSTM;
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
    bf16, emit_t 0, C/s and T, ragged lengths, nonzero h0, and the R = 1
    forward-only launch; timed beside the bound and cuDNN with hx = h0;
    the forward-only gru_fwd at uni_gru's decode shape;
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
    1 and T', q/k/v strided as the fused qkv projection gives them; timed
    (bf16) beside the bound, the plain versions and
    ``F.scaled_dot_product_attention`` with the same boolean mask (the
    backward pair and SDPA's backward in 9 alternating rounds of CUDA
    graph replays, device time only: medians, the pair's ratio to SDPA
    with its spread, each kernel's share of its bound), and the port's
    einsum path at T' = 256 and 701 (the flash/einsum crossover);
    the framed-input front-end kernel (row 2) at B = 32, T = 1001 beside
    cuFFT, and one call of its entry point ``cuda_frontend.fused_logmel``;
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
# stream CLI flags: uni_gru at zero lookahead; bilstm_deep (trained with
# causal CMVN) at the default lookahead of 16 frames
STREAM_ARGS = {UNI_PRESET: ["--right-frames", "0"], LSTM_PRESET: []}
CONF_PRESET, CONF_STREAM = "conformer", "conformer_stream"
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
       # a bf16 ulp, 2^-8), the gradients (measured equal) one ulp + 1e-3
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
       "attn_loss_bf16_rtol": 4e-4}
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
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
GRAPH_CALLS = 10        # calls in one CUDA graph of phase 18's rounds
# H100 SXM datasheet: HBM bytes/s, dense peak FLOP/s
HBM_RATE = 3.35e12
PEAK = {"bf16": 989e12, "fp32": 67e12}


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
    operations over the peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_RATE * 1e3
    t_ops = flops / PEAK[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def excess(got, want, rtol: float, atol: float, scale=None) -> float:
    """max over the elements of |got − want| / (atol + rtol·scale), in
    fp32, ``scale`` |want| by default: at most 1 where numpy's
    ``assert_allclose(rtol, atol)`` holds."""
    a, b = got.float(), want.float()
    s = b.abs() if scale is None else scale
    return float(((a - b).abs() / (atol + rtol * s)).max())


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


def library_rnn(cell: str, dev, T: int, B: int, H: int, lens, dtype):
    """cuDNN's bidirectional GRU or LSTM over packed sequences (``_cudnn``):
    the yardstick for the recurrence kernels, input projection included.
    → (forward ms, training-forward ms, backward ms)."""
    import torch
    from torch.nn.utils.rnn import pack_padded_sequence

    rnn = _cudnn(cell, dev, 2 * H, H, True, dtype)
    x = torch.randn(T, B, 2 * H, device=dev, dtype=dtype)
    packed = pack_padded_sequence(x, lens.cpu(), enforce_sorted=False)
    packed_g = packed._replace(data=packed.data.clone().requires_grad_())

    def fwd():
        with torch.no_grad():
            rnn(packed)

    def fwd_train():
        rnn(packed_g)

    def fwd_bwd():
        out, _ = rnn(packed_g)
        out.data.sum().backward()

    _check_no_compaction(cell, fwd, fwd_bwd)
    t_fwd = time_ms(fwd)
    t_train = time_ms(fwd_train)
    return t_fwd, t_train, time_ms(fwd_bwd) - t_train


def library_stream(cell: str, dev, T: int, B: int, H: int, ndir: int, lens,
                   h0, dtype) -> float:
    """cuDNN's GRU or LSTM (bidirectional when ndir = 2) over the same
    window, packed, its initial state hx taken from h0 (the port's rows
    [d·B, (d+1)·B) are direction d): the same work as a stream launch,
    input projection included, but not the same function (no carry at
    emit_t; a length-0 row runs one step). → forward ms."""
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
            rnn(packed, hx)

    _check_no_compaction(cell, fwd)
    return time_ms(fwd, calls=STREAM_CALLS)


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
        best_keep_cuda, best_keep_plain)
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
    # the kernel's work: a dense fp32 DFT (2·512·514 flops a frame) + mel
    nb = C.N_FFT // 2 + 1
    flops = CHECK_B * T * (2 * C.N_FFT * 2 * nb + 2 * nb * C.N_MELS)
    # yardstick: cuFFT's rfft of the windowed frames, power, the mel matmul
    # and the log (the frames are cut and windowed outside the timing)
    win, mel = _tables(dev)
    frames = (ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :T] * win).contiguous()

    def library_logmel():
        spec = torch.fft.rfft(frames, n=C.N_FFT, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(power @ mel, min=C.LOG_EPS))

    lib_err = float((library_logmel() - want).abs().max())
    out["frontend_logmel"] = dict(
        max_abs_err=err, ms=time_ms(lambda: fused_logmel_rows_cuda(ext, T)),
        plain_ms=time_ms(lambda: logmel_from_extended(ext, T)),
        library_ms=time_ms(library_logmel),
        **bound(nbytes(ext, got), flops, "fp32"))
    print(f"[kernels] frontend_logmel {out['frontend_logmel']['ms']:.4f} ms, "
          f"plain {out['frontend_logmel']['plain_ms']:.4f} ms, cuFFT rfft + "
          f"mel + log on windowed frames {out['frontend_logmel']['library_ms']:.4f}"
          f" ms (max abs vs plain {lib_err:.3e})")

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
    lib_fwd, _, _ = library_rnn("gru", dev, Tp, B, H, flen, torch.bfloat16)
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
        timing = dict(
            max_abs_err=err,
            ms=time_ms(lambda: gru_scan_cuda(xs, w, lo, hi, cdt)),
            plain_ms=time_ms(lambda: gru_scan_plain(xs, w, lo, hi, cdt),
                             warmup=1, reps=3),
            library_ms=lib_fwd,
            **bound(xs_live + w_bytes + nbytes(got, lo, hi),
                    2 * live * H * 3 * H, tag))
        print(f"[kernels] gru_fwd {tag}: {timing['ms']:.3f} ms, plain "
              f"{timing['plain_ms']:.3f} ms, cuDNN GRU (bf16, with input "
              f"projection) {lib_fwd:.3f} ms")
        if cdt == torch.bfloat16:       # the preset's compute dtype
            out["gru_fwd"] = timing

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
    kb, kk = best_keep_cuda(lg, gl)
    pb, pk = best_keep_plain(lg, gl)
    torch.cuda.synchronize()
    mism = int((kb != pb).sum() + (kk != pk).sum())
    print(f"[kernels] greedy logits {tuple(lg.shape)}: {mism} mismatches "
          f"(exact), best[1,2]={int(kb[1, 2])} best[1,5]={int(kb[1, 5])}")
    check(mism == 0, "greedy disagrees with its plain version")
    check(int(kb[1, 2]) == 0 and int(kb[1, 5]) == 0 and int(kb[0, 3]) == 5,
          "greedy: NaN/tie rule broken")
    out["greedy"] = dict(
        max_abs_err=float(mism), ms=time_ms(lambda: best_keep_cuda(lg, gl)),
        plain_ms=time_ms(lambda: best_keep_plain(lg, gl)), library_ms=None,
        **bound(nbytes(lg, gl, kb, kk), lg.numel(), "fp32"))
    return out


def phase_train_kernels(dev, rng) -> dict:
    """The four training kernels vs their plain versions at the training
    path's shapes: 24 utterances of 9-10 s padded to the 1024-frame
    bucket (T' = 256, S = 2·128 + 1)."""
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.ctc import (
        LOG_ZERO, ctc_alpha_plain, ctc_beta_grad_plain, ctc_inputs)
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
    h_prev = shift_prev(ys_p)
    dxs, dhn = gru_bwd_cuda(gates_p, w, lo, hi, h_prev, g, cdt)
    dxs_p, dhn_p = gru_bwd_plain(gates_p, w, lo, hi, h_prev, g, cdt)
    torch.cuda.synchronize()
    gerr = max(float((dxs.float() - dxs_p.float()).abs().max()),
               float((dhn.float() - dhn_p.float()).abs().max()))
    print(f"[train-kernels] gru_bwd gates {tuple(gates.shape)} -> dxs "
          f"{tuple(dxs.shape)}, dhn: max abs {gerr:.3e} "
          f"(tol {TOL['gru_grad_bf16']})")
    check(bool(torch.isfinite(dxs.float()).all()), "gru_bwd: non-finite")
    check(gerr <= TOL["gru_grad_bf16"], "gru_bwd disagrees")
    live = 2 * int(flen.sum())
    esz = xs.element_size()
    _, lib_train, lib_bwd = library_rnn("gru", dev, T, B, H, flen, cdt)
    out["gru_fwd_train"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: gru_scan_train_cuda(xs, w, lo, hi, cdt)),
        plain_ms=time_ms(lambda: gru_scan_train_plain(xs, w, lo, hi, cdt),
                         warmup=1, reps=3),
        library_ms=lib_train,
        **bound(live * 3 * H * esz + w.numel() * esz + nbytes(ys, gates, lo,
                                                               hi),
                2 * live * H * 3 * H, "bf16"))
    out["gru_bwd"] = dict(
        max_abs_err=gerr,
        ms=time_ms(lambda: gru_bwd_cuda(gates_p, w, lo, hi, h_prev, g, cdt)),
        plain_ms=time_ms(lambda: gru_bwd_plain(gates_p, w, lo, hi, h_prev,
                                               g, cdt), warmup=1, reps=3),
        library_ms=lib_bwd,
        **bound(live * (4 * H * esz + 2 * H * 4) + w.numel() * esz
                + nbytes(dxs, dhn, lo, hi), 2 * live * 3 * H * H, "bf16"))

    # CTC alpha and beta: 90-100 labels an utterance (10 symbols a second)
    lab_len = np.minimum((samples / C.SAMPLE_RATE * 10).astype(np.int64), L)
    labels = np.full((B, L), -1, np.int64)
    for i, n in enumerate(lab_len):
        labels[i, :n] = rng.integers(1, V, n)
    labels[0, 1] = labels[0, 0]                       # a repeat
    logits = torch.from_numpy(
        2 * rng.standard_normal((B, T, V)).astype(np.float32)).to(dev)
    lp_ext, allow2, t_len, lab_len_t = ctc_inputs(
        logits, flen.to(dev), torch.from_numpy(labels).to(dev),
        torch.from_numpy(lab_len).to(dev))
    alphas, loss = ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len_t)
    alphas_p, loss_p = ctc_alpha_plain(lp_ext, allow2, t_len, lab_len_t)
    torch.cuda.synchronize()
    rel = float(((loss - loss_p).abs() / loss_p.abs()).max())
    # both outputs over all of [B, T', S]: the LOG_ZERO states and frozen
    # rows exactly, the live alphas at the loss's rtol (the loss is their
    # logsumexp) plus 1e-4
    sent = alphas_p <= LOG_ZERO / 2
    sent_ok = bool(torch.equal(alphas <= LOG_ZERO / 2, sent)
                   and torch.equal(alphas[sent], alphas_p[sent]))
    adiff = (alphas - alphas_p).abs()[~sent]
    aerr = float(adiff.max())
    alpha_ok = bool((adiff <= TOL["ctc_alpha_atol"] + TOL["ctc_loss_rtol"]
                     * alphas_p[~sent].abs()).all())
    print(f"[train-kernels] ctc_fwd lp_ext {tuple(lp_ext.shape)}: loss max "
          f"rel {rel:.3e} (rtol {TOL['ctc_loss_rtol']}), loss "
          f"{float(loss.min()):.2f}..{float(loss.max()):.2f}; alphas max abs "
          f"{aerr:.3e} over {adiff.numel()} live states (atol "
          f"{TOL['ctc_alpha_atol']} + rtol {TOL['ctc_loss_rtol']}), "
          f"{int(sent.sum())} LOG_ZERO states equal: {sent_ok}")
    check(bool(torch.isfinite(loss).all()), "ctc_fwd: non-finite loss")
    check(rel <= TOL["ctc_loss_rtol"], "ctc_fwd loss disagrees")
    check(sent_ok and alpha_ok, "ctc_fwd alphas disagree")
    gl = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).to(dev)
    grad_p = ctc_beta_grad_plain(lp_ext, allow2, t_len, lab_len_t, alphas_p,
                                 loss_p, gl)
    cerr = 0.0
    # once on the plain alphas (the kernel alone), once on the forward
    # kernel's own (the training path)
    for a, l in ((alphas_p, loss_p), (alphas, loss)):
        grad = ctc_bwd_cuda(lp_ext, allow2, t_len, lab_len_t, a, l, gl)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(grad).all()), "ctc_bwd: non-finite")
        cerr = max(cerr, float((grad - grad_p).abs().max()))
    print(f"[train-kernels] ctc_bwd: grad max abs {cerr:.3e} "
          f"(tol {TOL['ctc_grad']}; on the plain and the kernel's alphas)")
    check(cerr <= TOL["ctc_grad"], "ctc_bwd disagrees")
    # the recursions need lp (and alphas) at live frames and valid states
    S = lp_ext.shape[2]
    need = int((t_len.long() * (2 * lab_len_t.long() + 1)).sum()) * 4
    cells = need // 4
    out["ctc_fwd"] = dict(
        max_abs_err=max(aerr, float((loss - loss_p).abs().max())),
        ms=time_ms(lambda: ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len_t)),
        plain_ms=time_ms(lambda: ctc_alpha_plain(lp_ext, allow2, t_len,
                                                 lab_len_t), warmup=1,
                         reps=3),
        **bound(need + nbytes(allow2, t_len, lab_len_t, alphas, loss),
                12 * cells, "fp32"))
    out["ctc_bwd"] = dict(
        max_abs_err=cerr,
        ms=time_ms(lambda: ctc_bwd_cuda(lp_ext, allow2, t_len, lab_len_t,
                                        alphas_p, loss_p, gl)),
        plain_ms=time_ms(lambda: ctc_beta_grad_plain(
            lp_ext, allow2, t_len, lab_len_t, alphas_p, loss_p, gl),
            warmup=1, reps=3),
        **bound(2 * need + nbytes(allow2, t_len, lab_len_t, loss, gl, grad),
                16 * cells, "fp32"))
    # yardstick: PyTorch's CTC (blank 0) on the same log-probabilities
    lpt = torch.log_softmax(logits, -1).transpose(0, 1).detach()
    lpt.requires_grad_()
    tg = torch.from_numpy(np.maximum(labels, 0)).to(dev)
    il, tl = flen.to(dev), torch.from_numpy(lab_len).to(dev)

    def lib_fwd():
        F.ctc_loss(lpt, tg, il, tl, blank=0, reduction="none")

    def lib_fwd_bwd():
        F.ctc_loss(lpt, tg, il, tl, blank=0, reduction="none").sum() \
            .backward()

    out["ctc_fwd"]["library_ms"] = time_ms(lib_fwd)
    out["ctc_bwd"]["library_ms"] = time_ms(lib_fwd_bwd) - out["ctc_fwd"][
        "library_ms"]
    for name in ("gru_fwd_train", "gru_bwd", "ctc_fwd", "ctc_bwd"):
        t = out[name]
        print(f"[train-kernels] {name}: {t['ms']:.4f} ms, plain "
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
    lib_fwd, _, _ = library_rnn("lstm", dev, Tp, B, H, flen, torch.bfloat16)
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
        timing = dict(
            max_abs_err=err,
            ms=time_ms(lambda: lstm_scan_cuda(xs, w, lo, hi, cdt)),
            plain_ms=time_ms(lambda: lstm_scan_plain(xs, w, lo, hi, cdt),
                             warmup=1, reps=3),
            library_ms=lib_fwd,
            **bound(live * 4 * H * esz + w.numel() * esz
                    + nbytes(got, lo, hi), 2 * live * H * 4 * H, tag))
        print(f"[lstm-kernels] lstm_fwd {tag}: {timing['ms']:.4f} ms, plain "
              f"{timing['plain_ms']:.4f} ms, cuDNN LSTM (bf16, with input "
              f"projection) {lib_fwd:.4f} ms, bound {timing['bound_ms']:.5f} "
              f"ms ({timing['bound_by']})")
        if cdt == torch.bfloat16:       # the preset's compute dtype
            out["lstm_fwd"] = timing
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

    live = 2 * int(flen.sum())
    esz = xs.element_size()
    w_bytes = w.numel() * esz
    _, lib_train, lib_bwd = library_rnn("lstm", dev, T, B, H, flen, cdt)
    out = {
        "lstm_fwd_train": dict(
            max_abs_err=err,
            ms=time_ms(lambda: lstm_scan_train_cuda(xs, w, lo, hi, cdt)),
            plain_ms=time_ms(lambda: lstm_scan_train_plain(xs, w, lo, hi,
                                                           cdt),
                             warmup=1, reps=3),
            library_ms=lib_train,
            **bound(live * 4 * H * esz + w_bytes
                    + nbytes(ys, cs, gates, lo, hi),
                    2 * live * H * 4 * H, "bf16")),
        "lstm_bwd": dict(
            max_abs_err=gerr,
            ms=time_ms(lambda: lstm_bwd_cuda(*args)),
            plain_ms=time_ms(lambda: lstm_bwd_plain(*args), warmup=1,
                             reps=3),
            library_ms=lib_bwd,
            # gates, cs (read once: c_{t-1} is the step before's c) and g
            **bound(live * (4 * H * esz + 2 * H * 4) + w_bytes
                    + nbytes(dxs, lo, hi), 2 * live * 4 * H * H, "bf16")),
    }
    for name in ("lstm_fwd_train", "lstm_bwd"):
        t = out[name]
        print(f"[lstm-train-kernels] {name}: {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, cuDNN LSTM {t['library_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.5f} ms ({t['bound_by']})")
    print(f"[lstm-train-kernels] T' = {T}, B = {B}, H = {H}")
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


def phase_stream_kernels(dev, rng) -> dict:
    """The stream kernels vs their plain versions at the streaming paths'
    window shapes (B = 32): gru_fwd_stream forward-only (uni_gru, chunk 64,
    right 0: T = 16) and bidirectional (T = 20), lstm_fwd_stream
    bidirectional (bilstm_deep, chunk 64, right 16: T = 20), each in fp32
    and bf16 at emit_t 0, C/s and T, with ragged lengths (row 1 ends before
    C/s, row 2 is empty) and a nonzero h0 on the forward rows; the R = 1
    launch of one forward-only stream; timed (bf16, emit_t = C/s) beside
    the bound and cuDNN over the same window with hx = h0. Also the
    forward-only inference form of gru_fwd at uni_gru's decode shape."""
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.conv import (
        conv_out_length)
    from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
        gru_scan_cuda, gru_scan_plain, gru_scan_stream_cuda,
        gru_scan_stream_plain, lstm_scan_stream_cuda, lstm_scan_stream_plain)

    fns = {"gru": (3, gru_scan_stream_cuda, gru_scan_stream_plain),
           "lstm": (4, lstm_scan_stream_cuda, lstm_scan_stream_plain)}
    out = {}
    uT, u_emit, _, _ = stream_shapes(UNI_PRESET, 0)
    bT, b_emit, _, _ = stream_shapes(LSTM_PRESET, 16)
    uH, gH, lH = (preset_config(p).model.rnn_hidden
                  for p in (UNI_PRESET, PRESET, LSTM_PRESET))
    cases = [("gru_fwd_stream", "gru", 1, CHECK_B, uT, u_emit, uH),
             ("gru_fwd_stream bidirectional", "gru", 2, CHECK_B, bT, b_emit,
              gH),
             ("lstm_fwd_stream", "lstm", 2, CHECK_B, bT, b_emit, lH),
             ("gru_fwd_stream R=1", "gru", 1, 1, uT, u_emit, uH),
             ("lstm_fwd_stream R=1", "lstm", 1, 1, bT, b_emit, lH)]
    for tag, cell, ndir, B, T, emit, H in cases:
        G, kernel, plain = fns[cell]
        R, Cw = ndir * B, H if cell == "gru" else 2 * H
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
        xs32 = torch.from_numpy(rng.standard_normal(
            (T, R, G * H)).astype(np.float32)).to(dev)
        h0 = torch.zeros(R, Cw, device=dev)        # backward rows: zeros
        h0[:B] = torch.from_numpy(
            0.5 * rng.standard_normal((B, Cw)).astype(np.float32)).to(dev)
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
            if tag not in ("gru_fwd_stream", "lstm_fwd_stream") \
                    or cdt != torch.bfloat16:
                continue
            live = int((hi - lo).sum())       # live (row, step) pairs
            esz = xs.element_size()
            one = time_ms(lambda: kernel(xs, w, lo, hi, h0, cdt, emit))
            t = dict(
                max_abs_err=err,
                ms=time_ms(lambda: kernel(xs, w, lo, hi, h0, cdt, emit),
                           calls=STREAM_CALLS),
                plain_ms=time_ms(lambda: plain(xs, w, lo, hi, h0, cdt, emit),
                                 warmup=1, reps=3),
                library_ms=library_stream(cell, dev, T, B, H, ndir,
                                          lens.long(), h0, cdt),
                **bound(live * G * H * esz + w.numel() * esz
                        + nbytes(ys, carry, lo, hi, h0),
                        2 * live * H * G * H, "bf16"))
            out[tag] = t
            print(f"[stream-kernels] {tag}: {t['ms']:.4f} ms a call over "
                  f"{STREAM_CALLS} back to back ({one:.4f} ms for one call, "
                  f"the wrapper's host time included), plain "
                  f"{t['plain_ms']:.4f} ms, cuDNN {cell.upper()} (hx = h0, "
                  f"with input projection, {STREAM_CALLS} back to back) "
                  f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
                  f"({t['bound_by']})")

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
    live = int(flen.sum())
    t = dict(max_abs_err=err,
             ms=time_ms(lambda: gru_scan_cuda(xs, w, lo, hi, torch.bfloat16)),
             **bound(live * 3 * H * 2 + w.numel() * 2 + nbytes(got, lo, hi),
                     2 * live * H * 3 * H, "bf16"))
    print(f"[stream-kernels] gru_fwd ndir=1 bf16 xs {tuple(xs.shape)}: max "
          f"abs {err:.3e} (tol {TOL['gru_bf16']}), {t['ms']:.4f} ms, bound "
          f"{t['bound_ms']:.6f} ms ({t['bound_by']})")
    check(err <= TOL["gru_bf16"], "gru_fwd ndir=1 disagrees")
    return out


def write_checkpoint(root: str, preset: str, rng,
                     overrides: dict | None = None) -> str:
    """A params-only checkpoint of ``preset`` (with dotted config
    ``overrides``) with random weights from ``rng``, written by the port's
    own writer; → its directory."""
    from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
    from chainer_speech_recognition_tpu_torch.checkpoint import save_params
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    cfg = preset_config(preset)
    if overrides:
        cfg = cfg.override(overrides)
    model = build_model(cfg.model)
    ckpt = os.path.join(root, f"ckpt_{preset}{'_stream' if overrides else ''}")
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
    compute dtype to 3e-2. An attention checkpoint, whose bf16 noise over
    eight blocks of LayerNorms, softmaxes and residual sums is as large as
    that bar, runs at fp32 and at bf16 compute on both: fp32 card vs CPU to
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
    attention = cfg.model.attn_blocks > 0
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


def phase_stream(root, vocab, wavs, audio_s, preset: str, dev, rng) -> dict:
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
    → the cold stream run's launches."""
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
    tag = "uni-stream" if uni else "lstm-stream"
    right = 0 if uni else 16
    ckpt = write_checkpoint(root, preset, rng,
                            {"features.cmvn_mode": "causal",
                             "features.cmvn": True})
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
        _, off_lines = phase_decode("uni-decode", ckpt, vocab, wavs, audio_s,
                                    DECODE_LAUNCHES[UNI_PRESET])
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
    """(device busy share, window ms, top kernels) of a torch.profiler
    chrome trace: the union of device kernel/copy intervals over the span
    of all events."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy / (t1 - t0), (t1 - t0) / 1e3, top


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
    for name, us in top:
        print(f"[{tag}] device time {us / 1e3:9.3f} ms  {name[:90]}")

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
    return launches, os.path.join(data, "train_index.jsonl")


def phase_train_parity(dev, index: str, preset: str,
                       overrides: dict | None = None) -> None:
    """One step's loss and gradients, card (kernels) vs CPU (plain
    versions), from the same weights, batch of 2 utterances and, where the
    preset enables it, SpecAugment draws; ``overrides`` are dotted config
    overrides of the preset."""
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

    tag = {PRESET: "train-parity", LSTM_PRESET: "lstm-train-parity",
           CONF_PRESET: "conformer-train-parity"}[preset]
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


def phase_attention_kernels(dev, rng) -> dict:
    """The three flash kernels vs their plain versions (phase 18)."""
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.attention import (
        einsum_attention)
    from chainer_speech_recognition_tpu_torch.models.rnn import time_mask
    from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac

    mcfg = preset_config(CONF_PRESET).model
    h, dh = mcfg.attn_heads, mcfg.attn_dim // mcfg.attn_heads
    strides = mcfg.conv_stride_time
    # decode: 32 long-form wavs of 22-28 s in one chunk (T' = 701 at 28 s);
    # training: 24 utterances of 9-10 s in the 1024-frame bucket
    n_long = int(LONG_SECONDS[1] * C.SAMPLE_RATE)
    dec_len, T_dec = subsampled(
        rng.uniform(*LONG_SECONDS, CHECK_B) * C.SAMPLE_RATE,
        C.num_frames(n_long), strides)
    tr_len, T_tr = subsampled(
        rng.uniform(*TRAIN_SECONDS, TRAIN_B) * C.SAMPLE_RATE, TRAIN_FRAMES,
        strides)
    for lens, T in ((dec_len, T_dec), (tr_len, T_tr)):
        lens[0], lens[1] = T, 1                # ragged: lengths T and 1
    cases = [("decode", CHECK_B, T_dec, dec_len, 0, 0),
             ("decode chunk 16/4", CHECK_B, T_dec, dec_len,
              preset_config(CONF_STREAM).model.attn_chunk,
              preset_config(CONF_STREAM).model.attn_left_chunks),
             ("train", TRAIN_B, T_tr, tr_len, 0, 0)]
    out = {}
    for tag, B, T, lens_cpu, chunk, left in cases:
        lens = lens_cpu.to(torch.int32).to(dev)
        d = h * dh
        f32 = lambda *s: torch.from_numpy(
            rng.standard_normal(s).astype(np.float32)).to(dev)
        qkv32, do32 = f32(B, T, 3 * d), f32(B, T, h, dh)
        ok = ac.allowed_mask(T, lens, chunk, left)            # [B, 1, T, T]
        pairs = int(ok.expand(B, 1, T, T).sum()) * h
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
            for name, t in (("out", o), ("lse", lse), ("dq", dq), ("dk", dk),
                            ("dv", dv)):
                check(bool(torch.isfinite(t.float()).all()),
                      f"flash {tag} {dtag}: non-finite {name}")
            live = lse_p > ac.NEG / 2
            check(torch.equal(lse[~live], lse_p[~live]),
                  f"flash {tag} {dtag}: rows with no allowed key")
            ftol, gtol = TOL[f"flash_{dtag}"], TOL[f"flash_grad_{dtag}"]
            o_scale = o_p.float().abs()
            if cdt == torch.bfloat16:         # + Σ p·|v| / l (see TOL)
                o_scale += ac.flash_fwd_plain(q, k, v.abs(), lens, chunk,
                                              left)[0].float()
            # (max abs error, max of |a - b| / (atol + rtol·s)): each
            # output passes where the second is at most 1
            err = {n: (float((a.float() - b.float()).abs().max()),
                       excess(a, b, *tol, s))
                   for n, a, b, tol, s in (
                       ("out", o, o_p, ftol, o_scale),
                       ("lse", lse[live], lse_p[live], TOL["flash_fp32"],
                        None),
                       ("dq", dq, dq_p, gtol, None),
                       ("dk", dk, dk_p, gtol, None),
                       ("dv", dv, dv_p, gtol, None))}
            print(f"[attn-kernels] {tag} {dtag} B={B} T'={T} h={h} dh={dh}"
                  f" ({int((~live).sum())} rows with no allowed key): max abs"
                  f" (share of the elementwise bar) " + ", ".join(
                      f"{n} {a:.3e} ({x:.3f})" for n, (a, x) in err.items())
                  + f"; bars (rtol, atol): out {ftol}"
                  f"{' of |b| + Σp|v|/l' if cdt == torch.bfloat16 else ''}"
                  f", lse {TOL['flash_fp32']}, gradients {gtol}")
            check(err["out"][1] <= 1 and err["lse"][1] <= 1,
                  f"flash_fwd {tag} {dtag} disagrees")
            check(max(err[n][1] for n in ("dq", "dk", "dv")) <= 1,
                  f"flash backward {tag} {dtag} disagrees")
            ferr = max(err["out"][0], err["lse"][0])
            gerr = {n: err[n][0] for n in ("dq", "dk", "dv")}
            if cdt != torch.bfloat16:          # the presets' compute dtype
                continue
            t = {}
            t["flash_fwd"] = dict(
                max_abs_err=ferr,
                ms=time_ms(lambda: ac.flash_fwd_cuda(q, k, v, lens, chunk,
                                                     left)),
                plain_ms=time_ms(lambda: ac.flash_fwd_plain(
                    q, k, v, lens, chunk, left), warmup=1, reps=3),
                **flash_bound(B, T, h, dh, pairs, 3, 1, 1, 4))
            # yardstick: PyTorch's SDPA with the same boolean mask, heads
            # second; its backward computes dq, dk and dv in one call
            qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
            leaves = [x.detach().clone().requires_grad_() for x in
                      (qh, kh, vh)]

            def sdpa_fwd():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qh, kh, vh, attn_mask=ok)

            def sdpa_train():
                return F.scaled_dot_product_attention(*leaves, attn_mask=ok)

            # the backward pair and SDPA's backward in alternating rounds of
            # CUDA-graph replays, device time only on both sides; SDPA's
            # backward is its forward and backward less its training
            # forward, the two captured alike
            g_dq, dq_g = graph_of(lambda: ac.flash_bwd_dq_cuda(*args))
            g_dkv, dkv_g = graph_of(lambda: ac.flash_bwd_dkv_cuda(*args))
            g_fb, _ = graph_of(lambda: torch.autograd.grad(
                sdpa_train(), leaves, doh))
            g_fw, _ = graph_of(sdpa_train)
            rounds = alternating_ms({
                "flash_bwd_dq": g_dq, "flash_bwd_dkv": g_dkv,
                "sdpa_fwd_bwd": g_fb, "sdpa_train": g_fw})
            check(all(torch.equal(a.view(torch.int16), b.view(torch.int16))
                      for a, b in zip((dq_g, *dkv_g), (dq, dk, dv))),
                  f"flash backward {tag}: a replay differs from the eager "
                  "call (not deterministic)")
            rounds["sdpa_bwd"] = [a - b for a, b in zip(
                rounds["sdpa_fwd_bwd"], rounds["sdpa_train"])]
            med = {n: statistics.median(r) for n, r in rounds.items()}
            ratio = [(a + b) / c for a, b, c in zip(
                rounds["flash_bwd_dq"], rounds["flash_bwd_dkv"],
                rounds["sdpa_bwd"])]
            t["flash_bwd_dq"] = dict(
                max_abs_err=gerr["dq"], ms=med["flash_bwd_dq"],
                plain_ms=time_ms(lambda: ac.flash_bwd_dq_plain(*args),
                                 warmup=1, reps=3),
                **flash_bound(B, T, h, dh, pairs, 4, 1, 2, 6))
            t["flash_bwd_dkv"] = dict(
                max_abs_err=max(gerr["dk"], gerr["dv"]),
                ms=med["flash_bwd_dkv"],
                plain_ms=time_ms(lambda: ac.flash_bwd_dkv_plain(*args),
                                 warmup=1, reps=3),
                **flash_bound(B, T, h, dh, pairs, 4, 2, 2, 8))
            t["flash_fwd"]["library_ms"] = time_ms(sdpa_fwd)
            t["flash_bwd_dq"]["library_ms"] = med["sdpa_bwd"]
            t["flash_bwd_dkv"]["library_ms"] = med["sdpa_bwd"]
            pair = med["flash_bwd_dq"] + med["flash_bwd_dkv"]
            print(f"[attn-kernels] {tag} backward, {len(ratio)} alternating "
                  f"rounds of graph replays (medians): dq "
                  f"{med['flash_bwd_dq']:.4f} ms "
                  f"({t['flash_bwd_dq']['bound_ms'] / med['flash_bwd_dq']:.3f}"
                  f" of its bound), dkv {med['flash_bwd_dkv']:.4f} ms "
                  f"({t['flash_bwd_dkv']['bound_ms'] / med['flash_bwd_dkv']:.3f}"
                  f" of its bound), pair {pair:.4f} ms; SDPA backward "
                  f"{med['sdpa_bwd']:.4f} ms (forward and backward "
                  f"{med['sdpa_fwd_bwd']:.4f} ms); pair / SDPA "
                  f"{statistics.median(ratio):.3f} (rounds {min(ratio):.3f}"
                  f"-{max(ratio):.3f}); replays equal the eager outputs")
            for name in FLASH:
                r = t[name]
                both = " (dq, dk, dv together)" if name != "flash_fwd" else ""
                print(f"[attn-kernels] {tag} {name}: {r['ms']:.4f} ms, plain "
                      f"{r['plain_ms']:.4f} ms, SDPA {r['library_ms']:.4f} "
                      f"ms{both}, bound {r['bound_ms']:.5f} ms "
                      f"({r['bound_by']}), "
                      f"{pairs} allowed (query, key) pairs")
            if chunk == 0:
                # the port's einsum path on the same q, k, v: the card's
                # flash/einsum crossover (recorded, not acted on)
                mask = time_mask(T, lens)
                ein = time_ms(lambda: einsum_attention(q, k, v, mask))
                print(f"[attn-kernels] {tag} einsum path {ein:.4f} ms vs "
                      f"flash_fwd {t['flash_fwd']['ms']:.4f} ms at T'={T}")
            if tag == "decode":
                out["flash_fwd"] = t["flash_fwd"]
            elif tag == "train":
                out["flash_bwd_dq"] = t["flash_bwd_dq"]
                out["flash_bwd_dkv"] = t["flash_bwd_dkv"]
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

    nb = C.N_FFT // 2 + 1
    t = dict(max_abs_err=err, ms=time_ms(lambda: fused_logmel_cuda(frames)),
             plain_ms=time_ms(lambda: logmel_from_frames(frames)),
             library_ms=time_ms(library_logmel),
             **bound(nbytes(frames, got),
                     CHECK_B * T * (2 * C.N_FFT * 2 * nb + 2 * nb * C.N_MELS),
                     "fp32"))
    print(f"[frames-kernel] {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"cuFFT rfft + mel + log {t['library_ms']:.4f} ms, bound "
          f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
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


def main() -> int:
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
            train_launches, index = phase_train(root, data, PRESET,
                                                resume_to=RESUME_STEPS)
            phase_train_parity(dev, index, PRESET)
            lckpt = write_checkpoint(root, LSTM_PRESET, lrng)
            lstm_decode, _ = phase_decode("lstm-decode", lckpt, vocab, wavs,
                                          audio_s, DECODE_LAUNCHES[LSTM_PRESET])
            phase_parity(lckpt, wavs, dev, "lstm-parity")
            lstm_train, _ = phase_train(root, data, LSTM_PRESET)
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
            conf_train, _ = phase_train(
                root, data, CONF_PRESET,
                extra_sets=("model.attn_impl=flash",))
            phase_train_parity(dev, index, CONF_PRESET,
                               {"model.attn_impl": "flash"})
        launches.update({k: train_launches[k] for k in (
            "gru_fwd_train", "gru_bwd", "ctc_fwd", "ctc_bwd")})
        launches["lstm_fwd"] = lstm_decode["lstm_fwd"]
        launches.update({k: lstm_train[k] for k in (
            "lstm_fwd_train", "lstm_bwd")})
        launches["gru_fwd_stream"] = uni_stream["gru_fwd_stream"]
        launches["lstm_fwd_stream"] = lstm_stream["lstm_fwd_stream"]
        launches["frontend_logmel_frames"] = frames_launches
        launches["flash_fwd"] = conf_decode["flash_fwd"]
        launches["flash_bwd_dq"] = conf_train["flash_bwd_dq"]
        launches["flash_bwd_dkv"] = conf_train["flash_bwd_dkv"]
        loaded = sorted(k for k in sys.modules
                        if k.split(".")[0] in ("jax", "jaxlib", "flax",
                                               "optax",
                                               "chainer_speech_recognition_tpu"))
        check(not loaded, f"JAX modules were imported: {loaded[:5]}")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    kernels = [dict(name=name, route="cuda", source=SOURCES[name][0],
                    replaces=SOURCES[name][1], launches=launches[name],
                    **timings[name]) for name in SOURCES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
