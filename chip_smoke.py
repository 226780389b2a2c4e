"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Drives the port (``chainer_speech_recognition_tpu_torch``) at the full
width of the ``bigru`` preset (phases 3-9), of the ``bilstm_deep`` preset
(phases 10-14) and of both streaming paths, the forward-only ``uni_gru``
preset and ``bilstm_deep`` with causal CMVN (phases 15-17), with random
weights made from a seed, and fails (exit code != 0, no result line) if
any phase fails:

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
   card; every decode kernel must show launches from that run; a second,
   warm run gives utterances per second and the real-time factor;
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
    CLI on the 64 wavs (the LSTM forward must show launches), a warm
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
    window logits card vs CPU.

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
       "greedy": 0}                   # exact
# decode CLI, 64 wavs in two chunks: launches of each decode kernel
MIN_LAUNCHES = {PRESET: {"frontend_logmel": 2, "gru_fwd": 6, "greedy": 2},
                LSTM_PRESET: {"frontend_logmel": 2, "lstm_fwd": 10,
                              "greedy": 2},
                UNI_PRESET: {"frontend_logmel": 2, "gru_fwd": 8, "greedy": 2},
                # stream CLI, 64 wavs in two lockstep batches: at least one
                # window a batch (phase 16 checks the exact counts)
                f"{UNI_PRESET} stream": {"frontend_logmel": 2,
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
}
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


def phase_decode(ckpt, vocab, wavs, audio_s,
                 preset: str) -> tuple[dict, list[str]]:
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model

    tag = {PRESET: "decode", LSTM_PRESET: "lstm-decode",
           UNI_PRESET: "uni-decode"}[preset]
    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", str(BATCH),
            "--device", "cuda", *wavs]
    _kernels.reset_launches()
    lines, cold = run_decode(args)
    launches = _kernels.launches()
    print(f"[{tag}] cold run {cold:.3f} s, launches {launches}")
    check(len(lines) == len(wavs), f"decode printed {len(lines)} lines")
    check([l.split("\t")[0] for l in lines] == wavs,
          "decode output is not in input order")
    check(all(len(l.split("\t")) == 2 for l in lines), "malformed lines")
    for name, need in MIN_LAUNCHES[preset].items():
        check(launches[name] >= need, f"{name}: {launches[name]} launches on "
              f"the {preset} decode path, expected >= {need}")
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


def phase_parity(ckpt, wavs, dev, tag: str) -> float:
    import torch

    from chainer_speech_recognition_tpu_torch.cli.decode import load_model
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav

    sigs = [read_wav(w) for w in wavs[:PARITY_WAVS]]
    n = max(len(s) for s in sigs)
    x = np.zeros((len(sigs), n), np.float32)
    for i, s in enumerate(sigs):
        x[i, : len(s)] = s
    lens = np.asarray([len(s) for s in sigs], np.int32)
    res = []
    for d in (dev, torch.device("cpu")):
        cfg, model, _ = load_model(ckpt, device=d)
        with torch.inference_mode():
            feats, fl = select_frontend(cfg.features)(
                torch.from_numpy(x).to(d), torch.from_numpy(lens).to(d),
                apply_cmvn=cfg.features.cmvn_arg)
            logits, ol = model(feats, fl)
        res.append((logits.float().cpu(), ol.cpu()))
    (lc, oc), (lp, op) = res
    check(lc.shape == lp.shape and torch.equal(oc, op), "parity: shapes")
    check(bool(torch.isfinite(lc).all()), "parity: non-finite card logits")
    err = float((lc - lp).abs().max())
    print(f"[{tag}] logits {tuple(lc.shape)} card vs CPU: max abs "
          f"{err:.3e} (tol {TOL['gru_bf16']}), |logits| max "
          f"{float(lp.abs().max()):.3f}")
    check(err <= TOL["gru_bf16"], "card and CPU logits disagree")
    return err


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
        off_launches, off_lines = phase_decode(ckpt, vocab, wavs, audio_s,
                                               UNI_PRESET)
        check(off_launches["gru_fwd"] == layers * 2 and
              off_launches["gru_fwd_stream"] == 0,
              f"offline uni_gru launches {off_launches}")
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
                resume_to: int | None = None) -> tuple[dict, str]:
    """Train the full-width preset through the CLI on the card: exact
    launches, finite metrics, checkpoint decode and (``resume_to``) a
    resumed run; → (the training run's launches, the train index path)."""
    import torch

    from chainer_speech_recognition_tpu_torch import _kernels
    from chainer_speech_recognition_tpu_torch.checkpoint import (
        list_checkpoints)
    from chainer_speech_recognition_tpu_torch.cli import train as train_cli
    from chainer_speech_recognition_tpu_torch.config import preset_config

    tag = "train" if preset == PRESET else "lstm-train"
    cfg = preset_config(preset)
    ckpt = os.path.join(root, f"train_ckpt_{preset}")
    metrics = os.path.join(root, f"train_{preset}.jsonl")
    prof = os.path.join(root, f"prof_{preset}")
    sets = ["train.data_mode=stream", "train.log_every=1",
            f"train.eval_every={EVERY}", f"train.checkpoint_every={EVERY}",
            "optim.warmup_steps=4"]
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
    other = {"gru": "lstm", "lstm": "gru"}[cell]
    want = {f"{cell}_fwd_train": layers * TRAIN_STEPS,
            f"{cell}_bwd": layers * TRAIN_STEPS,
            f"{cell}_fwd": layers * n_eval,
            f"{other}_fwd_train": 0, f"{other}_bwd": 0, f"{other}_fwd": 0,
            "ctc_bwd": TRAIN_STEPS,
            "ctc_fwd": TRAIN_STEPS + n_eval,
            "frontend_logmel": TRAIN_STEPS + n_eval,
            "greedy": n_eval}
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


def phase_train_parity(dev, index: str, preset: str) -> None:
    """One step's loss and gradients, card (kernels) vs CPU (plain
    versions), from the same weights, batch of 2 utterances and, where the
    preset enables it, SpecAugment draws."""
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

    tag = "train-parity" if preset == PRESET else "lstm-train-parity"
    cfg = preset_config(preset)
    utts = load_index(index)
    vocab = Vocab.load(os.path.join(os.path.dirname(index), "vocab.txt"))
    batch = BatchLoader(utts, vocab, cfg.buckets).load(3, np.arange(2))
    draws = None
    if cfg.specaugment.enabled:
        draws = specaugment_draws(step_generator(
            np.asarray([0, SEED], np.uint32), 0), 2, cfg.specaugment)
    res = []
    for d in (dev, torch.device("cpu")):
        model = build_model(cfg.model)
        init_parameters(model, SEED)
        model.to(d)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()
             if k != "bucket_id"}
        loss, _, _, _ = forward_loss(
            model, cfg, b, None if draws is None else draws.to(d))
        loss.backward()
        res.append((float(loss.detach()), {k: p.grad.float().cpu()
                                  for k, p in model.named_parameters()}))
    (lc, gc), (lp, gp) = res
    rel = abs(lc - lp) / abs(lp)
    worst = max((float((gc[k] - gp[k]).abs().max())
                 / max(float(gp[k].abs().max()), 1e-12), k) for k in gp)
    print(f"[{tag}] {preset} (SpecAugment "
          f"{'on' if draws is not None else 'off'}): loss card {lc:.5f} CPU "
          f"{lp:.5f} (rel {rel:.3e}, tol {TOL['train_loss_rtol']}); worst "
          f"gradient max abs diff / max abs {worst[0]:.3e} ({worst[1]}, tol "
          f"{TOL['gru_grad_bf16']})")
    check(np.isfinite(lc) and rel <= TOL["train_loss_rtol"],
          f"{preset} train loss parity")
    check(worst[0] <= TOL["gru_grad_bf16"], f"{preset} train gradient parity")


def main() -> int:
    try:
        import torch

        kind, _ = phase_device()
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
        with tempfile.TemporaryDirectory() as root:
            ckpt, vocab, wavs, audio_s = phase_inputs(root, rng)
            launches, _ = phase_decode(ckpt, vocab, wavs, audio_s, PRESET)
            phase_parity(ckpt, wavs, dev, "parity")
            data = write_corpus(root, rng)
            train_launches, index = phase_train(root, data, PRESET,
                                                resume_to=RESUME_STEPS)
            phase_train_parity(dev, index, PRESET)
            lckpt = write_checkpoint(root, LSTM_PRESET, lrng)
            lstm_decode, _ = phase_decode(lckpt, vocab, wavs, audio_s,
                                          LSTM_PRESET)
            phase_parity(lckpt, wavs, dev, "lstm-parity")
            lstm_train, _ = phase_train(root, data, LSTM_PRESET)
            phase_train_parity(dev, index, LSTM_PRESET)
            uni_stream = phase_stream(root, vocab, wavs, audio_s, UNI_PRESET,
                                      dev, srng)
            lstm_stream = phase_stream(root, vocab, wavs, audio_s,
                                       LSTM_PRESET, dev, srng)
        launches.update({k: train_launches[k] for k in (
            "gru_fwd_train", "gru_bwd", "ctc_fwd", "ctc_bwd")})
        launches["lstm_fwd"] = lstm_decode["lstm_fwd"]
        launches.update({k: lstm_train[k] for k in (
            "lstm_fwd_train", "lstm_bwd")})
        launches["gru_fwd_stream"] = uni_stream["gru_fwd_stream"]
        launches["lstm_fwd_stream"] = lstm_stream["lstm_fwd_stream"]
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
