"""Time this checkout's redesigned kernels against another checkout's on
one card, on the same inputs, by two yardsticks:

    python3 tools/kernel_ab.py OTHER_ROOT [--rounds 9] [--seed 0]
                [--cases frontend,flash,lstm,gru,stream,ctc,greedy,dw,beam]

OTHER_ROOT is the root of another checkout of the repo (for example an
older commit unpacked by ``git archive`` into a git-ignored directory).
Its ``csrc/frontend_logmel.cu``, ``attention_fwd.cu``,
``attention_bwd.cu``, ``lstm_fwd.cu``, ``lstm_bwd.cu``, ``gru_fwd.cu``,
``gru_bwd.cu``, ``ctc.cu``, ``greedy.cu``, ``dw.cu`` and ``beam.cu`` (those
it has; with
``library.cu``, the error strings) are built alone into a library of
their own, and its Python package is imported under another name with
that library bound in, so each build is called through its own
checkout's wrappers, weight layouts and host tables.

Kernels and shapes (those of ``chip_smoke.py``):

* the front-end, rows 1 and 2 (phase 3 and the frames phase: B = 32 wavs
  of 10 s, the last 8 s, T = 1001): the extended-signal form and the
  framed form, beside cuFFT's rfft of the windowed frames + power + mel
  matmul + log;
* the bf16 flash forward (row 11) and backward pair (rows 12-13), h = 4,
  dh = 64, at phase 18's three shapes (B = 32, T' = 701 with chunk 0 and
  with chunk 16 / left 4; B = 24, T' = 256), beside SDPA's forward and its
  backward (its forward and backward less its training forward); the two
  builds' outputs (out, lse, dq, dk, dv) must be bitwise equal, in bf16
  and in fp32 on the same inputs widened;
* the bf16 LSTM, H = 384 (``chip_smoke.lstm_cases``): row 6's
  residual-free form at B = 32, T' = 251 beside cuDNN's forward; row 6's
  training form and row 7 at B = 24, T' = 256 beside cuDNN's training
  forward and backward; and the forms the FMA kernels keep (fp32
  forward, training forward and backward; the stream form in fp32),
  which must be bitwise equal across the builds;
* the bf16 GRU, H = 256 (``chip_smoke.gru_cases``): row 3's
  residual-free form at B = 32, T' = 251 for bigru (ndir 2) and uni_gru
  (ndir 1) beside cuDNN's forward; row 4's training form and row 5 at
  B = 24, T' = 256 beside cuDNN's training forward and backward; the
  forms kept on the FMA kernels (fp32 forward, training forward and
  backward; the stream form in fp32) bitwise equal across the builds, as
  the LSTM's;
* the bf16 stream forms (row 8) at the streaming paths' two windows
  (``chip_smoke.stream_cases``: uni_gru's forward-only GRU, H = 256,
  T = 16; bilstm_deep's BiLSTM, H = 384, T = 20; B = 32, emit_t = C/s,
  ragged lengths and a nonzero h0) beside cuDNN over the same window
  with hx = h0; the fp32 stream form bitwise equal across the builds;
* the CTC α and β recursions (rows 9-10, ``chip_smoke.ctc_cases``) at
  phase 7's training shape (B = 24, T' = 256, S = 257, 90-99 labels) and
  long-form (B = 24, T' = 701, S = 601, 228-280 labels), beside
  F.ctc_loss's forward and its backward (forward+backward less forward);
  both builds' alphas, loss and grad must be bitwise equal (each build
  through its own wrappers and launch plan);
* greedy decoding (row 14) at the decode shape (B = 32, T' = 251, V =
  64) and long-form (T' = 701): each build's ``greedy_decode`` (this
  one's single launch; older builds' kernel and the torch compaction
  after it), both equal to the plain version exactly;
* the recurrences' weight gradient at bilstm_deep's training layer (T' =
  256, B = 24, H = 384, N = 4H) and bigru's (H = 256, N = 3H: two gate
  tensors): this build's ``rnn_dw`` (the dW kernel) against the other
  build's chain (shift_prev, dw_matmul, cat) and cuBLAS's bmm of bf16
  operands laid out beforehand, held to the other build at twice the
  fp32 summation bar;
* the prefix beam's narrow form (chip_smoke phase 23's shape: B = 32,
  T' = 251, V = 64, K = 8, a random dense 3-gram): each build's
  ``beam_chunk_cuda`` through its own wrapper on the same log-probs, LM
  and state, in the 1-best, n-best and chunk forms; the builds' outputs
  (ids, counts, parents, scores, state) must be bitwise equal, and this
  build's equal to the plain version at phase 23's bars.

``--cases`` takes a subset of
``frontend,flash,lstm,gru,stream,ctc,greedy,dw,beam``.

Each case also records whether the two builds' bf16-compute outputs are
bitwise equal (``bf16 bitwise equal``; dW against the other build's own
dW kernel where it has one), printed, not gated: a redesign may change
them, a change that leaves a path as it was must not.

Each is timed in alternating rounds, both builds and the library call in
each round:

* graph: replays of a CUDA graph of 10 calls, device time only;
* eager: one call between CUDA events, median of 7 warm calls
  (``chip_smoke.time_ms``), so each wrapper's host time is in it wherever
  it exceeds the kernel's.

F.ctc_loss takes its lengths through the host, so no graph holds it: in
the graph kind it runs eagerly, 10 calls back to back a timing
(``chip_smoke.ctc_library_replay``).

Each build is first held to the plain versions: the LSTM and the GRU at 3e-2
(forward) and 5e-2 (gradient) max abs, the front-end at 5e-4 max abs,
the CTC loss at rtol 1e-5, alphas at 1e-4 + rtol 1e-5 (their LOG_ZERO
states exactly) and the gradient at 2e-4 max abs,
the flash forward's out at 2^-7·(|b| + Σp·|v|/l) + 1e-5 and lse at 2e-5,
the gradients at the bar derived from bf16 rounding (2^-7·|b| + the
rounding room + 1e-3, ``attention_cuda.bwd_rounding_room``); the share of
the old gradient bar (2^-7·|b| + 1e-3) is printed beside it. Prints the
card, the medians, the per-round ratios of the other build to this one
with their spread; the last line is all of it as JSON. Exits 1 without a
card or if a build breaks a bar.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PKG = "chainer_speech_recognition_tpu_torch"
SOURCES = ("frontend_logmel.cu", "attention_fwd.cu", "attention_bwd.cu",
           "lstm_fwd.cu", "lstm_bwd.cu", "gru_fwd.cu", "gru_bwd.cu",
           "ctc.cu", "greedy.cu", "dw.cu", "beam.cu", "library.cu")
CASES = ("frontend", "flash", "lstm", "gru", "stream", "ctc", "greedy",
         "dw", "beam")


def build_alone(root: str, tag: str) -> str:
    """``root``'s kernel sources of ``SOURCES`` (those it has), one nvcc
    each, started together, linked into one library → its path."""
    from chainer_speech_recognition_tpu_torch import _kernels

    csrc = os.path.join(root, PKG, "csrc")
    out = os.path.join(_kernels._BUILD, "ab")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"{tag}_{os.getpid()}.so")
    srcs = [s for s in SOURCES if os.path.exists(os.path.join(csrc, s))]
    objs = [f"{so}.{s}.o" for s in srcs]
    procs = [subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-c",
                               "-o", o, os.path.join(csrc, s)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    for s, p, log in zip(srcs, procs, logs):
        cs.check(p.returncode == 0, f"nvcc failed on {root}/{s}:\n{log}")
    r = subprocess.run([_kernels._nvcc(), "-shared", "-o", so, *objs],
                       capture_output=True, text=True)
    cs.check(r.returncode == 0, f"nvcc link failed:\n{r.stdout}{r.stderr}")
    return so


def load_checkout(root: str, alias: str):
    """``root``'s port package imported as ``alias``, its kernels launched
    from a library of ``SOURCES`` built alone → the package."""
    init = os.path.join(root, PKG, "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    kern = importlib.import_module(f"{alias}._kernels")
    lib = ctypes.CDLL(build_alone(root, alias))
    for k in kern.KERNELS.values():
        if hasattr(lib, k.symbol):
            fn = getattr(lib, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
    lib.csr_error_string.argtypes = [ctypes.c_int]
    lib.csr_error_string.restype = ctypes.c_char_p
    kern.library = lambda: lib
    return pkg


def timed(fns: dict, rounds: int, replays: dict) -> dict:
    """{kind: {name: median ms}, kind + " rounds": {name: [ms]}} of
    ``fns`` as graph replays and eagerly, in alternating rounds."""
    graph = cs.alternating_ms(replays, rounds)
    eager = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            eager[n].append(cs.time_ms(fn, warmup=1, reps=7))
    return {"graph": graph, "eager": eager}


def ratios(t: dict, num: str, den: str) -> dict:
    r = [a / b for a, b in zip(t[num], t[den])]
    return {"median": statistics.median(r), "rounds": [min(r), max(r)]}


def report(tag: str, times: dict, pairs: list) -> dict:
    """Medians and the listed ratios (numerator, denominator) per kind."""
    res = {}
    for kind, t in times.items():
        med = {n: statistics.median(x) for n, x in t.items()}
        rat = {f"{a}/{b}": ratios(t, a, b) for a, b in pairs}
        res[kind] = {"ms": med, "ratios": rat}
        print(f"[ab] {tag}, {kind}, medians (ms): " + ", ".join(
            f"{n} {m:.4f}" for n, m in med.items()) + "; " + ", ".join(
            f"{n} {r['median']:.3f} ({r['rounds'][0]:.3f}-"
            f"{r['rounds'][1]:.3f})" for n, r in rat.items()))
    return res


def frontend_cases(dev, rng, other, rounds: int) -> list:
    import torch

    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.frontend import cuda_frontend
    from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
        _K, _tables, extend_signal, logmel_from_extended, logmel_from_frames)

    ocf = importlib.import_module(f"{other.__name__}.frontend.cuda_frontend")
    V = preset_config(cs.PRESET).model.vocab_size
    n = int(cs.CHECK_SECONDS * C.SAMPLE_RATE)
    sigs = np.zeros((cs.CHECK_B, n), np.float32)
    lens = np.full(cs.CHECK_B, n, np.int32)
    for i in range(cs.CHECK_B):
        s = cs.synth_signal(rng, cs.WAV_SECONDS[0] if i == cs.CHECK_B - 1
                            else cs.CHECK_SECONDS, V)
        sigs[i, :len(s)] = s
        lens[i] = len(s)
    T = C.num_frames(n)
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.from_numpy(lens).to(dev), T + _K + 1)
    frames = ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :T].contiguous()
    win, mel = _tables(dev)
    windowed = frames * win

    def cufft():
        spec = torch.fft.rfft(windowed, n=C.N_FFT, dim=-1)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(power @ mel, min=C.LOG_EPS))

    out = []
    for tag, this, oth, plain in (
            ("frontend rows (row 1)",
             lambda: cuda_frontend.fused_logmel_rows_cuda(ext, T),
             lambda: ocf.fused_logmel_rows_cuda(ext, T),
             logmel_from_extended(ext, T)),
            ("frontend frames (row 2)",
             lambda: cuda_frontend.fused_logmel_cuda(frames),
             lambda: ocf.fused_logmel_cuda(frames),
             logmel_from_frames(frames))):
        fns = {"this": this, "other": oth, "cufft": cufft}
        res = {"tag": tag, "B": cs.CHECK_B, "T": T}
        for b in ("this", "other"):
            got = fns[b]()
            torch.cuda.synchronize()
            err = float((got - plain).abs().max())
            cs.check(bool(torch.isfinite(got).all())
                     and err <= cs.TOL["frontend_logmel"],
                     f"{tag} {b}: max abs {err:.3e} vs plain")
            res[f"{b} max abs"] = err
        print(f"[ab] {tag}: max abs vs plain this {res['this max abs']:.3e},"
              f" other {res['other max abs']:.3e}")
        replays = {n: cs.graph_of(fn, mode="relaxed")[0]
                   for n, fn in fns.items()}
        res.update(report(tag, timed(fns, rounds, replays),
                          [("other", "this"), ("this", "cufft"),
                           ("other", "cufft")]))
        out.append(res)
    return out


def shares(got, want, room) -> tuple[float, float]:
    """(share of the derived gradient bar, share of the old one)."""
    new = cs.excess(got, want, 2 ** -7, 1e-3, extra=room)
    return new, cs.excess(got, want, 2 ** -7, 1e-3)


def flash_case(dev, rng, other, rounds, tag, B, T, lens_cpu, chunk, left):
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac

    oac = importlib.import_module(f"{other.__name__}.ops.attention_cuda")
    mcfg = preset_config(cs.CONF_PRESET).model
    h, dh = mcfg.attn_heads, mcfg.attn_dim // mcfg.attn_heads
    d = h * dh
    lens = lens_cpu.to(torch.int32).to(dev)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    qkv, do = bf(B, T, 3 * d), bf(B, T, h, dh)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(B, T, h, dh)
               for i in range(3))
    o_p, lse_p = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
    o_scale = o_p.float().abs() + ac.flash_fwd_plain(
        q, k, v.abs(), lens, chunk, left)[0].float()
    live = lse_p > ac.NEG / 2
    d_rows = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
    plain = (ac.flash_bwd_dq_plain(*args), *ac.flash_bwd_dkv_plain(*args))
    room = ac.bwd_rounding_room(*args)
    ok = ac.allowed_mask(T, lens, chunk, left)
    res = {"tag": tag, "B": B, "T": T, "chunk": chunk, "left": left,
           "pairs": int(ok.expand(B, 1, T, T).sum()) * h}
    mods = {"this": ac, "other": oac}
    outs = {}
    for b, m in mods.items():
        o, lse = m.flash_fwd_cuda(q, k, v, lens, chunk, left)
        grads = (m.flash_bwd_dq_cuda(*args), *m.flash_bwd_dkv_cuda(*args))
        torch.cuda.synchronize()
        outs[b] = (o, lse, *grads)
        out_share = cs.excess(o, o_p, *cs.TOL["flash_bf16"], o_scale)
        lse_share = cs.excess(lse[live], lse_p[live], *cs.TOL["flash_fp32"])
        g = [shares(a, p, r) for a, p, r in zip(grads, plain, room)]
        cs.check(out_share <= 1 and lse_share <= 1,
                 f"{tag} {b}: forward breaks its bar ({out_share:.3f}, "
                 f"{lse_share:.3f})")
        cs.check(max(x[0] for x in g) <= 1,
                 f"{tag} {b}: a gradient breaks the derived bar")
        res[f"{b} shares"] = {"out": out_share, "lse": lse_share, **{
            n: {"derived": x[0], "old": x[1]}
            for n, x in zip(("dq", "dk", "dv"), g)}}
        print(f"[ab] {tag} {b}: bar shares out {out_share:.3f}, lse "
              f"{lse_share:.3f}; derived (old) gradient bar: " + ", ".join(
                  f"{n} {x[0]:.3f} ({x[1]:.3f})"
                  for n, x in zip(("dq", "dk", "dv"), g)))

    # the two builds bitwise: bf16 here, fp32 on the same inputs widened
    same = {"bf16": all(cs.same_bits(a, b) for a, b in zip(outs["this"],
                                                          outs["other"]))}
    args32 = tuple(x.float() if torch.is_tensor(x) and x.is_floating_point()
                   else x for x in args)
    q32, k32, v32 = args32[:3]
    outs32 = [(m.flash_fwd_cuda(q32, k32, v32, lens, chunk, left),
               m.flash_bwd_dq_cuda(*args32), m.flash_bwd_dkv_cuda(*args32))
              for m in mods.values()]
    flat = [[o, lse, dq, dk, dv] for (o, lse), dq, (dk, dv) in outs32]
    same["fp32"] = all(cs.same_bits(a, b) for a, b in zip(*flat))
    res["bitwise"] = same
    print(f"[ab] {tag}: this build's outputs (out, lse, dq, dk, dv) bitwise "
          f"the other build's: " + ", ".join(
              f"{k} {'yes' if v else 'NO'}" for k, v in same.items()))
    cs.check(all(same.values()), f"{tag}: the builds' outputs differ")

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=ok)

    sdpa_train = lambda: F.scaled_dot_product_attention(*leaves,
                                                        attn_mask=ok)
    fns = {}
    for b, m in mods.items():
        fns[f"{b} fwd"] = lambda m=m: m.flash_fwd_cuda(q, k, v, lens, chunk,
                                                       left)
        fns[f"{b} dq"] = lambda m=m: m.flash_bwd_dq_cuda(*args)
        fns[f"{b} dkv"] = lambda m=m: m.flash_bwd_dkv_cuda(*args)
    fns["sdpa fwd"] = sdpa_fwd
    fns["sdpa fwd+bwd"] = lambda: torch.autograd.grad(sdpa_train(), leaves,
                                                      doh)
    fns["sdpa train fwd"] = sdpa_train
    replays = {n: cs.graph_of(fn, mode="relaxed")[0] for n, fn in fns.items()}
    times = timed(fns, rounds, replays)
    for t in times.values():
        t["sdpa bwd"] = [a - b for a, b in zip(t["sdpa fwd+bwd"],
                                                t["sdpa train fwd"])]
        for b in mods:
            t[f"{b} pair"] = [x + y for x, y in zip(t[f"{b} dq"],
                                                    t[f"{b} dkv"])]
    res.update(report(f"{tag} B={B} T'={T} chunk {chunk}/{left}", times, [
        ("other fwd", "this fwd"), ("this fwd", "sdpa fwd"),
        ("other fwd", "sdpa fwd"), ("other pair", "this pair"),
        ("this pair", "sdpa bwd"), ("other pair", "sdpa bwd")]))
    return res


def lstm_case(dev, rng, other, rounds, tag, B, T, lens, train: bool):
    """Row 6 (the residual-free form, or the training form with row 7)
    in bf16 at bilstm_deep's width: both builds held to the plain versions
    at 3e-2 (forward) and 5e-2 (gradient), then timed with cuDNN's LSTM in
    the same rounds; under fp32 the two builds' forward forms, backward and
    stream form, which the FMA kernels keep, must agree bit for bit."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    orc = importlib.import_module(f"{other.__name__}.ops.rnn_cuda")
    H = preset_config(cs.LSTM_PRESET).model.rnn_hidden
    lo, hi = cs.rnn_rows(lens.to(torch.float32), T, dev)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    w = f32(2, H, 4 * H) / np.sqrt(H)
    xs32, g = f32(T, 2 * B, 4 * H), f32(T, 2 * B, H)
    h0 = 0.5 * f32(2 * B, 2 * H)
    cdt = torch.bfloat16
    xs = xs32.to(cdt)
    mods = {"this": rc, "other": orc}
    res = {"tag": tag, "B": B, "T": T, "H": H}
    if train:
        ys_p, cs_p, gates_p = rc.lstm_scan_train_plain(xs, w, lo, hi, cdt)
        dxs_p = rc.lstm_bwd_plain(gates_p, w, lo, hi, cs_p, g, cdt)
    else:
        ys_p = rc.lstm_scan_plain(xs, w, lo, hi, cdt)
    bf16 = {}
    for b, m in mods.items():
        if train:
            ys, c, gates = m.lstm_scan_train_cuda(xs, w, lo, hi, cdt)
            dxs = m.lstm_bwd_cuda(gates_p, w, lo, hi, cs_p, g, cdt)
            err = {"ys": ys - ys_p, "cs": c - cs_p,
                   "gates": gates.float() - gates_p.float(),
                   "dxs": dxs.float() - dxs_p.float()}
            bf16[b] = [ys, c, gates, dxs]
        else:
            bf16[b] = [m.lstm_scan_cuda(xs, w, lo, hi, cdt)]
            err = {"ys": bf16[b][0] - ys_p}
        torch.cuda.synchronize()
        err = {n: float(e.abs().max()) for n, e in err.items()}
        res[f"{b} max abs"] = err
        print(f"[ab] {tag} {b}: max abs vs plain " + ", ".join(
            f"{n} {e:.3e}" for n, e in err.items()))
        cs.check(all(e <= (cs.TOL["gru_grad_bf16"] if n == "dxs" else
                           cs.TOL["gru_bf16"]) for n, e in err.items()),
                 f"{tag} {b}: breaks the bf16 bar")
    bf16_bits(res, tag, bf16)
    # the forms the FMA kernels keep: bitwise those of the other build
    kept = {}
    f32 = torch.float32
    for b, m in mods.items():
        ys, c, gates = m.lstm_scan_train_cuda(xs32, w, lo, hi, f32)
        kept[b] = [m.lstm_scan_cuda(xs32, w, lo, hi, f32), ys, c, gates,
                   m.lstm_bwd_cuda(gates, w, lo, hi, c, g, f32),
                   *m.lstm_scan_stream_cuda(xs32, w, lo, hi, h0, f32,
                                            T // 2)]
    torch.cuda.synchronize()
    res["kept forms bitwise equal"] = cs.same_bits(kept["this"],
                                                   kept["other"])
    print(f"[ab] {tag}: fp32 forward, training forward and backward and "
          f"the fp32 stream form bitwise equal across the builds: "
          f"{res['kept forms bitwise equal']}")
    cs.check(res["kept forms bitwise equal"],
             f"{tag}: a kept form differs from the other build's")

    lib = cs.library_rnn_fns("lstm", dev, T, B, H, lens, cdt)
    fns = {}
    for b, m in mods.items():
        if train:
            fns[f"{b} fwd_train"] = lambda m=m: m.lstm_scan_train_cuda(
                xs, w, lo, hi, cdt)
            fns[f"{b} bwd"] = lambda m=m: m.lstm_bwd_cuda(
                gates_p, w, lo, hi, cs_p, g, cdt)
        else:
            fns[f"{b} fwd"] = lambda m=m: m.lstm_scan_cuda(xs, w, lo, hi,
                                                           cdt)
    if train:
        fns["cudnn train fwd"] = lib["training forward"]
        fns["cudnn fwd+bwd"] = lib["forward+backward"]
        pairs = [("other fwd_train", "this fwd_train"),
                 ("this fwd_train", "cudnn train fwd"),
                 ("other bwd", "this bwd"), ("this bwd", "cudnn bwd")]
    else:
        fns["cudnn fwd"] = lib["forward"]
        pairs = [("other fwd", "this fwd"), ("this fwd", "cudnn fwd"),
                 ("other fwd", "cudnn fwd")]
    replays = {n: cs.graph_of(fn, mode="relaxed")[0] for n, fn in fns.items()}
    times = timed(fns, rounds, replays)
    if train:
        for t in times.values():
            t["cudnn bwd"] = [a - b for a, b in zip(t["cudnn fwd+bwd"],
                                                    t["cudnn train fwd"])]
    res.update(report(f"{tag} B={B} T'={T} H={H}", times, pairs))
    return res


def bf16_bits(res: dict, tag: str, outs: dict) -> None:
    """Whether the two builds' bf16-compute outputs (``outs``: {"this":
    [...], "other": [...]}) are bitwise equal, recorded and printed (a
    redesign may change them; a change that keeps a path must not)."""
    import torch

    torch.cuda.synchronize()
    res["bf16 bitwise equal"] = cs.same_bits(outs["this"], outs["other"])
    print(f"[ab] {tag}: the bf16 outputs bitwise equal across the builds: "
          f"{res['bf16 bitwise equal']}")


def bwd_carries(m, ys):
    """What a build's GRU backward takes for h_prev: ys itself (it reads
    one step back in place) or, in builds before that, ``shift_prev(ys)``."""
    takes_ys = "ys" in inspect.signature(m.gru_bwd_cuda).parameters
    return ys if takes_ys else m.shift_prev(ys)


def gru_case(dev, rng, other, rounds, tag, B, T, lens, train: bool,
             ndir: int):
    """Row 3 (the residual-free form, ndir 2 or 1), or the training form
    (row 4) with the backward (row 5), in bf16 at bigru's and uni_gru's
    width: both builds held to the plain versions at 3e-2 (forward) and
    5e-2 (gradients), then timed with cuDNN's GRU in the same rounds; the
    forms the FMA kernels keep (fp32 forward, training forward and
    backward; the stream form in fp32) must agree bit for bit across the
    builds."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    orc = importlib.import_module(f"{other.__name__}.ops.rnn_cuda")
    H = preset_config(cs.PRESET if ndir == 2 else cs.UNI_PRESET) \
        .model.rnn_hidden
    if ndir == 2:
        lo, hi = cs.rnn_rows(lens.to(torch.float32), T, dev)
    else:
        lo = torch.zeros(B, 1, device=dev)
        hi = lens.to(torch.float32)[:, None].to(dev)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev)
    w = f32(ndir, H, 3 * H) / np.sqrt(H)
    xs32, g = f32(T, ndir * B, 3 * H), f32(T, ndir * B, H)
    h0 = 0.5 * f32(ndir * B, H)
    cdt = torch.bfloat16
    xs = xs32.to(cdt)
    mods = {"this": rc, "other": orc}
    res = {"tag": tag, "B": B, "T": T, "H": H, "ndir": ndir}
    if train:
        ys_p, gates_p = rc.gru_scan_train_plain(xs, w, lo, hi, cdt)
        dxs_p, dhn_p = rc.gru_bwd_plain(gates_p, w, lo, hi,
                                        rc.shift_prev(ys_p), g, cdt)
        prev = {b: bwd_carries(m, ys_p) for b, m in mods.items()}
    else:
        ys_p = rc.gru_scan_plain(xs, w, lo, hi, cdt)
    bf16 = {}
    for b, m in mods.items():
        if train:
            ys, gates = m.gru_scan_train_cuda(xs, w, lo, hi, cdt)
            dxs, dhn = m.gru_bwd_cuda(gates_p, w, lo, hi, prev[b], g, cdt)
            err = {"ys": ys - ys_p, "gates": gates.float() - gates_p.float(),
                   "dxs": dxs.float() - dxs_p.float(),
                   "dhn": dhn.float() - dhn_p.float()}
            bf16[b] = [ys, gates, dxs, dhn]
        else:
            bf16[b] = [m.gru_scan_cuda(xs, w, lo, hi, cdt)]
            err = {"ys": bf16[b][0] - ys_p}
        torch.cuda.synchronize()
        err = {n: float(e.abs().max()) for n, e in err.items()}
        res[f"{b} max abs"] = err
        print(f"[ab] {tag} {b}: max abs vs plain " + ", ".join(
            f"{n} {e:.3e}" for n, e in err.items()))
        cs.check(all(e <= (cs.TOL["gru_grad_bf16"] if n in ("dxs", "dhn")
                           else cs.TOL["gru_bf16"]) for n, e in err.items()),
                 f"{tag} {b}: breaks the bf16 bar")
    bf16_bits(res, tag, bf16)
    # the forms the FMA kernels keep: bitwise those of the other build
    kept = {}
    f32 = torch.float32
    for b, m in mods.items():
        out = [m.gru_scan_cuda(xs32, w, lo, hi, f32)]
        if ndir == 2:
            ys, gates = m.gru_scan_train_cuda(xs32, w, lo, hi, f32)
            out += [ys, gates, *m.gru_bwd_cuda(gates, w, lo, hi,
                                               bwd_carries(m, ys), g, f32)]
        kept[b] = out + list(m.gru_scan_stream_cuda(xs32, w, lo, hi, h0, f32,
                                                    T // 2))
    torch.cuda.synchronize()
    res["kept forms bitwise equal"] = cs.same_bits(kept["this"],
                                                   kept["other"])
    print(f"[ab] {tag}: fp32 forward"
          + (", training forward and backward" if ndir == 2 else "")
          + " and the fp32 stream form bitwise equal across the builds: "
          f"{res['kept forms bitwise equal']}")
    cs.check(res["kept forms bitwise equal"],
             f"{tag}: a kept form differs from the other build's")

    lib = cs.library_rnn_fns("gru", dev, T, B, H, lens, cdt, ndir)
    fns = {}
    for b, m in mods.items():
        if train:
            fns[f"{b} fwd_train"] = lambda m=m: m.gru_scan_train_cuda(
                xs, w, lo, hi, cdt)
            fns[f"{b} bwd"] = lambda m=m, b=b: m.gru_bwd_cuda(
                gates_p, w, lo, hi, prev[b], g, cdt)
        else:
            fns[f"{b} fwd"] = lambda m=m: m.gru_scan_cuda(xs, w, lo, hi, cdt)
    if train:
        fns["cudnn train fwd"] = lib["training forward"]
        fns["cudnn fwd+bwd"] = lib["forward+backward"]
        pairs = [("other fwd_train", "this fwd_train"),
                 ("this fwd_train", "cudnn train fwd"),
                 ("other bwd", "this bwd"), ("this bwd", "cudnn bwd")]
    else:
        fns["cudnn fwd"] = lib["forward"]
        pairs = [("other fwd", "this fwd"), ("this fwd", "cudnn fwd"),
                 ("other fwd", "cudnn fwd")]
    replays = {n: cs.graph_of(fn, mode="relaxed")[0] for n, fn in fns.items()}
    times = timed(fns, rounds, replays)
    if train:
        for t in times.values():
            t["cudnn bwd"] = [a - b for a, b in zip(t["cudnn fwd+bwd"],
                                                    t["cudnn train fwd"])]
    res.update(report(f"{tag} B={B} T'={T} H={H}", times, pairs))
    return res


def stream_case(dev, rng, other, rounds, tag, cell, ndir, B, T, emit, H):
    """Row 8 at one streaming window (``chip_smoke.stream_cases``): both
    builds' bf16 stream forms held to the plain version at 3e-2 (ys and
    carry, emit_t = C/s) and the fp32 stream form bitwise equal across the
    builds (emit_t 0, C/s and T), then the bf16 form timed with cuDNN over
    the same window, hx = h0 (``chip_smoke.library_stream``), in the same
    rounds."""
    import torch

    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    orc = importlib.import_module(f"{other.__name__}.ops.rnn_cuda")
    fn = f"{cell}_scan_stream"
    lens, lo, hi, w, xs32, h0 = cs.stream_inputs(rng, dev, cell, ndir, B, T,
                                                  emit, H)
    cdt = torch.bfloat16
    xs = xs32.to(cdt)
    mods = {"this": rc, "other": orc}
    res = {"tag": tag, "B": B, "T": T, "H": H, "ndir": ndir, "emit_t": emit}
    ys_p, carry_p = getattr(rc, f"{fn}_plain")(xs, w, lo, hi, h0, cdt, emit)
    kept, bf16 = {}, {}
    for b, m in mods.items():
        ys, carry = getattr(m, f"{fn}_cuda")(xs, w, lo, hi, h0, cdt, emit)
        bf16[b] = [ys, carry]
        kept[b] = [getattr(m, f"{fn}_cuda")(xs32, w, lo, hi, h0,
                                            torch.float32, e)
                   for e in (0, emit, T)]
        torch.cuda.synchronize()
        err = {"ys": float((ys - ys_p).abs().max()),
               "carry": float((carry - carry_p).abs().max())}
        res[f"{b} max abs"] = err
        print(f"[ab] {tag} {b}: max abs vs plain " + ", ".join(
            f"{n} {e:.3e}" for n, e in err.items()))
        cs.check(max(err.values()) <= cs.TOL["gru_bf16"],
                 f"{tag} {b}: breaks the bf16 bar")
    bf16_bits(res, tag, bf16)
    res["kept forms bitwise equal"] = cs.same_bits(kept["this"],
                                                   kept["other"])
    print(f"[ab] {tag}: the fp32 stream form (emit_t 0, {emit}, {T}) "
          f"bitwise equal across the builds: "
          f"{res['kept forms bitwise equal']}")
    cs.check(res["kept forms bitwise equal"],
             f"{tag}: the fp32 stream form differs from the other build's")
    fns = {f"{b} stream": (lambda m=m: getattr(m, f"{fn}_cuda")(
               xs, w, lo, hi, h0, cdt, emit)) for b, m in mods.items()}
    fns["cudnn stream"] = cs.library_stream(cell, dev, T, B, H, ndir,
                                            lens.long(), h0, cdt)
    replays = {n: cs.graph_of(f, mode="relaxed")[0] for n, f in fns.items()}
    res.update(report(f"{tag} B={B} T={T} H={H} ndir={ndir}",
                      timed(fns, rounds, replays),
                      [("other stream", "this stream"),
                       ("this stream", "cudnn stream"),
                       ("other stream", "cudnn stream")]))
    return res


def ctc_case(dev, rng, other, rounds, tag, seconds, T, lens, L):
    """Rows 9-10 at one shape (``chip_smoke.ctc_cases``): both builds held
    to the plain recursions at phase 7's bars and bitwise to each other
    (alphas, loss; grad on the plain alphas), then timed with F.ctc_loss in
    the same rounds."""
    import torch

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import ctc_cuda as cc
    from chainer_speech_recognition_tpu_torch.ops.ctc import (
        ctc_alpha_plain, ctc_beta_grad_plain)

    occ = importlib.import_module(f"{other.__name__}.ops.ctc_cuda")
    V = preset_config(cs.PRESET).model.vocab_size
    logits, labels, lab_len = cs.ctc_draws(rng, seconds, T, L, V)
    args, lib = cs.ctc_setup(dev, logits, lens, labels, lab_len)
    alphas_p, loss_p = ctc_alpha_plain(*args)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, len(seconds)).astype(
        np.float32)).to(dev)
    bwd_args = (*args, alphas_p, loss_p, g)
    grad_p = ctc_beta_grad_plain(*bwd_args)
    S = args[0].shape[2]
    res = {"tag": tag, "B": len(seconds), "T": T, "S": S,
           "plan": {f: list(cc.ctc_plan(S, f)) for f in ("fwd", "bwd")}}
    outs = {}
    mods = {"this": cc, "other": occ}
    for b, m in mods.items():
        alphas, loss = m.ctc_fwd_cuda(*args)
        grad = m.ctc_bwd_cuda(*bwd_args)
        torch.cuda.synchronize()
        a = cs.ctc_alpha_check(alphas, loss, alphas_p, loss_p)
        gerr = float((grad - grad_p).abs().max())
        res[f"{b} vs plain"] = {
            "loss rel": a["rel"], "alphas max abs": a["aerr"],
            "grad max abs": gerr, "bitwise": cs.same_bits(
                (alphas, loss, grad), (alphas_p, loss_p, grad_p))}
        print(f"[ab] {tag} {b}: vs plain loss rel {a['rel']:.3e}, alphas "
              f"max abs {a['aerr']:.3e}, grad max abs {gerr:.3e}; bitwise "
              f"the plain recursions': {res[f'{b} vs plain']['bitwise']}")
        cs.check(a["rel"] <= cs.TOL["ctc_loss_rtol"] and a["sent_ok"]
                 and a["alpha_ok"] and gerr <= cs.TOL["ctc_grad"],
                 f"{tag} {b}: breaks a CTC bar")
        outs[b] = (alphas, loss, grad)
    res["bitwise equal"] = cs.same_bits(outs["this"], outs["other"])
    print(f"[ab] {tag}: alphas, loss and grad bitwise equal across the "
          f"builds: {res['bitwise equal']}; plan {res['plan']}")
    cs.check(res["bitwise equal"], f"{tag}: the builds' outputs differ")
    fns = {}
    for b, m in mods.items():
        fns[f"{b} fwd"] = lambda m=m: m.ctc_fwd_cuda(*args)
        fns[f"{b} bwd"] = lambda m=m: m.ctc_bwd_cuda(*bwd_args)
    replays = {n: cs.graph_of(f, mode="relaxed")[0] for n, f in fns.items()}
    for n, f in lib.items():
        fns[f"F.ctc_loss {n}"] = f
        replays[f"F.ctc_loss {n}"] = cs.ctc_library_replay(f)
    times = timed(fns, rounds, replays)
    for t in times.values():
        t["F.ctc_loss bwd"] = [a - b for a, b in zip(
            t["F.ctc_loss forward+backward"], t["F.ctc_loss forward"])]
    res.update(report(f"{tag} B={len(seconds)} T'={T} S={S}", times, [
        ("other fwd", "this fwd"), ("other bwd", "this bwd"),
        ("this fwd", "F.ctc_loss forward"), ("this bwd", "F.ctc_loss bwd")]))
    med = res["graph"]["ms"]
    print(f"[ab] {tag}: a step (graph ms / T'): " + ", ".join(
        f"{n} {med[n] / T * 1e3:.4f} us" for n in fns if "ctc_loss" not in n))
    return res


def greedy_case(dev, rng, other, rounds, tag, B, T, V):
    """Row 14: this build's greedy_decode (one launch: argmax, keep mask
    and compaction) against the other build's (its kernel, then
    compact_kept in torch), each through its own package, on the same
    logits (planted ties and NaN frames, lengths 0, 1 and T'); both must
    equal the plain version exactly."""
    import torch

    from chainer_speech_recognition_tpu_torch.decode import greedy as gd

    og = importlib.import_module(f"{other.__name__}.decode.greedy")
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logits[0, 3, [5, 9]] = 7.0
    logits[1, 2, 7] = np.nan
    logits[1, 5, :] = np.nan
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lens[:3] = [0, 1, T]
    lg, ln = torch.from_numpy(logits).to(dev), torch.from_numpy(lens).to(dev)
    want = gd.compact_kept(*gd.best_keep_plain(lg, ln), T)
    mods = {"this": gd, "other": og}
    res = {"tag": tag, "B": B, "T": T, "V": V}
    for b, m in mods.items():
        got = m.greedy_decode(lg, ln)
        torch.cuda.synchronize()
        res[f"{b} equals plain"] = cs.same_bits(tuple(got), tuple(want))
        cs.check(res[f"{b} equals plain"], f"{tag} {b}: differs from plain")
    print(f"[ab] {tag}: both builds equal the plain version exactly")
    fns = {f"{b} greedy_decode": (lambda m=m: m.greedy_decode(lg, ln))
           for b, m in mods.items()}
    replays = {n: cs.graph_of(f, mode="relaxed")[0] for n, f in fns.items()}
    res.update(report(f"{tag} B={B} T'={T} V={V}",
                      timed(fns, rounds, replays),
                      [("other greedy_decode", "this greedy_decode")]))
    return res


def dw_case(dev, rng, other, rounds, tag, T, B, H, cell):
    """The recurrent weights' gradient of one training layer: this build's
    ``rnn_dw`` (the dW kernel, one launch; the GRU's two products in one)
    against the other build's chain as its backward ran it (shift_prev,
    dw_matmul per gate tensor on the card, cat for the GRU) and cuBLAS's
    bmm (bf16 operands laid out per direction beforehand, fp32 out), on
    the same ys (fp32) and bf16 gate gradients; held to the other build's
    result at 2·K·2⁻²³·Σ|h·g| (both sum exact products in fp32)."""
    import torch

    from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc

    orc = importlib.import_module(f"{other.__name__}.ops.rnn_cuda")
    cdt = torch.bfloat16
    ys = torch.from_numpy(rng.uniform(-1, 1, (T, 2 * B, H)).astype(
        np.float32)).to(dev)
    widths = (3 * H, H) if cell == "gru" else (4 * H,)
    gs = [torch.from_numpy(rng.standard_normal((T, 2 * B, n)).astype(
        np.float32)).to(dev).to(cdt) for n in widths]
    gates = (gs[0][..., :2 * H], gs[1]) if cell == "gru" else (gs[0],)

    def this():
        return rc.rnn_dw(ys, gates, B, cdt)

    def chain():
        h_prev = orc.shift_prev(ys)
        d = [orc.dw_matmul(h_prev, g, B, cdt) for g in gates]
        return d[0] if len(d) == 1 else torch.cat(d, dim=2)

    N = sum(g.shape[2] for g in gates)
    hp = rc.shift_prev(ys).to(cdt)
    a = torch.stack([hp[:, d * B:(d + 1) * B].reshape(-1, H)
                     for d in (0, 1)]).transpose(1, 2)
    gb = torch.cat(list(gates), dim=2)
    bm = torch.stack([gb[:, d * B:(d + 1) * B].reshape(-1, N)
                      for d in (0, 1)]).contiguous()
    library = lambda: torch.bmm(a, bm, out_dtype=torch.float32)
    got, want = this(), chain()
    absum = torch.stack([a[d].double().abs() @ bm[d].double().abs()
                         for d in (0, 1)])
    bar = 2 * T * B * 2.0 ** -23 * absum
    ex = float(((got.double() - want.double()).abs()
                / (bar + torch.finfo(torch.float64).tiny)).max())
    res = {"tag": tag, "T": T, "B": B, "H": H, "N": N,
           "this vs other |d|/bar": ex,
           "cuBLAS max abs vs other": float((library() - want).abs().max())}
    print(f"[ab] {tag}: this vs the other build's chain |Δ| / (2·K·2^-23·"
          f"Σ|h·g|) {ex:.3e}; cuBLAS bmm max abs vs it "
          f"{res['cuBLAS max abs vs other']:.3e}")
    cs.check(ex <= 1, f"{tag}: this build's dW breaks the bar")
    if hasattr(orc, "dw_cuda"):       # the other build's own dW kernel
        bf16_bits(res, tag, {"this": [got], "other": [orc.dw_cuda(
            ys, gates, B)]})
    fns = {"this rnn_dw": this, "other chain": chain, "cuBLAS bmm": library}
    replays = {n: cs.graph_of(f, mode="relaxed")[0] for n, f in fns.items()}
    res.update(report(f"{tag} T'={T} B={B} H={H} N={N}",
                      timed(fns, rounds, replays),
                      [("other chain", "this rnn_dw"),
                       ("this rnn_dw", "cuBLAS bmm")]))
    return res


def beam_case(dev, rng, other, rounds, tag, B, T, V, K):
    """The beam's narrow form at K ≤ 32: this build's and the other
    build's ``beam_chunk_cuda`` (each through its own wrapper and
    ``DeviceLM``) on the same log-probs, dense 3-gram table and fresh
    state, in the 1-best, n-best and chunk forms; every output bitwise
    equal across the builds, this build's equal to the plain version at
    phase 23's bars; the 1-best form timed."""
    import torch

    from chainer_speech_recognition_tpu_torch.decode import beam as tb
    from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda

    ob = importlib.import_module(f"{other.__name__}.decode.beam")
    obc = importlib.import_module(f"{other.__name__}.ops.beam_cuda")
    x = rng.standard_normal((B, T, V)).astype(np.float32) * 2
    path = rng.integers(0, V, (B, T))
    for r in range(B):
        x[r, np.arange(T), path[r]] += 3.0
    lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
    lens[0] = T
    lm = NGramLM(3, V)
    lm.logp[0][()] = {c: float(np.log(0.8 / (V - 1))) for c in range(1, V)}
    for k in (1, 2):
        for ctx in {tuple(int(c) for c in rng.integers(1, V, k))
                    for _ in range(400)}:
            succ = rng.integers(1, V, size=5)
            lm.logp[k][ctx] = {int(c): float(p) for c, p in zip(
                succ, np.log(rng.dirichlet(np.ones(5)) * 0.7))}
            lm.backoff[k][ctx] = float(np.log(0.3))
    table = lm.to_dense()
    lp = tb._log_probs(torch.from_numpy(x).to(dev))
    ln = torch.from_numpy(lens).to(dev)
    mods = {"this": (tb, beam_cuda), "other": (ob, obc)}
    dlms = {n: m.lm_on_device(table, V, dev) for n, (m, _) in mods.items()}
    a, b = cs.BEAM_ALPHA, cs.BEAM_BETA
    res = {"tag": tag, "B": B, "T": T, "V": V, "K": K, "bitwise equal": True}
    for ordered, keep in ((True, 1), (True, K), (False, K)):
        outs = {}
        for n, (m, c) in mods.items():
            s0 = m.beam_stream_init(B, K, dlms[n].ctx_len, dev)
            got = c.beam_chunk_cuda(lp, ln, s0, dlms[n], a, b, keep, T,
                                    ordered)
            outs[n] = (*got[:4], *got[4])
        torch.cuda.synchronize()
        s0 = tb.beam_stream_init(B, K, dlms["this"].ctx_len, dev)
        want = tb.beam_chunk_plain(lp, ln, s0, dlms["this"], a, b, keep, T,
                                   ordered)
        cs.beam_same(f"{tag} keep={keep} ordered={ordered}",
                     (*outs["this"][:4], outs["this"][4:]), want)
        res["bitwise equal"] &= cs.same_bits(outs["this"], outs["other"])
    print(f"[ab] {tag}: this build equals the plain version; the builds' "
          f"outputs bitwise equal: {res['bitwise equal']}")
    cs.check(res["bitwise equal"], f"{tag}: the builds' outputs differ")
    fns = {}
    for n, (m, c) in mods.items():
        s0 = m.beam_stream_init(B, K, dlms[n].ctx_len, dev)
        fns[f"{n} beam"] = (lambda c=c, s0=s0, d=dlms[n]: c.beam_chunk_cuda(
            lp, ln, s0, d, a, b, 1, T, True)[0])
    replays = {n: cs.graph_of(f, mode="relaxed")[0] for n, f in fns.items()}
    res.update(report(f"{tag} B={B} T'={T} V={V} K={K} dense 3-gram",
                      timed(fns, rounds, replays),
                      [("other beam", "this beam")]))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--seed", type=int, default=cs.SEED)
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated subset of {CASES}")
    a = ap.parse_args()
    cases = a.cases.split(",")
    try:
        name, smi = cs.phase_device()
        import torch

        from chainer_speech_recognition_tpu_torch import _kernels
        from chainer_speech_recognition_tpu_torch.config import preset_config

        dev = torch.device("cuda")
        _kernels.library()
        other = load_checkout(os.path.abspath(a.other), "other_port")
        rng = np.random.default_rng(a.seed)
        out = []
        if "frontend" in cases:
            out += frontend_cases(dev, rng, other, a.rounds)
        if "flash" in cases:
            out += [flash_case(dev, rng, other, a.rounds, *c)
                    for c in cs.attention_cases(rng)]
        if "lstm" in cases:
            out += [lstm_case(dev, rng, other, a.rounds, *c)
                    for c in cs.lstm_cases(rng)]
        if "gru" in cases:
            out += [gru_case(dev, rng, other, a.rounds, *c)
                    for c in cs.gru_cases(rng)]
        if "stream" in cases:
            out += [stream_case(dev, rng, other, a.rounds, *c)
                    for c in cs.stream_cases() if c[0] in cs.TIMED_STREAM]
        if "ctc" in cases:
            out += [ctc_case(dev, rng, other, a.rounds, *c)
                    for c in cs.ctc_cases(rng)]
        if "greedy" in cases:
            V = preset_config(cs.PRESET).model.vocab_size
            out += [greedy_case(dev, rng, other, a.rounds,
                                f"greedy T'={T}", cs.CHECK_B, T, V)
                    for T in (251, 701)]
        if "dw" in cases:
            for p in (cs.LSTM_PRESET, cs.PRESET):
                m = preset_config(p).model
                out.append(dw_case(dev, rng, other, a.rounds, f"dw {p}", 256,
                                   cs.TRAIN_B, m.rnn_hidden, m.rnn_type))
        if "beam" in cases:
            V = preset_config(cs.PRESET).model.vocab_size
            out.append(beam_case(dev, rng, other, a.rounds, "beam narrow",
                                 cs.CHECK_B, cs.BEAM_FRAMES, V,
                                 cs.BEAM_WIDTH))
    except cs.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": smi, "other": os.path.abspath(a.other),
                      "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
