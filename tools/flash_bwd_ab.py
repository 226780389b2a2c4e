"""Time this checkout's flash-attention backward kernels against another
checkout's on one card, on the same inputs, by two yardsticks:

    python3 tools/flash_bwd_ab.py OTHER_ROOT [--rounds 9] [--seed 0]

OTHER_ROOT is the root of another checkout of the repo (for example an
older commit unpacked by ``git archive`` into a git-ignored directory)
whose ``csrc/attention_bwd.cu`` has the same C entry points,
``csr_flash_bwd_dq`` and ``csr_flash_bwd_dkv``. That one file is built
alone into its own shared library. Both builds are called through this
checkout's wrappers (``ops/attention_cuda.py``), so a call does the same
host work whichever build it launches.

At the shapes of ``chip_smoke.py`` phase 18 (bf16, h = 4, dh = 64: B = 32,
T' = 701 with chunk 0 and with chunk 16 / left 4; B = 24, T' = 256), each
build's dq and dk/dv and SDPA's backward (its forward and backward less its
training forward, as in phase 18) are timed in alternating rounds:

* graph: replays of a CUDA graph of 10 calls, device time only, as phase
  18 times the pair;
* eager: one call between CUDA events, median of 7 warm calls
  (``chip_smoke.time_ms``), so the wrapper's host time is in it wherever
  it exceeds the kernel's.

Prints the card, each build's largest share of the gradient bar against
the plain versions (phase 18's bar, 2^-7·|b| + 1e-3), the medians, and the
per-round ratio of the other build's pair to this one's with its spread;
the last line is all of it as JSON. Exits 1 without a card or if a build
disagrees with the plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


class OtherKernel:
    """A flash backward entry point of the other build (uncounted)."""

    def __init__(self, lib: ctypes.CDLL, kernel) -> None:
        self.symbol = kernel.symbol
        self.fn = getattr(lib, kernel.symbol)
        self.fn.argtypes = kernel.argtypes
        self.fn.restype = ctypes.c_int

    def launch(self, *args) -> None:
        err = self.fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol} (other build): CUDA error "
                               f"{err}")


def build_other(root: str):
    """Build ``root``'s ``attention_bwd.cu`` alone → (dq, dkv) entry
    points."""
    from chainer_speech_recognition_tpu_torch import _kernels

    src = os.path.join(root, "chainer_speech_recognition_tpu_torch", "csrc",
                       "attention_bwd.cu")
    out = os.path.join(_kernels._BUILD, "other")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"attention_bwd_{os.getpid()}.so")
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared",
                        "-o", so, src], capture_output=True, text=True)
    cs.check(r.returncode == 0, f"nvcc failed on {src}:\n{r.stdout}"
             f"{r.stderr}")
    lib = ctypes.CDLL(so)
    return (OtherKernel(lib, _kernels.FLASH_BWD_DQ),
            OtherKernel(lib, _kernels.FLASH_BWD_DKV))


@contextlib.contextmanager
def launching(build):
    """Inside the block the wrappers launch ``build``'s (dq, dkv) entry
    points (None: this checkout's)."""
    from chainer_speech_recognition_tpu_torch import _kernels

    saved = _kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKV
    if build is not None:
        _kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKV = build
    try:
        yield
    finally:
        _kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKV = saved


def cases(rng):
    """phase 18's three cases: (tag, B, T', lengths, chunk, left)."""
    from chainer_speech_recognition_tpu_torch import constants as C
    from chainer_speech_recognition_tpu_torch.config import preset_config

    mcfg = preset_config(cs.CONF_PRESET).model
    smcfg = preset_config(cs.CONF_STREAM).model
    n_long = int(cs.LONG_SECONDS[1] * C.SAMPLE_RATE)
    dec_len, T_dec = cs.subsampled(
        rng.uniform(*cs.LONG_SECONDS, cs.CHECK_B) * C.SAMPLE_RATE,
        C.num_frames(n_long), mcfg.conv_stride_time)
    tr_len, T_tr = cs.subsampled(
        rng.uniform(*cs.TRAIN_SECONDS, cs.TRAIN_B) * C.SAMPLE_RATE,
        cs.TRAIN_FRAMES, mcfg.conv_stride_time)
    for lens, T in ((dec_len, T_dec), (tr_len, T_tr)):
        lens[0], lens[1] = T, 1
    return [("long-form", cs.CHECK_B, T_dec, dec_len, 0, 0),
            ("chunk 16/4", cs.CHECK_B, T_dec, dec_len, smcfg.attn_chunk,
             smcfg.attn_left_chunks),
            ("training", cs.TRAIN_B, T_tr, tr_len, 0, 0)]


def run_case(dev, rng, other, rounds, tag, B, T, lens_cpu, chunk, left):
    import torch
    import torch.nn.functional as F

    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac

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
    d_rows = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
    plain = (ac.flash_bwd_dq_plain(*args), *ac.flash_bwd_dkv_plain(*args))
    ok = ac.allowed_mask(T, lens, chunk, left)
    pairs = int(ok.expand(B, 1, T, T).sum()) * h

    def call(build, name):
        fn = ac.flash_bwd_dq_cuda if name == "dq" else ac.flash_bwd_dkv_cuda

        def run():
            with launching(build):
                return fn(*args)
        return run

    builds = {"this": None, "other": other}
    fns = {f"{b} {n}": call(build, n) for b, build in builds.items()
           for n in ("dq", "dkv")}
    res = {"tag": tag, "B": B, "T": T, "chunk": chunk, "left": left,
           "pairs": pairs}
    for b in builds:
        got = (fns[f"{b} dq"](), *fns[f"{b} dkv"]())
        torch.cuda.synchronize()
        cs.check(all(bool(torch.isfinite(g.float()).all()) for g in got),
                 f"{tag} {b}: non-finite gradient")
        share = max(cs.excess(g, p, 2 ** -7, 1e-3)
                    for g, p in zip(got, plain))
        cs.check(share <= 1, f"{tag} {b}: a gradient breaks the bar "
                 f"({share:.3f} of it)")
        res[f"{b} bar share"] = share

    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    leaves = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]
    sdpa_train = lambda: F.scaled_dot_product_attention(*leaves,
                                                        attn_mask=ok)
    fns["sdpa fwd+bwd"] = lambda: torch.autograd.grad(sdpa_train(), leaves,
                                                      doh)
    fns["sdpa train fwd"] = sdpa_train

    replays = {n: cs.graph_of(fn, mode="relaxed")[0] for n, fn in fns.items()}
    graph = cs.alternating_ms(replays, rounds)
    eager = {n: [] for n in fns}
    for _ in range(rounds):
        for n, fn in fns.items():
            eager[n].append(cs.time_ms(fn, warmup=1, reps=7))
    for kind, t in (("graph", graph), ("eager", eager)):
        t["sdpa bwd"] = [a - b for a, b in zip(t["sdpa fwd+bwd"],
                                                t["sdpa train fwd"])]
        for b in builds:
            t[f"{b} pair"] = [x + y for x, y in zip(t[f"{b} dq"],
                                                    t[f"{b} dkv"])]
        ratio = [a / b for a, b in zip(t["other pair"], t["this pair"])]
        med = {n: statistics.median(x) for n, x in t.items()}
        res[kind] = dict(med, **{
            "other/this pair": statistics.median(ratio),
            "other/this rounds": [min(ratio), max(ratio)],
            "this pair/sdpa": med["this pair"] / med["sdpa bwd"],
            "other pair/sdpa": med["other pair"] / med["sdpa bwd"]})
        print(f"[ab] {tag} B={B} T'={T} chunk {chunk}/{left}, {kind}, "
              f"{rounds} alternating rounds (medians, ms): this dq "
              f"{med['this dq']:.4f} dkv {med['this dkv']:.4f} pair "
              f"{med['this pair']:.4f}; other dq {med['other dq']:.4f} dkv "
              f"{med['other dkv']:.4f} pair {med['other pair']:.4f}; SDPA "
              f"backward {med['sdpa bwd']:.4f}; other/this "
              f"{statistics.median(ratio):.3f} (rounds {min(ratio):.3f}-"
              f"{max(ratio):.3f}); pair/SDPA this "
              f"{res[kind]['this pair/sdpa']:.3f}, other "
              f"{res[kind]['other pair/sdpa']:.3f}")
    print(f"[ab] {tag}: gradient bar shares this "
          f"{res['this bar share']:.3f}, other {res['other bar share']:.3f}"
          f"; {pairs} allowed (query, key) pairs")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--seed", type=int, default=cs.SEED)
    a = ap.parse_args()
    try:
        name, smi = cs.phase_device()
        import torch

        dev = torch.device("cuda")
        from chainer_speech_recognition_tpu_torch import _kernels

        _kernels.library()
        other = build_other(os.path.abspath(a.other))
        rng = np.random.default_rng(a.seed)
        out = [run_case(dev, rng, other, a.rounds, *c) for c in cases(rng)]
    except cs.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"card": smi, "other": os.path.abspath(a.other),
                      "cases": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
