"""Where a beam frame's time goes on the card: a copy of the package whose
``csrc/beam.cu`` reads ``clock64()`` between the steps of each frame (row
0's first block, thread 0; every step ends at a block barrier, so thread
0's clock stands for the block's), one launch at each case, and the
cycles a frame of each step, summed over the live frames and divided by
their count:

    python3 tools/beam_clock.py [--cases V:K:lm,...] [--copy DIR]

The narrow form's steps: wait (the lp row's staging and the frame's first
barrier), prepare (step 2), merge (step 3), keys (the key sweep), thresh
(the warps' bests ranked), list (the candidates at or above it), rank (the
list ranked), advance (step 5). The wide form's: wait, prepare, merge,
radix (the passes), gather, survivors (their exchange), sort, advance.
The copy (default ``.chipscratch/v/clock``, git-ignored) is made anew;
its outputs are the kernel's (the patch only reads the clock). Shapes
and data as ``tools/kernel_ab.py``'s beam cases (B = 32, T' = 251).
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402
import kernel_ab as ab  # noqa: E402

NARROW_STEPS = ("wait", "prepare", "merge", "keys", "thresh", "list",
                "rank", "advance")
WIDE_STEPS = ("wait", "prepare", "merge", "radix", "gather", "survivors",
              "sort", "advance")
CLK = ("#include <cstdio>\n"
       "#define BEAM_CLK(i) if (blockIdx.x == 0 && threadIdx.x == 0) { "
       "const long long now_ = clock64(); clk_[i] += now_ - clk_t_; "
       "clk_t_ = now_; }\n")


def _sub(text: str, old: str, new: str) -> str:
    assert text.count(old) == 1, old
    return text.replace(old, new)


def _frame(body: str, marks: list, form: str, steps: tuple) -> str:
    """``body`` (one kernel's source) with the clock before its frame
    loop, a mark after each anchor of ``marks`` and the print at its
    end."""
    body = re.sub(r"(\n  for \(int t = 0; t < n; \+\+t\) \{\n)",
                  r"\n  long long clk_[8] = {}, clk_t_ = clock64();\1", body,
                  count=1)
    for i, anchor in enumerate(marks):
        body = _sub(body, anchor, anchor + f"    BEAM_CLK({i});\n")
    fmt = " ".join(f"{s}=%lld" for s in steps)
    args = ", ".join(f"n > 0 ? clk_[{i}] / n : 0LL" for i in range(8))
    close = body.rindex("\n}")
    return (body[:close] + "\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
            f'printf("[clock] {form} K=%d V=%d frames=%d cycles a frame: '
            f'{fmt}\\n", a.K, a.V, n, {args});' + body[close:])


def patch(src: str) -> str:
    """beam.cu with the clock marks in both kernels."""
    n0 = src.index("__global__ void __launch_bounds__(NT, 1) beam_kernel")
    n1 = src.index("// Dynamic shared memory past 48 KB")
    w0 = src.index("template <bool kStage, bool kWsShared>\n__global__")
    w1 = src.index("template <bool kStage, bool kWsShared>\nint launch_wide")
    narrow = _frame(src[n0:n1], [
        "    const State S = state_of(R, st);\n    __syncthreads();\n",
        "    if (tid == 0) sh.n_list = 0;\n    __syncthreads();\n",
        "    merge_stays(a, R, S, lpr);\n    __syncthreads();\n",
        "        w.step(V);\n      }\n    }\n",
        "      if (rank == K - 1) sh.thr = best;\n    }\n"
        "    __syncthreads();\n",
        "      if (c >= thr) list[atomicAdd(&sh.n_list, 1)] = c;\n    }\n"
        "    __syncthreads();\n",
        "      if (rank < K) sh.top[rank] = c;\n    }\n    __syncthreads();\n",
        "    st ^= 1;\n    __syncthreads();\n"], "narrow", NARROW_STEPS)
    wide = _frame(src[w0:w1], [
        "    const State S = state_of(R, st);\n    __syncthreads();\n",
        "    if (tid == 0) n_loc = 0;\n    __syncthreads();\n",
        "    merge_stays(a, R, S, lpr);\n    __syncthreads();\n",
        "      if (all) break;\n    }\n",
        "      pub[1] = s;\n    }\n    row_sync(C);\n",
        "        });\n      }\n    }\n    row_sync(C);\n",
        "    const unsigned long long* top = sort_desc(surv, tmp, K);\n",
        "    st ^= 1;\n    __syncthreads();\n"], "wide", WIDE_STEPS)
    return (CLK + src[:n0] + narrow + src[n1:w0] + wide + src[w1:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default="64:8:dense3,64:8:none,64:32:none,"
                    "2048:8:none,64:64:dense3,64:256:none,2048:64:none")
    ap.add_argument("--copy", default=os.path.join(ROOT, ".chipscratch",
                                                   "v", "clock"))
    ap.add_argument("--seed", type=int, default=cs.SEED)
    a = ap.parse_args()
    try:
        name, smi = cs.phase_device()
        import torch

        shutil.rmtree(a.copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, ab.PKG),
                        os.path.join(a.copy, ab.PKG),
                        ignore=shutil.ignore_patterns("_build"))
        path = os.path.join(a.copy, ab.PKG, "csrc", "beam.cu")
        with open(path) as f:
            src = f.read()
        with open(path, "w") as f:
            f.write(patch(src))
        pkg = ab.load_checkout(a.copy, "clock_port")
        tb = __import__(f"{pkg.__name__}.decode.beam", fromlist=["x"])
        bc = __import__(f"{pkg.__name__}.ops.beam_cuda", fromlist=["x"])
        lmm = __import__(f"{pkg.__name__}.decode.lm", fromlist=["x"])
        dev = torch.device("cuda")
        rng = np.random.default_rng(a.seed)
        B, T = cs.CHECK_B, cs.BEAM_FRAMES
        print(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,"
                              "clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
        for case in a.cases.split(","):
            V, K, kind = case.split(":")
            V, K = int(V), int(K)
            x = rng.standard_normal((B, T, V)).astype(np.float32) * 2
            path_ = rng.integers(0, V, (B, T))
            for r in range(B):
                x[r, np.arange(T), path_[r]] += 3.0
            lens = rng.integers(T // 2, T + 1, B).astype(np.int32)
            lens[0] = T
            lm = ab.beam_lm(rng, V, kind)
            if kind == "hashed10":
                lm = lmm.HashedLM(lm.table, lm.rows, lm.order, lm.max_probes)
            dlm = tb.lm_on_device(lm, V, dev)
            lp = tb._log_probs(torch.from_numpy(x).to(dev))
            ln = torch.from_numpy(lens).to(dev)
            plan = bc.beam_plan(T, V, K, dlm.ctx_len)
            print(f"[clock] case V={V} K={K} {kind}: plan {tuple(plan)}",
                  flush=True)
            for _ in range(2):
                s0 = tb.beam_stream_init(B, K, dlm.ctx_len, dev)
                bc.beam_chunk_cuda(lp, ln, s0, dlm, cs.BEAM_ALPHA,
                                   cs.BEAM_BETA, 1, T, True)
                torch.cuda.synchronize()
            sys.stdout.flush()
    except cs.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
