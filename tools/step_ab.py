"""Time the default-mode training step of this checkout against another
checkout's on one card, each through its own train CLI:

    python3 tools/step_ab.py OTHER_ROOT --out DIR
                [--presets bigru,bilstm_deep,conformer]

OTHER_ROOT is the root of another checkout of the repo (for example an
older commit unpacked by ``git archive`` into a git-ignored directory).
The corpus is ``chip_smoke.py``'s phase 8 corpus (192 + 24 tone
utterances of 9-10 s, seed 0), written once by this checkout. Each run is
phase 24's program: the preset in the default data mode (the bf16 device
cache, 8 steps a CUDA-graph replay), 24 steps, warm-up 4, a log line every
step, dev eval at 24, checkpoints at 16 and 24, the replay of steps 8-15
profiled (``--profile-dir``). The runs go OTHER, THIS, THIS, OTHER for
each preset, each in a process of its own started in its checkout's root,
so each imports and builds its own package.

For each run it reports:

* the device time a step in the profiled replay: the sum of the kernel,
  copy and set durations over 8, and their union over 8, and the busy
  share of the profiled window;
* the step wall of the third dispatch (one replay) by two spans: from the
  step-16 log line to the step-24 one, and from the end of the step-16
  checkpoint to the step-24 log line;
* the kernels whose device time a step differs most between the two
  checkouts (means over each checkout's two runs);

and, for each preset, the largest |difference| between the two
checkouts' checkpoints at 16 and at 24 (parameters, Adam moments and
counts; 0 is bitwise equal). Every run's output goes to ``DIR``; the last
line of stdout is one JSON object with every number and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

PKG = "chainer_speech_recognition_tpu_torch"
STEPS, K, CKPT_AT = 24, 8, 16
TRAIN_UTTS, DEV_UTTS, SECONDS, SEED = 192, 24, (9.0, 10.0), 0
PRESET_SETS = {"conformer": ["model.attn_impl=flash"]}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def write_corpus(out: str) -> str:
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        write_tone_corpus)

    data = os.path.join(out, "corpus")
    write_tone_corpus(data, np.random.default_rng(SEED),
                      {"train": TRAIN_UTTS, "dev": DEV_UTTS},
                      preset_config("bigru").model.vocab_size, SECONDS)
    return data


def run(root: str, tag: str, preset: str, data: str, out: str) -> str:
    """One train CLI run in ``root`` → its directory under ``out``."""
    d = os.path.join(out, tag)
    os.makedirs(d)
    cmd = [sys.executable, "-m", f"{PKG}.cli.train", "--data-dir", data,
           "--preset", preset, "--device", "cuda",
           "--ckpt-dir", os.path.join(d, "ckpt"),
           "--metrics", os.path.join(d, "metrics.jsonl"),
           "--profile-dir", os.path.join(d, "prof"), "--set",
           "optim.warmup_steps=4", f"train.total_steps={STEPS}",
           "train.log_every=1", f"train.eval_every={STEPS}",
           f"train.checkpoint_every={CKPT_AT}", *PRESET_SETS.get(preset, [])]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    with open(os.path.join(d, "log.txt"), "w") as f:
        rc = subprocess.run(cmd, cwd=root, env=env, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    if rc:
        raise SystemExit(f"{tag}: the train CLI exited {rc} "
                         f"(see {d}/log.txt)")
    print(f"[{tag}] {time.perf_counter() - t0:.3f} s", flush=True)
    return d


def trace_numbers(path: str) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        raise SystemExit(f"{path}: no device activity")
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e["dur"] for e in events)
    union, end = 0.0, -1e30
    for a, b, _ in dev:
        if b > end:
            union += b - max(a, end)
            end = b
    by_name: dict = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3 / K
    return {"device_ms_a_step_sum": sum(by_name.values()),
            "device_ms_a_step_union": union / 1e3 / K,
            "busy": union / (t1 - t0), "window_ms": (t1 - t0) / 1e3,
            "kernels_ms_a_step": by_name}


def walls(metrics: str) -> dict:
    with open(metrics) as f:
        ev = [json.loads(line) for line in f if line.strip()]
    log = {e["step"]: e["t"] for e in ev if e["kind"] == "train"}
    ck = {e["step"]: e["t"] for e in ev if e["kind"] == "checkpoint"}
    return {"step_ms_from_log": (log[3 * K] - log[2 * K]) / K * 1e3,
            "step_ms_from_ckpt": (log[3 * K] - ck[2 * K]) / K * 1e3}


def ckpt_arrays(path: str) -> dict:
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
            out[prefix] = np.asarray(v, np.float64)

    walk("", {"params": tree["params"], "opt_state": tree["opt_state"]})
    return out


def ckpt_gap(a: str, b: str) -> float:
    x, y = ckpt_arrays(a), ckpt_arrays(b)
    if set(x) != set(y):
        return float("inf")
    return max(float(np.max(np.abs(x[k] - y[k]))) if x[k].size else 0.0
               for k in x)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("other", help="root of the other checkout")
    p.add_argument("--presets", default="bigru,bilstm_deep,conformer")
    p.add_argument("--out", required=True,
                   help="directory for every run's logs, metrics, "
                   "profiles and checkpoints")
    args = p.parse_args()
    roots = {"other": os.path.abspath(args.other), "this": HERE}
    args.out = os.path.abspath(args.out)
    os.makedirs(args.out, exist_ok=True)
    name = card()
    print(name, flush=True)
    data = write_corpus(args.out)
    result = {"card": name, "presets": {}}
    for preset in args.presets.split(","):
        runs = []
        for i, which in enumerate(("other", "this", "this", "other")):
            d = run(roots[which], f"{preset}_{i}_{which}", preset, data,
                    args.out)
            r = {"checkout": which, **walls(os.path.join(d, "metrics.jsonl")),
                 **trace_numbers(os.path.join(d, "prof", "trace.json")),
                 "dir": d}
            runs.append(r)
            print(f"[{preset} {i} {which}] device "
                  f"{r['device_ms_a_step_sum']:.4f} ms a step (sum), "
                  f"{r['device_ms_a_step_union']:.4f} "
                  f"(union), busy {r['busy']:.4f} of {r['window_ms']:.3f} ms;"
                  f" third dispatch {r['step_ms_from_log']:.3f} ms a step "
                  f"from the step-16 log, {r['step_ms_from_ckpt']:.3f} from "
                  f"the step-16 checkpoint's end", flush=True)
        mean: dict = {"other": {}, "this": {}}
        for r in runs:
            for k, v in r["kernels_ms_a_step"].items():
                mean[r["checkout"]][k] = mean[r["checkout"]].get(k, 0) + v / 2
        names = set(mean["other"]) | set(mean["this"])
        delta = sorted(((mean["this"].get(n, 0) - mean["other"].get(n, 0),
                         n) for n in names), key=lambda x: -abs(x[0]))
        for dms, n in delta[:8]:
            print(f"[{preset}] this - other {dms * 1e3:+10.3f} us a step  "
                  f"{n[:100]}", flush=True)
        gaps = {s: ckpt_gap(
            os.path.join(runs[0]["dir"], "ckpt", f"step_{s:08d}.msgpack"),
            os.path.join(runs[1]["dir"], "ckpt", f"step_{s:08d}.msgpack"))
            for s in (CKPT_AT, STEPS)}
        print(f"[{preset}] checkpoints this vs other, max |diff|: "
              + ", ".join(f"step {s} {g:.3e}" for s, g in gaps.items()),
              flush=True)
        for r in runs:
            del r["kernels_ms_a_step"], r["dir"]
        result["presets"][preset] = {
            "runs": runs, "ckpt_max_abs_diff": gaps,
            "largest_kernel_deltas_us": [[n[:100], dms * 1e3]
                                         for dms, n in delta[:8]]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
