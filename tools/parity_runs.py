"""The CER-parity runs of PARITY.md §1, §3, §3d and §3g through the port's
CLIs, on one CUDA card: ``python3 tools/parity_runs.py [--out DIR]
[--runs bigru,online,glu]``.

1. smoke: a 24-utterance corpus through make_synthetic, preprocess --pack,
   10 training steps, evaluate, evaluate --streaming, train_lm and the
   beam paths below, so that a broken path fails in a minute and not after
   the full synthesis;
2. the parity corpus: ``make_synthetic --style confusable --utts 2000
   --vocab 82 --min-labels 50 --max-labels 150 --seed 20260816`` and
   ``preprocess --dev-fraction 0.1 --pack``;
3. run 1, the greedy gate (PARITY.md §3): ``train --preset bigru``,
   buckets {1024: 16, 1536: 8}, max_label_len 160, 2,500 steps, eval every
   250, the default data mode (the bf16 device cache, 8 steps a
   CUDA-graph replay: 2,504 steps), then
   ``evaluate``: dev CER ≤ 0.015;
4. run 2, the streaming gate (§3d): the same with
   ``features.cmvn_mode=causal``, then ``evaluate`` (offline, ≤ 0.015) and
   ``evaluate --streaming --stream-chunk 64 --stream-right 16
   --stream-batch 16`` (≤ 0.020);
5. config 4, the LM gate (PARITY.md §3): ``train_lm --order 3`` on the
   parity corpus, ``evaluate --compare --beam 8 --lm lm_3gram.arpa
   --lm-alpha 0.5 --lm-beta 1.0`` on run 1's checkpoint: beam+LM edits
   ≤ 0.6 × greedy edits on the same dev set; ``evaluate --streaming
   --stream-chunk 64 --stream-right 16 --beam 8 --lm …`` on run 2's
   checkpoint: ≤ 0.6 × run 2's streaming greedy edits; recorded without a
   gate: ``--lm-repr hashed`` with an order-4 LM on run 1's checkpoint;
6. the online presets (``--runs online``; the smoke trains and streams
   both for 10 steps first): §3d's ``uni_gru`` (causal CMVN, 2,500 steps
   with run 1's buckets), scored offline, streaming greedy at chunk 32 /
   right 0 (320 ms: its edits within ±2 of offline's, the one utterance
   the offline bucket menu drops) and streaming beam 8 + 3-gram;
   §3g's ``conformer_stream`` (causal CMVN, 9,000 steps, eval every 500):
   offline greedy ≤ 0.03, ``--compare --beam 8 --lm``: beam+LM edits ≤
   0.6 × greedy's, and streaming greedy and streaming beam+LM (chunk 64 =
   one attention chunk, right 0) each within ±2 edits of its offline row.
   Beside each ±2 gate, recorded: the streamed and offline hypotheses
   (``--hyp-out``) compared utterance by utterance on the ones both score;
7. ``glu_conv`` (``--runs glu``; the smoke trains it for 10 steps first),
   PARITY.md's "All four acoustic-model families" row: run 1's buckets and
   2,500 steps, then ``evaluate --compare --beam 8 --lm lm_3gram.arpa
   --lm-alpha 0.5 --lm-beta 1.0``: greedy, beam 8 and beam 8 + LM,
   recorded (PARITY.md gives the row no gate).

8. §3g's streaming gate at each compute dtype (``--runs stream_gate``; the
   smoke trains and streams conformer_stream for 10 steps first): the
   ``conformer_stream`` of 6 trained alone, then ``tools/stream_gate.py``
   scores it offline and streamed at one attention chunk, greedy, at bf16
   and at fp32 compute on the utterances both score, and compares the
   logits of each utterance whose hypotheses differ (recorded: the gate
   of 6 stays the bf16 one).

``--runs`` picks the parts after the smoke and the corpus: ``bigru``
(3-5), ``online`` (6), ``glu`` (7) and ``stream_gate`` (8);
``bigru,online`` by default.

Every command's output goes to ``DIR/<name>.log``; the last line of stdout
is one JSON object with each run's dev CER, edits, reference characters,
utterance count, gate, the training wall time and utt/s, evaluate's wall,
utt/s and checkpoint load time, and the card's name and power limit. The
gates' verdicts are printed; a command that fails gives exit code 1, a
missed gate exit code 4.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

PKG = "chainer_speech_recognition_tpu_torch"
CORPUS = ["--style", "confusable", "--utts", "2000", "--vocab", "82",
          "--min-labels", "50", "--max-labels", "150", "--seed", "20260816"]
TRAIN_SETS = ["buckets.boundaries=[1024,1536]", "buckets.batch_sizes=[16,8]",
              "buckets.max_label_len=160", "train.total_steps=2500",
              "train.eval_every=250"]
SMOKE_CORPUS = ["--style", "confusable", "--utts", "24", "--vocab", "82",
                "--min-labels", "10", "--max-labels", "20",
                "--min-seconds", "2", "--max-seconds", "4", "--seed", "1"]
SMOKE_SETS = ["buckets.boundaries=[512]", "buckets.batch_sizes=[8]",
              "buckets.max_label_len=40", "train.total_steps=10",
              "train.eval_every=10"]
GATES = {"run1": 0.015, "run2_offline": 0.015, "run2_streaming": 0.020,
         "cstream_offline": 0.03}
LM_RATIO = 0.6           # PARITY.md §3: beam K=8 + 3-gram edits / greedy's
BEAM_ARGS = ["--beam", "8", "--lm-alpha", "0.5", "--lm-beta", "1.0"]
STREAM_ARGS = ["--streaming", "--stream-chunk", "64", "--stream-right", "16",
               "--stream-batch", "16"]
# PARITY.md §3d's uni_gru and §3g's conformer_stream (causal CMVN both)
UNI_SETS = TRAIN_SETS + ["features.cmvn_mode=causal"]
CSTREAM_SETS = ["buckets.boundaries=[1024,1536]", "buckets.batch_sizes=[16,8]",
                "buckets.max_label_len=160", "train.total_steps=9000",
                "train.eval_every=500", "features.cmvn_mode=causal"]
UNI_STREAM_ARGS = ["--streaming", "--stream-chunk", "32", "--stream-right",
                   "0", "--stream-batch", "16"]
CSTREAM_ARGS = ["--streaming", "--stream-chunk", "64", "--stream-batch",
                "16"]                   # the lookahead resolves to 0
EXACT_EDITS = 2          # streaming vs offline: the utterance offline drops
_CER = re.compile(r"CER(\[streaming\])? ([0-9.]+) \| (?:loss ([0-9.]+) \| )?"
                  r"(\d+) utts \| (\d+) edits / (\d+) ref chars")
_CMP = re.compile(r"CER\[([^\]]+)\] ([0-9.]+) \| (\d+) utts \| (\d+) edits / "
                  r"(\d+) ref chars")


class RunFailure(Exception):
    pass


def run(out: str, name: str, module: str, args: list[str]) -> tuple[str, float]:
    """``python -m PKG.cli.<module> args`` → (stdout + stderr, wall s);
    the output goes to ``out/<name>.log``, a non-zero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"{PKG}.cli.{module}",
                           *args], capture_output=True, text=True)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(text)
    print(f"[{name}] {module} exit {proc.returncode} in {wall:.3f} s",
          flush=True)
    if proc.returncode != 0:
        print(text[-3000:], flush=True)
        raise RunFailure(f"{name}: {module} exited {proc.returncode}")
    return text, wall


def train(out: str, name: str, prep: str, sets: list[str],
          preset: str = "bigru") -> dict:
    """Train ``preset`` from ``prep`` (its train.pack) → training
    figures."""
    ckpt = os.path.join(out, f"{name}_ckpt")
    metrics = os.path.join(out, f"{name}_metrics.jsonl")
    _, wall = run(out, f"{name}_train", "train", [
        "--data-dir", prep, "--preset", preset, "--ckpt-dir", ckpt,
        "--metrics", metrics, "--set", *sets])
    with open(metrics) as f:
        ev = [json.loads(l) for l in f]
    steps = [e for e in ev if e["kind"] == "train"]
    evals = [e for e in ev if e["kind"] == "eval"]
    # utt/s of the logged windows after the first (the first one holds the
    # kernel build and the first hit of each bucket)
    rates = [e["utt_per_sec"] for e in steps[1:]]
    mode = [e for e in ev if e["kind"] == "data_mode"]
    res = {"ckpt": ckpt, "steps": steps[-1]["step"] if steps else 0,
           "data_mode": {k: v for k, v in mode[0].items()
                         if k not in ("kind", "t")} if mode else None,
           "train_wall_s": wall,
           "train_utt_per_s_median": statistics.median(rates) if rates
           else None,
           "dev_evals": [(e["step"], e["cer"]) for e in evals]}
    print(f"[{name}] {json.dumps(res)}", flush=True)
    return res


def evaluate(out: str, name: str, ckpt: str, prep: str,
             extra: list[str]) -> dict:
    text, wall = run(out, name, "evaluate", [
        "--ckpt-dir", ckpt, "--data-dir", prep, *extra])
    m = _CER.search(text)
    if m is None:
        raise RunFailure(f"{name}: no CER line in {text[-2000:]!r}")
    load = re.search(r"checkpoint load ([0-9.]+) s", text)
    rate = re.search(r"scored \d+ utts in ([0-9.]+) s: ([0-9.]+) utt/s",
                     text)
    res = {"cer": float(m.group(2)),
           "loss": None if m.group(3) is None else float(m.group(3)),
           "utts": int(m.group(4)), "edits": int(m.group(5)),
           "ref_chars": int(m.group(6)), "evaluate_wall_s": wall,
           "checkpoint_load_s": float(load.group(1)),
           "scoring_s": float(rate.group(1)),
           "utt_per_s": float(rate.group(2)),
           "line": m.group(0)}
    if name in GATES:
        res["gate"] = GATES[name]
        res["passed"] = res["cer"] <= GATES[name]
    print(f"[{name}] {json.dumps(res)}", flush=True)
    return res


def compare(out: str, name: str, ckpt: str, prep: str, lm: str,
            extra: tuple = ()) -> dict:
    """``evaluate --compare`` (greedy, beam 8, beam 8 + LM from one forward
    pass) → {decoder: {cer, edits, ref_chars, utts}} and the LM gate."""
    text, wall = run(out, name, "evaluate", [
        "--ckpt-dir", ckpt, "--data-dir", prep, "--compare", "--lm", lm,
        *BEAM_ARGS, *extra])
    res = {m.group(1): {"cer": float(m.group(2)), "utts": int(m.group(3)),
                        "edits": int(m.group(4)),
                        "ref_chars": int(m.group(5))}
           for m in _CMP.finditer(text)}
    if set(res) != {"greedy", "beam8", "beam8+lm"}:
        raise RunFailure(f"{name}: compare lines {text[-2000:]!r}")
    res["evaluate_wall_s"] = wall
    res["gate_edits"] = LM_RATIO * res["greedy"]["edits"]
    res["passed"] = res["beam8+lm"]["edits"] <= res["gate_edits"]
    print(f"[{name}] {json.dumps(res)}", flush=True)
    return res


def lm_gate(name: str, edits: int, greedy_edits: int) -> dict:
    gate = LM_RATIO * greedy_edits
    res = {"edits": edits, "greedy_edits": greedy_edits, "gate_edits": gate,
           "passed": edits <= gate}
    print(f"[{name}] LM gate: {edits} edits against {LM_RATIO} x "
          f"{greedy_edits} = {gate:.1f}: "
          f"{'met' if res['passed'] else 'MISSED'}", flush=True)
    return res


def read_hyps(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return dict(line.rstrip("\n").split("\t", 1) for line in f)


def exact_gate(name: str, edits: int, offline_edits: int, hyps: str,
               offline_hyps: str) -> dict:
    """Streaming against offline on the same checkpoint: the edits within
    ±EXACT_EDITS (offline drops the one utterance past the bucket menu);
    recorded beside it, the utterances both score whose hypotheses
    differ, and the ones only one of them scores."""
    a, b = read_hyps(hyps), read_hyps(offline_hyps)
    common = sorted(set(a) & set(b))
    differ = [u for u in common if a[u] != b[u]]
    res = {"edits": edits, "offline_edits": offline_edits,
           "passed": abs(edits - offline_edits) <= EXACT_EDITS,
           "common_utts": len(common), "differing_utts": differ,
           "streaming_only": sorted(set(a) - set(b)),
           "offline_only": sorted(set(b) - set(a))}
    print(f"[{name}] streaming {edits} edits vs offline {offline_edits}: "
          f"{'met' if res['passed'] else 'MISSED'} (±{EXACT_EDITS}); "
          f"hypotheses differ on {len(differ)} of the {len(common)} "
          f"utterances both score {differ[:5]}; streaming alone scores "
          f"{res['streaming_only']}", flush=True)
    return res


def bigru_runs(out: str, prep: str, lm3: str) -> dict:
    """PARITY.md §3's run 1, §3d's run 2 and config 4's LM gates → their
    figures and gates."""
    res = {"run1": train(out, "run1", prep, TRAIN_SETS)}
    res["run1"].update(evaluate(out, "run1", res["run1"]["ckpt"], prep, []))
    res["run2"] = train(out, "run2", prep, TRAIN_SETS + [
        "features.cmvn_mode=causal"])
    res["run2"]["offline"] = evaluate(out, "run2_offline",
                                      res["run2"]["ckpt"], prep, [])
    res["run2"]["streaming"] = evaluate(out, "run2_streaming",
                                        res["run2"]["ckpt"], prep,
                                        STREAM_ARGS)
    # config 4: the LM gate, offline and streaming
    cmp = compare(out, "run1_compare", res["run1"]["ckpt"], prep, lm3)
    res["config4_offline"] = {**cmp, **lm_gate(
        "config4_offline", cmp["beam8+lm"]["edits"], cmp["greedy"]["edits"])}
    sb = evaluate(out, "run2_streaming_beam_lm", res["run2"]["ckpt"], prep,
                  STREAM_ARGS + BEAM_ARGS + ["--lm", lm3])
    res["config4_streaming"] = {**sb, **lm_gate(
        "config4_streaming", sb["edits"], res["run2"]["streaming"]["edits"])}
    res["config4_hashed4"] = evaluate(
        out, "run1_beam_lm4_hashed", res["run1"]["ckpt"], prep,
        BEAM_ARGS + ["--lm", os.path.join(prep, "lm_4gram.arpa"),
                     "--lm-repr", "hashed"])
    return res


def online_runs(out: str, prep: str, lm3: str) -> dict:
    """PARITY.md §3d's uni_gru and §3g's conformer_stream → their figures
    and gates."""
    res = {}

    def hyp(name):
        return ["--hyp-out", os.path.join(out, f"{name}_hyps.txt")]

    uni = train(out, "uni", prep, UNI_SETS, "uni_gru")
    uni["offline"] = evaluate(out, "uni_offline", uni["ckpt"], prep,
                              hyp("uni_offline"))
    uni["streaming"] = evaluate(out, "uni_streaming", uni["ckpt"], prep,
                                UNI_STREAM_ARGS + hyp("uni_streaming"))
    uni["streaming"].update(exact_gate(
        "uni_streaming", uni["streaming"]["edits"],
        uni["offline"]["edits"], hyp("uni_streaming")[1],
        hyp("uni_offline")[1]))
    uni["streaming_beam_lm"] = evaluate(
        out, "uni_streaming_beam_lm", uni["ckpt"], prep,
        UNI_STREAM_ARGS + BEAM_ARGS + ["--lm", lm3])
    res["uni"] = uni
    cs = train(out, "cstream", prep, CSTREAM_SETS, "conformer_stream")
    cs["offline"] = evaluate(out, "cstream_offline", cs["ckpt"], prep,
                             hyp("cstream_offline"))
    # --compare writes the beam8+lm hypotheses
    cmp = compare(out, "cstream_compare", cs["ckpt"], prep, lm3,
                  hyp("cstream_offline_lm"))
    cs["compare"] = {**cmp, **lm_gate("cstream_lm", cmp["beam8+lm"]["edits"],
                                      cmp["greedy"]["edits"])}
    cs["streaming"] = evaluate(out, "cstream_streaming", cs["ckpt"], prep,
                               CSTREAM_ARGS + hyp("cstream_streaming"))
    cs["streaming"].update(exact_gate(
        "cstream_streaming", cs["streaming"]["edits"],
        cs["offline"]["edits"], hyp("cstream_streaming")[1],
        hyp("cstream_offline")[1]))
    cs["streaming_beam_lm"] = evaluate(
        out, "cstream_streaming_beam_lm", cs["ckpt"], prep,
        CSTREAM_ARGS + BEAM_ARGS + ["--lm", lm3]
        + hyp("cstream_streaming_lm"))
    cs["streaming_beam_lm"].update(exact_gate(
        "cstream_streaming_beam_lm", cs["streaming_beam_lm"]["edits"],
        cmp["beam8+lm"]["edits"], hyp("cstream_streaming_lm")[1],
        hyp("cstream_offline_lm")[1]))
    res["cstream"] = cs
    return res


def stream_gate(out: str, name: str, ckpt: str, prep: str) -> dict:
    """``tools/stream_gate.py`` on a conformer_stream checkpoint at one
    attention chunk → its JSON (the output in ``out/<name>.log``)."""
    tool = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "stream_gate.py")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, tool, "--ckpt-dir", ckpt,
                           "--data-dir", prep, *CSTREAM_ARGS[1:]],
                          capture_output=True, text=True)
    wall = time.perf_counter() - t0
    with open(os.path.join(out, f"{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    print(f"[{name}] stream_gate exit {proc.returncode} in {wall:.3f} s\n"
          + proc.stdout[-6000:], flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], flush=True)
        raise RunFailure(f"{name}: stream_gate exited {proc.returncode}")
    return {**json.loads(proc.stdout.strip().splitlines()[-1]),
            "wall_s": wall}


def stream_gate_runs(out: str, prep: str) -> dict:
    """§3g's conformer_stream trained as in ``online_runs``, scored by
    ``tools/stream_gate.py`` at bf16 and fp32 compute → its figures."""
    cs = train(out, "cstream", prep, CSTREAM_SETS, "conformer_stream")
    cs["stream_gate"] = stream_gate(out, "cstream_stream_gate", cs["ckpt"],
                                    prep)
    return {"cstream": cs}


def glu_runs(out: str, prep: str, lm3: str) -> dict:
    """PARITY.md's glu_conv row: trained as run 1, scored by ``--compare``
    (recorded, no gate)."""
    glu = train(out, "glu", prep, TRAIN_SETS, "glu_conv")
    glu["compare"] = compare(out, "glu_compare", glu["ckpt"], prep, lm3)
    return {"glu": glu}


def corpus(out: str, name: str, synth_args: list[str]) -> str:
    root = os.path.join(out, f"{name}_corpus")
    prep = os.path.join(out, f"{name}_prep")
    _, synth_s = run(out, f"{name}_make_synthetic", "make_synthetic",
                     ["--out", root, *synth_args])
    _, prep_s = run(out, f"{name}_preprocess", "preprocess", [
        "--corpus", root, "--out", prep, "--dev-fraction", "0.1", "--pack"])
    print(f"[{name}] corpus synthesized in {synth_s:.3f} s, preprocessed "
          f"and packed in {prep_s:.3f} s", flush=True)
    return prep


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--out", default=os.path.join("chiprun_out", "parity"))
    p.add_argument("--work", default=os.path.join(".chipscratch", "parity"),
                   help="corpora and checkpoints (git-ignored)")
    p.add_argument("--runs", default="bigru,online",
                   help="comma list of bigru (runs 1-2, config 4), online "
                        "(uni_gru, conformer_stream), glu (glu_conv) and "
                        "stream_gate (conformer_stream at bf16 and fp32)")
    args = p.parse_args()
    runs = set(args.runs.split(","))
    if not runs or runs - {"bigru", "online", "glu", "stream_gate"}:
        raise SystemExit(f"--runs {args.runs!r}: expected a comma list of "
                         "bigru, online, glu and stream_gate")
    if {"online", "stream_gate"} <= runs:
        raise SystemExit("--runs: online already trains conformer_stream; "
                         "take stream_gate alone")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    result: dict = {"card": card}
    try:
        prep = corpus(args.work, "smoke", SMOKE_CORPUS)
        sm = train(args.work, "smoke", prep, SMOKE_SETS + [
            "features.cmvn_mode=causal"])
        evaluate(args.work, "smoke_eval", sm["ckpt"], prep,
                 ["--index", "dev_index.jsonl,dev.pack"])
        evaluate(args.work, "smoke_stream", sm["ckpt"], prep, STREAM_ARGS)
        run(args.work, "smoke_train_lm", "train_lm",
            ["--data-dir", prep, "--order", "3"])
        smoke_lm = os.path.join(prep, "lm_3gram.arpa")
        compare(args.work, "smoke_compare", sm["ckpt"], prep, smoke_lm)
        evaluate(args.work, "smoke_stream_beam", sm["ckpt"], prep,
                 STREAM_ARGS + BEAM_ARGS + ["--lm", smoke_lm])
        online = [("uni", "uni_gru", UNI_STREAM_ARGS),
                  ("cstream", "conformer_stream", CSTREAM_ARGS)]
        if "online" not in runs:
            online = online[1:] if "stream_gate" in runs else []
        for name, preset, sargs in online:
            o = train(args.work, f"smoke_{name}", prep, SMOKE_SETS + [
                "features.cmvn_mode=causal"], preset)
            evaluate(args.work, f"smoke_{name}_stream", o["ckpt"], prep,
                     sargs + BEAM_ARGS + ["--lm", smoke_lm])
            if "stream_gate" in runs:
                stream_gate(args.work, "smoke_stream_gate", o["ckpt"], prep)
        if "glu" in runs:
            o = train(args.work, "smoke_glu", prep, SMOKE_SETS, "glu_conv")
            compare(args.work, "smoke_glu_compare", o["ckpt"], prep,
                    smoke_lm)
        t0 = time.perf_counter()
        prep = corpus(args.work, "parity", CORPUS)
        result["corpus_s"] = time.perf_counter() - t0
        for order in (3, 4):
            run(args.work, f"train_lm_{order}", "train_lm",
                ["--data-dir", prep, "--order", str(order)])
        lm3 = os.path.join(prep, "lm_3gram.arpa")
        if "online" in runs:
            result.update(online_runs(args.work, prep, lm3))
        if "bigru" in runs:
            result.update(bigru_runs(args.work, prep, lm3))
        if "glu" in runs:
            result.update(glu_runs(args.work, prep, lm3))
        if "stream_gate" in runs:
            result.update(stream_gate_runs(args.work, prep))
    except RunFailure as e:
        print(f"parity_runs: FAILED: {e}", file=sys.stderr)
        print(json.dumps(result))
        return 1
    finally:
        for name in os.listdir(args.work):    # logs, metrics, hypotheses
            if name.endswith((".log", ".jsonl", "_hyps.txt")):
                with open(os.path.join(args.work, name), "rb") as src, \
                        open(os.path.join(args.out, name), "wb") as dst:
                    dst.write(src.read())
    gated = []
    if "bigru" in runs:
        gated += [("run1", result["run1"]),
                  ("run2_offline", result["run2"]["offline"]),
                  ("run2_streaming", result["run2"]["streaming"]),
                  ("config4_offline", result["config4_offline"]),
                  ("config4_streaming", result["config4_streaming"])]
    if "online" in runs:
        cs = result["cstream"]
        gated += [("uni_streaming", result["uni"]["streaming"]),
                  ("cstream_offline", cs["offline"]),
                  ("cstream_lm", cs["compare"]),
                  ("cstream_streaming", cs["streaming"]),
                  ("cstream_streaming_beam_lm", cs["streaming_beam_lm"])]
    if "glu" in runs:
        c = result["glu"]["compare"]
        print("glu_conv (recorded, no gate): " + ", ".join(
            f"{k} {c[k]['cer']:.4f} ({c[k]['edits']} edits)"
            for k in ("greedy", "beam8", "beam8+lm")), flush=True)
    verdicts = {name: r["passed"] for name, r in gated}
    print(f"gates: " + ", ".join(f"{n} {'met' if v else 'MISSED'}"
                                 for n, v in verdicts.items()), flush=True)
    print(json.dumps(result))
    return 0 if all(verdicts.values()) else 4


if __name__ == "__main__":
    sys.exit(main())
