"""PARITY.md §3g's streaming gate at each compute dtype: a chunk-causal
checkpoint (``conformer_stream``, causal CMVN) scored offline and streamed
at one attention chunk, greedy, on the utterances both score:

    python3 tools/stream_gate.py --ckpt-dir C --data-dir P
        [--index dev_index.jsonl] [--dtypes bfloat16,float32]
        [--stream-chunk 64] [--stream-batch 16] [--device cuda]

For each dtype the checkpoint's weights are built at that
``model.compute_dtype`` (the evaluate CLI refuses the override, as the
reference's does), then

* offline: the evaluate CLI's greedy path (bucketed batches,
  ``train.loop.evaluate_multi``);
* streamed: ``StreamingRecognizer`` in lockstep batches
  (``decode.streaming.decode_lockstep``, the evaluate CLI's
  ``--streaming`` path), lookahead 0;

and the edits of both are counted on the utterances both score (offline
drops those past the bucket menu). For each utterance whose two
hypotheses differ, that utterance alone is streamed and run offline once
more, and their logits compared frame by frame: the first window whose
logits leave the offline ones by more than ``--bar``, and, at each frame
where the two argmaxes differ, the offline top-2 margin beside the
logits' difference there (a near-tie flips where the margin is below the
difference). The gate: streamed edits within ±2 of offline's.

The last line of stdout is one JSON object of all of it; exit 1 on a
failure, 0 otherwise (a missed gate is a finding, not a failure here).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chainer_speech_recognition_tpu_torch.bridge import (  # noqa: E402
    load_flax_params)
from chainer_speech_recognition_tpu_torch.checkpoint import (  # noqa: E402
    load_config, load_params)
from chainer_speech_recognition_tpu_torch.cli.common import (  # noqa: E402
    resolve_device)
from chainer_speech_recognition_tpu_torch.data.corpus import (  # noqa: E402
    load_index, load_signal)
from chainer_speech_recognition_tpu_torch.data.sampler import (  # noqa: E402
    BatchLoader, BucketSampler)
from chainer_speech_recognition_tpu_torch.decode import (  # noqa: E402
    streaming)
from chainer_speech_recognition_tpu_torch.decode.metrics import (  # noqa: E402
    edit_distance_batch)
from chainer_speech_recognition_tpu_torch.frontend import (  # noqa: E402
    select_frontend)
from chainer_speech_recognition_tpu_torch.models.presets import (  # noqa: E402
    build_model)
from chainer_speech_recognition_tpu_torch.train.loop import (  # noqa: E402
    evaluate_multi)
from chainer_speech_recognition_tpu_torch.train.step import (  # noqa: E402
    make_auto_eval)
from chainer_speech_recognition_tpu_torch.utils.wav import (  # noqa: E402
    read_wav)
from chainer_speech_recognition_tpu_torch.vocab import Vocab  # noqa: E402

EXACT_EDITS = 2          # PARITY.md §3g: streamed within ±2 of offline


def load_at(ckpt: str, dtype: str, device):
    """(config, model in eval mode) of the checkpoint at compute dtype
    ``dtype``."""
    cfg = load_config(ckpt).override({"model.compute_dtype": dtype})
    params, _ = load_params(ckpt, 1)
    model = build_model(cfg.model)
    load_flax_params(model, params)
    return cfg, model.to(device).eval()


def stream_logits(model, cfg, sig, chunk: int) -> torch.Tensor:
    """One utterance streamed alone, lookahead 0 → its window logits
    chained, [T', V] fp32 on the CPU, as the recognizer hands them to its
    greedy collapse."""
    taken = []
    collapse = streaming._emit_greedy

    def spy(logits, lens, prev_id, C_s):
        n = int(torch.clamp(lens, 0, C_s)[0])
        taken.append(logits[0, :n].float().cpu())
        return collapse(logits, lens, prev_id, C_s)

    streaming._emit_greedy = spy
    try:
        rec = streaming.StreamingRecognizer(model, cfg, batch=1,
                                            chunk_frames=chunk,
                                            right_frames=0)
        rec.accept(np.asarray(sig, np.float32)[None], drain=False)
        rec.flush(num_samples=np.asarray([len(sig)], np.int64))
    finally:
        streaming._emit_greedy = collapse
    return torch.cat(taken)


def offline_logits(model, cfg, sig, device) -> torch.Tensor:
    """The offline forward of one utterance alone → [T', V] fp32 CPU."""
    fe = select_frontend(cfg.features)
    with torch.inference_mode():
        feats, fl = fe(torch.from_numpy(np.asarray(sig, np.float32)[None])
                       .to(device),
                       torch.tensor([len(sig)], dtype=torch.int32,
                                    device=device),
                       apply_cmvn=cfg.features.cmvn_arg)
        lg, ol = model(feats, fl)
    return lg[0, : int(ol[0])].float().cpu()


def where_they_part(got, want, chunk_frames: int, bar: float) -> dict:
    """The first window whose logits leave the offline ones by more than
    ``bar``, and the frames whose argmaxes differ: each with the offline
    top-2 margin and the logits' largest difference at that frame."""
    res = {"frames": int(want.shape[0]), "shape_equal":
           tuple(got.shape) == tuple(want.shape)}
    if not res["shape_equal"]:
        return res
    diff = (got - want).abs().amax(-1)                     # [T']
    res["max_abs"] = float(diff.max())
    over = torch.nonzero(diff > bar)
    res["first_window_over_bar"] = (None if over.numel() == 0 else
                                    int(over[0, 0]) // chunk_frames)
    top2 = want.topk(2, -1).values
    flips = torch.nonzero(got.argmax(-1) != want.argmax(-1))[:, 0]
    res["argmax_flips"] = [
        {"frame": int(t), "window": int(t) // chunk_frames,
         "offline_margin": float(top2[t, 0] - top2[t, 1]),
         "logit_diff": float(diff[t])} for t in flips]
    return res


def score(ckpt: str, data_dir: str, index: str, dtype: str, device,
          chunk: int, batch: int, bar: float) -> dict:
    """Offline and streamed greedy hypotheses of the set at ``dtype`` →
    their edits on the utterances both score and the differing ones'
    logit comparison."""
    cfg, model = load_at(ckpt, dtype, device)
    vocab = Vocab.load(os.path.join(data_dir, "vocab.txt"))
    utts = load_index(os.path.join(data_dir, index))
    read1 = lambda i: load_signal(utts[i], read_wav)
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    sink = []
    evaluate_multi(make_auto_eval(model, cfg, None),
                   BatchLoader(utts, vocab, cfg.buckets),
                   sampler.eval_batches(), vocab, utts, {"greedy": None},
                   sink=sink, sink_decoder="greedy")
    offline = dict(sink)
    rec = streaming.StreamingRecognizer(model, cfg, batch=batch,
                                        chunk_frames=chunk, right_frames=0)
    order = sorted(range(len(utts)), key=lambda i: utts[i].num_samples)
    streamed = {}
    for grp, ids in streaming.decode_lockstep(rec, order, read1):
        streamed.update((i, vocab.decode(row)) for i, row in zip(grp, ids))
    common = sorted(set(offline) & set(streamed))
    refs = [utts[i].text for i in common]
    e_off = edit_distance_batch([offline[i] for i in common], refs)
    e_str = edit_distance_batch([streamed[i] for i in common], refs)
    differ = [i for i in common if offline[i] != streamed[i]]
    parts = {}
    for i in differ:
        sig = read1(i)
        parts[utts[i].utt_id] = where_they_part(
            stream_logits(model, cfg, sig, chunk),
            offline_logits(model, cfg, sig, device), chunk, bar)
        parts[utts[i].utt_id]["edits"] = {
            "offline": int(e_off[common.index(i)]),
            "streamed": int(e_str[common.index(i)])}
    res = {"dtype": dtype, "common_utts": len(common),
           "ref_chars": int(sum(len(r) for r in refs)),
           "offline_edits": int(e_off.sum()),
           "streamed_edits": int(e_str.sum()),
           "offline_only": [utts[i].utt_id for i in sorted(
               set(offline) - set(streamed))],
           "streamed_only": [utts[i].utt_id for i in sorted(
               set(streamed) - set(offline))],
           "differing_utts": parts}
    res["gate_met"] = abs(res["streamed_edits"]
                          - res["offline_edits"]) <= EXACT_EDITS
    print(f"[{dtype}] on the {len(common)} utterances both score: offline "
          f"{res['offline_edits']} edits, streamed {res['streamed_edits']}"
          f" (±{EXACT_EDITS}: {'met' if res['gate_met'] else 'MISSED'}); "
          f"hypotheses differ on {len(differ)}", flush=True)
    for u, p in parts.items():
        print(f"[{dtype}] {u}: {json.dumps(p)}", flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--index", default="dev_index.jsonl")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--stream-chunk", type=int, default=64)
    ap.add_argument("--stream-batch", type=int, default=16)
    ap.add_argument("--bar", type=float, default=1e-4,
                    help="logit difference that marks where the stream "
                         "leaves the offline function")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    device = resolve_device(a.device)
    out = {}
    for dtype in a.dtypes.split(","):
        out[dtype] = score(a.ckpt_dir, a.data_dir, a.index, dtype, device,
                           a.stream_chunk, a.stream_batch, a.bar)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
