"""Structured metrics: JSONL file + human stdout (the port's copy of the
reference's ``train/metrics.py``, so both packages write the same
events)."""

from __future__ import annotations

import json
import sys
import time


class MetricsLogger:
    def __init__(self, path: str | None = None, stream=None):
        self.f = open(path, "a", buffering=1) if path else None
        # stream=None follows sys.stdout DYNAMICALLY: a default bound at
        # class-definition time pins whatever sys.stdout was at first
        # import (e.g. a since-closed pytest capture), and every later
        # logger writes into a dead stream
        self._stream = stream
        self._t0 = time.perf_counter()

    @property
    def stream(self):
        return self._stream if self._stream is not None else sys.stdout

    def log(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "t": round(time.perf_counter() - self._t0, 3),
               **fields}
        if self.f:
            self.f.write(json.dumps(rec) + "\n")
        if kind == "train":
            self.stream.write(
                "step {step:>7d} | epoch {epoch:>3d} | loss {loss:8.4f} | "
                "gnorm {grad_norm:7.3f} | {utt_per_sec:7.1f} utt/s | "
                "bucket {bucket_id}\n".format(**{k: fields.get(k, 0) for k in (
                    "step", "epoch", "loss", "grad_norm", "utt_per_sec",
                    "bucket_id")}))
        elif kind == "eval":
            self.stream.write(
                "EVAL step {step} | CER {cer:.4f} | loss {loss:.4f} | "
                "{num_utts} utts\n".format(**fields))
        else:
            self.stream.write(f"{kind}: {json.dumps(fields)}\n")
        self.stream.flush()

    def close(self):
        if self.f:
            self.f.close()
