"""CER scoring (host-side, eval-only): the port's copy of the reference's
``decode/metrics.py`` with its pure Python/NumPy edit distance (the port
does not build the C++ one).

Corpus CER = total edit operations / total reference length
(character-level Levenshtein).
"""

from __future__ import annotations

import numpy as np


def edit_distance_py(hyp, ref) -> int:
    """Pure-Python/NumPy reference implementation."""
    m, n = len(hyp), len(ref)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = np.arange(n + 1, dtype=np.int32)
    cur = np.empty(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        cur[0] = i
        h = hyp[i - 1]
        sub = prev[:-1] + (np.asarray([h != r for r in ref], dtype=np.int32)
                           if not isinstance(ref, np.ndarray)
                           else (ref != h).astype(np.int32))
        # vectorized inner loop: cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1])
        np.minimum(prev[1:] + 1, sub, out=cur[1:])
        for j in range(1, n + 1):          # cumulative dependency on cur[j-1]
            if cur[j - 1] + 1 < cur[j]:
                cur[j] = cur[j - 1] + 1
        prev, cur = cur, prev
    return int(prev[n])


class CERAccumulator:
    """Streaming corpus-level character error rate."""

    def __init__(self):
        self.edits = 0
        self.ref_len = 0
        self.num_utts = 0

    def add(self, hyp, ref) -> None:
        self.edits += edit_distance_py(hyp, ref)
        self.ref_len += len(ref)
        self.num_utts += 1

    def add_batch(self, hyps, refs) -> None:
        self.edits += sum(edit_distance_py(h, r) for h, r in zip(hyps, refs))
        self.ref_len += sum(len(r) for r in refs)
        self.num_utts += len(refs)

    @property
    def cer(self) -> float:
        return self.edits / max(self.ref_len, 1)
