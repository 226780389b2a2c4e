"""CER scoring (host-side, eval-only): the port's copy of the reference's
``decode/metrics.py``. A batch of (hyp, ref) pairs is scored by one call
of the C++ batch edit distance (``native/edit_distance.cpp``, built by
``utils/native.py``); ``edit_distance_py`` is its plain version, which the
tests hold it to.

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


def _to_ids(seq) -> list[int]:
    return [ord(c) for c in seq] if isinstance(seq, str) else list(seq)


def edit_distance_batch(hyps, refs) -> np.ndarray:
    """Distances for N (hyp, ref) pairs (strings or id sequences) →
    int64[N]: each side padded into one [N, S] int32 matrix, ONE native
    call (``utils/native.edit_distance_batch_native``)."""
    from ..utils.native import edit_distance_batch_native

    hs = [_to_ids(h) for h in hyps]
    rs = [_to_ids(r) for r in refs]
    n = len(hs)
    if n != len(rs):
        raise ValueError(f"{n} hypotheses for {len(rs)} references")
    if n == 0:
        return np.zeros(0, np.int64)
    sh = max(1, max(len(h) for h in hs))
    sr = max(1, max(len(r) for r in rs))
    hm = np.zeros((n, sh), np.int32)
    rm = np.zeros((n, sr), np.int32)
    for i, h in enumerate(hs):
        hm[i, : len(h)] = h
    for i, r in enumerate(rs):
        rm[i, : len(r)] = r
    hl = np.asarray([len(h) for h in hs], np.int32)
    rl = np.asarray([len(r) for r in rs], np.int32)
    return edit_distance_batch_native(hm, hl, rm, rl)


class CERAccumulator:
    """Streaming corpus-level character error rate."""

    def __init__(self):
        self.edits = 0
        self.ref_len = 0
        self.num_utts = 0

    def add(self, hyp, ref) -> None:
        self.add_batch([hyp], [ref])

    def add_batch(self, hyps, refs) -> None:
        """One native call for a whole eval batch of (hyp, ref) pairs."""
        self.edits += int(edit_distance_batch(hyps, refs).sum())
        self.ref_len += sum(len(r) for r in refs)
        self.num_utts += len(refs)

    @property
    def cer(self) -> float:
        return self.edits / max(self.ref_len, 1)
