"""A numpy model of ``csrc/beam.cu``'s top-K selection, which cannot run
here: the block's threads split the K stays and K·V extensions as the
kernel does (thread t: stay t if t < K, then extension (j, v) for every
parent j and v ≡ t mod kThreads), each keeps a sorted top-KMAX list
(``insert``), K rounds of a warp argbest with a pop merge a warp's lists,
and warp 0 merges the warps' lists the same way. The result must equal a
stable descending sort's first K (``jax.lax.top_k``'s order: the lower
flat index first on ties) on scores full of exact ties and LOG_ZERO rows,
with the kernel's constants read from the source; a merge planted to let
the higher index win a tie must fail."""

import os
import re

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chainer_speech_recognition_tpu_torch", "csrc", "beam.cu")
LOG_ZERO = np.float32(-1e30)
SENTINEL = (-np.inf, 2**31 - 1)


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)", open(SRC).read())
    return int(m.group(1))


THREADS = _constant("kThreads")


def better(a, b, low_index_wins=True):
    if a[0] != b[0]:
        return a[0] > b[0]
    return a[1] < b[1] if low_index_wins else a[1] > b[1]


def insert(lst, c, lw):
    """The kernel's unrolled insertion, position by position."""
    kmax = len(lst)
    if not better(c, lst[-1], lw):
        return
    old = list(lst)
    for q in range(kmax - 1, 0, -1):
        if better(c, old[q - 1], lw):
            lst[q] = old[q - 1]
        elif better(c, old[q], lw):
            lst[q] = c
    if better(c, old[0], lw):
        lst[0] = c


def warp_best(cands, lw):
    """The xor-shuffle reduction over 32 lanes: every lane ends with the
    same winner (the tree order matters only where ``better`` is not a
    total order)."""
    vals = list(cands)
    off = 16
    while off:
        vals = [vals[i] if not better(vals[i ^ off], vals[i], lw)
                else vals[i ^ off] for i in range(32)]
        off //= 2
    assert all(v == vals[0] for v in vals)
    return vals[0]


def kernel_topk(scores, K, low_index_wins=True):
    """scores [K + K·V] fp32 → the kernel's K (score, index) pairs."""
    n = scores.shape[0]
    V = (n - K) // K
    kmax = 8 if K <= 8 else 32
    lw = low_index_wins
    lists = [[SENTINEL] * kmax for _ in range(THREADS)]
    for t in range(min(K, THREADS)):
        insert(lists[t], (float(scores[t]), t), lw)
    for j in range(K):
        for t in range(THREADS):
            for v in range(t, V, THREADS):
                i = K + j * V + v
                insert(lists[t], (float(scores[i]), i), lw)
    wtops = []
    for w in range(THREADS // 32):
        lanes = lists[32 * w : 32 * w + 32]
        top = []
        for _ in range(K):
            best = warp_best([l[0] for l in lanes], lw)
            for l in lanes:
                if l[0][1] == best[1]:          # the popping lane(s)
                    l[:] = l[1:] + [SENTINEL]
            top.append(best)
        wtops.append(top)
    heads = [0] * len(wtops)
    out = []
    for _ in range(K):
        cands = [wtops[w][heads[w]] if w < len(wtops) and heads[w] < K
                 else SENTINEL for w in range(32)]
        best = warp_best(cands, lw)
        for w in range(len(wtops)):
            if heads[w] < K and wtops[w][heads[w]][1] == best[1]:
                heads[w] += 1
        out.append(best)
    return out


def stable_topk(scores, K):
    order = np.argsort(-scores, kind="stable")[:K]
    return [(float(scores[i]), int(i)) for i in order]


def _scores(rng, K, V, kind):
    n = K + K * V
    if kind == "ties":          # few distinct values: ties everywhere
        s = rng.choice(np.float32([-3.0, -1.5, -0.5, -7.25]), n)
    elif kind == "dead":        # one live beam: LOG_ZERO rows, -5e29 stays
        s = np.full(n, LOG_ZERO, np.float32)
        s[:K] = np.float32(-5e29)
        s[0] = -2.0
        live = K + rng.choice(V, 5, replace=False)
        s[live] = rng.standard_normal(5).astype(np.float32) - 4
    else:
        s = rng.standard_normal(n).astype(np.float32)
        s[rng.random(n) < 0.3] = LOG_ZERO
    return s.astype(np.float32)


@pytest.mark.parametrize("K,V", [(1, 5), (4, 64), (8, 64), (8, 300),
                                 (16, 40), (32, 9)])
@pytest.mark.parametrize("kind", ["ties", "dead", "random"])
def test_kernel_selection_is_stable_topk(K, V, kind):
    rng = np.random.default_rng(K * 1000 + V)
    s = _scores(rng, K, V, kind)
    assert kernel_topk(s, K) == stable_topk(s, K)


def test_higher_index_merge_fails():
    """The same model with ties going to the higher index differs from the
    stable sort wherever dead beams are filled (LOG_ZERO ties at the K-th
    place), and on tied scores: the tests above can see the tie rule."""
    rng = np.random.default_rng(1)
    for K, V in ((8, 64), (8, 300), (16, 40)):   # K > the 6 live ones
        s = _scores(rng, K, V, "dead")
        assert kernel_topk(s, K, low_index_wins=False) != stable_topk(s, K)
    s = _scores(rng, 8, 300, "ties")
    assert kernel_topk(s, 8, low_index_wins=False) != stable_topk(s, 8)
