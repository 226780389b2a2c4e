"""Numpy models of ``csrc/beam.cu``'s two top-K selections, which cannot
run here, each of which must equal a stable descending sort's first K
(``jax.lax.top_k``'s order: the lower flat index first on ties) on scores
full of exact ties and LOG_ZERO rows, with the kernel's constants read
from the source; a variant planted to let the higher index win a tie must
fail.

The narrow form (K ≤ 32): the block's threads split the K stays and K·V
extensions as the kernel does (thread t: stay t if t < K, then extension
(j, v) for every parent j and v ≡ t mod kThreads), each keeps a sorted
top-KMAX list (``insert``), K rounds of a warp argbest with a pop merge a
warp's lists, and warp 0 merges the warps' lists the same way.

The wide form (any K): an order-preserving uint32 key a score (-0 as +0),
a radix select of kRadixBins bins a pass (warp 0's lanes own 8 bins each,
highest first; the first lane whose running count reaches the need owns
the digit; the passes stop once the digit's bin is all taken), the keys
above the threshold class, then the class's first members in the order
the kernel ranks them (warp w's index range [w·span, (w+1)·span) in
rounds of 32 lanes), and the bitonic network over the survivors packed as
(key << 32) | ~index, padded to a power of 2 with zeros."""

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
WIDE_WARPS = _constant("kWideThreads") // 32
BINS = _constant("kRadixBins")


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


# ------------------------------------------------------------ wide form --

def order_keys(scores):
    """The kernel's ``order_key``: float32 → uint32, -0 as +0."""
    u = (scores.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def kernel_order(n):
    """Flat indices in the order the kernel's tie ranking visits them."""
    span = ((n + WIDE_WARPS - 1) // WIDE_WARPS + 31) // 32 * 32
    idx = (np.arange(WIDE_WARPS)[:, None, None] * span
           + np.arange(0, span, 32)[None, :, None]
           + np.arange(32)[None, None, :]).reshape(-1)
    return idx[idx < n]


def bitonic_desc(s):
    """The kernel's ``bitonic_desc`` network on a power-of-2 array."""
    s, n = s.copy(), len(s)
    size = 2
    while size <= n:
        stride = size // 2
        while stride:
            q = np.arange(n // 2)
            lo = 2 * q - (q & (stride - 1))
            hi = lo + stride
            x, y = s[lo], s[hi]
            swap = (x < y) == ((lo & size) == 0)
            s[lo[swap]], s[hi[swap]] = y[swap], x[swap]
            stride //= 2
        size *= 2
    return s


def wide_topk(scores, K, low_index_wins=True):
    """scores [N] fp32 → the wide form's K (score, index) pairs."""
    n = len(scores)
    keys = order_keys(scores)
    bits = BINS.bit_length() - 1
    per_lane = BINS // 32
    prefix, need = 0, K
    for p in range(32 // bits):
        shift = 32 - bits * (p + 1)
        inside = (np.ones(n, bool) if p == 0
                  else (keys >> np.uint32(shift + bits)) == prefix)
        hist = np.bincount((keys[inside] >> np.uint32(shift)) & (BINS - 1),
                           minlength=BINS)
        desc = hist[::-1]                       # lane l: bins BINS-1-8l...
        lane_sum = desc.reshape(32, per_lane).sum(axis=1)
        incl = np.cumsum(lane_sum)
        src = int(np.argmax(incl >= need))
        above, q = int(incl[src] - lane_sum[src]), 0
        while above + desc[src * per_lane + q] < need:
            above += int(desc[src * per_lane + q])
            q += 1
        prefix = (prefix << bits) | (BINS - 1 - (src * per_lane + q))
        need -= above
        take_all = desc[src * per_lane + q] == need
        if take_all:
            break
    hi = keys >> np.uint32(shift)
    taken = list(np.flatnonzero((hi > prefix) | (take_all & (hi == prefix))))
    if not take_all:
        order = kernel_order(n)
        ties = order[hi[order] == prefix]
        taken += list(ties[:need] if low_index_wins else ties[::-1][:need])
    assert len(taken) == K
    idx = np.asarray(taken, np.uint64)
    low = (np.uint64(0xFFFFFFFF) - idx) if low_index_wins else idx
    packed = (keys[taken].astype(np.uint64) << np.uint64(32)) | low
    p2 = 1 << (K - 1).bit_length()
    top = bitonic_desc(np.concatenate([packed, np.zeros(p2 - K, np.uint64)]))
    lows = top[:K] & np.uint64(0xFFFFFFFF)
    out = (np.uint64(0xFFFFFFFF) - lows) if low_index_wins else lows
    return [(float(scores[i]), int(i)) for i in out.astype(np.int64)]


@pytest.mark.parametrize("K,V", [(33, 64), (64, 64), (100, 12), (128, 64),
                                 (256, 64), (1000, 5)])
@pytest.mark.parametrize("kind", ["ties", "dead", "random", "zeros"])
def test_wide_selection_is_stable_topk(K, V, kind):
    rng = np.random.default_rng(K * 1000 + V)
    if kind == "zeros":             # -0.0 and +0.0 are one score
        s = rng.choice(np.float32([0.0, -0.0, -1.0]), K + K * V)
    else:
        s = _scores(rng, K, V, kind)
    assert wide_topk(s, K) == stable_topk(s, K)


def test_wide_kernel_order_is_ascending():
    """The warps' index ranges, rounds and lanes visit every flat index
    once, in ascending order: the ties' ranking is their index order."""
    for n in (33 * 65, 1000 * 6, 17):
        assert np.array_equal(kernel_order(n), np.arange(n))


def test_wide_higher_index_variant_fails():
    """The wide model with ties going to the higher index (in the tie
    ranking and in the survivors' packing) differs from the stable sort
    wherever dead beams are filled and on tied scores."""
    rng = np.random.default_rng(2)
    for K, V in ((33, 64), (100, 12), (256, 64)):
        for kind in ("dead", "ties"):
            s = _scores(rng, K, V, kind)
            assert wide_topk(s, K, low_index_wins=False) != stable_topk(s, K)
