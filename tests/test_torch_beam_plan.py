"""Numpy models of ``csrc/beam.cu``'s two top-K selections, which cannot
run here, each of which must equal a stable descending sort's first K
(``jax.lax.top_k``'s order: the lower flat index first on ties) on scores
full of exact ties and LOG_ZERO rows, with the kernel's constants read
from the source; variants planted to let the higher index win a tie, or
to give the wide form's blocks their index ranges out of order, must fail.

Both forms select on one 64-bit word a candidate, (order key << 32) |
(2^32 - 1 - index), the order key a uint32 whose order is the float order
(-0 as +0), so no two words are equal.

The narrow form (K ≤ 32, 128 or 256 threads a row): thread t holds the
run of m = ⌈N/NT⌉ candidates from t·m and keeps the best word; each warp
writes its 32 bests at their ranks (``warp_rank``: all pairs, ties to the
lower lane); each entry of a warp's top K counts by a fixed-step binary
search (``count_above32``) the other warps' entries above it, and the one
ranked K-1 is the threshold; every candidate at or
above it joins a list (in whatever order the atomic slots give), and each
list entry's rank is the count of list entries above it.

The wide form (any K, a row over C = 1, 2 or 4 blocks of 16 warps): block
r owns the flat indices [r·nb, (r+1)·nb), its warp w the part
[w·span, (w+1)·span) of that in rounds of 32 lanes; a radix select of 11,
11 and 10 bits a pass over the summed histograms (thread u owns bins
nbins-1-u·per … nbins-per-u·per, highest first; the thread whose range
holds the need-th key picks the digit; the passes stop once the digit's
bin is all taken); the keys above the threshold class in any order, then
the class's first ``need`` members by their rank in (block, warp, round,
lane) order; the K survivors sorted by ``sort_desc`` (each run of 32
placed by ``warp_rank``, then each word's rank among the other runs by
``count_above32``). The plan (``make_plan``, ``csrc/beam_plan.cuh``: plain
C++ that the kernels' library compiles too, built here with g++) routes
between the forms and picks the block size and the cluster."""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest

from chainer_speech_recognition_tpu_torch.ops import beam_cuda

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "chainer_speech_recognition_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "beam.cu")
PLAN_SRC = os.path.join(CSRC, "beam_plan.cuh")
LOG_ZERO = np.float32(-1e30)
MASK32 = np.uint64(0xFFFFFFFF)


def _constant(name: str) -> int:
    src = open(SRC).read() + open(PLAN_SRC).read()
    m = re.search(rf"constexpr int {name} = ([^;]+);", src)
    return int(eval(m.group(1), {}, {"kDigitBits": DIGIT_BITS}
                    if name != "kDigitBits" else {}))


DIGIT_BITS = int(re.search(r"constexpr int kDigitBits = (\d+);",
                           open(SRC).read()).group(1))
THREADS = _constant("kThreads")
MAX_SPLIT = _constant("kMaxSplit")
WIDE_WARPS = _constant("kWideThreads") // 32
BINS = _constant("kRadixBins")
MAX_CLUSTER = _constant("kMaxCluster")
MAX_BEAM = _constant("kMaxBeam")


# ------------------------------------------------------------- helpers --

def order_keys(scores):
    """The kernel's ``order_key``: float32 → uint32, -0 as +0."""
    u = (scores.astype(np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def words(keys, idx, low_index_wins=True):
    """(key << 32) | (2^32 - 1 - index); the planted variant packs the
    index itself, so the higher index wins a tie."""
    idx = np.asarray(idx, np.uint64)
    low = (MASK32 - idx) if low_index_wins else idx
    return (np.asarray(keys, np.uint64) << np.uint64(32)) | low


def word_index(w, low_index_wins=True):
    low = np.asarray(w, np.uint64) & MASK32
    return ((MASK32 - low) if low_index_wins else low).astype(np.int64)


def warp_rank(x, break_ties=True):
    """The kernel's ``warp_rank``: lane l's count of lanes holding a larger
    word, or an equal one at a lower lane (the planted variant counts only
    the larger ones, so equal words collide)."""
    x = np.asarray(x, np.uint64)
    lane = np.arange(32)
    earlier = (lane[None, :] < lane[:, None]) & break_ties
    return ((x[None, :] > x[:, None])
            | ((x[None, :] == x[:, None]) & earlier)).sum(axis=1)


def warp_order(x, break_ties=True):
    """32 words written at their ``warp_rank`` (later writes win; a rank
    no lane takes keeps 2^64 - 1, no word)."""
    out = np.full(32, 2**64 - 1, np.uint64)
    for lane, r in enumerate(warp_rank(x, break_ties)):
        out[r] = x[lane]
    return out


def count_above32(s, x):
    """The kernel's ``count_above32``: how many of s[0, 32) (descending)
    are above x, by fixed steps of 16, 8, 4, 2, 1 and a last look."""
    pos = 0
    for step in (16, 8, 4, 2, 1):
        if s[pos + step - 1] > x:
            pos += step
    return pos + int(s[pos] > x)


def sort_desc(s):
    """The kernel's ``sort_desc``: runs of 32 placed by ``warp_rank``
    (zeros pad the last), then each word lands at its rank in its run plus
    its count of the other runs' words above it."""
    n = len(s)
    runs = -(-n // 32)
    tmp = np.zeros(runs * 32, np.uint64)
    tmp[:n] = s
    for r in range(runs):
        tmp[32 * r:32 * r + 32] = warp_order(tmp[32 * r:32 * r + 32])
    if runs == 1:
        return tmp[:n]
    out = np.zeros(n, np.uint64)
    for i in range(n):
        r = i // 32
        rank = i - 32 * r + sum(count_above32(tmp[32 * q:32 * q + 32],
                                              tmp[i])
                                for q in range(runs) if q != r)
        out[rank] = tmp[i]
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
        live = K + rng.choice(V, min(5, V), replace=False)
        s[live] = rng.standard_normal(len(live)).astype(np.float32) - 4
    elif kind == "flat":        # a few live candidates, LOG_ZERO elsewhere
        s = np.full(n, LOG_ZERO, np.float32)
        live = rng.choice(n, min(5, n), replace=False)
        s[live] = rng.standard_normal(len(live)).astype(np.float32) - 4
    elif kind == "zeros":       # -0.0 and +0.0 are one score
        s = rng.choice(np.float32([0.0, -0.0, -1.0]), n)
    elif kind == "symbol":      # one symbol best from every beam
        s = rng.standard_normal(n).astype(np.float32) - 6
        v = int(rng.integers(1, V)) if V > 1 else 0
        s[K + np.arange(K) * V + v] = -rng.random(K).astype(np.float32)
    else:
        s = rng.standard_normal(n).astype(np.float32)
        s[rng.random(n) < 0.3] = LOG_ZERO
    return s.astype(np.float32)


# ---------------------------------------------------------- the narrow --

def kernel_topk(scores, K, split=1, low_index_wins=True, rng=None,
                stats=None):
    """scores [K + K·V] fp32 → the narrow form's K (score, index) pairs;
    ``rng`` shuffles the list's atomic slots."""
    n = len(scores)
    NT = THREADS * split
    NW = NT // 32
    w = words(order_keys(scores), np.arange(n), low_index_wins)
    m = -(-n // NT)
    best = np.zeros(NT, np.uint64)
    for t in range(NT):
        mine = w[t * m:(t + 1) * m]
        if len(mine):
            best[t] = mine.max()
    lists = [warp_order(best[32 * q:32 * q + 32]) for q in range(NW)]
    thr = None
    for q in range(NW):
        for p in range(K):
            e = lists[q][p]
            rank = p + sum(count_above32(lists[q2], e)
                           for q2 in range(NW) if q2 != q)
            if rank == K - 1:
                assert thr is None
                thr = e
    assert thr is not None
    cand = w[w >= thr]
    if rng is not None:
        cand = rng.permutation(cand)
    assert K <= len(cand) <= K * m
    if stats is not None:
        stats.append(len(cand))
    top = np.zeros(K, np.uint64)
    for c in cand:
        rank = int((cand > c).sum())
        if rank < K:
            top[rank] = c
    idx = word_index(top, low_index_wins)
    return [(float(scores[i]), int(i)) for i in idx]


def test_warp_rank_sorts():
    """Words written at their warp ranks land in descending order, lane 0
    first, equal words (zero padding) at distinct ranks; ranked by the
    larger words alone they collide and the order loses words; the fixed-
    step search counts exactly."""
    rng = np.random.default_rng(0)
    for _ in range(200):
        x = rng.integers(0, 2**63, 32, dtype=np.uint64)
        x[rng.random(32) < 0.3] = 0
        assert sorted(warp_rank(x)) == list(range(32))
        assert np.array_equal(warp_order(x), np.sort(x)[::-1])
        for y in (*x[:4], np.uint64(0), np.uint64(2**64 - 1)):
            assert count_above32(np.sort(x)[::-1], y) == int((x > y).sum())
    x = np.zeros(32, np.uint64)
    x[:3] = [5, 7, 9]
    assert len(set(warp_rank(x, break_ties=False))) < 32
    assert not np.array_equal(warp_order(x, break_ties=False),
                              np.sort(x)[::-1])


@pytest.mark.parametrize("K,V", [(1, 5), (4, 64), (8, 64), (8, 300),
                                 (16, 40), (32, 9), (24, 64), (32, 64)])
@pytest.mark.parametrize("kind", ["ties", "dead", "random", "symbol",
                                  "flat"])
def test_kernel_selection_is_stable_topk(K, V, kind):
    rng = np.random.default_rng(K * 1000 + V)
    s = _scores(rng, K, V, kind)
    want = stable_topk(s, K)
    for split in (1, MAX_SPLIT):
        assert kernel_topk(s, K, split, rng=rng) == want


def test_narrow_long_rows():
    """V = 2048 at K = 8 and 16 (256 threads a row, the plan's long rows)
    and V = 64 at K = 32: the selection is the stable sort's, and the list
    stays within 2K where one symbol leads every beam (at most K times a
    thread's candidates in any frame)."""
    rng = np.random.default_rng(3)
    for K, V, split in ((8, 2048, MAX_SPLIT), (16, 2048, MAX_SPLIT),
                        (32, 64, 1), (8, 64, 1)):
        for kind in ("random", "symbol", "dead", "ties", "flat"):
            stats = []
            s = _scores(rng, K, V, kind)
            assert kernel_topk(s, K, split, rng=rng,
                               stats=stats) == stable_topk(s, K)
            if kind == "symbol":
                assert stats[0] <= 2 * K, (K, V, stats)


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


# ------------------------------------------------------------ the wide --

def block_ranges(n, C, reversed_blocks=False):
    """[(lo, hi)] of the row's C blocks; the planted variant gives block r
    the range of block C-1-r while the tie offsets still run by rank."""
    nb = -(-n // C)
    out = [(r * nb, min(n, (r + 1) * nb)) for r in range(C)]
    return out[::-1] if reversed_blocks else out


def kernel_order(lo, hi, nb):
    """Flat indices of one block in the order its tie ranking visits them:
    warp w's range [lo + w·span, ...) in rounds of 32 lanes."""
    span = (-(-nb // WIDE_WARPS) + 31) // 32 * 32
    idx = (lo + np.arange(WIDE_WARPS)[:, None, None] * span
           + np.arange(0, span, 32)[None, :, None]
           + np.arange(32)[None, None, :]).reshape(-1)
    return idx[(idx >= lo) & (idx < hi)]


def wide_topk(scores, K, C=1, low_index_wins=True, reversed_blocks=False,
              rng=None):
    """scores [N] fp32 → the wide form's K (score, index) pairs over a row
    of C blocks."""
    n = len(scores)
    keys = order_keys(scores)
    ranges = block_ranges(n, C, reversed_blocks)
    prefix, need, shift, take_all = 0, K, 0, False
    for p in range(3):
        bits = DIGIT_BITS if p < 2 else 32 - 2 * DIGIT_BITS
        shift = 32 - DIGIT_BITS * p - bits
        nbins = 1 << bits
        per = nbins // (WIDE_WARPS * 32)
        inside = (np.ones(n, bool) if p == 0 else
                  (keys >> np.uint32(shift + bits)) == prefix)
        hist = np.zeros(nbins, np.int64)
        for lo, hi in ranges:             # each block's, then summed
            k = keys[lo:hi][inside[lo:hi]]
            hist += np.bincount((k >> np.uint32(shift)) & (nbins - 1),
                                minlength=nbins)
        desc = hist[::-1].reshape(-1, per)      # thread u: its bins
        sums = desc.sum(axis=1)
        above = np.concatenate([[0], np.cumsum(sums)[:-1]])
        owner = np.flatnonzero((above < need) & (need <= above + sums))
        assert len(owner) == 1
        u = int(owner[0])
        a = int(above[u])
        for q in range(per):
            if a + desc[u, q] >= need:
                break
            a += int(desc[u, q])
        prefix = (prefix << bits) | (nbins - 1 - (u * per + q))
        take_all = desc[u, q] == need - a
        need -= a
        if take_all:
            break
    h = keys >> np.uint32(shift)
    surv = []
    above_all = []
    for lo, hi in ranges:                 # any order within a block
        sel = lo + np.flatnonzero((h[lo:hi] > prefix)
                                  | (take_all & (h[lo:hi] == prefix)))
        above_all += list(rng.permutation(sel) if rng is not None else sel)
    surv += above_all
    if not take_all:
        nb = -(-n // C)
        ties = []
        for lo, hi in ranges:             # blocks by rank, warps, rounds
            order = kernel_order(lo, hi, nb)
            ties += list(order[h[order] == prefix])
        surv += (ties[:need] if low_index_wins else ties[::-1][:need])
    assert len(surv) == K
    w = words(keys[surv], surv, low_index_wins)
    idx = word_index(sort_desc(w), low_index_wins)
    return [(float(scores[i]), int(i)) for i in idx]


@pytest.mark.parametrize("K,V", [(33, 64), (64, 64), (100, 12), (128, 64),
                                 (256, 64), (1000, 5)])
@pytest.mark.parametrize("kind", ["ties", "dead", "random", "zeros",
                                  "flat"])
def test_wide_selection_is_stable_topk(K, V, kind):
    rng = np.random.default_rng(K * 1000 + V)
    s = _scores(rng, K, V, kind)
    want = stable_topk(s, K)
    for C in (1, 2, MAX_CLUSTER):
        assert wide_topk(s, K, C, rng=rng) == want


@pytest.mark.parametrize("kind", ["ties", "dead", "random", "symbol"])
def test_wide_cluster_rows(kind):
    """V = 2048 at K = 64 (the plan's four blocks a row) and K = 32 (two):
    the selection is the stable sort's on every split."""
    rng = np.random.default_rng(7)
    for K in (32, 64):
        s = _scores(rng, K, 2048, kind)
        want = stable_topk(s, K)
        for C in (1, 2, MAX_CLUSTER):
            assert wide_topk(s, K, C, rng=rng) == want


def test_wide_kernel_order_is_ascending():
    """The blocks' ranges, their warps' ranges, rounds and lanes visit
    every flat index once, in ascending order: the ties' ranking is their
    index order."""
    for n in (33 * 65, 1000 * 6, 17, 64 * 2049):
        for C in (1, 2, MAX_CLUSTER):
            nb = -(-n // C)
            got = np.concatenate([kernel_order(lo, hi, nb)
                                  for lo, hi in block_ranges(n, C)])
            assert np.array_equal(got, np.arange(n))


def test_wide_higher_index_variant_fails():
    """The wide model with ties going to the higher index (in the tie
    ranking and in the survivors' packing) differs from the stable sort
    wherever dead beams are filled and on tied scores."""
    rng = np.random.default_rng(2)
    for K, V in ((33, 64), (100, 12), (256, 64)):
        for kind in ("dead", "ties"):
            s = _scores(rng, K, V, kind)
            assert wide_topk(s, K, low_index_wins=False) != stable_topk(s, K)


def test_wide_blocks_out_of_order_fail():
    """The wide model with the blocks' index ranges out of rank order (the
    tie offsets summed by rank) takes the wrong ties wherever the threshold
    class spans blocks: a few live candidates, LOG_ZERO elsewhere."""
    rng = np.random.default_rng(5)
    for K, V in ((64, 64), (256, 64), (64, 2048)):
        for C in (2, MAX_CLUSTER):
            s = _scores(rng, K, V, "flat")
            assert wide_topk(s, K, C) == stable_topk(s, K)
            assert wide_topk(s, K, C, reversed_blocks=True) != \
                stable_topk(s, K)


def test_sort_desc_runs():
    """``sort_desc`` orders any n distinct words (one run and several)."""
    rng = np.random.default_rng(4)
    for n in (1, 7, 32, 33, 64, 100, 256, 1000):
        x = rng.choice(2**62, n, replace=False).astype(np.uint64) + 1
        assert np.array_equal(sort_desc(x), np.sort(x)[::-1])


# ------------------------------------------------------------ the plan --

# the plan's constants, in the order the host build reports them
PLAN_CONSTANTS = ("kThreads", "kMaxSplit", "kNarrowLongRow", "kMaxBeam",
                  "kMaxCtx", "kStageMaxV", "kSharedBudget", "kMaxCluster",
                  "kWideLongRow", "kWSlots")
_SHIM = """#include "beam_plan.cuh"
extern "C" void plan(int T, int V, int K, int CL, int wide, int* out) {
  plan_out(T, V, K, CL, wide, out);
}
extern "C" void constants(long long* out) {
  const long long c[] = {%s};
  for (int i = 0; i < %d; ++i) out[i] = c[i];
}
""" % (", ".join(PLAN_CONSTANTS), len(PLAN_CONSTANTS))


@pytest.fixture(scope="module")
def host_plan(tmp_path_factory):
    """``csrc/beam_plan.cuh`` built for this host with g++: a function
    (T, V, K, ctx_len, wide) → the ``BeamPlan`` that ``beam_plan`` reads
    from the card's library for the same call, and the plan's constants
    as the compiler sees them."""
    d = tmp_path_factory.mktemp("beam_plan")
    (d / "shim.cpp").write_text(_SHIM)
    so = str(d / "libbeam_plan.so")
    proc = subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                           "-I", CSRC, "-o", so, str(d / "shim.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(so)

    def plan(T, V, K, ctx_len=1, wide=False):
        out = (ctypes.c_int * 8)()
        lib.plan(T, V, K, ctx_len, int(wide), out)
        return beam_cuda.BeamPlan(*out)

    c = (ctypes.c_longlong * len(PLAN_CONSTANTS))()
    lib.constants(c)
    plan.constants = dict(zip(PLAN_CONSTANTS, c))
    return plan


def test_plan_constants_are_the_source_s(host_plan):
    """The plan's constants as the tests' models read them from the source
    (``_constant``) are the ones the compiler sees, and the wrapper's beam
    limit is ``csrc/beam.cu``'s."""
    got = host_plan.constants
    for name in PLAN_CONSTANTS[:-1]:
        assert _constant(name) == got[name], name
    value, names = -1, {}                 # the enum's kWSlots
    for entry in re.search(r"enum WideSlot \{(.*?)\};", open(PLAN_SRC).read(),
                           re.S).group(1).split(","):
        name, _, given = entry.strip().partition(" = ")
        value = eval(given, {}, names) if given else value + 1
        names[name] = value
    assert name == "kWSlots" and value == got["kWSlots"]
    assert _constant("kMaxWideBeam") == beam_cuda.MAX_WIDTH
    assert got["kMaxBeam"] == MAX_BEAM and got["kMaxSplit"] == MAX_SPLIT


@pytest.mark.parametrize("V", [5, 64, 2048])
def test_plan_routes_by_width(host_plan, V):
    """The routing boundary: the narrow form up to K = 32 (kMaxBeam) at ≤ 8
    context lanes where its row's keys and list fit (every K up to it at V
    ≤ 64; at V = 2048 up to K = 19, then the wide form), the wide form past
    any of these or when asked; the main paths' K = 8 (decode, stream
    windows) narrow, K = 64 wide."""
    for CL in (1, 8, 9):
        narrow = [K for K in range(1, 70)
                  if host_plan(251, V, K, CL).wide == 0]
        if CL > _constant("kMaxCtx"):
            assert narrow == []
        else:
            last = {2048: 19}.get(V, MAX_BEAM)
            assert narrow == list(range(1, last + 1))
        assert all(host_plan(251, V, K, CL, wide=True).wide
                   for K in range(1, 70))
    assert host_plan(251, 64, 8, 2).wide == 0
    assert host_plan(80, 64, 8, 2).wide == 0
    assert host_plan(251, 64, 64, 2).wide == 1


def test_plan_narrow_split_and_list(host_plan):
    """The narrow form takes 256 threads past kNarrowLongRow candidates
    (K = 16 to 32 at V = 64, K = 8 at V = 2048), 128 up to it (K = 8 at V =
    64 and 100); its list holds K times a thread's candidates; a row whose
    keys and list pass the budget goes wide."""
    long_row = _constant("kNarrowLongRow")
    p = host_plan(251, 64, 8, 2)
    assert (p.wide, p.split, p.keys_shared) == (0, 1, 1)
    assert host_plan(251, 64, 15, 2).split == 1
    for K in (16, 24, 32):
        assert host_plan(251, 64, K, 2).split == MAX_SPLIT
    p = host_plan(251, 2048, 8, 1)
    assert (p.wide, p.split) == (0, MAX_SPLIT)
    assert 8 + 8 * 100 <= long_row < 8 + 8 * 128
    assert host_plan(251, 100, 8, 1).split == 1
    assert host_plan(251, 128, 8, 1).split == MAX_SPLIT
    assert host_plan(251, 2048, 16, 1).wide == 0
    assert host_plan(251, 2048, 32, 1).wide == 1
    budget = _constant("kSharedBudget")
    for T, V, K in ((251, 64, 8), (251, 2048, 16), (1700, 8, 32)):
        p = host_plan(T, V, K, 1)
        N = K + K * V
        cap = K * -(-N // (THREADS * p.split))
        stage = 2 * V * 4 if p.staged else 0
        assert p.smem >= stage + 4 * N + 8 * cap
        assert p.smem <= budget
        assert p.tb_shared == (p.smem - (T * K * 4 if p.tb_shared else 0)
                               + T * K * 4 <= budget)


def test_plan_cluster_choice(host_plan):
    """The wide form takes the fewest blocks a row (1, 2, 4) whose share
    of the row's keys fits beside the staged rows and the workspace, two at
    least past kWideLongRow candidates; 4 with the keys computed again
    where none fits; 1 where the workspace itself passes shared memory (it
    then lives in a scratch), its keys in shared memory where they fit
    there and computed again where they do not."""
    budget = _constant("kSharedBudget")
    long_row = _constant("kWideLongRow")
    assert host_plan(251, 64, 64, 2).split == 1
    assert host_plan(251, 64, 128, 1).split == 2
    assert host_plan(251, 64, 256, 1).split == 2
    p = host_plan(251, 2048, 64, 1)
    assert (p.split, p.keys_shared, p.tb_shared) == (MAX_CLUSTER, 1, 0)
    assert host_plan(251, 2048, 32, 1).split == 2
    assert host_plan(251, 2048, 8, 1, wide=True).split == 2
    assert host_plan(251, 64, 32, 1, wide=True).split == 1
    p = host_plan(4, 13000, 40, 1)
    assert (p.split, p.keys_shared, p.staged) == (MAX_CLUSTER, 0, 0)
    p = host_plan(6, 5, 2000, 1)
    assert (p.split, p.ws_shared, p.keys_shared) == (1, 0, 1)
    p = host_plan(4, 30, 2000, 1)
    assert (p.split, p.ws_shared, p.keys_shared) == (1, 0, 0)
    for K in (33, 64, 128, 256, 1000):
        for V in (5, 64, 2048):
            p = host_plan(251, V, K, 1)
            if not p.ws_shared:
                assert p.split == 1
                continue
            N = K + K * V
            fits = [c for c in (1, 2, MAX_CLUSTER)
                    if (c > 1 or N <= long_row)
                    and _round16(_round16(2 * V * 4) + p.ws_bytes)
                    + 4 * -(-N // c) <= budget]
            assert p.split == (min(fits) if fits else MAX_CLUSTER)
            assert p.keys_shared == bool(fits)


def _round16(x):
    return (x + 15) // 16 * 16
