"""The CTC lanes kernels (``csrc/ctc.cu``) modelled on the CPU: a thread's
states, the shuffles, the warps' halos and their exchange, the ring's
slots and its cp.async groups, the frozen rows and skipped columns, held
bitwise to the plain recursions of ``ops/ctc.py``.

The warps of an utterance meet only at the halo exchange, so between two
exchanges one may run up to EXCHANGE - 1 frames ahead of another. The
model runs them in lockstep and also one warp at a time from exchange to
exchange, in both orders. The ring is one array of shared columns, laid
out as the kernels lay it out: a copy may land as soon as it is issued,
and a read gives NaN unless its cell still holds the frame it wants and
the reading thread has waited for its own copy of it. A layout where two
warps' threads stage into one column (by state, as an earlier version
did) fails the model once the warps drift.

The design constants below are those of ``csrc/ctc.cu``; the kernels
themselves, and the launch plan the library computes from S, need a card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.ops.ctc import (
    LOG_ZERO, ctc_alpha_plain, ctc_beta_grad_plain, ctc_inputs, logsumexp3)

K = 2               # states a thread (kStates)
R = 8               # frames in the ring, R - 1 ahead (kRing)
HALO_LANES = 4      # a warp's lanes that hold its neighbour's states
H = HALO_LANES * K  # halo states (kHalo)
EXCHANGE = H // 2   # frames between two exchanges (kExchange)
OWN = (32 - HALO_LANES) * K     # a warp's own states (kOwn)
MAX_WARPS = 16      # warps an utterance (kMaxWarps)
NAN = float("nan")


def _warp_states(w, bwd):
    """[32, K] state indices of warp w's threads: in the forward lanes
    below HALO_LANES hold the halo below the warp's own states, in the
    backward lanes from 32 − HALO_LANES the halo above them."""
    lane = torch.arange(32)
    s0 = w * OWN + (lane if bwd else lane - HALO_LANES) * K
    return s0[:, None] + torch.arange(K)


def _columns(layout, w, bwd):
    """[32, K] ring columns of warp w's threads and the ring's width:
    "thread" (the kernels': K columns a thread) or "state" (a column a
    state, as the first lanes design had it)."""
    if layout == "thread":
        return (w * 32 + torch.arange(32))[:, None] * K + torch.arange(K), \
            MAX_WARPS * 32 * K
    return _warp_states(w, bwd) + H, H + MAX_WARPS * OWN + 32 * K + H


def _gather(row, sidx, fill):
    """row[s] at every state index, ``fill`` outside [0, len(row))."""
    ok = (sidx >= 0) & (sidx < row.numel())
    return torch.where(ok, row[sidx.clamp(0, row.numel() - 1)], fill)


class _Ring:
    """R slots of shared columns. A cell holds a value and the frame whose
    copy was issued to it last (a copy may land at once); each warp's
    copies form the cp.async groups the kernel commits."""

    def __init__(self, width):
        self.val = torch.full((R, width), NAN)
        self.frame = torch.full((R, width), -1, dtype=torch.int64)

    def stage(self, cols, mask, frame, values):
        c = cols[mask]
        self.val[frame % R, c] = values[mask]
        self.frame[frame % R, c] = frame

    def read(self, cols, frame, waited):
        """What a thread reads of ``frame``: NaN unless the cell holds it
        and ``waited`` (the thread's own copy has completed)."""
        ok = (self.frame[frame % R, cols] == frame) & waited
        return torch.where(ok, self.val[frame % R, cols], NAN)


class _Groups:
    """One warp's cp.async groups: commit() closes a group of the frames
    staged since the last, wait(n) completes all but the newest n."""

    def __init__(self):
        self.groups, self.open, self.done = [], set(), set()

    def add(self, frame):
        self.open.add(frame)

    def commit(self):
        self.groups.append(self.open)
        self.open = set()

    def wait(self, n):
        for g in self.groups[:len(self.groups) - n]:
            self.done |= g

    def waited(self, frame):
        return frame in self.done


def _run(warps, order):
    """Run the warps' generators (each yields after a step, True where the
    live warps meet before its next one): "lockstep" one step each in
    turn; "up" / "down" each warp on its own from exchange to exchange,
    the lowest (highest) first."""
    gens = warps if order != "down" else warps[::-1]
    while gens:
        left = []
        for g in gens:
            try:
                while not next(g) and order != "lockstep":
                    pass
                left.append(g)
            except StopIteration:
                pass
        gens = left


def _model_fwd(lp, allow2, t_len, lab_len, order, layout):
    """The lanes forward kernel, warp by warp. Thread i holds K states;
    its s−1, s−2 at j = 0, 1 come from thread i − 1, lane 0's from nowhere
    (NaN): only the warp's halo lanes see them, and every EXCHANGE frames
    the halo takes the warp below's values of the frame before."""
    B, T, S = lp.shape
    NW = -(-S // OWN)
    alphas = torch.full((B, T, S), NAN)
    loss = torch.empty(B)
    lane = torch.arange(32)[:, None]
    own = lane >= HALO_LANES
    for b in range(B):
        tl, L = min(int(t_len[b]), T), int(lab_len[b])
        sv = 2 * L + 1
        live_warps = min(-(-sv // OWN), NW)
        ring = _Ring(_columns(layout, 0, False)[1])
        xbuf = torch.full((2, MAX_WARPS, HALO_LANES, K), NAN)
        fin = torch.full((S,), LOG_ZERO)

        def warp(w):
            sidx = _warp_states(w, False)
            cols = _columns(layout, w, False)[0]
            valid = (sidx >= 0) & (sidx < sv)
            keep = own & (sidx < S)
            skip = (sidx >= 2) & (_gather(allow2[b], sidx, 0.0) > 0.5)
            groups = _Groups()

            def stage(r):
                ring.stage(cols, valid, r, _gather(lp[b, r], sidx, NAN))
                groups.add(r)

            init = ((sidx == 0) | ((sidx == 1) & (L > 0))) & valid
            a = torch.where(init, _gather(lp[b, 0], sidx, NAN), LOG_ZERO)
            alphas[b, 0, sidx[keep]] = a[keep]
            for r in range(1, R):
                if r < tl:
                    stage(r)
                groups.commit()
            for t in range(1, tl):
                groups.wait(R - 2)
                if t > 1 and (t - 1) % EXCHANGE == 0 and live_warps > 1 \
                        and w > 0:
                    x = xbuf[((t - 1) // EXCHANGE) & 1, w - 1]
                    a = torch.cat([x, a[HALO_LANES:]])
                up = torch.cat([torch.full((1, 2), NAN), a[:-1, K - 2:]])
                ext = torch.cat([up, a], 1)                 # s-2 .. s+K-1
                sh2 = torch.where(skip, ext[:, :K], LOG_ZERO)
                lpt = ring.read(cols, t, groups.waited(t))
                new = logsumexp3(a, ext[:, 1:K + 1], sh2) + lpt
                a = torch.where(valid, new, LOG_ZERO)
                alphas[b, t, sidx[keep]] = a[keep]
                if t % EXCHANGE == 0:
                    xbuf[(t // EXCHANGE) & 1, w] = a[32 - HALO_LANES:]
                if t + R - 1 < tl:
                    stage(t + R - 1)
                groups.commit()
                yield t % EXCHANGE == 0
            fin[sidx[keep]] = a[keep]
            alphas[b, max(tl, 1):, sidx[keep]] = a[keep]

        _run([warp(w) for w in range(live_warps)], order)
        loss[b] = -logsumexp3(fin[2 * L], fin[2 * L - 1] if L > 0
                              else torch.tensor(LOG_ZERO),
                              torch.tensor(LOG_ZERO))
        alphas[b, :, live_warps * OWN:] = LOG_ZERO
    return alphas, loss


def _model_bwd(lp, allow2, t_len, lab_len, alphas, loss, g, order, layout):
    """The lanes backward kernel as ``_model_fwd`` models the forward:
    step i computes frame t_len − 1 − i from ring slot i mod R; s+1, s+2
    from thread i + 1, lane 31's from nowhere (NaN); the halo lanes sit
    above the own ones and take the warp above's values every EXCHANGE
    steps."""
    B, T, S = lp.shape
    NW = -(-S // OWN)
    grad = torch.full((B, T, S), NAN)
    own = torch.arange(32)[:, None] < 32 - HALO_LANES
    for b in range(B):
        tl, L = min(int(t_len[b]), T), int(lab_len[b])
        sv = 2 * L + 1
        live_warps = min(-(-sv // OWN), NW)
        lring = _Ring(_columns(layout, 0, True)[1])
        aring = _Ring(_columns(layout, 0, True)[1])
        xbuf = torch.full((2, MAX_WARPS, HALO_LANES, K), NAN)

        def warp(w):
            sidx = _warp_states(w, True)
            cols = _columns(layout, w, True)[0]
            valid = sidx < sv
            keep = own & (sidx < S)
            skip = _gather(allow2[b], sidx + 2, 0.0) > 0.5
            init = (sidx == 2 * L) | ((sidx == 2 * L - 1) & (L > 0))
            groups = _Groups()

            def stage(i):
                t = tl - 1 - i
                lring.stage(cols, valid, i, _gather(lp[b, t], sidx, NAN))
                aring.stage(cols, valid, i, _gather(alphas[b, t], sidx, NAN))
                groups.add(i)

            for i in range(R - 1):
                if i < tl:
                    stage(i)
                groups.commit()
            bt = torch.full(sidx.shape, LOG_ZERO)
            for i in range(tl):
                groups.wait(R - 2)
                if i > 1 and (i - 1) % EXCHANGE == 0 and live_warps > 1 \
                        and w + 1 < live_warps:
                    x = xbuf[((i - 1) // EXCHANGE) & 1, w + 1]
                    bt = torch.cat([bt[:32 - HALO_LANES], x])
                dn = torch.cat([bt[1:, :2], torch.full((1, 2), NAN)])
                ext = torch.cat([bt, dn], 1)                 # s .. s+K+1
                lpv = lring.read(cols, i, groups.waited(i))
                if i == 0:
                    v = torch.where(init, lpv, LOG_ZERO)
                else:
                    sh2 = torch.where(skip, ext[:, 2:], LOG_ZERO)
                    v = logsumexp3(bt, ext[:, 1:K + 1], sh2) + lpv
                v = torch.where(valid, v, LOG_ZERO)
                post = aring.read(cols, i, groups.waited(i)) + v - lpv \
                    - (-loss[b])
                gv = -torch.exp(torch.clamp(post, max=0.0)) * g[b]
                gv = torch.where(valid, gv, 0.0)
                grad[b, tl - 1 - i, sidx[keep]] = gv[keep]
                bt = v
                if i > 0 and i % EXCHANGE == 0:
                    xbuf[(i // EXCHANGE) & 1, w] = bt[:HALO_LANES]
                if i + R - 1 < tl:
                    stage(i + R - 1)
                groups.commit()
                yield i % EXCHANGE == 0 and i > 0

        _run([warp(w) for w in range(live_warps)], order)
        grad[b, tl:] = 0.0
        grad[b, :, live_warps * OWN:] = 0.0
    return grad


def _bits(x):
    return x.contiguous().view(torch.int32)


CASES = [
    (5, 12, 6, 4, 1),        # one warp, frames past t_len
    (4, 14, 9, 60, 2),       # S = 121: three warps, halos exchanged
    (2, 1, 4, 3, 3),         # T = 1 < R
    (6, 30, 40, 150, 4),     # S = 301: six warps, live warps fewer
    (3, 9, 5, 47, 5),        # S = 95: the last thread's spare states
    (4, 40, 30, 90, 6),      # S = 181: T past many exchanges
    (2, 150, 30, 80, 8)]     # a 50-label alignment across two warps


def _case(B, T, V, L, seed):
    """Ragged t_len (0, 1, T and above T, clamped), lab_len 0 and full, a
    repeated label, an impossible sample; the plain recursions' outputs
    and an upstream gradient."""
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        2 * rng.standard_normal((B, T, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, V, (B, L)).astype(np.int32))
    tl = rng.integers(0, T + 1, B)
    ll = rng.integers(0, L + 1, B)
    tl[0], ll[0] = T, min(L, max(T // 3, 1))
    labels[0, :2] = 2
    ll[1] = 0
    if B > 3:
        tl[2], ll[2] = 2, L                     # impossible
        tl[3], ll[3] = T + 5, L
    args = ctc_inputs(logits, torch.from_numpy(tl), labels,
                      torch.from_numpy(ll))
    alphas, loss = ctc_alpha_plain(*args)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32))
    g = torch.where(loss < -LOG_ZERO / 2, g, 0.0)
    return args, alphas, loss, g, ctc_beta_grad_plain(*args, alphas, loss, g)


@pytest.mark.parametrize("order", ["lockstep", "up", "down"])
@pytest.mark.parametrize("B,T,V,L,seed", CASES)
def test_lanes_model_matches_plain_bitwise(B, T, V, L, seed, order):
    """The modelled kernels equal the plain recursions bit for bit, with
    the warps in lockstep or drifting apart between exchanges."""
    args, alphas_p, loss_p, g, grad_p = _case(B, T, V, L, seed)
    assert args[0].shape[2] <= MAX_WARPS * OWN
    alphas, loss = _model_fwd(*args, order, "thread")
    assert torch.equal(_bits(alphas), _bits(alphas_p))
    assert torch.equal(_bits(loss), _bits(loss_p))
    grad = _model_bwd(*args, alphas_p, loss_p, g, order, "thread")
    assert torch.equal(_bits(grad), _bits(grad_p))


@pytest.mark.parametrize("form,order", [("fwd", "down"), ("bwd", "up")])
def test_model_sees_warps_share_ring_columns(form, order):
    """The model can fail: with the ring laid out a column a state, a
    halo lane and the lane that owns its state stage into one column, and
    a warp running ahead refills it before its neighbour has read it (the
    forward's upper warp, the backward's lower one). In lockstep that
    layout passes, as the card tests did."""
    args, alphas_p, loss_p, g, grad_p = _case(4, 40, 30, 90, 6)

    def out(order):
        if form == "fwd":
            return _model_fwd(*args, order, "state")[0]
        return _model_bwd(*args, alphas_p, loss_p, g, order, "state")

    want = alphas_p if form == "fwd" else grad_p
    assert torch.equal(_bits(out("lockstep")), _bits(want))
    assert not torch.equal(_bits(out(order)), _bits(want))
