"""The port's prefix beam (decode/beam.py, the plain version the CPU runs
and the card holds its kernel to) against the reference's ``beam_decode`` /
``beam_decode_nbest`` on the same seeded logits: B = 4, T = 40, per-row
lengths (one row of a single frame), V ∈ {5, 64, 512} × K ∈ {1, 4, 8}
without an LM, with a dense 3-gram, a hashed 4-gram, a unigram at α = 0,
β ≠ 0, and V = 3000 with an order-4 hashed LM (fp32 and fp16 rows); the
widths the kernel's wide form takes, K ∈ {33, 64, 100, 128} at V = 64
without an LM, with the dense 3-gram and with the hashed 4-gram, and a
hashed 12-gram (11 context lanes) at K = 64.

Tolerances: 1-best ids, n-best prefixes and lengths exactly (dead-beam
rows included: they show the top-K's tie rule), final scores within 1e-4
(XLA's and torch's exp/log1p may differ in the last bits); the state's
four hash arrays (and last, context) exactly after 10 frames. The port's
copy of the host oracle gives the reference oracle's answers, and both
decoders equal exhaustive path-sum enumeration on a small case."""

import itertools
from collections import defaultdict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.decode import beam as jb
from chainer_speech_recognition_tpu.decode import lm as jl
from chainer_speech_recognition_tpu_torch.decode import beam as tb
from chainer_speech_recognition_tpu_torch.decode import lm as tl

torch.set_num_threads(1)
B, T = 4, 40
LENS = np.asarray([40, 33, 1, 17], np.int32)
SCORE_ATOL = 1e-4


def _logits(seed, V, peak=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    path = rng.integers(0, V, (B, T))
    for b in range(B):
        x[b, np.arange(T), path[b]] += peak
    return x


def random_lm(mod, V, order, seed, n_ctx=100):
    """The same backoff LM built in either package (``mod``: lm module)."""
    rng = np.random.default_rng(seed)
    lm = mod.NGramLM(order, V)
    lm.logp[0][()] = {c: float(np.log(0.8 / (V - 1))) for c in range(1, V, 3)}
    for k in range(1, order):
        for ctx in {tuple(int(x) for x in rng.integers(1, V, k))
                    for _ in range(n_ctx)}:
            succ = rng.integers(1, V, size=5)
            lp = np.log(rng.dirichlet(np.ones(5)) * 0.7)
            lm.logp[k][ctx] = {int(c): float(p) for c, p in zip(succ, lp)}
            lm.backoff[k][ctx] = float(np.log(0.3))
    return lm


def _lms(kind, V):
    """(JAX-side lm, port-side lm, alpha, beta) for one LM case."""
    if kind == "none":
        return None, None, 0.5, 1.0
    if kind == "dense3":
        return random_lm(jl, V, 3, 5), random_lm(tl, V, 3, 5), 0.6, 0.5
    if kind == "unigram":
        return random_lm(jl, V, 1, 6), random_lm(tl, V, 1, 6), 0.0, 1.5
    if kind == "hashed12":
        return (random_lm(jl, V, 12, 8, 20).to_hashed(),
                random_lm(tl, V, 12, 8, 20).to_hashed(), 0.6, 0.5)
    j, t = random_lm(jl, V, 4, 7).to_hashed(), random_lm(tl, V, 4, 7) \
        .to_hashed()
    if kind == "hashed4_fp16":
        j = jl.HashedLM(j.table, j.rows.astype(np.float16), j.order,
                        j.max_probes)
        t = tl.HashedLM(t.table, t.rows.astype(np.float16), t.order,
                        t.max_probes)
    return j, t, 0.6, 0.5


CASES = ([(V, K, "none") for V in (5, 64, 512) for K in (1, 4, 8)]
         + [(64, 8, "dense3"), (64, 4, "hashed4"), (64, 8, "unigram"),
            (3000, 8, "hashed4"), (3000, 8, "hashed4_fp16")]
         + [(64, K, kind) for K in (33, 64, 100, 128)
            for kind in ("none", "dense3", "hashed4")]
         + [(64, 64, "hashed12")])


@pytest.mark.parametrize("V,K,kind", CASES)
def test_beam_matches_reference(V, K, kind):
    logits = _logits(V * 10 + K, V)
    jlm, tlm, a, b = _lms(kind, V)
    ref = jb.beam_decode(logits, LENS, beam=K, lm=jlm, alpha=a, beta=b)
    got = tb.beam_decode(torch.from_numpy(logits), LENS, beam=K, lm=tlm,
                         alpha=a, beta=b)
    assert got == [[int(x) for x in r] for r in ref]
    jp, jn, jf = jb.beam_decode_nbest(logits, LENS, beam=K, lm=jlm,
                                      alpha=a, beta=b)
    tp, tn, tf = tb.beam_decode_nbest(torch.from_numpy(logits), LENS,
                                      beam=K, lm=tlm, alpha=a, beta=b)
    assert np.array_equal(tn, jn) and np.array_equal(tp, jp)
    assert np.abs(tf - np.asarray(jf)).max() <= SCORE_ATOL


@pytest.mark.parametrize("V,K,kind", [(64, 8, "none"), (64, 8, "dense3"),
                                      (3000, 8, "hashed4")])
def test_state_after_ten_frames_matches_reference(V, K, kind):
    """The carried state after a 10-frame chunk: the four hash arrays,
    last and the LM context exactly; the chunk's packed emissions, counts
    and parent beams (``_beam_chunk_jit``) exactly."""
    logits = _logits(V + 3, V)[:, :10]
    jlm, tlm, a, b = _lms(kind, V)
    lt, lr, lo, fu, ha, pr, aa, bb = jb._prep_lm(jlm, V, a, b)
    st = jb.beam_stream_init(B, K, max(lo - 1, 1))
    packed, jfin, jst = jb._beam_chunk_jit(
        jnp.asarray(logits), jnp.asarray(LENS), st, K, lt, lr, lo, fu, ha,
        pr, jb._ab_device(float(aa), float(bb)))
    dlm = tb.lm_on_device(tlm, V, "cpu")
    chars, elen, p0, tfin, tst = tb.beam_chunk_plain(
        tb._log_probs(logits), torch.from_numpy(LENS),
        tb.beam_stream_init(B, K, dlm.ctx_len), dlm, a, b, K, 10, False)
    for j, t in zip(jst[2:], tst[2:]):
        assert np.array_equal(np.asarray(j), t.numpy())
    for j, t in zip(jst[:2], tst[:2]):
        assert np.abs(np.asarray(j) - t.numpy()).max() <= SCORE_ATOL
    arr = np.asarray(packed).astype(np.int32)
    assert np.array_equal(arr[:, : K * 10].reshape(B, K, 10), chars.numpy())
    assert np.array_equal(arr[:, K * 10 : K * 11], elen.numpy())
    assert np.array_equal(arr[:, K * 11 :], p0.numpy())
    assert np.abs(np.asarray(jfin) - tfin.numpy()).max() <= SCORE_ATOL


def test_hash_arithmetic_wraps_like_int32():
    """The rolled prefix hashes and the hashed LM's slot keys at the int32
    edges, against the reference's jnp.int32 arithmetic."""
    h = np.asarray([-2**31, -32, -1, 0, 1, 2**30 - 36, 2**31 - 1], np.int32)
    c = np.asarray([0, 1, 5, 32766, 7, 3, 2], np.int32)
    for mult, mod in ((jb._HASH_MULT, jb._HASH_MOD),
                      (jb._HASH_MULT2, jb._HASH_MOD2)):
        ref = ((jnp.asarray(h) % mod) * mult + jnp.asarray(c)) % mod
        got = tb._roll(torch.from_numpy(h), torch.from_numpy(c), mult, mod)
        assert np.array_equal(np.asarray(ref), got.numpy())
    ref = jnp.asarray(h).astype(jnp.uint32) * jnp.uint32(2654435761)
    got = tb._slot_hash(torch.from_numpy(h))
    assert np.array_equal(np.asarray(ref).astype(np.int64), got.numpy())


def _exhaustive(lp):
    """All collapsed prefixes with exact total probability, best first."""
    T_, V = lp.shape
    probs = defaultdict(float)
    for path in itertools.product(range(V), repeat=T_):
        p = np.exp(sum(lp[t, c] for t, c in enumerate(path)))
        out, prev = [], -1
        for c in path:
            if c != 0 and c != prev:
                out.append(c)
            prev = c
        probs[tuple(out)] += p
    return sorted(probs.items(), key=lambda kv: -kv[1])


@pytest.mark.parametrize("with_lm", [False, True])
def test_oracle_and_exhaustive_enumeration(with_lm):
    """A beam wide enough for every prefix: the port's oracle equals the
    reference's oracle, and the batched beam's 1-best and n-best equal
    exhaustive enumeration (re-scored with the LM when fused)."""
    rng = np.random.default_rng(17 + with_lm)
    logits = rng.standard_normal((1, 4, 3)).astype(np.float32) * 1.5
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))[0]
    jlm = tlm = None
    alpha, beta = 0.0, 0.0
    if with_lm:
        jlm, tlm = random_lm(jl, 3, 2, 3, 4), random_lm(tl, 3, 2, 3, 4)
        alpha, beta = 0.4, 1.1
    exact = [(np.log(p) + (alpha * tlm.sequence_logp(k) + beta * len(k)
                           if with_lm else 0.0), k)
             for k, p in _exhaustive(lp)]
    exact.sort(key=lambda e: -e[0])
    want = list(exact[0][1])
    assert tb.beam_decode_reference(lp, 4, beam=64, lm=tlm, alpha=alpha,
                                    beta=beta) == want
    assert jb.beam_decode_reference(lp, 4, beam=64, lm=jlm, alpha=alpha,
                                    beta=beta) == want
    got = tb.beam_decode(torch.from_numpy(logits), np.asarray([4]), beam=16,
                         lm=tlm, alpha=alpha, beta=beta)
    assert got[0] == want
    pfx, plen, final = tb.beam_decode_nbest(
        torch.from_numpy(logits), np.asarray([4]), beam=16, lm=tlm,
        alpha=alpha, beta=beta, max_len=4)
    for k in range(4):
        assert list(pfx[0, k, : plen[0, k]]) == list(exact[k][1])
        if not with_lm:
            assert abs(final[0, k] - exact[k][0]) < 1e-3


def test_refusals_and_stream_generator():
    logits = torch.from_numpy(_logits(1, 5))
    with pytest.raises(ValueError, match="32767"):
        tb.beam_decode(torch.zeros((1, 2, 32768)), [2], beam=2)
    with pytest.raises(ValueError, match="beam width"):
        tb.beam_decode(logits, LENS, beam=0)
    with pytest.raises(ValueError, match="unsupported device"):
        tb.beam_chunk(logits.to("meta"), torch.from_numpy(LENS),
                      tb.beam_stream_init(B, 2), tb.NO_LM, 0.0, 0.0, 1, T,
                      True)
    batches = [(logits, LENS), (logits[:2, :20], LENS[:2] // 2)]
    got = list(tb.beam_decode_stream(iter(batches), beam=4))
    assert got == [tb.beam_decode(lg, ln, beam=4) for lg, ln in batches]
