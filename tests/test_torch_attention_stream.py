"""The chunk-causal attention stream (``conformer_stream``) against the JAX
package on the CPU, at the reference suite's cut (2 blocks, d = 16, 2
heads, chunk 4, left 2, conv kernel 7; tests/test_streaming.py:522-527),
weights bridged from flax, inputs from numpy seeds.

Modules: the MHSA step over ``[cache ++ chunk]`` (RoPE at ``pos0``, the
rolled caches), the conv module's VALID conv over ``[tail ++ chunk]`` and
a block's carries, against the flax modules (fp32 atol 1e-5, the block's
eight sums 3e-5; bf16 3e-2, tests/test_torch_attention.py's bars); RoPE at
the positions a stream of hours reaches; ``init_stream_carries`` and
``reset_stream_rows`` against the JAX model's layout and values.

The recognizer (mirrors of tests/test_streaming.py:530-607): streaming ==
the port's offline chunk-masked decode == the JAX recognizer's ids, for
two streams of different lengths with the caches rolling past capacity,
for ragged eager feeding, for the streaming beam (== the offline beam on
the offline logits) and for endpointed segments."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.decode import streaming as jstream
from chainer_speech_recognition_tpu.models import attention as jatt
from chainer_speech_recognition_tpu_torch.bridge import flax_to_state_dict
from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from chainer_speech_recognition_tpu_torch.decode.beam import beam_decode
from chainer_speech_recognition_tpu_torch.decode.greedy import greedy_decode
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    batch_features)
from chainer_speech_recognition_tpu_torch.models import attention as tatt
from chainer_speech_recognition_tpu_torch.ops import attention_cuda
from test_torch_streaming import _pcm, _setup

torch.set_num_threads(1)
D, HEADS, CHUNK, LEFT, KERNEL = 16, 2, 4, 2, 7
P = CHUNK * LEFT
DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
ATTN = dict(attn_blocks=2, attn_dim=D, attn_heads=HEADS, attn_chunk=CHUNK,
            attn_left_chunks=LEFT, attn_conv_kernel=KERNEL)


def _load(module, params):
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   params["params"]))
    module.load_state_dict(sd, strict=True)
    return module


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _stream_inputs(seed, jdt, tdt, B=3, T=CHUNK):
    """A chunk, its lengths, caches in the compute dtype, a cache mask,
    pos0 (one row deep into a stream) and a conv tail → (jax args, torch
    args) as dicts."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 2, 0][:B], np.int32)
    dh = D // HEADS
    kc, vc = (rng.standard_normal((B, P, HEADS, dh)).astype(np.float32)
              for _ in range(2))
    cm = rng.uniform(size=(B, P)) < 0.7
    cm[2] = False                              # a row with nothing cached
    pos0 = np.asarray([P, 24, 1_000_000][:B], np.int32)
    tail = rng.standard_normal((B, KERNEL - 1, D)).astype(np.float32)

    def j(a):
        return jnp.asarray(a, jdt)

    def t(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jdt).astype(
            jnp.float32))).to(tdt)
    mask = np.arange(T)[None, :] < lens[:, None]
    jin = dict(x=j(x), lens=jnp.asarray(lens), mask=jnp.asarray(mask),
               kc=j(kc), vc=j(vc), cm=jnp.asarray(cm),
               pos0=jnp.asarray(pos0), tail=j(tail))
    tin = dict(x=t(x), lens=torch.from_numpy(lens).long(),
               mask=torch.from_numpy(mask), kc=t(kc), vc=t(vc),
               cm=torch.from_numpy(cm), pos0=torch.from_numpy(pos0),
               tail=t(tail))
    return jin, tin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mhsa_step_matches_flax(dtype):
    """Queries of one chunk over [cache ++ chunk] keys: RoPE at pos0, the
    keys attendable are cache_mask ++ mask (a row with neither attends
    nothing valid and is garbage, as in the reference: its frames are
    padding), and the rolled caches are the last P post-RoPE keys and
    values in the compute dtype. The step counts as einsum, never flash."""
    jdt, tdt, tol = DT[dtype]
    j, t = _stream_inputs(0, jdt, tdt)
    jm = jatt._MHSA(heads=HEADS, dtype=jdt, chunk=CHUNK, left_chunks=LEFT)
    args = (j["x"], j["mask"])
    kw = dict(kv_cache=(j["kc"], j["vc"]), cache_mask=j["cm"],
              pos0=j["pos0"])
    params = jm.init(jax.random.key(0), *args, **kw)
    want, (wk, wv) = jm.apply(params, *args, **kw)
    tm = _load(tatt.MHSA(D, HEADS, tdt, CHUNK, LEFT, impl="flash"), params)
    before = dict(attention_cuda.ROUTED)
    got, (gk, gv) = tm(t["x"], t["mask"], t["lens"], kv_cache=(t["kc"],
                       t["vc"]), cache_mask=t["cm"], pos0=t["pos0"])
    assert attention_cuda.ROUTED["einsum"] == before["einsum"] + 1
    assert attention_cuda.ROUTED["flash"] == before["flash"]
    assert gk.dtype == gv.dtype == tdt and tuple(gk.shape) == tuple(wk.shape)
    _close(got[:2], want[:2], tol)  # row 2 has no attendable key at all
    _close(gk, wk, tol)
    _close(gv, wv, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_tail_matches_flax(dtype):
    """The causal depthwise conv runs VALID over [tail ++ chunk]; the new
    tail is the last k − 1 post-GLU, post-mask frames; a zero tail equals
    the offline causal conv's left pad."""
    jdt, tdt, tol = DT[dtype]
    j, t = _stream_inputs(1, jdt, tdt)
    jm = jatt._ConvModule(kernel=KERNEL, dtype=jdt, causal=True)
    params = jm.init(jax.random.key(1), j["x"], j["mask"], h_tail=j["tail"])
    want, wtail = jm.apply(params, j["x"], j["mask"], h_tail=j["tail"])
    tm = _load(tatt.ConvModule(D, KERNEL, tdt, causal=True), params)
    got, gtail = tm(t["x"], t["mask"], h_tail=t["tail"])
    assert tuple(gtail.shape) == (3, KERNEL - 1, D) and gtail.dtype == tdt
    _close(got, want, tol)
    _close(gtail, wtail, tol)
    zero, _ = tm(t["x"], t["mask"], h_tail=torch.zeros_like(t["tail"]))
    _close(zero, tm(t["x"], t["mask"]), 0)


@pytest.mark.parametrize("rdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_carries_match_flax(dtype, rdt):
    """A block's streaming step: (x, (k_cache, v_cache, conv_tail))."""
    jdt, tdt, tol = DT[dtype]
    j, t = _stream_inputs(2, jdt, tdt)
    jr, tr = DT[rdt][:2]
    jm = jatt.ConformerBlock(heads=HEADS, conv_kernel=KERNEL, dtype=jdt,
                             chunk=CHUNK, left_chunks=LEFT,
                             residual_dtype=jr)
    kw = dict(carries=(j["kc"], j["vc"], j["tail"]), cache_mask=j["cm"],
              pos0=j["pos0"])
    params = jm.init(jax.random.key(2), j["x"], j["lens"], **kw)
    want, wc = jm.apply(params, j["x"], j["lens"], **kw)
    tm = _load(tatt.ConformerBlock(D, heads=HEADS, conv_kernel=KERNEL,
                                   dtype=tdt, chunk=CHUNK, left_chunks=LEFT,
                                   residual_dtype=tr), params)
    got, gc = tm(t["x"], t["lens"], carries=(t["kc"], t["vc"], t["tail"]),
                 cache_mask=t["cm"], pos0=t["pos0"])
    assert got.dtype == tr and len(gc) == 3
    bar = 3e-5 if dtype == "float32" and rdt == "float32" else DT[
        "bfloat16"][2]
    _close(got[:2], want[:2], bar)               # row 2: padding only
    assert torch.all(got[2] == 0)
    for g, w in zip(gc, wc):
        _close(g, w, tol)


@pytest.mark.parametrize("pos0", [[0, 3, 10_000], [1_000_000, 2 ** 22,
                                                   5_000_003]])
def test_rope_at_stream_positions_matches(pos0):
    """pos0 grows without bound (a stream of hours at 25 frames a second
    reaches 10^5-10^6 subsampled frames): the angle is the same fp32
    (pos0 + t)·freq product in both packages."""
    x = np.random.default_rng(7).standard_normal((3, CHUNK, HEADS, 8)) \
        .astype(np.float32)
    p0 = np.asarray(pos0, np.int32)
    want = jatt.rope(jnp.asarray(x), pos0=jnp.asarray(p0))
    got = tatt.rope(torch.from_numpy(x), pos0=torch.from_numpy(p0))
    _close(got, want, 1e-5)


def _attn_setup(seed):
    return _setup("conformer_stream", seed=seed, **ATTN)


def test_stream_carries_layout_and_reset_match_jax():
    """init_stream_carries: [pos0, total_valid, seg_start] [B] int32, then
    per block k, v [B, P, h, dh] and the conv tail [B, k − 1, d] in the
    compute dtype, zeros. reset_stream_rows on random carries: seg_start
    of the reset rows takes their total_valid, their conv tails zero, the
    caches and counters stay; other rows untouched."""
    cfg, tm, jcfg, jm, params = _attn_setup(3)
    tc = tm.init_stream_carries(3)
    jc = jm.init_stream_carries(3)
    assert len(tc) == len(jc) == 3 + 3 * 2
    for a, b in zip(tc, jc):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert not torch.any(a != 0)
    rng = np.random.default_rng(4)
    vals = [rng.integers(0, 50, c.shape).astype(np.int32)
            if c.dtype == jnp.int32 else
            rng.standard_normal(c.shape).astype(np.float32) for c in jc]
    want = jm.reset_stream_rows([jnp.asarray(v) for v in vals],
                                jnp.asarray([0, 2]))
    got = tm.reset_stream_rows([torch.from_numpy(v) for v in vals],
                               torch.tensor([0, 2]))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=i)
        assert np.array_equal(vals[i][1], g.numpy()[1])


def _offline_ids(tm, pcm, ns):
    with torch.inference_mode():
        feats, flens = batch_features(torch.from_numpy(pcm),
                                      torch.tensor(ns), apply_cmvn="causal")
        logits, lens = tm(feats, flens)
    ids, n = greedy_decode(logits, lens)
    return [ids[b, : n[b]].tolist() for b in range(len(ns))], logits, lens


def _both(setup, drive, **kw):
    cfg, tm, jcfg, jm, params = setup
    trec = tstream.StreamingRecognizer(tm, cfg, **kw)
    jrec = jstream.StreamingRecognizer(jm, params, jcfg, **kw)
    drive(trec)
    drive(jrec)
    return trec, jrec


def test_streaming_exact_multistream_matches_offline_and_jax():
    """Two lockstep streams of different true lengths, buffered then
    flushed: chunk 4 at stride 4 forces a 16-frame emit region, so 61
    frames make 4 windows and the 2-chunk caches roll past capacity."""
    setup = _attn_setup(40)
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=41)
    pcm[1, ns[1]:] = 0.0

    def drive(rec):
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)

    before = dict(attention_cuda.ROUTED)
    t, j = _both(setup, drive, batch=2, chunk_frames=16, right_frames=0)
    assert t.geo["C"] == 16 and t.geo["R"] == 0 and len(t.window_times) == 4
    assert attention_cuda.ROUTED["flash"] == before["flash"]
    offline = _offline_ids(setup[1], pcm, ns)[0]
    assert t.emitted == j.emitted == offline and all(offline)


def test_block_split_invariance_matches_offline_and_jax():
    """Eager ragged feeding (pieces of 37, 2963, 1 and the rest) reaches
    the buffered transcription: every attention carry is invariant to how
    the PCM arrives."""
    setup = _attn_setup(42)
    n = 9600
    pcm = _pcm((n,), seed=43)

    def drive(blocks):
        def run(rec):
            rec.out = []
            for blk in blocks:
                rec.out += rec.accept(blk)[0]
            rec.out += rec.flush()[0]
        return run

    many = tstream.StreamingRecognizer(setup[1], setup[0], batch=1,
                                       chunk_frames=16, right_frames=0)
    drive([pcm[:37], pcm[37:3000], pcm[3000:3001], pcm[3001:]])(many)
    one_t, one_j = _both(setup, drive([pcm]), batch=1, chunk_frames=16,
                         right_frames=0)
    assert many.out == one_t.out == one_j.out == many.emitted[0]
    assert one_t.out == _offline_ids(setup[1], pcm[None], [n])[0][0]


def test_streaming_beam_matches_offline_beam_and_jax():
    """The carried prefix beam over the attention windows equals the
    offline beam on the offline chunk-masked logits, and the JAX
    recognizer's streaming beam."""
    setup = _attn_setup(44)
    n = 9600
    pcm = _pcm((1, n), seed=45)

    def drive(rec):
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=[n])

    t, j = _both(setup, drive, batch=1, chunk_frames=16, right_frames=0,
                 decoder="beam", beam=4)
    _, logits, lens = _offline_ids(setup[1], pcm, [n])
    assert t.emitted == j.emitted == beam_decode(logits, lens, beam=4)


def test_endpointing_segments_match_jax():
    """Endpointing on the attention family: the reset advances seg_start
    (the keys before the boundary become unattendable) and zeroes the
    conv tails; the segments and their end frames equal JAX's and
    concatenate to ``emitted``."""
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        make_utterance)

    setup = _attn_setup(46)
    rng = np.random.default_rng(2)
    sig1, _ = make_utterance(rng, [1, 2], tone_len=1600)
    sig2, _ = make_utterance(rng, [3, 1], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    def drive(rec):
        for a in range(0, len(pcm), 1600):
            rec.accept(pcm[a : a + 1600])
        rec.flush()

    t, j = _both(setup, drive, batch=1, chunk_frames=16, right_frames=0,
                 endpoint_ms=600)
    assert t.segments == j.segments and len(t.segments[0]) >= 1
    assert t.emitted == j.emitted
    assert sum((s for s, _ in t.segments[0]), []) == t.emitted[0]
