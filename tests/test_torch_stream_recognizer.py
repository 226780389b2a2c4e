"""The port's ``StreamingRecognizer`` (decode/streaming.py) against the
JAX package's on the CPU, at cut widths, fp32, with weights bridged from
flax: the emitted ids (and endpoint segments) equal JAX's in every case —
fp32 logits agree to ~1e-6, far inside the top-2 gaps of these random
models — and the forward-only preset's streaming ids equal the port's own
offline decode. tests/test_torch_streaming.py holds the window math."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from chainer_speech_recognition_tpu_torch.decode.greedy import greedy_decode
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    batch_features)
from chainer_speech_recognition_tpu_torch.parallel.mesh import Mesh
from test_torch_streaming import _pcm, _setup

torch.set_num_threads(1)


def _both(setup, drive, **kw):
    """Run ``drive(rec)`` on the port's and the JAX recognizer."""
    from chainer_speech_recognition_tpu.decode import streaming as jstream

    cfg, tm, jcfg, jm, params = setup
    trec = tstream.StreamingRecognizer(tm, cfg, **kw)
    jrec = jstream.StreamingRecognizer(jm, params, jcfg, **kw)
    drive(trec)
    drive(jrec)
    return trec, jrec


def _buffered(pcm, ns):
    def drive(rec):
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
    return drive


def test_conv_only_multistream_matches_jax():
    """tiny_conv, two streams of different true lengths in one lockstep
    batch, buffered then flushed."""
    ns = [8000, 6496]
    pcm = _pcm((2, max(ns)), seed=1)
    pcm[1, ns[1]:] = 0.0
    t, j = _both(_setup("tiny_conv"), _buffered(pcm, ns), batch=2,
                 chunk_frames=16, right_frames=8)
    assert t.emitted == j.emitted and any(t.emitted)


def test_uni_gru_zero_lookahead_matches_jax_and_offline():
    """The online preset at zero lookahead, buffered (batch 2) and eager
    in 1111-sample blocks (batch 1): equal to the JAX recognizer's ids and
    to the port's own offline decode."""
    setup = _setup("uni_gru", seed=30)
    cfg, tm = setup[:2]
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=31)
    pcm[1, ns[1]:] = 0.0
    t, j = _both(setup, _buffered(pcm, ns), batch=2, chunk_frames=16,
                 right_frames=0)
    assert t.emitted == j.emitted

    with torch.inference_mode():
        feats, flens = batch_features(torch.from_numpy(pcm),
                                      torch.tensor(ns), apply_cmvn="causal")
        ids, lens = greedy_decode(*tm(feats, flens))
    offline = [ids[b, : lens[b]].tolist() for b in range(2)]
    assert t.emitted == offline and any(offline)

    def eager(rec):
        rec.out = []
        for a in range(0, ns[0], 1111):
            rec.out += rec.accept(pcm[0, a : a + 1111][None])[0]
        rec.out += rec.flush()[0]

    t1, j1 = _both(setup, eager, batch=1, chunk_frames=16, right_frames=0)
    assert t1.out == j1.out == t1.emitted[0] == offline[0]


@pytest.mark.parametrize("name,right", [("bigru", 8), ("bilstm_deep", 16)])
def test_birnn_causal_cmvn_matches_jax(name, right):
    """Latency-controlled BiRNN streaming (backward rows restart at each
    window's right edge) with causal CMVN: the port's ids equal JAX's."""
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=41)
    pcm[1, ns[1]:] = 0.0
    t, j = _both(_setup(name, seed=40), _buffered(pcm, ns), batch=2,
                 chunk_frames=16, right_frames=right)
    assert t.emitted == j.emitted and any(t.emitted)


def test_endpointing_segments_match_jax():
    """CTC endpointing on tiny_conv, CMVN off: two tone bursts split by
    2 s of silence; the segments and their end frames equal JAX's."""
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        make_utterance)

    rng = np.random.default_rng(0)
    sig1, _ = make_utterance(rng, [1, 2, 3], tone_len=1600)
    sig2, _ = make_utterance(rng, [3, 1], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    def drive(rec):
        for a in range(0, len(pcm), 1600):
            rec.accept(pcm[a : a + 1600])
        rec.flush()

    t, j = _both(_setup("tiny_conv", seed=13, cmvn=False), drive, batch=1,
                 chunk_frames=16, right_frames=8, endpoint_ms=600)
    assert t.segments == j.segments and len(t.segments[0]) == 2
    assert t.emitted == j.emitted


def test_block_split_invariance():
    """The transcription does not depend on how the audio is split across
    ``accept`` calls, and equals the JAX recognizer's."""
    setup = _setup("tiny_conv", seed=5)
    cfg, tm = setup[:2]
    n = 8320
    pcm = _pcm((n,), seed=6)

    def run(blocks):
        rec = tstream.StreamingRecognizer(tm, cfg, batch=1, chunk_frames=16,
                                          right_frames=8)
        out = []
        for blk in blocks:
            out += rec.accept(blk)[0]
        return out + rec.flush()[0]

    one = run([pcm])
    assert one == run([pcm[:37], pcm[37:3000], pcm[3000:3001], pcm[3001:]])
    _, j = _both(setup, _buffered(pcm[None], [n]), batch=1, chunk_frames=16,
                 right_frames=8)
    assert one == j.emitted[0]


def test_refusals():
    cfg, tm = _setup("tiny_conv", cmvn_mode="utterance")[:2]
    with pytest.raises(ValueError, match="causal"):
        tstream.StreamingRecognizer(tm, cfg)
    cfg, tm = _setup("tiny_conv")[:2]
    with pytest.raises(ValueError, match="expected greedy|beam"):
        tstream.StreamingRecognizer(tm, cfg, decoder="prefix")
    # a mesh the lockstep batch does not split over runs the batch whole
    # (the sharded recognizer: tests/test_torch_mesh.py)
    three = Mesh(rank=1, size=3, device=torch.device("cpu"), shape=(3,),
                 axis_names=("data",))
    assert tstream.StreamingRecognizer(tm, cfg, mesh=three)._mesh is None
    rec = tstream.StreamingRecognizer(tm, cfg, chunk_frames=16,
                                      right_frames=8)
    rec.accept(_pcm((48000,), seed=5))           # eager: drains windows
    with pytest.raises(ValueError, match="already emitted"):
        rec.flush(num_samples=[1600])
