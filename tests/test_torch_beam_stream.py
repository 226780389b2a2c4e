"""The port's streaming beam against the reference's, on the CPU.

``BeamStreamDecoder`` over chunks of {1, 7, 16} frames (per-row valid
counts, a dense 3-gram LM or none; K = 6, and K = 64, a width of the
kernel's wide form, at 16 frames): the tokens it finalizes after each
step equal the reference ``BeamStreamDecoder``'s, and its final 1-best
equals the port's offline beam on the same logits (the recursion is
causal, so chunking is exact). ``StreamingRecognizer(decoder="beam",
lm=…)`` on a bridged cut ``bigru`` with causal CMVN emits the JAX
recognizer's ids, with endpointing too; the endpoint resets rows through
``end_rows``."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu.decode import beam as jb
from chainer_speech_recognition_tpu.decode import lm as jl
from chainer_speech_recognition_tpu.decode import streaming as jstream
from chainer_speech_recognition_tpu_torch.decode import beam as tb
from chainer_speech_recognition_tpu_torch.decode import lm as tl
from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from test_torch_beam import random_lm
from test_torch_streaming import _pcm, _setup

torch.set_num_threads(1)


@pytest.mark.parametrize("chunk", [1, 7, 16])
@pytest.mark.parametrize("with_lm", [False, True])
def test_chunked_decoder_matches_reference_and_offline(chunk, with_lm):
    _chunked_case(chunk, 6, with_lm)


@pytest.mark.parametrize("with_lm", [False, True])
def test_chunked_decoder_wide_beam_matches_reference(with_lm):
    """K = 64, a width only the kernel's wide form takes on the card."""
    _chunked_case(16, 64, with_lm)


def _chunked_case(chunk, K, with_lm):
    B, T, V = 3, 40, 12
    rng = np.random.default_rng(chunk)
    logits = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    path = rng.integers(0, V, (B, T))
    for b in range(B):
        logits[b, np.arange(T), path[b]] += 4.0
    lens = np.asarray([40, 23, 9])
    jlm = tlm = None
    if with_lm:
        jlm, tlm = random_lm(jl, V, 3, 2, 30), random_lm(tl, V, 3, 2, 30)
    jdec = jb.BeamStreamDecoder(B, beam=K, lm=jlm, alpha=0.7, beta=0.8)
    tdec = tb.BeamStreamDecoder(B, beam=K, lm=tlm, alpha=0.7, beta=0.8)
    for c0 in range(0, T, chunk):
        n = np.clip(lens - c0, 0, chunk).astype(np.int32)
        part = logits[:, c0 : c0 + chunk]
        assert tdec.step(torch.from_numpy(part), n) == jdec.step(part, n)
    assert tdec.finish() == [[int(x) for x in r] for r in jdec.finish()]
    offline = tb.beam_decode(torch.from_numpy(logits), lens, beam=K,
                             lm=tlm, alpha=0.7, beta=0.8)
    assert tdec.finish() == offline


def test_end_rows_matches_reference():
    B, V, K = 2, 9, 4
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((B, 24, V)) * 3).astype(np.float32)
    jdec, tdec = jb.BeamStreamDecoder(B, beam=K), tb.BeamStreamDecoder(B,
                                                                       beam=K)
    n = np.asarray([8, 8], np.int32)
    for c0, rows in ((0, [1]), (8, [0, 1]), (16, [])):
        part = logits[:, c0 : c0 + 8]
        assert tdec.step(torch.from_numpy(part), n) == jdec.step(part, n)
        assert tdec.end_rows(rows) == {
            b: [int(x) for x in v] for b, v in jdec.end_rows(rows).items()}
    assert tdec.finish() == [[int(x) for x in r] for r in jdec.finish()]
    assert tb.BeamStreamDecoder(B).end_rows([0]) == {0: []}
    with pytest.raises(ValueError, match="expected batch"):
        tdec.step(torch.zeros((3, 2, V)), np.ones(3, np.int32))


def _both(setup, drive, **kw):
    cfg, tm, jcfg, jm, params = setup
    lm = kw.pop("lm", None)
    trec = tstream.StreamingRecognizer(tm, cfg, lm=lm and lm[1], **kw)
    jrec = jstream.StreamingRecognizer(jm, params, jcfg, lm=lm and lm[0],
                                       **kw)
    drive(trec)
    drive(jrec)
    return trec, jrec


@pytest.mark.parametrize("with_lm", [False, True])
def test_recognizer_beam_matches_jax(with_lm):
    """Two lockstep streams of different true lengths, buffered then
    flushed, through a bigru with causal CMVN at 8 frames of lookahead."""
    setup = _setup("bigru", seed=40)
    ns = [9600, 7040]
    pcm = _pcm((2, max(ns)), seed=41)
    pcm[1, ns[1]:] = 0.0

    def drive(rec):
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)

    lm = None
    if with_lm:
        V = setup[0].model.vocab_size
        lm = (jl.device_lm(random_lm(jl, V, 3, 9, 20)),
              tl.device_lm(random_lm(tl, V, 3, 9, 20)))
    t, j = _both(setup, drive, batch=2, chunk_frames=16, right_frames=8,
                 decoder="beam", beam=4, lm=lm, lm_alpha=0.5, lm_beta=0.5)
    assert t.emitted == j.emitted and any(t.emitted)


def test_recognizer_beam_endpointing_matches_jax():
    """CTC endpointing with the beam: eager 100 ms blocks, two bursts
    split by 2 s of silence; segments and ids equal JAX's."""
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        make_utterance)

    rng = np.random.default_rng(0)
    sig1, _ = make_utterance(rng, [1, 2, 3], tone_len=1600)
    sig2, _ = make_utterance(rng, [3, 1], tone_len=1600)
    sil = np.zeros(32000, np.float32)
    pcm = np.concatenate([sig1, sil, sig2, sil]).astype(np.float32)

    def drive(rec):
        rec.out = []
        for a in range(0, len(pcm), 1600):
            rec.out += rec.accept(pcm[a : a + 1600])[0]
        rec.out += rec.flush()[0]

    t, j = _both(_setup("tiny_conv", seed=13, cmvn=False), drive, batch=1,
                 chunk_frames=16, right_frames=8, endpoint_ms=600,
                 decoder="beam", beam=4)
    assert t.segments == j.segments and len(t.segments[0]) >= 1
    assert t.emitted == j.emitted and t.out == [int(x) for x in j.out]
