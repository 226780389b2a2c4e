"""The plain versions of the port's stream kernels
(ops/rnn_cuda.py: ``gru_scan_stream_plain``, ``lstm_scan_stream_plain``)
against the JAX package's ``birnn_pallas_stream`` in interpret mode on the
CPU. The kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Both directions (ndir = 2) and forward-only (ndir = 1: the JAX side runs
its forward-only layout, one weight matrix duplicated over two row halves),
``emit_t`` ∈ {0, 3, T}, ragged lengths with a row that ends before
``emit_t``, and a nonzero ``h0``. Bars: fp32 1e-4, bf16 3e-2 (the
reference suite's bf16 bar, tests/test_rnn_pallas.py:81). Also the stream
wrappers' cache of laid-out weights."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainer_speech_recognition_tpu.ops.rnn_pallas import birnn_pallas_stream
from chainer_speech_recognition_tpu_torch.models.rnn import BiRNNLayer
from chainer_speech_recognition_tpu_torch.ops import rnn_cuda
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    gru_scan_stream, gru_scan_stream_plain, lstm_scan_stream,
    lstm_scan_stream_plain, stream_dtype, stream_launch_args)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
_PLAIN = {"gru": gru_scan_stream_plain, "lstm": lstm_scan_stream_plain}
T, H = 7, 32


def _inputs(cell, ndir, B, seed, lens):
    """Port-layout inputs: xs [T, ndir·B, G·H], w [ndir, H, G·H], lo/hi,
    h0 [ndir·B, C]."""
    G = 3 if cell == "gru" else 4
    C = H if cell == "gru" else 2 * H
    rng = np.random.default_rng(seed)
    R = ndir * B
    xs = rng.standard_normal((T, R, G * H)).astype(np.float32)
    w = (rng.standard_normal((ndir, H, G * H)) / np.sqrt(H)).astype(
        np.float32)
    lens = np.asarray(lens, np.float32)
    lo, hi = np.zeros(B, np.float32), lens
    if ndir == 2:
        lo = np.concatenate([lo, T - lens])
        hi = np.concatenate([hi, np.full(B, T, np.float32)])
    h0 = (0.5 * rng.standard_normal((R, C))).astype(np.float32)
    return xs, w, lo[:, None], hi[:, None], h0


def _jax(cell, dtype, xs, w, lo, hi, h0, emit_t):
    """birnn_pallas_stream on the port's layout: a forward-only layout
    (one W) runs as the JAX model runs it, W duplicated over two halves;
    an odd row count gets its last row repeated to make the halves even
    (only the real rows are compared)."""
    R = xs.shape[1]
    if w.shape[0] == 1:
        w = np.concatenate([w, w])
        if R % 2:
            pick = np.r_[np.arange(R), R - 1]
            xs, lo, hi, h0 = xs[:, pick], lo[pick], hi[pick], h0[pick]
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xs_j = jnp.asarray(xs).astype(sdt)
    ys, carry = birnn_pallas_stream(
        xs_j, jnp.asarray(w), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(h0), cell, dtype, emit_t)
    return (np.asarray(ys)[:, :R], np.asarray(carry)[:R],
            np.array(xs_j.astype(jnp.float32))[:, :R])


def _port(cell, dtype, xs_stream, w, lo, hi, h0, emit_t):
    xs_t = torch.from_numpy(xs_stream).to(stream_dtype(_TORCH[dtype]))
    ys, carry = _PLAIN[cell](xs_t, torch.from_numpy(w), torch.from_numpy(lo),
                             torch.from_numpy(hi), torch.from_numpy(h0),
                             _TORCH[dtype], emit_t)
    return ys.numpy(), carry.numpy()


@pytest.mark.parametrize("emit_t", [0, 3, T])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndir", [2, 1])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_plain_matches_birnn_pallas_stream(cell, ndir, dtype, emit_t):
    """Row 2 ends at step 2 (< emit_t = 3): its carry is the state frozen
    at its true end; a length-0 row carries h0 through."""
    B = 4
    xs, w, lo, hi, h0 = _inputs(cell, ndir, B, seed=7 * ndir + emit_t,
                                lens=[T, 0, 2, 5])
    ys_j, carry_j, xs_s = _jax(cell, dtype, xs, w, lo, hi, h0, emit_t)
    ys_t, carry_t = _port(cell, dtype, xs_s, w, lo, hi, h0, emit_t)
    tol = _TOL[dtype]
    np.testing.assert_allclose(ys_t, ys_j, atol=tol, rtol=0)
    np.testing.assert_allclose(carry_t, carry_j, atol=tol, rtol=0)
    C = h0.shape[1]
    assert carry_t.shape == (ndir * B, C)
    if emit_t == 0:
        assert np.array_equal(carry_t, h0)
    # the length-0 row never moves off h0; row 2 freezes after step 1
    assert np.array_equal(carry_t[1], h0[1])
    assert np.all(ys_t[:, 1] == h0[1, :H])
    if emit_t >= 2:
        assert np.array_equal(carry_t[2, :H], ys_t[1, 2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_plain_one_row(cell, dtype):
    """R = 1: one forward-only stream at batch 1 (cli/stream.py --raw)."""
    xs, w, lo, hi, h0 = _inputs(cell, 1, 1, seed=3, lens=[T])
    ys_j, carry_j, xs_s = _jax(cell, dtype, xs, w, lo, hi, h0, 4)
    ys_t, carry_t = _port(cell, dtype, xs_s, w, lo, hi, h0, 4)
    assert ys_t.shape == (T, 1, H)
    np.testing.assert_allclose(ys_t, ys_j, atol=_TOL[dtype], rtol=0)
    np.testing.assert_allclose(carry_t, carry_j, atol=_TOL[dtype], rtol=0)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_wrappers_take_plain_versions_on_cpu(cell):
    xs, w, lo, hi, h0 = (torch.from_numpy(a) for a in _inputs(
        cell, 2, 3, seed=5, lens=[T, 1, 4]))
    wrapper = {"gru": gru_scan_stream, "lstm": lstm_scan_stream}[cell]
    got = wrapper(xs, w, lo, hi, h0, torch.float32, 3)
    want = _PLAIN[cell](xs, w, lo, hi, h0, torch.float32, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="emit_t"):
        wrapper(xs, w, lo, hi, h0, torch.float32, T + 1)
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(xs.to("meta"), w, lo, hi, h0, torch.float32, 3)


@pytest.mark.parametrize("cell,dtype", [("gru", torch.bfloat16),
                                        ("lstm", torch.bfloat16),
                                        ("lstm", torch.float32)])
def test_stream_layout_cache(cell, dtype):
    """The stream wrappers take W laid out from a cache kept per weight
    tensor (``stream_launch_args``): a second call with the same tensor
    returns the same layout; an in-place ``add_``, a reloaded state dict
    (``copy_``) or another tensor with the same values misses and lays W
    out anew; an inference tensor (no version) is laid out at each call.
    (The fp32 GRU takes W as it is: ``test_torch_gru_plan.py``.)"""
    layer = BiRNNLayer(8, 32, cell=cell, bidirectional=False)
    with torch.no_grad():
        layer.rec.normal_()
    w = layer.rec
    args = {"gru": rnn_cuda._gru_launch_args,
            "lstm": rnn_cuda._lstm_launch_args}[cell]

    def laid_out(t):
        """The cached layout, checked against one laid out afresh."""
        wk, C = stream_launch_args(cell, t, 3, dtype)
        ref, C_ref = args(t.detach(), 3, dtype, "fwd")
        assert C == C_ref == (1 if dtype == torch.bfloat16 else 0)
        assert torch.equal(wk, ref) and wk is not t
        return wk

    first = laid_out(w)
    assert laid_out(w) is first                     # a hit
    with torch.no_grad():
        w.add_(1.0)
    second = laid_out(w)                            # in place: a miss
    assert not torch.equal(second, first)
    assert laid_out(w) is second
    layer.load_state_dict({k: v + 1.0 for k, v in
                           layer.state_dict().items()})
    third = laid_out(w)                             # reloaded: a miss
    assert not torch.equal(third, second)
    other = w.detach().clone()
    assert laid_out(other) is not third             # another tensor
    assert laid_out(other) is laid_out(other)
    with torch.inference_mode():
        inf = w.detach().clone()
    assert laid_out(inf) is not laid_out(inf)       # no version: no cache
