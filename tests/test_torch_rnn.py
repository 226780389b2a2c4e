"""PyTorch BiGRU (ops/rnn_cuda.py plain version, models/rnn.py layer) vs
the JAX Pallas BiRNN kernel (interpret mode on the CPU) and the flax layer.
The CUDA kernel itself is checked on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.models.rnn import BiRNNLayer as JaxBiRNN
from chainer_speech_recognition_tpu.ops.rnn_pallas import birnn_pallas
from chainer_speech_recognition_tpu_torch.bridge import load_flax_params
from chainer_speech_recognition_tpu_torch.models.rnn import BiRNNLayer
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    gru_scan, gru_scan_plain, stream_dtype)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scan_inputs(seed, T=12, B=3, H=32, lens=None):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, 2 * B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    lens = np.asarray(lens if lens is not None
                      else rng.integers(0, T + 1, B), np.float32)
    lo = np.concatenate([np.zeros(B), T - lens])[:, None].astype(np.float32)
    hi = np.concatenate([lens, np.full(B, T)])[:, None].astype(np.float32)
    return xs, w, lo, hi


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_plain_gru_matches_birnn_pallas(dtype, tol):
    """Same kernel boundary on both sides; lengths 0 and T included. fp32
    is held to 1e-5 (summation order); bf16 to the reference suite's bf16
    bar (3e-2): both round h and w to bf16 before the product, so only
    the order of the fp32 sums differs."""
    T = 12
    xs, w, lo, hi = _scan_inputs(0, T=T, B=4, lens=[T, 0, 5, 1])
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xs_j = jnp.asarray(xs).astype(sdt)
    ys_j = np.asarray(birnn_pallas(xs_j, jnp.asarray(w), jnp.asarray(lo),
                                   jnp.asarray(hi), "gru", dtype))
    tdt = _TORCH[dtype]
    xs_t = torch.from_numpy(np.array(xs_j.astype(jnp.float32))).to(
        stream_dtype(tdt))
    ys_t = gru_scan_plain(xs_t, torch.from_numpy(w), torch.from_numpy(lo),
                          torch.from_numpy(hi), tdt).numpy()
    np.testing.assert_allclose(ys_t, ys_j, atol=tol, rtol=0)
    # a length-0 row never leaves h = 0; frozen rows repeat their state
    assert np.all(ys_t[:, 1] == 0)
    assert np.all(ys_t[5:, 2] == ys_t[4, 2])


def test_gru_wrapper_takes_plain_version_on_cpu():
    xs, w, lo, hi = _scan_inputs(1)
    args = [torch.from_numpy(a) for a in (xs, w, lo, hi)]
    assert torch.equal(gru_scan(*args, torch.float32),
                       gru_scan_plain(*args, torch.float32))


@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 3e-2)])
def test_birnn_layer_matches_flax(impl, dtype, tol):
    """Layer through the bridge vs the flax layer (scan path), ragged
    lengths including 0 and T."""
    rng = np.random.default_rng(2)
    B, T, D, H = 4, 11, 10, 32
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 0, 6, 1], np.int32)
    jl = JaxBiRNN(hidden=H, cell="gru", dtype=jnp.dtype(dtype), impl="scan")
    p = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lens))
    yj = np.asarray(jl.apply(p, jnp.asarray(x), jnp.asarray(lens)))
    tl = BiRNNLayer(D, H, dtype=_TORCH[dtype], impl=impl)
    load_flax_params(tl, jax.tree_util.tree_map(np.asarray, p["params"]))
    with torch.inference_mode():
        yt = tl(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(yt, yj, atol=tol, rtol=0)
    assert np.all(yt[1] == 0) and np.all(yt[2, 6:] == 0)


def test_birnn_layer_refuses_unported_variants():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BiRNNLayer(8, 32, cell="lstm")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BiRNNLayer(8, 32, bidirectional=False)
    layer = BiRNNLayer(8, 32, dtype=torch.float32)
    x = torch.zeros(2, 5, 8)
    with pytest.raises(NotImplementedError, match="streaming"):
        layer(x, torch.tensor([5, 3]), h0_fwd=torch.zeros(2, 32),
              emit_carry_at=2)
