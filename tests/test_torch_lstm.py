"""The port's BiLSTM (ops/rnn_cuda.py: the plain versions of the LSTM
kernels and ``BiLSTMScan``; models/rnn.py: the layer) against the JAX
package: ``birnn_pallas(..., "lstm", ...)`` and its VJP in interpret mode,
and the flax ``BiRNNLayer(cell="lstm")``. The kernels are held to these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py).

Bars: forward fp32 1e-5 and bf16 3e-2 (tests/test_rnn_pallas.py:81);
gradients fp32 atol 2e-5 / rtol 1e-4 (summation order only) and bf16
5e-2 (tests/test_rnn_pallas.py:88); the hand-written backward against
autograd in float64 at 1e-12 (algebra, not rounding)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.models.rnn import BiRNNLayer as JaxBiRNN
from chainer_speech_recognition_tpu.ops.rnn_pallas import birnn_pallas
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params)
from chainer_speech_recognition_tpu_torch.models import rnn as trnn
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    BiLSTMScan, dw_matmul, lstm_bwd, lstm_bwd_plain, lstm_scan,
    lstm_scan_plain, lstm_scan_train, lstm_scan_train_plain, shift_prev,
    stream_dtype)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
_GRAD_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _inputs(seed, T=11, B=4, H=16, lens=(11, 0, 6, 1)):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, 2 * B, 4 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    lens = np.asarray(lens[:B], np.float32)
    lo = np.concatenate([np.zeros(B), T - lens])[:, None].astype(np.float32)
    hi = np.concatenate([lens, np.full(B, T)])[:, None].astype(np.float32)
    gy = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    return xs, w, lo, hi, gy


def _stream(xs_j, dtype):
    return torch.from_numpy(np.array(xs_j.astype(jnp.float32))).to(
        stream_dtype(_TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_lstm_matches_birnn_pallas(dtype):
    """Same kernel boundary on both sides; lengths T and 0 included."""
    xs, w, lo, hi, _ = _inputs(0)
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xs_j = jnp.asarray(xs).astype(sdt)
    ys_j = np.asarray(birnn_pallas(xs_j, jnp.asarray(w), jnp.asarray(lo),
                                   jnp.asarray(hi), "lstm", dtype))
    ys_t = lstm_scan_plain(_stream(xs_j, dtype), torch.from_numpy(w),
                           torch.from_numpy(lo), torch.from_numpy(hi),
                           _TORCH[dtype]).numpy()
    np.testing.assert_allclose(ys_t, ys_j, atol=_FWD_TOL[dtype], rtol=0)
    # a length-0 row never leaves h = 0 (both directions); frozen rows
    # repeat their state
    assert np.all(ys_t[:, 1] == 0) and np.all(ys_t[:, 5] == 0)
    assert np.all(ys_t[6:, 2] == ys_t[5, 2])


def test_lstm_wrappers_take_plain_versions_on_cpu():
    xs, w, lo, hi, gy = (torch.from_numpy(a) for a in _inputs(1))
    assert torch.equal(lstm_scan(xs, w, lo, hi, torch.float32),
                       lstm_scan_plain(xs, w, lo, hi, torch.float32))
    ys, cs, gates = lstm_scan_train(xs, w, lo, hi, torch.float32)
    for a, b in zip((ys, cs, gates),
                    lstm_scan_train_plain(xs, w, lo, hi, torch.float32)):
        assert torch.equal(a, b)
    assert torch.equal(
        lstm_bwd(gates, w, lo, hi, cs, gy, torch.float32),
        lstm_bwd_plain(gates, w, lo, hi, cs, gy, torch.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_scan(xs.to("meta"), w, lo, hi, torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilstm_scan_value_and_vjp_match_pallas(dtype):
    xs, w, lo, hi, gy = _inputs(2)
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(xs).astype(sdt)
    yj, vjp = jax.vjp(lambda x, ww: birnn_pallas(
        x, ww, jnp.asarray(lo), jnp.asarray(hi), "lstm", dtype), xj,
        jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(gy))
    xt = _stream(xj, dtype).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = BiLSTMScan.apply(xt, wt, torch.from_numpy(lo), torch.from_numpy(hi),
                          _TORCH[dtype])
    yt.backward(torch.from_numpy(gy))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               **_GRAD_TOL[dtype])
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dxj.astype(jnp.float32)),
                               **_GRAD_TOL[dtype])
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dwj),
                               **_GRAD_TOL[dtype])
    # a length-0 row has no live step: no gradient reaches its inputs
    assert torch.all(xt.grad[:, 1] == 0) and torch.all(xt.grad[:, 5] == 0)


def test_plain_backward_matches_autograd_float64():
    """The hand-written backward (stored gates and cell states) is the
    exact derivative of the plain forward."""
    xs, w, lo, hi, gy = (torch.from_numpy(a.astype(np.float64))
                         for a in _inputs(3))
    xa, wa = xs.clone().requires_grad_(), w.clone().requires_grad_()
    lstm_scan_plain(xa, wa, lo, hi, torch.float64).backward(gy)
    xb, wb = xs.clone().requires_grad_(), w.clone().requires_grad_()
    BiLSTMScan.apply(xb, wb, lo, hi, torch.float64).backward(gy)
    torch.testing.assert_close(xb.grad, xa.grad, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(wb.grad, wa.grad, atol=1e-12, rtol=1e-10)
    ys, cs, gates = lstm_scan_train_plain(xs, w, lo, hi, torch.float64)
    assert torch.equal(ys, lstm_scan_plain(xs, w, lo, hi, torch.float64))
    dxs = lstm_bwd_plain(gates, w, lo, hi, cs, gy, torch.float64)
    assert torch.equal(dxs, xb.grad)
    dw = dw_matmul(shift_prev(ys), dxs, ys.shape[1] // 2, torch.float64)
    torch.testing.assert_close(dw, wa.grad, atol=1e-12, rtol=1e-10)


def _layer_pair(dtype, jax_impl, seed=4, B=3, T=10, D=6, H=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 7, 1][:B], np.int32)
    jl = JaxBiRNN(hidden=H, cell="lstm", dtype=jnp.dtype(dtype),
                  impl=jax_impl)
    p = jl.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(lens))
    tl = trnn.BiRNNLayer(D, H, cell="lstm", dtype=_TORCH[dtype],
                         impl="pallas")
    load_flax_params(tl, jax.tree_util.tree_map(np.asarray, p["params"]))
    return x, lens, jl, p, tl


@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_layer_matches_flax(impl, dtype):
    """The layer through the bridge against the flax layer's scan path,
    both of the port's ``impl``s, ragged lengths including 0 and T."""
    rng = np.random.default_rng(5)
    B, T, D, H = 4, 11, 10, 32
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 0, 6, 1], np.int32)
    jl = JaxBiRNN(hidden=H, cell="lstm", dtype=jnp.dtype(dtype), impl="scan")
    p = jl.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(lens))
    yj = np.asarray(jl.apply(p, jnp.asarray(x), jnp.asarray(lens)))
    tl = trnn.BiRNNLayer(D, H, cell="lstm", dtype=_TORCH[dtype], impl=impl)
    assert tuple(tl.rec.shape) == (2, H, 4 * H)
    load_flax_params(tl, jax.tree_util.tree_map(np.asarray, p["params"]))
    with torch.inference_mode():
        yt = tl(torch.from_numpy(x), torch.from_numpy(lens).long()).numpy()
    np.testing.assert_allclose(yt, yj, atol=_FWD_TOL[dtype], rtol=0)
    assert np.all(yt[1] == 0) and np.all(yt[2, 6:] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_layer_gradients_match_flax_pallas_path(dtype):
    x, lens, jl, p, tl = _layer_pair(dtype, "pallas")
    wy = np.cos(np.arange(x.shape[0] * x.shape[1] * 32)).reshape(
        x.shape[0], x.shape[1], 32).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(jl.apply(params, xx, jnp.asarray(lens))
                       * jnp.asarray(wy))

    gp, gx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (tl(xt, torch.from_numpy(lens).long()) * torch.from_numpy(wy)).sum() \
        .backward()
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gp["params"]))
    for name, prm in tl.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **_GRAD_TOL[dtype])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               **_GRAD_TOL[dtype])


def test_lstm_layer_takes_bilstm_scan_only_under_autograd(monkeypatch):
    calls = []
    real = trnn.BiLSTMScan.apply
    monkeypatch.setattr(trnn.BiLSTMScan, "apply",
                        lambda *a: calls.append(1) or real(*a))
    x, lens, _, _, tl = _layer_pair("float32", "scan")
    lens_t = torch.from_numpy(lens).long()
    with torch.no_grad():
        y0 = tl(torch.from_numpy(x), lens_t)
    assert not calls                        # residual-free forward
    y1 = tl(torch.from_numpy(x), lens_t)
    assert calls == [1]
    assert torch.equal(y0, y1.detach())


def test_lstm_padding_invariance_with_gradients():
    """Padding past a row's length changes neither its outputs nor the
    gradients it sends to its inputs; padded outputs are zero."""
    x, _, _, _, tl = _layer_pair("float32", "scan")
    xa = torch.from_numpy(x).requires_grad_()
    ya = tl(xa, torch.tensor([10, 7, 1]))
    (ya[1, :7] ** 2).sum().backward()
    xb = torch.from_numpy(x[1:2, :7].copy()).requires_grad_()
    yb = tl(xb, torch.tensor([7]))
    (yb ** 2).sum().backward()
    torch.testing.assert_close(ya[1, :7], yb[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(xa.grad[1, :7], xb.grad[0], atol=1e-6, rtol=0)
    assert torch.all(ya[1, 7:] == 0) and torch.all(xa.grad[1, 7:] == 0)
