"""The BiGRU training path: ``BiGRUScan`` (ops/rnn_cuda.py; on the CPU the
plain versions of the training-forward and backward kernels) against
``jax.vjp(birnn_pallas)`` in interpret mode, the layer's gradients against
the flax layer's on the Pallas path, and the plain hand-written backward
against autograd through the plain forward in float64. The kernels are
held to these plain versions on the card (tests/test_torch_cuda.py).

Bars: fp32 atol 2e-5 / rtol 1e-4 (summation order only); bf16 5e-2, the
reference suite's gradient bar for its bf16 streams
(tests/test_rnn_pallas.py:88)."""

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
    BiGRUScan, dw_matmul, gru_bwd_plain, gru_scan_plain,
    gru_scan_train_plain, shift_prev, stream_dtype)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
        "bfloat16": dict(atol=5e-2, rtol=5e-2)}


def _inputs(seed, T=11, B=4, H=16):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((T, 2 * B, 3 * H)).astype(np.float32)
    w = (rng.standard_normal((2, H, 3 * H)) / np.sqrt(H)).astype(np.float32)
    lens = np.asarray([T, 0, 6, 1][:B], np.float32)
    lo = np.concatenate([np.zeros(B), T - lens])[:, None].astype(np.float32)
    hi = np.concatenate([lens, np.full(B, T)])[:, None].astype(np.float32)
    gy = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    return xs, w, lo, hi, gy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bigru_scan_value_and_vjp_match_pallas(dtype):
    xs, w, lo, hi, gy = _inputs(0)
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(xs).astype(sdt)
    yj, vjp = jax.vjp(lambda x, ww: birnn_pallas(
        x, ww, jnp.asarray(lo), jnp.asarray(hi), "gru", dtype), xj,
        jnp.asarray(w))
    dxj, dwj = vjp(jnp.asarray(gy))
    tdt = _TORCH[dtype]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        stream_dtype(tdt)).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = BiGRUScan.apply(xt, wt, torch.from_numpy(lo), torch.from_numpy(hi),
                         tdt)
    yt.backward(torch.from_numpy(gy))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == torch.float32
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               **_TOL[dtype])
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dxj.astype(jnp.float32)),
                               **_TOL[dtype])
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dwj),
                               **_TOL[dtype])
    # a length-0 row has no live step: no gradient reaches its inputs
    assert torch.all(xt.grad[:, 1] == 0) and torch.all(xt.grad[:, 5] == 0)


def test_plain_backward_matches_autograd_float64():
    """The hand-written backward (with stored gates) is the exact
    derivative of the plain forward: float64, so any disagreement is an
    algebra error, not rounding."""
    xs, w, lo, hi, gy = (torch.from_numpy(a.astype(np.float64))
                         for a in _inputs(1))
    xa, wa = xs.clone().requires_grad_(), w.clone().requires_grad_()
    gru_scan_plain(xa, wa, lo, hi, torch.float64).backward(gy)
    xb, wb = xs.clone().requires_grad_(), w.clone().requires_grad_()
    BiGRUScan.apply(xb, wb, lo, hi, torch.float64).backward(gy)
    torch.testing.assert_close(xb.grad, xa.grad, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(wb.grad, wa.grad, atol=1e-12, rtol=1e-10)
    ys, gates = gru_scan_train_plain(xs, w, lo, hi, torch.float64)
    assert torch.equal(ys, gru_scan_plain(xs, w, lo, hi, torch.float64))
    dxs, dhn = gru_bwd_plain(gates, w, lo, hi, shift_prev(ys), gy,
                             torch.float64)
    assert torch.equal(dxs, xb.grad)
    H, B = w.shape[1], ys.shape[1] // 2
    dw = torch.cat([dw_matmul(shift_prev(ys), dxs[..., :2 * H], B,
                              torch.float64),
                    dw_matmul(shift_prev(ys), dhn, B, torch.float64)], dim=2)
    torch.testing.assert_close(dw, wa.grad, atol=1e-12, rtol=1e-10)


def _layer_pair(dtype, seed=2, B=3, T=10, D=6, H=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 7, 1][:B], np.int32)
    jl = JaxBiRNN(hidden=H, cell="gru", dtype=jnp.dtype(dtype),
                  impl="pallas")
    p = jl.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(lens))
    tl = trnn.BiRNNLayer(D, H, dtype=_TORCH[dtype], impl="pallas")
    load_flax_params(tl, jax.tree_util.tree_map(np.asarray, p["params"]))
    wy = np.cos(np.arange(B * T * 2 * H)).reshape(B, T, 2 * H).astype(
        np.float32)
    return x, lens, jl, p, tl, wy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_gradients_match_flax_pallas_path(dtype):
    x, lens, jl, p, tl, wy = _layer_pair(dtype)

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
                                   err_msg=name, **_TOL[dtype])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               **_TOL[dtype])


def test_layer_takes_bigru_scan_only_under_autograd(monkeypatch):
    calls = []
    real = trnn.BiGRUScan.apply
    monkeypatch.setattr(trnn.BiGRUScan, "apply",
                        lambda *a: calls.append(1) or real(*a))
    x, lens, _, _, tl, _ = _layer_pair("float32")
    lens_t = torch.from_numpy(lens).long()
    with torch.no_grad():
        y0 = tl(torch.from_numpy(x), lens_t)
    assert not calls                        # residual-free forward
    y1 = tl(torch.from_numpy(x), lens_t)
    assert calls == [1]
    assert torch.equal(y0, y1.detach())
    scan = trnn.BiRNNLayer(x.shape[2], 16, dtype=torch.float32, impl="scan")
    scan.load_state_dict(tl.state_dict())
    scan(torch.from_numpy(x), lens_t).sum().backward()
    assert calls == [1]                     # "scan": autograd, no Function


def test_padding_invariance_with_gradients():
    """Padding past a row's length changes neither its outputs nor the
    gradients it sends to its inputs; padded outputs are zero."""
    x, _, _, _, tl, _ = _layer_pair("float32")
    xa = torch.from_numpy(x).requires_grad_()
    ya = tl(xa, torch.tensor([10, 7, 1]))
    (ya[1, :7] ** 2).sum().backward()
    xb = torch.from_numpy(x[1:2, :7].copy()).requires_grad_()
    yb = tl(xb, torch.tensor([7]))
    (yb ** 2).sum().backward()
    torch.testing.assert_close(ya[1, :7], yb[0], atol=1e-6, rtol=0)
    torch.testing.assert_close(xa.grad[1, :7], xb.grad[0], atol=1e-6, rtol=0)
    assert torch.all(ya[1, 7:] == 0) and torch.all(xa.grad[1, 7:] == 0)
