"""Forward-only (``bidirectional=False``) GRU and LSTM layers under
autograd: the training forward, the backward and dW run as one-direction
launches (``rec`` [1, H, G·H], B rows; on the CPU the kernels' plain
versions), where the TPU path duplicates W over 2B rows and sums the two
halves' dW.

Held, on the CPU: the autograd Functions with ndir = 1 against autograd
through the plain forward in float64 (an algebra error would show, not
rounding); ``dw_plain`` at ndir = 1 against the duplicated-W sum; the
layer's outputs and gradients (xs, ``in_fwd``, ``rec``) against the flax
layer's scan path (``impl="scan"``, which the reference differentiates
off the TPU) and its Pallas path in interpret mode (the duplicated-W
custom VJP), under both of the port's ``impl``s. Bars: fp32 atol 2e-5 /
rtol 1e-4; bf16 5e-2, the reference suite's gradient bar for its bf16
streams (tests/test_rnn_pallas.py:88)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.models.rnn import BiRNNLayer as JaxBiRNN
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params)
from chainer_speech_recognition_tpu_torch.models import rnn as trnn
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    BiGRUScan, BiLSTMScan, dw_plain, gru_scan_plain, lstm_scan_plain,
    rnn_dw)

torch.set_num_threads(1)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
        "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_CELL = {"gru": (3, gru_scan_plain, BiGRUScan),
         "lstm": (4, lstm_scan_plain, BiLSTMScan)}


def _rows(seed, cell, T=9, B=4, H=16):
    rng = np.random.default_rng(seed)
    G = _CELL[cell][0]
    xs = rng.standard_normal((T, B, G * H))
    w = rng.standard_normal((1, H, G * H)) / np.sqrt(H)
    lens = np.asarray([T, 0, 5, 1][:B])
    lo = np.zeros((B, 1))
    hi = lens[:, None].astype(np.float64)
    gy = rng.standard_normal((T, B, H))
    return [torch.from_numpy(a.astype(np.float64))
            for a in (xs, w, lo, hi, gy)]


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_forward_only_function_matches_autograd_float64(cell):
    """BiGRUScan / BiLSTMScan with ndir = 1 (the training forward with
    residuals, the backward, dW) equal autograd through the plain forward
    in float64, and no gradient reaches a length-0 row."""
    _, plain, function = _CELL[cell]
    xs, w, lo, hi, gy = _rows(0, cell)
    xa, wa = xs.clone().requires_grad_(), w.clone().requires_grad_()
    plain(xa, wa, lo, hi, torch.float64).backward(gy)
    xb, wb = xs.clone().requires_grad_(), w.clone().requires_grad_()
    ys = function.apply(xb, wb, lo, hi, torch.float64)
    assert tuple(ys.shape) == (9, 4, 16)
    ys.backward(gy)
    assert tuple(wb.grad.shape) == (1, 16, _CELL[cell][0] * 16)
    torch.testing.assert_close(xb.grad, xa.grad, atol=1e-12, rtol=1e-10)
    torch.testing.assert_close(wb.grad, wa.grad, atol=1e-12, rtol=1e-10)
    assert torch.all(xb.grad[:, 1] == 0)


@pytest.mark.parametrize("n_gates", [1, 2])
def test_forward_only_dw_is_the_duplicated_halves_sum(n_gates):
    """The TPU path runs a forward-only layer as two halves of B rows with
    W duplicated; autodiff sums the halves' dW. At ndir = 1 the plain dW
    (and ``rnn_dw``, one or two gate tensors) is that sum over the forward
    rows alone: the duplicated rows' half is the same products again."""
    rng = np.random.default_rng(3)
    T, B, H = 7, 3, 8
    ys = torch.from_numpy(rng.standard_normal((T, B, H)).astype(np.float32))
    gates = [torch.from_numpy(rng.standard_normal((T, B, G)).astype(
        np.float32)) for G in (2 * H, H)[:n_gates]]
    got = rnn_dw(ys, tuple(gates), B, torch.float32)
    assert tuple(got.shape) == (1, H, sum(g.shape[2] for g in gates))
    dup = torch.cat([dw_plain(torch.cat([ys, ys], dim=1),
                              torch.cat([g, g], dim=1), B, torch.float32)
                     for g in gates], dim=2)
    assert tuple(dup.shape) == (2, H, got.shape[2])
    torch.testing.assert_close(got[0], dup[0], atol=0, rtol=0)
    torch.testing.assert_close(got[0] * 2, dup.sum(0), atol=1e-5, rtol=1e-6)


def _layer_pair(cell, dtype, jax_impl, seed=2, B=4, T=10, D=6, H=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    lens = np.asarray([T, 7, 0, 1][:B], np.int32)
    jl = JaxBiRNN(hidden=H, cell=cell, dtype=jnp.dtype(dtype),
                  impl=jax_impl, bidirectional=False)
    p = jl.init(jax.random.key(seed), jnp.asarray(x), jnp.asarray(lens))
    wy = np.cos(np.arange(B * T * H)).reshape(B, T, H).astype(np.float32)
    return x, lens, jl, p, wy


@pytest.mark.parametrize("impl", ["pallas", "scan"])
@pytest.mark.parametrize("jax_impl", ["scan", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_forward_only_layer_values_and_gradients_match_jax(cell, dtype,
                                                           jax_impl, impl):
    """The layer's output and the gradients of x, ``in_fwd`` and ``rec``
    against the flax layer's, on its scan path (the reference's path off
    the TPU) and its Pallas path in interpret mode (W duplicated, the two
    halves' dW summed), under the port's kernel wrappers (``pallas``: the
    plain versions of the one-direction training kernels) and its plain
    scan."""
    x, lens, jl, p, wy = _layer_pair(cell, dtype, jax_impl)

    def jloss(params, xx):
        y = jl.apply(params, xx, jnp.asarray(lens))
        return jnp.sum(y * jnp.asarray(wy)), y

    (_, yj), (gp, gx) = jax.value_and_grad(jloss, argnums=(0, 1),
                                           has_aux=True)(p, jnp.asarray(x))
    tl = trnn.BiRNNLayer(x.shape[2], 32, cell=cell, dtype=_TORCH[dtype],
                         impl=impl, bidirectional=False)
    load_flax_params(tl, jax.tree_util.tree_map(np.asarray, p["params"]))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tl(xt, torch.from_numpy(lens).long())
    (yt * torch.from_numpy(wy)).sum().backward()
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj),
                               **_TOL[dtype])
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gp["params"]))
    assert set(dict(tl.named_parameters())) == set(want)
    for name, prm in tl.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), want[name].numpy(),
                                   err_msg=name, **_TOL[dtype])
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx),
                               **_TOL[dtype])
    assert np.all(xt.grad.numpy()[2] == 0)          # the length-0 row


def test_forward_only_layer_takes_the_function_under_autograd(monkeypatch):
    """Under autograd a forward-only layer goes through BiGRUScan with its
    one W ([1, H, 3H], B rows: no duplicate), outside autograd through the
    residual-free forward; a streaming call under autograd still
    raises."""
    seen = []
    real = trnn.BiGRUScan.apply
    monkeypatch.setattr(
        trnn.BiGRUScan, "apply",
        lambda xs, w, *a: seen.append((tuple(xs.shape), tuple(w.shape)))
        or real(xs, w, *a))
    layer = trnn.BiRNNLayer(6, 32, dtype=torch.float32, impl="pallas",
                            bidirectional=False)
    x, lens = torch.randn(3, 8, 6), torch.tensor([8, 5, 1])
    with torch.no_grad():
        y0 = layer(x, lens)
    assert not seen
    y1 = layer(x, lens)
    assert seen == [((8, 3, 96), (1, 32, 96))]
    assert torch.equal(y0, y1.detach())
    y1.sum().backward()
    assert layer.rec.grad is not None and layer.in_fwd.weight.grad is not None
    with pytest.raises(NotImplementedError, match="streaming calls are "
                       "inference only"):
        layer(x, lens, h0_fwd=torch.zeros(3, 32), emit_carry_at=2)
