"""The recurrences' weight gradient (ops/rnn_cuda.py: ``dw_plain``, the
plain version of ``csrc/dw.cu``, and ``rnn_dw``, the routing) against the
reference's ``rnn_pallas._dw_einsum`` on ``_shift_prev(ys)``. The kernel
itself is held to ``dw_plain`` and to an fp64 sum on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Bar: every product of two bf16 (or fp32-rounded) operands is exact in fp32
(or nearly so), and the two sides add the K = T·B products of an element
in different orders in fp32, so an element may differ by at most about
K·2⁻²³·Σ_k|h_k·g_k| (the worst-case growth of a sum of K fp32 terms)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainer_speech_recognition_tpu.ops.rnn_pallas import (
    _dw_einsum, _shift_prev)
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    dw_cuda, dw_plain, rnn_dw, shift_prev)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _draw(seed, T, B, H, G):
    rng = np.random.default_rng(seed)
    ys = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    dg = rng.standard_normal((T, 2 * B, G)).astype(np.float32)
    return ys, dg


def _reference(ys, dg, B, dtype):
    """``_dw_einsum(_shift_prev(ys), dg)`` as JAX computes it, and the
    elementwise bar: K·2⁻²³·Σ|h·g| over the operands rounded to dtype."""
    jt = _DT[dtype][1]
    ref = np.asarray(_dw_einsum(_shift_prev(jnp.asarray(ys)),
                                jnp.asarray(dg).astype(jt), B, jt))
    hp = np.asarray(_shift_prev(jnp.asarray(ys)).astype(jt), np.float64)
    g = np.asarray(jnp.asarray(dg).astype(jt), np.float64)
    absum = np.stack([
        np.einsum("trh,trg->hg", np.abs(hp[:, :B]), np.abs(g[:, :B])),
        np.einsum("trh,trg->hg", np.abs(hp[:, B:]), np.abs(g[:, B:]))])
    K = ys.shape[0] * B
    return ref, K * 2.0 ** -23 * absum


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5])
@pytest.mark.parametrize("B", [1, 3, 24])
def test_dw_plain_matches_reference(dtype, T, B):
    H, G = 8, 12
    ys, dg = _draw(T * 100 + B, T, B, H, G)
    tdt = _DT[dtype][0]
    got = dw_plain(torch.from_numpy(ys), torch.from_numpy(dg).to(tdt), B,
                   tdt)
    assert got.dtype == torch.float32 and got.shape == (2, H, G)
    ref, bar = _reference(ys, dg, B, dtype)
    assert np.all(np.abs(got.numpy().astype(np.float64) - ref) <= bar)
    if T == 1:                    # h_prev is all zeros: no gradient
        assert torch.all(got == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_column_slices_share_one_buffer(dtype):
    """The GRU's two products, dxs[..., :2H] (a column slice with a row
    stride of 3H) and dhn, land in one [2, H, 3H] tensor with no cat on
    the caller's side: the reference's concatenation of two einsums."""
    T, B, H = 6, 3, 8
    rng = np.random.default_rng(7)
    ys = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    dxs = rng.standard_normal((T, 2 * B, 3 * H)).astype(np.float32)
    dhn = rng.standard_normal((T, 2 * B, H)).astype(np.float32)
    tdt = _DT[dtype][0]
    txs = torch.from_numpy(dxs).to(tdt)
    got = rnn_dw(torch.from_numpy(ys), (txs[..., :2 * H],
                                        torch.from_numpy(dhn).to(tdt)), B,
                 tdt)
    assert got.shape == (2, H, 3 * H)
    ref_a, bar_a = _reference(ys, dxs[..., :2 * H], B, dtype)
    ref_b, bar_b = _reference(ys, dhn, B, dtype)
    ref = np.concatenate([ref_a, ref_b], axis=2)
    bar = np.concatenate([bar_a, bar_b], axis=2)
    assert np.all(np.abs(got.numpy().astype(np.float64) - ref) <= bar)


def test_first_frame_contributes_nothing():
    """h_prev[0] = 0: the gate gradient of frame 0 and the carries of the
    last frame (never a predecessor) do not move dW."""
    T, B, H, G = 5, 3, 8, 12
    ys, dg = _draw(11, T, B, H, G)
    base = dw_plain(torch.from_numpy(ys), torch.from_numpy(dg), B,
                    torch.float32)
    ys2, dg2 = ys.copy(), dg.copy()
    dg2[0] = 1e3
    ys2[-1] = -1e3
    moved = dw_plain(torch.from_numpy(ys2), torch.from_numpy(dg2), B,
                     torch.float32)
    assert torch.equal(base, moved)
    assert torch.equal(shift_prev(torch.from_numpy(ys))[0],
                       torch.zeros(2 * B, H))


def test_cpu_route_takes_plain_version():
    """On CPU tensors ``rnn_dw`` is ``dw_plain`` (one gate tensor) or the
    plain products side by side (two); the kernel's wrapper refuses them."""
    T, B, H = 4, 2, 8
    ys, dg = _draw(3, T, B, H, 4 * H)
    tys, tdg = torch.from_numpy(ys), torch.from_numpy(dg).to(torch.bfloat16)
    assert torch.equal(rnn_dw(tys, (tdg,), B, torch.bfloat16),
                       dw_plain(tys, tdg, B, torch.bfloat16))
    two = rnn_dw(tys, (tdg[..., :2 * H], tdg[..., 3 * H:]), B, torch.bfloat16)
    assert torch.equal(two, torch.cat([
        dw_plain(tys, tdg[..., :2 * H], B, torch.bfloat16),
        dw_plain(tys, tdg[..., 3 * H:], B, torch.bfloat16)], dim=2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dw_cuda(tys, (tdg,), B)
