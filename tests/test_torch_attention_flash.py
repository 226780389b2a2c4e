"""The plain versions of the flash-attention kernels
(``ops/attention_cuda.py``) against the Pallas kernels of
``ops/attention_pallas.py`` in interpret mode, on the CPU: the forward and
its logsumexp rows against ``_flash_forward``, the gradients through
``FlashAttention`` (the dQ and dK/dV plain versions) against
``jax.grad(flash_mhsa)``. Inputs from numpy with a seed; lengths 1 and T
in every batch; chunk 0 and the chunk-causal pattern. Bars: forward and
lse rtol/atol 2e-5, gradients 3e-4 (``tests/test_attention_pallas.py``).
A row of length 0 comes out finite: out 0, lse −1e30, zero gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.ops import attention_pallas as ap
from chainer_speech_recognition_tpu_torch.ops import attention_cuda as tc

CASES = [
    dict(B=3, T=64, h=2, chunk=0, left=0),
    dict(B=2, T=200, h=2, chunk=0, left=0),      # ragged T, two key tiles
    dict(B=3, T=96, h=2, chunk=16, left=2),      # chunk-causal
    # wider heads of the reference's set (dh % 64 == 0, dh <= 512)
    dict(B=2, T=200, h=1, chunk=0, left=0, dh=128),
    dict(B=3, T=96, h=2, chunk=16, left=2, dh=128),
    dict(B=2, T=130, h=1, chunk=0, left=0, dh=256),
    dict(B=2, T=64, h=1, chunk=16, left=1, dh=256),
    dict(B=2, T=64, h=1, chunk=0, left=0, dh=192),
]


def _inputs(B, T, h, seed, dh=64):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((B, T, h, dh)).astype(np.float32)
                  for _ in range(4))
    lens = rng.integers(1, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = T, 1
    return q, k, v, w, lens


def _row_has_key(T, lens, chunk, left):
    """[B, T] bool: query rows with at least one allowed key."""
    ok = tc.allowed_mask(T, torch.from_numpy(lens), chunk, left)
    return ok.expand(-1, -1, T, T).any(dim=-1)[:, 0].numpy()


@pytest.mark.parametrize("case", CASES)
def test_forward_and_lse_match_pallas(case):
    B, T, h, dh = case["B"], case["T"], case["h"], case.get("dh", 64)
    q, k, v, _, lens = _inputs(B, T, h, seed=T, dh=dh)
    Tp = ap._pad_t(T)
    fold = lambda x: np.pad(np.moveaxis(x, 2, 1).reshape(B * h, T, dh),
                            ((0, 0), (0, Tp - T), (0, 0)))
    out_j, lse_j = ap._flash_forward(
        jnp.asarray(fold(q)), jnp.asarray(fold(k)), jnp.asarray(fold(v)),
        jnp.asarray(np.repeat(lens, h)), case["chunk"], case["left"])
    out_j = np.moveaxis(np.asarray(out_j)[:, :T].reshape(B, h, T, dh), 1, 2)
    lse_j = np.asarray(lse_j)[:, :T, 0].reshape(B, h, T)
    out, lse = tc.flash_fwd(*(torch.from_numpy(x) for x in (q, k, v, lens)),
                            case["chunk"], case["left"])
    rows = _row_has_key(T, lens, case["chunk"], case["left"])   # [B, T]
    np.testing.assert_allclose(out.numpy()[rows], out_j[rows], rtol=2e-5,
                               atol=2e-5)
    r = np.broadcast_to(rows[:, None, :], lse_j.shape)
    np.testing.assert_allclose(lse.numpy()[r], lse_j[r], rtol=2e-5, atol=2e-5)
    assert np.all(out.numpy()[~rows] == 0) and np.all(lse.numpy()[~r] == tc.NEG)


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_pallas(case):
    """The cotangent weighs every query row that has an allowed key,
    padded rows included (the dK/dV plain version walks them all)."""
    B, T, h = case["B"], case["T"], case["h"]
    q, k, v, w, lens = _inputs(B, T, h, seed=T + 1, dh=case.get("dh", 64))
    w = w * _row_has_key(T, lens, case["chunk"], case["left"])[:, :, None,
                                                               None]

    def loss(q, k, v):
        return jnp.sum(ap.flash_mhsa(q, k, v, jnp.asarray(lens),
                                     chunk=case["chunk"],
                                     left_chunks=case["left"]) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                               for x in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tc.flash_mhsa(qt, kt, vt, torch.from_numpy(lens), case["chunk"],
                        case["left"])
    (out * torch.from_numpy(w)).sum().backward()
    for got, ref, name in zip((qt.grad, kt.grad, vt.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=3e-4,
                                   atol=3e-4, err_msg=f"d{name}")


def test_bf16_plain_close_to_fp32_pallas():
    """bf16 inputs: scores of the bf16 values in fp32, probabilities rounded
    to bf16 before the value product; within bf16 noise of the fp32
    kernel (the JAX suite's 5e-2)."""
    B, T, h = 2, 128, 2
    q, k, v, _, lens = _inputs(B, T, h, seed=3)
    want = np.asarray(ap.flash_mhsa(*(jnp.asarray(x) for x in (q, k, v)),
                                    jnp.asarray(lens)))
    got, lse = tc.flash_fwd(*(torch.from_numpy(x).to(torch.bfloat16)
                              for x in (q, k, v)), torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_length_zero_row_is_finite():
    """A length-0 row has no allowed key: out 0, lse −1e30, and zero
    gradients, where the reference would divide by a zero sum."""
    q, k, v, w, _ = _inputs(2, 40, 2, seed=9)
    lens = torch.tensor([0, 40])
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tc.flash_fwd(qt.detach(), kt.detach(), vt.detach(), lens)
    assert torch.all(out[0] == 0) and torch.all(lse[0] == tc.NEG)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    y = tc.flash_mhsa(qt, kt, vt, lens, 16, 1)
    (y * torch.from_numpy(w)).sum().backward()
    for g in (qt.grad, kt.grad, vt.grad):
        assert torch.isfinite(g).all() and torch.all(g[0] == 0)


@pytest.mark.parametrize("extra,offset,aligned", [
    (0, 0, True), (8, 0, True), (4, 0, False), (0, 4, False), (0, 8, True)])
def test_rows_aligned16(extra, offset, aligned):
    """The bf16 backward's row rule: the data pointer and the b, t, h
    strides of a [B, T, h, 64] view all multiples of 8 values; the fused
    qkv projection's slices (t stride 3·h·64) keep it."""
    wide = torch.zeros(2, 5, offset + 3 * 2 * 64 + extra,
                       dtype=torch.bfloat16)
    q = wide[..., offset:offset + 2 * 64].reshape(2, 5, 2, 64)
    assert tc.rows_aligned16(q) == aligned


def test_auto_gate():
    """The reference's gate: long-form T' > 512 and a head width of its
    set (dh % 64 == 0, dh <= 512), which the kernels take whole."""
    assert not tc.supports(256, 64) and not tc.supports(512, 64)
    assert tc.supports(513, 64) and tc.supports(700, 64)
    assert tc.supports(1024, 128) and tc.supports(701, 512)
    assert not tc.supports(1024, 96) and not tc.supports(1024, 1024)
    assert not tc.supports(512, 128)
    for T, dh in ((513, 64), (700, 192), (1024, 128), (600, 96),
                  (1024, 576), (256, 256)):
        assert tc.supports(T, dh) == ap.supports(T, dh)
    assert tc.KERNEL_DHS == tuple(dh for dh in range(1, 1025)
                                  if ap.supports(1024, dh))
