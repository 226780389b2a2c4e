"""The port's CTC (ops/ctc.py plain recursions, ops/ctc_cuda.py Function;
on the CPU the Function runs the kernels' plain versions) against the JAX
package: ``ctc_loss_pallas`` (interpret mode) for the Function and
``ctc_jax.ctc_loss`` for autograd through the plain α recursion, plus
``torch.nn.functional.ctc_loss`` as an outside cross-check. The kernels
themselves are held to the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Bars: loss atol 2e-4 / rtol 1e-5, gradient atol 2e-4, all fp32 — the
reference's own bars for its kernel (tests/test_ctc_pallas.py:35-42)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.ops.ctc_jax import ctc_loss as jax_ctc
from chainer_speech_recognition_tpu.ops.ctc_pallas import ctc_loss_pallas
from chainer_speech_recognition_tpu_torch.ops import ctc as tctc
from chainer_speech_recognition_tpu_torch.ops.ctc_cuda import (
    ctc_alpha, ctc_beta_grad, ctc_loss)

B, T, V, L = 6, 14, 7, 5


def _case(seed):
    """Ragged time and label lengths, a label of length 0, repeated
    labels (no skip transition), an impossible sample (5 labels in 3
    frames) and a length above T (clamped)."""
    rng = np.random.default_rng(seed)
    logits = 2 * rng.standard_normal((B, T, V)).astype(np.float32)
    labels = rng.integers(1, V, (B, L)).astype(np.int32)
    labels[1, 1] = labels[1, 0]
    labels[4, :] = -1                       # padding, length 0 below
    tl = np.asarray([T, 11, 3, T + 4, 9, 12], np.int32)
    ll = np.asarray([5, 3, 5, 4, 0, 2], np.int32)
    w = rng.uniform(0.5, 2.0, B).astype(np.float32)
    return logits, tl, labels, ll, w


def _torch_loss_grad(fn, logits, tl, labels, ll, w):
    x = torch.from_numpy(logits).requires_grad_()
    loss = fn(x, torch.from_numpy(tl), torch.from_numpy(labels),
              torch.from_numpy(ll))
    (loss * torch.from_numpy(w)).sum().backward()
    return loss.detach().numpy(), x.grad.numpy()


def _jax_loss_grad(fn, logits, tl, labels, ll, w):
    args = [jnp.asarray(a) for a in (tl, labels, ll)]
    loss, vjp = jax.vjp(lambda x: fn(x, *args), jnp.asarray(logits))
    return np.asarray(loss), np.asarray(vjp(jnp.asarray(w))[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_function_matches_pallas_kernel(seed):
    case = _case(seed)
    lt, gt = _torch_loss_grad(ctc_loss, *case)
    lj, gj = _jax_loss_grad(ctc_loss_pallas, *case)
    np.testing.assert_allclose(lt, lj, atol=2e-4, rtol=1e-5)
    np.testing.assert_allclose(gt, gj, atol=2e-4, rtol=0)
    assert lt[2] >= 1e29 and np.all(gt[2] == 0)     # impossible: no gradient


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_autograd_matches_ctc_jax(seed):
    case = _case(seed)
    lt, gt = _torch_loss_grad(tctc.ctc_loss_scan, *case)
    lj, gj = _jax_loss_grad(jax_ctc, *case)
    np.testing.assert_allclose(lt, lj, atol=2e-4, rtol=1e-5)
    ok = lj < 1e29                  # both differentiate the sentinel path
    np.testing.assert_allclose(gt[ok], gj[ok], atol=2e-4, rtol=0)


def test_length_clamp_and_zero_length_labels():
    logits, tl, labels, ll, w = _case(2)
    l1, g1 = _torch_loss_grad(ctc_loss, logits, tl, labels, ll, w)
    tl2 = np.minimum(tl, T)
    l2, g2 = _torch_loss_grad(ctc_loss, logits, tl2, labels, ll, w)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(g1, g2)
    assert np.abs(g1[3]).max() > 0          # tl > T still trains
    # a length-0 label is the all-blank path: -Σ_t log p(blank)
    lp = torch.log_softmax(torch.from_numpy(logits[4]), -1)
    np.testing.assert_allclose(l1[4], float(-lp[: tl[4], 0].sum()),
                               rtol=1e-5)


def test_matches_torch_ctc_loss():
    """Cross-check against PyTorch's own CTC (blank 0, no reduction) on the
    samples that have an alignment; F.ctc_loss gives them the same NLL
    and the same gradient."""
    logits, tl, labels, ll, w = _case(3)
    ok = np.asarray([i != 2 for i in range(B)])
    lt, gt = _torch_loss_grad(ctc_loss, logits, tl, labels, ll, w)
    x = torch.from_numpy(logits).requires_grad_()
    ref = F.ctc_loss(torch.log_softmax(x, -1).transpose(0, 1),
                     torch.from_numpy(np.maximum(labels, 0)).long(),
                     torch.from_numpy(np.minimum(tl, T)).long(),
                     torch.from_numpy(ll).long(), blank=0,
                     reduction="none", zero_infinity=True)
    (ref * torch.from_numpy(w * ok)).sum().backward()
    np.testing.assert_allclose(lt[ok], ref.detach().numpy()[ok], atol=2e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(gt[ok], x.grad.numpy()[ok], atol=2e-4, rtol=0)


def test_plain_recursions_are_the_function_on_cpu():
    """The wrappers take the plain versions for CPU tensors, and the plain
    β gradient equals autograd through the plain α recursion."""
    logits, tl, labels, ll, w = _case(4)
    lp_ext, allow2, t_len, lab_len = tctc.ctc_inputs(
        torch.from_numpy(logits), torch.from_numpy(tl),
        torch.from_numpy(labels), torch.from_numpy(ll))
    lp_ext.requires_grad_()
    alphas, loss = tctc.ctc_alpha_plain(lp_ext, allow2, t_len, lab_len)
    a2, l2 = ctc_alpha(lp_ext.detach(), allow2, t_len, lab_len)
    assert torch.equal(alphas.detach(), a2) and torch.equal(loss.detach(), l2)
    g = torch.where(loss < 5e29, torch.from_numpy(w), 0.0)
    (loss * g).sum().backward()
    grad = ctc_beta_grad(lp_ext.detach(), allow2, t_len, lab_len, a2, l2, g)
    torch.testing.assert_close(grad, lp_ext.grad, atol=2e-4, rtol=0)


def test_emission_gather_sums_each_class_as_gather_does():
    """``ctc_inputs``' emission gather: the forward is ``torch.gather``'s,
    and its backward (an fp64 one-hot product, so the card sums in one
    order every run) equals ``gather``'s scatter-add backward, the blank
    and repeated labels each summed into their one class."""
    logits, _, labels, _, _ = _case(5)
    lp = torch.log_softmax(torch.from_numpy(logits), -1)
    ext = tctc.extend_labels(torch.from_numpy(labels))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, T, ext.shape[1])).astype(np.float32))
    x, y = lp.clone().requires_grad_(), lp.clone().requires_grad_()
    ours = tctc._EmissionGather.apply(x, ext)
    ref = torch.gather(y, 2, ext[:, None, :].expand(B, T, ext.shape[1]))
    assert torch.equal(ours, ref)
    ours.backward(g)
    ref.backward(g)
    torch.testing.assert_close(x.grad, y.grad, atol=1e-6, rtol=1e-6)
    assert x.grad[..., 0].abs().sum() > 0     # the blank's S/2+1 terms
