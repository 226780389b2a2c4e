"""CTC loss in plain PyTorch (port of ``ops/ctc_jax.py``).

Blank id 0, natural-log NLL per utterance over the extended label sequence
``b l1 b l2 ... lL b``; per-utterance time and label lengths are handled by
masking and freezing, so shapes stay static. All math is fp32 with
``LOG_ZERO = -1e30`` and ``_logsumexp3``'s clamps; a sample with no valid
alignment gets the sentinel loss ``-LOG_ZERO``.

What the reference leaves to XLA is here too, shared by both CTC paths:
``log_softmax``, the extended labels, ``allow2`` and the emission gather
``lp_ext [B, T, S]`` (``ctc_inputs``), whose backward is repeatable
(``_EmissionGather``). The α and β recursions over time
(``ctc_alpha_plain``, ``ctc_beta_grad_plain``) are the plain versions of
the kernels in ``csrc/ctc.cu`` (``ops/ctc_cuda.py``). ``ctc_loss_scan``
differentiates the plain α recursion with autograd, as ``ctc_jax.ctc_loss``
is differentiated through its ``lax.scan``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import BLANK_ID

LOG_ZERO = -1e30


def logsumexp3(a, b, c):
    """log(e^a + e^b + e^c) with ``ctc_jax._logsumexp3``'s clamps."""
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.clamp(m, min=LOG_ZERO / 2)
    se = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.clamp(se, min=1e-37))
    return torch.where(m <= LOG_ZERO / 2, LOG_ZERO, out)


def extend_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, L] → [B, 2L+1] int64, blanks interleaved (pads become blank)."""
    B, L = labels.shape
    ext = torch.zeros((B, 2 * L + 1), dtype=torch.int64, device=labels.device)
    ext[:, 1::2] = torch.clamp(labels.to(torch.int64), min=0)
    return ext


class _EmissionGather(torch.autograd.Function):
    """``lp [B, T, V] → lp[b, t, ext[b, s]]`` [B, T, S] with a repeatable
    backward: each frame's S gradients summed into their V classes (the
    blank and repeated labels share one) as one fp64 product with the
    one-hot [B, S, V] of ``ext``. ``gather``'s own backward scatter-adds
    with atomics on the card, in another order each run, so no two
    training runs there would be bitwise equal."""

    @staticmethod
    def forward(ctx, lp, ext):
        ctx.save_for_backward(ext)
        ctx.n_classes = lp.shape[-1]
        B, T, _ = lp.shape
        return torch.gather(lp, 2, ext[:, None, :].expand(B, T, ext.shape[1]))

    @staticmethod
    def backward(ctx, grad):
        (ext,) = ctx.saved_tensors
        classes = torch.arange(ctx.n_classes, device=ext.device)
        onehot = (ext[:, :, None] == classes).to(torch.float64)
        return torch.bmm(grad.to(torch.float64), onehot).to(grad.dtype), None


def ctc_inputs(logits, logit_lengths, labels, label_lengths):
    """(lp_ext [B,T,S] fp32, allow2 [B,S] fp32, t_len [B] int32, lab_len
    [B] int32): the recursions' inputs. ``t_len`` is clamped to T (as
    ``ctc_loss_pallas`` does: a longer length must behave like T) and
    ``lab_len`` to the label width L, so every index stays inside S."""
    logits = logits.to(torch.float32)
    B, T, _ = logits.shape
    lp = F.log_softmax(logits, dim=-1)
    ext = extend_labels(labels)                              # [B, S]
    S = ext.shape[1]
    sidx = torch.arange(S, device=ext.device)[None, :]
    prev2 = torch.cat([torch.zeros_like(ext[:, :2]), ext[:, :-2]],
                      dim=1)[:, :S]
    allow2 = (sidx >= 2) & (ext != BLANK_ID) & (ext != prev2)
    lp_ext = _EmissionGather.apply(lp, ext)
    t_len = torch.clamp(logit_lengths.to(lp.device), max=T).to(torch.int32)
    lab_len = torch.clamp(label_lengths.to(lp.device),
                          max=labels.shape[1]).to(torch.int32)
    return lp_ext, allow2.to(torch.float32), t_len, lab_len


def _shift(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """x[..., s-k] (k > 0) or x[..., s+|k|] (k < 0) along the last axis,
    filled with ``fill`` where the index leaves [0, S)."""
    S = x.shape[-1]
    pad = torch.full(x.shape[:-1] + (abs(k),), fill, dtype=x.dtype,
                     device=x.device)
    if k > 0:
        return torch.cat([pad, x], dim=-1)[..., :S]
    return torch.cat([x, pad], dim=-1)[..., -S:]


def _states(allow2, lab_len):
    S = allow2.shape[1]
    sidx = torch.arange(S, device=allow2.device)[None, :]
    s_valid = sidx < (2 * lab_len.to(torch.int64) + 1)[:, None]
    return sidx, s_valid, allow2 > 0.5


def ctc_alpha_plain(lp_ext, allow2, t_len, lab_len):
    """Plain version of the forward kernel: (alphas [B,T,S], loss [B]).
    Written without in-place updates, so autograd can differentiate it."""
    B, T, S = lp_ext.shape
    sidx, s_valid, a2 = _states(allow2, lab_len)
    lab = lab_len.to(torch.int64)
    tl = t_len.to(torch.int64)[:, None]
    init = ((sidx == 0) | ((sidx == 1) & (lab[:, None] > 0))) & s_valid
    alpha = torch.where(init, lp_ext[:, 0], LOG_ZERO)
    alphas = [alpha]
    for t in range(1, T):
        sh1 = _shift(alpha, 1, LOG_ZERO)
        sh2 = torch.where(a2, _shift(alpha, 2, LOG_ZERO), LOG_ZERO)
        new = logsumexp3(alpha, sh1, sh2) + lp_ext[:, t]
        new = torch.where(s_valid, new, LOG_ZERO)
        alpha = torch.where(t < tl, new, alpha)
        alphas.append(alpha)
    last = alpha.gather(1, (2 * lab)[:, None])[:, 0]
    prev = alpha.gather(1, torch.clamp(2 * lab - 1, min=0)[:, None])[:, 0]
    prev = torch.where(lab > 0, prev, LOG_ZERO)
    loss = -logsumexp3(last, prev, torch.full_like(last, LOG_ZERO))
    return torch.stack(alphas, dim=1), loss


def ctc_beta_grad_plain(lp_ext, allow2, t_len, lab_len, alphas, loss, g):
    """Plain version of the backward kernel: d(Σ g·loss)/d lp_ext
    [B,T,S] from the β recursion, zero past t_len and at invalid states.
    ``g`` [B] must already be zero for samples without an alignment."""
    B, T, S = lp_ext.shape
    sidx, s_valid, a2 = _states(allow2, lab_len)
    lab = lab_len.to(torch.int64)[:, None]
    tl = t_len.to(torch.int64)[:, None]
    a2s = _shift(a2, -2, False)
    init_ok = (sidx == 2 * lab) | ((sidx == 2 * lab - 1) & (lab > 0))
    logp = -loss[:, None]
    g = g.to(torch.float32)[:, None]
    beta = torch.full((B, S), LOG_ZERO, dtype=torch.float32,
                      device=lp_ext.device)
    grads = [None] * T
    for t in reversed(range(T)):
        lp_t = lp_ext[:, t]
        sh1 = _shift(beta, -1, LOG_ZERO)
        sh2 = torch.where(a2s, _shift(beta, -2, LOG_ZERO), LOG_ZERO)
        new = logsumexp3(beta, sh1, sh2) + lp_t
        inside = t < tl
        beta = torch.where(t + 1 == tl, torch.where(init_ok, lp_t, LOG_ZERO),
                           torch.where(inside, new, beta))
        beta = torch.where(s_valid, beta, LOG_ZERO)
        post = alphas[:, t] + beta - lp_t - logp
        grad = -torch.exp(torch.clamp(post, max=0.0)) * g
        grads[t] = torch.where(inside & s_valid, grad, 0.0)
    return torch.stack(grads, dim=1)


def ctc_loss_scan(logits, logit_lengths, labels, label_lengths):
    """Per-utterance CTC NLL [B] fp32, differentiated by autograd through
    the plain α recursion (``ctc_jax.ctc_loss``; ``train.ctc_impl=jnp``)."""
    lp_ext, allow2, t_len, lab_len = ctc_inputs(
        logits, logit_lengths, labels, label_lengths)
    return ctc_alpha_plain(lp_ext, allow2, t_len, lab_len)[1]
