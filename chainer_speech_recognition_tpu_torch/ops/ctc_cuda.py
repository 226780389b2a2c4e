"""CTC loss on the α/β kernels (``csrc/ctc.cu``) with a custom autograd
Function (port of ``ops/ctc_pallas.py``).

As in the reference, the kernels see only the extended-label emissions:
``log_softmax``, the ``[B,T,V] → [B,T,S]`` gather (``ops/ctc.ctc_inputs``),
the gather's sum back (a one-hot product, repeatable) and the
``log_softmax`` backward stay with autograd, as they stay with XLA. ``CTCLoss`` runs the α kernel forward
(alphas are kept for the backward) and the β kernel backward.

Two behaviours of the reference wrapper are kept: ``logit_lengths`` are
clamped to T (``ctc_loss_pallas``; otherwise the β initialisation at
``t == t_len - 1`` never fires), and samples with no valid alignment
(sentinel loss) get exactly zero gradient.

``ctc_alpha`` / ``ctc_beta_grad`` launch the kernels for CUDA tensors and
run the plain versions (``ops/ctc.py``) for CPU tensors. ``ctc_plan`` reads
the launch shape the kernels take for S extended states.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _kernels
from .ctc import LOG_ZERO, ctc_alpha_plain, ctc_beta_grad_plain, ctc_inputs


# the wide kernels hold the wavefront's 2·S floats in the 227 KB a block
# may take; below that csrc/ctc.cu picks the launch shape from S itself
MAX_STATES = 29056


class CtcPlan(NamedTuple):
    states: int     # states a thread: 2 (the lanes kernels), 0 (wide)
    warps: int      # warps of a block, which owns one utterance
    smem: int       # dynamic shared memory a block, bytes


def ctc_plan(S: int, form: str) -> CtcPlan:
    """The launch shape ``csrc/ctc.cu`` takes for S extended states
    (``form`` "fwd" or "bwd"), as the kernel library computes it; needs
    the card's build."""
    if form not in ("fwd", "bwd"):
        raise ValueError(f"ctc_plan: form {form!r} (fwd or bwd)")
    out = (ctypes.c_int * 3)()
    err = _kernels.call("csr_ctc_plan", S, int(form == "bwd"), out)
    if err:
        raise RuntimeError(f"csr_ctc_plan: CUDA error {err} at S = {S}")
    return CtcPlan(*out)


def _check(lp_ext, allow2, t_len, lab_len):
    B, T, S = lp_ext.shape
    if B < 1 or T < 1 or S < 1:
        raise ValueError(f"ctc kernel: empty input {tuple(lp_ext.shape)}")
    if S > MAX_STATES:
        raise ValueError(f"ctc kernel: S = {S} extended states exceed what "
                         "a block's shared memory holds (2·S floats)")
    _kernels.check_cuda_tensor("lp_ext", lp_ext, torch.float32, (B, T, S))
    _kernels.check_cuda_tensor("allow2", allow2, torch.float32, (B, S))
    _kernels.check_cuda_tensor("t_len", t_len, torch.int32, (B,))
    _kernels.check_cuda_tensor("lab_len", lab_len, torch.int32, (B,))
    return B, T, S


def ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len):
    """α kernel launch: (alphas [B,T,S], loss [B]) fp32; CUDA only.
    ``t_len <= T`` and ``2 lab_len + 1 <= S`` (``ctc_inputs`` clamps)."""
    B, T, S = _check(lp_ext, allow2, t_len, lab_len)
    alphas = torch.empty_like(lp_ext)
    loss = torch.empty((B,), dtype=torch.float32, device=lp_ext.device)
    _kernels.CTC_FWD.launch(
        lp_ext.data_ptr(), allow2.data_ptr(), t_len.data_ptr(),
        lab_len.data_ptr(), alphas.data_ptr(), loss.data_ptr(), B, T, S,
        _kernels.stream_ptr(lp_ext))
    return alphas, loss


def ctc_bwd_cuda(lp_ext, allow2, t_len, lab_len, alphas, loss, g):
    """β kernel launch: d lp_ext [B,T,S] fp32; CUDA only."""
    B, T, S = _check(lp_ext, allow2, t_len, lab_len)
    _kernels.check_cuda_tensor("alphas", alphas, torch.float32, (B, T, S))
    _kernels.check_cuda_tensor("loss", loss, torch.float32, (B,))
    _kernels.check_cuda_tensor("g", g, torch.float32, (B,))
    grad = torch.empty_like(lp_ext)
    _kernels.CTC_BWD.launch(
        lp_ext.data_ptr(), allow2.data_ptr(), t_len.data_ptr(),
        lab_len.data_ptr(), alphas.data_ptr(), loss.data_ptr(), g.data_ptr(),
        grad.data_ptr(), B, T, S, _kernels.stream_ptr(lp_ext))
    return grad


def ctc_alpha(lp_ext, allow2, t_len, lab_len):
    """(alphas, loss): the α kernel on the card, the plain version on the
    CPU."""
    if lp_ext.is_cuda:
        return ctc_fwd_cuda(lp_ext.contiguous(), allow2.contiguous(),
                            t_len.contiguous(), lab_len.contiguous())
    _kernels.check_cpu_tensor("ctc_alpha", lp_ext)
    return ctc_alpha_plain(lp_ext, allow2, t_len, lab_len)


def ctc_beta_grad(lp_ext, allow2, t_len, lab_len, alphas, loss, g):
    """d lp_ext: the β kernel on the card, the plain version on the CPU."""
    if lp_ext.is_cuda:
        return ctc_bwd_cuda(lp_ext.contiguous(), allow2.contiguous(),
                            t_len.contiguous(), lab_len.contiguous(),
                            alphas, loss, g.contiguous())
    _kernels.check_cpu_tensor("ctc_beta_grad", lp_ext)
    return ctc_beta_grad_plain(lp_ext, allow2, t_len, lab_len, alphas, loss, g)


class CTCLoss(torch.autograd.Function):
    """loss [B] from ``lp_ext`` [B,T,S]; only ``lp_ext`` gets a gradient."""

    @staticmethod
    def forward(ctx, lp_ext, allow2, t_len, lab_len):
        alphas, loss = ctc_alpha(lp_ext, allow2, t_len, lab_len)
        ctx.save_for_backward(lp_ext, allow2, t_len, lab_len, alphas, loss)
        return loss

    @staticmethod
    def backward(ctx, g):
        lp_ext, allow2, t_len, lab_len, alphas, loss = ctx.saved_tensors
        # impossible samples: exactly zero gradient (exp(α+β−lp−logP) is
        # numerically meaningless there)
        g = torch.where(loss < -LOG_ZERO / 2, g.to(torch.float32), 0.0)
        grad = ctc_beta_grad(lp_ext, allow2, t_len, lab_len, alphas, loss, g)
        return grad, None, None, None


def ctc_loss(logits, logit_lengths, labels, label_lengths):
    """Per-utterance CTC NLL [B] fp32 through the kernels' Function
    (``ctc_pallas.ctc_loss_pallas``; ``train.ctc_impl=pallas``/``auto``)."""
    lp_ext, allow2, t_len, lab_len = ctc_inputs(
        logits, logit_lengths, labels, label_lengths)
    return CTCLoss.apply(lp_ext.contiguous(), allow2, t_len, lab_len)
