"""Bidirectional GRU recurrence kernel (``csrc/gru_fwd.cu``), inference.

Port of ``ops/rnn_pallas.py``'s residual-free GRU forward (what
``birnn_pallas`` runs when nothing differentiates it), with the same
layout:

  xs    [T, R=2B, 3H] stream dtype — input pre-activations; rows [0, B) are
                         the forward direction (use w[0]), rows [B, 2B) the
                         time-reversed backward direction (use w[1])
  w     [2, H, 3H]    fp32 — recurrent weights per direction
  lo/hi [R, 1]        fp32 — step t is live for a row iff lo ≤ t < hi
  ys    [T, R, H]     fp32 — the carries h, frozen outside [lo, hi)

The stream dtype is bf16 under bf16 compute and fp32 under fp32 compute
(``stream_dtype``, as ``rnn_pallas._stream_dt``). The recurrent product
rounds h and w to the compute dtype and accumulates in fp32; carries and
gate math are fp32.

``gru_scan`` launches the kernel for CUDA tensors and runs the plain
version (a Python time loop, the ``lax.scan`` path of ``models/rnn.py`` on
the kernel's layout) for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _kernels


def stream_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if compute_dtype == torch.float32 else torch.bfloat16


def gru_scan_plain(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                   hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of the kernel (any device)."""
    T, R, _ = xs.shape
    H = w.shape[1]
    B = R // 2
    wc = w.to(compute_dtype).to(torch.float32)             # [2, H, 3H]
    h = torch.zeros((R, H), dtype=torch.float32, device=xs.device)
    ys = torch.empty((T, R, H), dtype=torch.float32, device=xs.device)
    for t in range(T):
        hc = h.to(compute_dtype).to(torch.float32)
        hp = torch.cat([hc[:B] @ wc[0], hc[B:] @ wc[1]], dim=0)
        xp = xs[t].to(torch.float32)
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2*H] + hp[:, H:2*H])
        n = torch.tanh(xp[:, 2*H:] + r * hp[:, 2*H:])
        h_new = (1.0 - z) * n + z * h
        valid = (lo <= t) & (t < hi)                       # [R, 1]
        h = torch.where(valid, h_new, h)
        ys[t] = h
    return ys


def gru_scan_cuda(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
                  hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Kernel launch (CUDA tensors only; raises on shapes it does not take)."""
    T, R, G = xs.shape
    H = w.shape[1]
    B = R // 2
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gru kernel: compute dtype {compute_dtype} is not "
                         "supported (float32 or bfloat16)")
    if R % 2 or B < 1 or T < 1:
        raise ValueError(f"gru kernel: need T >= 1 and an even R >= 2 "
                         f"(got T={T}, R={R})")
    if H % 32 or not 32 <= H <= 512:
        raise ValueError(f"gru kernel: hidden size {H} unsupported (one "
                         "thread per unit: 32 <= H <= 512, H % 32 == 0)")
    sdt = stream_dtype(compute_dtype)
    _kernels.check_cuda_tensor("xs", xs, sdt, (T, R, 3 * H))
    _kernels.check_cuda_tensor("w", w, torch.float32, (2, H, 3 * H))
    _kernels.check_cuda_tensor("lo", lo, torch.float32, (R, 1))
    _kernels.check_cuda_tensor("hi", hi, torch.float32, (R, 1))
    wk = w.to(compute_dtype).contiguous()
    ys = torch.empty((T, R, H), dtype=torch.float32, device=xs.device)
    _kernels.GRU_FWD.launch(
        xs.data_ptr(), wk.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        ys.data_ptr(), T, B, H, int(compute_dtype == torch.bfloat16),
        _kernels.stream_ptr(xs))
    return ys


def gru_scan(xs: torch.Tensor, w: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``birnn_pallas(xs, w, lo, hi, "gru", dtype)`` for inference: the
    kernel on the card, the plain version on the CPU."""
    if xs.is_cuda:
        return gru_scan_cuda(xs, w, lo, hi, compute_dtype)
    if xs.device.type != "cpu":
        raise ValueError(f"gru_scan: unsupported device {xs.device}")
    return gru_scan_plain(xs, w, lo, hi, compute_dtype)
