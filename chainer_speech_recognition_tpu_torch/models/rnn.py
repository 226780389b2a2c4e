"""Masked bidirectional GRU layer (port of ``models/rnn.py``'s
full-utterance call).

As in the reference: the input projections of both directions are hoisted
out of the recurrence (``in_fwd``/``in_bwd``, computed in the compute
dtype); the backward direction is the WHOLE padded time axis reversed
(``[::-1]``), live on the window ``[T-len, T)`` — not a per-utterance
reversal; both directions run as one ``[T, 2B, 3H]`` recurrence
(``ops/rnn_cuda.gru_scan``), the backward half is reversed back, and the
output is masked.

``impl``: "auto" and "pallas" take the kernel's wrapper (the kernel on
CUDA tensors, its plain version on CPU tensors); "scan" takes the plain
version on either device. LSTM cells, forward-only stacks and the
streaming call (``h0_fwd``/``emit_carry_at``) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn_cuda import gru_scan, gru_scan_plain, stream_dtype

__all__ = ["BiRNNLayer", "linear", "time_mask"]


def time_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] bool validity mask from per-utterance lengths."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BiRNNLayer(nn.Module):
    """One bidirectional GRU layer: [B, T, D] → [B, T, 2H] fp32 (masked)."""

    def __init__(self, in_dim: int, hidden: int, cell: str = "gru",
                 dtype: torch.dtype = torch.bfloat16, impl: str = "auto",
                 bidirectional: bool = True):
        super().__init__()
        if cell != "gru":
            raise NotImplementedError(
                f"rnn cell {cell!r} is not ported yet (ROADMAP.md, kernel "
                "queue: the LSTM kernels)")
        if not bidirectional:
            raise NotImplementedError(
                "forward-only RNN stacks are not ported yet (ROADMAP.md, "
                "module queue: streaming)")
        self.hidden = hidden
        self.dtype = dtype
        self.impl = impl
        G = 3 * hidden
        self.in_fwd = nn.Linear(in_dim, G)
        self.in_bwd = nn.Linear(in_dim, G)
        self.rec = nn.Parameter(torch.zeros(2, hidden, G))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                h0_fwd=None, emit_carry_at=None) -> torch.Tensor:
        if h0_fwd is not None or emit_carry_at is not None:
            raise NotImplementedError(
                "streaming BiRNN calls are not ported yet (ROADMAP.md, "
                "module queue: streaming)")
        B, T, _ = x.shape
        mask = time_mask(T, lengths)                        # [B, T]
        sdt = stream_dtype(self.dtype)
        xf = linear(x, self.in_fwd, self.dtype).transpose(0, 1)   # [T,B,3H]
        xb = linear(x, self.in_bwd, self.dtype).transpose(0, 1).flip(0)
        xs = torch.cat([xf, xb], dim=1).to(sdt).contiguous()     # [T,2B,3H]
        lens_f = lengths.to(torch.float32)
        lo = torch.cat([torch.zeros_like(lens_f), T - lens_f])[:, None]
        hi = torch.cat([lens_f, torch.full_like(lens_f, T)])[:, None]
        scan = gru_scan_plain if self.impl == "scan" else gru_scan
        ys = scan(xs, self.rec, lo, hi, self.dtype)         # [T, 2B, H]
        fwd = ys[:, :B].transpose(0, 1)                     # [B, T, H]
        bwd = ys.flip(0)[:, B:].transpose(0, 1)
        out = torch.cat([fwd, bwd], dim=-1)
        return out * mask[:, :, None].to(out.dtype)
