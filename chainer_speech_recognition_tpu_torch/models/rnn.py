"""Masked bidirectional GRU/LSTM layer (port of ``models/rnn.py``'s
full-utterance call).

As in the reference: the input projections of both directions are hoisted
out of the recurrence (``in_fwd``/``in_bwd``, computed in the compute
dtype); the backward direction is the WHOLE padded time axis reversed
(``[::-1]``), live on the window ``[T-len, T)`` — not a per-utterance
reversal; both directions run as one ``[T, 2B, G·H]`` recurrence
(``ops/rnn_cuda``, G = 3 gates for the GRU, 4 for the LSTM), the backward
half is reversed back, and the output is masked.

``impl``: "auto" and "pallas" take the kernels' wrappers (the kernels on
CUDA tensors, their plain versions on CPU tensors): ``BiGRUScan`` /
``BiLSTMScan`` (the training forward that keeps the residuals, and the
backward kernel) when autograd will differentiate the layer, otherwise the
residual-free forward, as ``birnn_pallas``'s primal-only call skips the
residual streams. The kernels take every shape they support (H % 32 == 0,
H ≤ 512); the reference's TPU tiling rule for "auto" (H % 128 == 0) does
not apply. "scan" takes the plain forward on either device and lets
autograd differentiate it, as the reference's ``lax.scan`` path does.
Forward-only stacks and the streaming call (``h0_fwd``/``emit_carry_at``)
are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn_cuda import (BiGRUScan, BiLSTMScan, gru_scan, gru_scan_plain,
                            lstm_scan, lstm_scan_plain, stream_dtype)

__all__ = ["BiRNNLayer", "linear", "time_mask"]

# cell → (gates, plain forward, inference wrapper, autograd Function)
_CELLS = {"gru": (3, gru_scan_plain, gru_scan, BiGRUScan),
          "lstm": (4, lstm_scan_plain, lstm_scan, BiLSTMScan)}


def time_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] bool validity mask from per-utterance lengths."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BiRNNLayer(nn.Module):
    """One bidirectional GRU/LSTM layer: [B, T, D] → [B, T, 2H] fp32
    (masked)."""

    def __init__(self, in_dim: int, hidden: int, cell: str = "gru",
                 dtype: torch.dtype = torch.bfloat16, impl: str = "auto",
                 bidirectional: bool = True):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"rnn cell {cell!r}: expected one of "
                             f"{tuple(_CELLS)}")
        if not bidirectional:
            raise NotImplementedError(
                "forward-only RNN stacks are not ported yet (ROADMAP.md, "
                "module queue: streaming)")
        self.hidden = hidden
        self.dtype = dtype
        self.impl = impl
        self.cell = cell
        G = _CELLS[cell][0] * hidden
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
        xf = linear(x, self.in_fwd, self.dtype).transpose(0, 1)   # [T,B,GH]
        xb = linear(x, self.in_bwd, self.dtype).transpose(0, 1).flip(0)
        xs = torch.cat([xf, xb], dim=1).to(sdt).contiguous()     # [T,2B,GH]
        lens_f = lengths.to(torch.float32)
        lo = torch.cat([torch.zeros_like(lens_f), T - lens_f])[:, None]
        hi = torch.cat([lens_f, torch.full_like(lens_f, T)])[:, None]
        _, plain, scan, function = _CELLS[self.cell]
        if self.impl == "scan":
            ys = plain(xs, self.rec, lo, hi, self.dtype)
        elif torch.is_grad_enabled() and (xs.requires_grad
                                          or self.rec.requires_grad):
            ys = function.apply(xs, self.rec, lo, hi, self.dtype)
        else:
            ys = scan(xs, self.rec, lo, hi, self.dtype)      # [T, 2B, H]
        fwd = ys[:, :B].transpose(0, 1)                     # [B, T, H]
        bwd = ys.flip(0)[:, B:].transpose(0, 1)
        out = torch.cat([fwd, bwd], dim=-1)
        return out * mask[:, :, None].to(out.dtype)
