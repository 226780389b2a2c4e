"""Masked bidirectional or forward-only GRU/LSTM layer (port of
``models/rnn.py``: the full-utterance and the streaming call).

As in the reference: the input projections of both directions are hoisted
out of the recurrence (``in_fwd``/``in_bwd``, computed in the compute
dtype); the backward direction is the WHOLE padded time axis reversed
(``[::-1]``), live on the window ``[T-len, T)`` — not a per-utterance
reversal; both directions run as one ``[T, 2B, G·H]`` recurrence
(``ops/rnn_cuda``, G = 3 gates for the GRU, 4 for the LSTM), the backward
half is reversed back, and the output is masked. A forward-only layer
(``bidirectional=False``, the ``uni_gru`` preset) has ``in_fwd`` and
``rec [1, H, G·H]`` only, runs a ``[T, B, G·H]`` recurrence (the kernels'
direction count is ``rec``'s leading extent) and outputs ``[B, T, H]``.

``impl``: "pallas" takes the kernels' wrappers (the kernels on CUDA
tensors, their plain versions on CPU tensors): ``BiGRUScan`` /
``BiLSTMScan`` (the training forward that keeps the residuals, and the
backward kernel) when autograd will differentiate the layer, otherwise the
residual-free forward, as ``birnn_pallas``'s primal-only call skips the
residual streams; on the card it raises for a hidden size the kernels do
not take. "auto" takes the wrappers where the kernels take the hidden size
(``rnn_cuda.kernel_takes``: 32 ≤ H ≤ 512, H % 32 == 0) and the plain scan
elsewhere, as the reference's "auto" takes its scan wherever its kernel's
tiling rule (H % 128 == 0) fails. "scan" takes the plain forward on either
device and lets autograd differentiate it, as the reference's ``lax.scan``
path does. ``rnn_cuda.ROUTED`` counts the path of each layer call.

The streaming call (``h0_fwd``, ``emit_carry_at``) takes the stream form
(``gru_scan_stream``/``lstm_scan_stream``; their plain versions under
"scan"): forward rows seed from ``h0_fwd``, backward rows from zeros at the
window's right edge, and it returns ``(out, h_fwd)``, the forward rows'
state after ``emit_carry_at`` steps, frozen at padding like the reference's
``h_carry``. It is inference only, and so is a forward-only layer: neither
has a backward kernel yet, so both raise under autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.rnn_cuda import (ROUTED, BiGRUScan, BiLSTMScan, gru_scan,
                            gru_scan_plain, gru_scan_stream,
                            gru_scan_stream_plain, kernel_takes, lstm_scan,
                            lstm_scan_plain, lstm_scan_stream,
                            lstm_scan_stream_plain, stream_dtype)

__all__ = ["BiRNNLayer", "linear", "time_mask"]

# cell → (gates, plain forward, inference wrapper, autograd Function,
#         plain stream form, stream wrapper)
_CELLS = {"gru": (3, gru_scan_plain, gru_scan, BiGRUScan,
                  gru_scan_stream_plain, gru_scan_stream),
          "lstm": (4, lstm_scan_plain, lstm_scan, BiLSTMScan,
                   lstm_scan_stream_plain, lstm_scan_stream)}


def time_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    """[B, T] bool validity mask from per-utterance lengths."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype):
    """flax ``nn.Dense(dtype=dtype, param_dtype=float32)``: input, kernel
    and bias cast to the compute dtype."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class BiRNNLayer(nn.Module):
    """One GRU/LSTM layer: [B, T, D] → [B, T, 2H] fp32 (masked), or
    [B, T, H] forward-only."""

    def __init__(self, in_dim: int, hidden: int, cell: str = "gru",
                 dtype: torch.dtype = torch.bfloat16, impl: str = "auto",
                 bidirectional: bool = True):
        super().__init__()
        if cell not in _CELLS:
            raise ValueError(f"rnn cell {cell!r}: expected one of "
                             f"{tuple(_CELLS)}")
        self.hidden = hidden
        self.dtype = dtype
        self.impl = impl
        self.cell = cell
        self.bidirectional = bidirectional
        G = _CELLS[cell][0] * hidden
        self.in_fwd = nn.Linear(in_dim, G)
        if bidirectional:
            self.in_bwd = nn.Linear(in_dim, G)
        self.rec = nn.Parameter(torch.zeros(2 if bidirectional else 1,
                                            hidden, G))

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                h0_fwd=None, emit_carry_at=None):
        """Full-utterance call → out; streaming call (``h0_fwd`` [B, C] and
        ``emit_carry_at``, C = H for the GRU, 2H = h‖c for the LSTM) →
        (out, h_fwd [B, C])."""
        if (h0_fwd is None) != (emit_carry_at is None):
            raise ValueError("h0_fwd and emit_carry_at must be passed together")
        stream = emit_carry_at is not None
        B, T, _ = x.shape
        mask = time_mask(T, lengths)                        # [B, T]
        sdt = stream_dtype(self.dtype)
        xs = linear(x, self.in_fwd, self.dtype).transpose(0, 1)  # [T,B,GH]
        lens_f = lengths.to(torch.float32)
        lo, hi = torch.zeros_like(lens_f), lens_f
        if self.bidirectional:
            xb = linear(x, self.in_bwd, self.dtype).transpose(0, 1).flip(0)
            xs = torch.cat([xs, xb], dim=1)                 # [T, 2B, GH]
            lo = torch.cat([lo, T - lens_f])
            hi = torch.cat([hi, torch.full_like(lens_f, T)])
        xs = xs.to(sdt).contiguous()
        lo, hi = lo[:, None], hi[:, None]
        _, plain, scan, function, stream_plain, stream_scan = \
            _CELLS[self.cell]
        use_scan = self.impl == "scan" or (
            self.impl == "auto" and not kernel_takes(self.hidden))
        ROUTED["scan" if use_scan else "kernel"] += 1
        if torch.is_grad_enabled() and (xs.requires_grad
                                        or self.rec.requires_grad):
            if stream or not self.bidirectional:
                raise NotImplementedError(
                    "streaming calls and forward-only layers are inference "
                    "only: their training forward and backward (ndir = 1) "
                    "are not ported yet (ROADMAP.md, module queue: "
                    "forward-only training)")
            ys = (plain if use_scan else function.apply)(
                xs, self.rec, lo, hi, self.dtype)
        elif stream:
            h0 = h0_fwd.to(torch.float32)                   # [B, C]
            if self.bidirectional:
                h0 = torch.cat([h0, torch.zeros_like(h0)])
            ys, carry = (stream_plain if use_scan else stream_scan)(
                xs, self.rec, lo, hi, h0, self.dtype, emit_carry_at)
        else:
            ys = (plain if use_scan else scan)(
                xs, self.rec, lo, hi, self.dtype)          # [T, ndir·B, H]
        out = ys[:, :B].transpose(0, 1)                     # [B, T, H]
        if self.bidirectional:
            out = torch.cat([out, ys.flip(0)[:, B:].transpose(0, 1)], dim=-1)
        out = out * mask[:, :, None].to(out.dtype)
        return (out, carry[:B]) if stream else out
