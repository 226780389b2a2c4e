"""Conformer blocks (port of ``models/attention.py``: the offline call and
the chunk-causal streaming step): a macaron block is ½FFN → MHSA → conv
module → ½FFN → final LayerNorm over a ``[B, T, d]`` residual stream,
padded frames zeroed on exit.

As in the reference: every dense layer computes in the compute dtype with
fp32 parameters (``rnn.linear``); LayerNorm statistics are fp32, with
flax's epsilon 1e-6 (torch's default is 1e-5) and flax's fast variance;
the residual stream is fp32 or, with ``residual_dtype`` bf16, bf16; RoPE
rotates q and k in fp32 and casts back; the attention scores are fp32
products of the compute-dtype q and k (the einsum upcasts them first:
torch's bf16 einsum would round its output to bf16), masked at padded
keys (and, with ``chunk > 0``, to the chunk-causal pattern) at −1e30,
softmax in fp32, probabilities rounded to the compute dtype before the
value product; the depthwise conv sees
padded frames zeroed and pads ``((k−1)//2, k//2)``, or ``(k−1, 0)`` when
causal (``chunk > 0``); swish is ``F.silu``.

``MHSA`` routes an offline call (``ops/attention_cuda.ROUTED`` counts each
call): ``impl="flash"`` takes ``flash_mhsa`` (the kernels on CUDA tensors,
their plain versions on CPU tensors), ``"einsum"`` the einsum path below
(the reference's XLA path, the model's own torch code), ``"auto"`` the
kernels on a CUDA tensor when ``attention_cuda.supports(T, dh)`` holds
(the reference's gate: T' > 512, its long-form policy, and dh % 64 == 0,
dh <= 512) and the einsum path otherwise.

The streaming step of a chunk-causal block (``chunk > 0``, the
``conformer_stream`` preset; ``decode/streaming.py``) takes one chunk and
the block's carries ``(k_cache, v_cache, conv_tail)``, as the reference's:
q and k rotate at each row's global position ``pos0``; the post-RoPE k and
v of the chunk, in the compute dtype, follow the ``[B, P, h, dh]`` caches
(P = chunk · left_chunks frames); the keys attendable are ``cache_mask ++
mask`` with no pattern mask (the key extent IS the chunk-causal window);
the scores are fp32, masked at −1e30, with the softmax in fp32 and the
probabilities in the compute dtype; the caches roll to the last P keys and
values, padded frames included by position (``cache_mask`` keeps them
unattendable). The depthwise conv runs VALID over ``[tail ++ chunk]`` and
the new tail is the last k − 1 post-GLU, post-mask frames. A streaming
step never takes the flash kernels (``ROUTED`` counts it under
``einsum``), as the reference's streaming step always takes its einsum
path.

Module names mirror the flax tree (``bridge.py``): ``ffn1/{in,out}``,
``ln_ffn1``, ``mhsa/{qkv,out}``, ``ln_mhsa``, ``conv/{pw_in,dw,ln,
pw_out}``, ``ln_conv``, ``ffn2``, ``ln_ffn2``, ``ln_out``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention_cuda import (NEG, ROUTED, chunk_causal_mask,
                                  flash_mhsa, supports)
from .rnn import linear, time_mask

__all__ = ["ConformerBlock", "chunk_causal_mask", "einsum_attention",
           "layer_norm", "rope"]

LN_EPS = 1e-6                    # flax nn.LayerNorm's epsilon


@functools.lru_cache(maxsize=None)
def _rope_freq(half: int, base: float, device: torch.device) -> torch.Tensor:
    """[half] fp32 ``base^(−i/half)``, computed in numpy fp32 as the
    reference computes it."""
    freq = base ** (-np.arange(half, dtype=np.float32) / half)
    return torch.from_numpy(freq.astype(np.float32)).to(device)


def rope(x: torch.Tensor, base: float = 10_000.0,
         pos0: torch.Tensor | None = None) -> torch.Tensor:
    """Rotary position embedding over the last (head) dim of [B, T, h, dh],
    rotate-half layout (channel i pairs with i + dh/2), in fp32, cast back
    to x's dtype. ``pos0`` [B] offsets each row's positions (the
    reference's streaming form); None starts every row at 0."""
    B, T, h, dh = x.shape
    half = dh // 2
    freq = _rope_freq(half, base, x.device)
    pos = torch.arange(T, dtype=torch.float32, device=x.device)
    if pos0 is None:
        ang = (pos[:, None] * freq)[None, :, None, :]       # [1, T, 1, dh/2]
    else:
        pos = pos0.to(torch.float32)[:, None] + pos[None, :]   # [B, T]
        ang = pos[:, :, None, None] * freq                  # [B, T, 1, dh/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=float32)`` as flax computes it: fp32
    statistics with the fast variance E[x²] − E[x]² (clamped at 0),
    epsilon 1e-6, then (x − mean) · (rsqrt(var + eps) · scale) + bias."""
    x = x.to(torch.float32)
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return (x - mean) * (torch.rsqrt(var + LN_EPS) * ln.weight) + ln.bias


def _layer_norm(d: int) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=LN_EPS)


class FFN(nn.Module):
    """Position-wise feed-forward (swish), the macaron half-step."""

    def __init__(self, d: int, mult: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.add_module("in", nn.Linear(d, mult * d))
        self.out = nn.Linear(mult * d, d)

    def forward(self, x):
        h = F.silu(linear(x, getattr(self, "in"), self.dtype))
        return linear(h, self.out, self.dtype)


class ConvModule(nn.Module):
    """GLU pointwise → masked depthwise conv → LN → swish → pointwise."""

    def __init__(self, d: int, kernel: int, dtype: torch.dtype,
                 causal: bool = False):
        super().__init__()
        self.dtype, self.kernel, self.causal = dtype, kernel, causal
        self.pw_in = nn.Linear(d, 2 * d)
        self.dw = nn.Conv1d(d, d, kernel, groups=d)
        self.ln = _layer_norm(d)
        self.pw_out = nn.Linear(d, d)

    def forward(self, x, mask, h_tail=None):
        """Offline → out; streaming (``h_tail`` [B, k−1, d], the previous
        chunk's post-GLU tail) → (out, new_tail)."""
        d = x.shape[-1]
        gates = linear(x, self.pw_in, self.dtype)
        h = gates[..., :d] * torch.sigmoid(gates[..., d:])
        # zero padded frames BEFORE the depthwise conv so padding cannot
        # leak through its receptive field
        h = h * mask[:, :, None].to(h.dtype)
        k = self.kernel
        if h_tail is not None:
            # VALID over [tail ++ chunk]: a zero tail is the causal left pad
            h = torch.cat([h_tail.to(h.dtype), h], dim=1)     # [B, k−1+T, d]
            new_tail = h[:, -(k - 1):]
            pad = (0, 0)
        else:
            pad = (k - 1, 0) if self.causal else ((k - 1) // 2, k // 2)
        h = F.conv1d(F.pad(h.transpose(1, 2), pad),
                     self.dw.weight.to(self.dtype),
                     self.dw.bias.to(self.dtype), groups=d).transpose(1, 2)
        h = F.silu(layer_norm(h, self.ln)).to(self.dtype)
        out = linear(h, self.pw_out, self.dtype)
        return out if h_tail is None else (out, new_tail)


class MHSA(nn.Module):
    """Multi-head self-attention with RoPE and the key-padding mask (and
    the chunk-causal pattern when ``chunk > 0``): the offline call, and
    with ``kv_cache`` the streaming step over one chunk."""

    def __init__(self, d: int, heads: int, dtype: torch.dtype,
                 chunk: int = 0, left_chunks: int = 0, impl: str = "auto"):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.chunk, self.left_chunks, self.impl = chunk, left_chunks, impl
        self.qkv = nn.Linear(d, 3 * d)
        self.out = nn.Linear(d, d)

    def takes_kernel(self, x: torch.Tensor) -> bool:
        T, dh = x.shape[1], x.shape[2] // self.heads
        return self.impl == "flash" or (
            self.impl == "auto" and x.is_cuda and supports(T, dh))

    def forward(self, x, mask, lengths, kv_cache=None, cache_mask=None,
                pos0=None):
        """Offline → out [B, T, d]; streaming (``kv_cache`` = (k, v)
        [B, P, h, dh] in the compute dtype, ``cache_mask`` [B, P] bool,
        ``pos0`` [B] int32) → (out, (new_k, new_v))."""
        B, T, d = x.shape
        h = self.heads
        dh = d // h
        # one fused [B,T,d]@[d,3d] product; q, k, v are views of it
        qkv = linear(x, self.qkv, self.dtype)
        q = qkv[..., :d].reshape(B, T, h, dh)
        k = qkv[..., d:2 * d].reshape(B, T, h, dh)
        v = qkv[..., 2 * d:].reshape(B, T, h, dh)
        q, k = rope(q, pos0=pos0), rope(k, pos0=pos0)
        if kv_cache is not None:
            ROUTED["einsum"] += 1
            P = kv_cache[0].shape[1]
            k_all = torch.cat([kv_cache[0], k.to(self.dtype)], dim=1)
            v_all = torch.cat([kv_cache[1], v.to(self.dtype)], dim=1)
            key_ok = torch.cat([cache_mask, mask], dim=1)    # [B, P + T]
            out = einsum_attention(q, k_all, v_all, key_ok)
            out = linear(out.reshape(B, T, d), self.out, self.dtype)
            return out, (k_all[:, -P:], v_all[:, -P:])
        if self.takes_kernel(x):
            ROUTED["flash"] += 1
            out = flash_mhsa(q, k, v, lengths, self.chunk, self.left_chunks)
        else:
            ROUTED["einsum"] += 1
            out = einsum_attention(q, k, v, mask, self.chunk,
                                   self.left_chunks)
        return linear(out.reshape(B, T, d), self.out, self.dtype)


def einsum_attention(q, k, v, mask, chunk: int = 0, left_chunks: int = 0):
    """The einsum path (the reference's XLA path): [B, T, h, dh] q and
    [B, S, h, dh] k, v in the compute dtype and the [B, S] key mask → [B,
    T, h, dh] in v's dtype, through the [B, h, T, S] fp32 scores (S = T
    offline; the streaming step's S = P + T keys, ``chunk`` 0)."""
    T, dh = q.shape[1], q.shape[-1]
    # fp32 scores of the compute-dtype q and k
    scores = torch.einsum("bthd,bshd->bhts", q.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(dh))
    allowed = mask[:, None, None, :]
    if chunk:
        allowed = allowed & chunk_causal_mask(T, chunk, left_chunks,
                                              q.device)[None, None]
    scores = torch.where(allowed, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class ConformerBlock(nn.Module):
    """One macaron block: [B, T, d] residual stream in, same out (padded
    frames zeroed). A streaming step of a chunk-causal block passes
    ``carries`` (k_cache, v_cache, conv_tail), ``cache_mask`` [B, P] and
    ``pos0`` [B] and gets (out, new carries)."""

    def __init__(self, d: int, heads: int = 4, ff_mult: int = 4,
                 conv_kernel: int = 15, dtype: torch.dtype = torch.bfloat16,
                 chunk: int = 0, left_chunks: int = 0, impl: str = "auto",
                 residual_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.residual_dtype = dtype, residual_dtype
        self.ffn1 = FFN(d, ff_mult, dtype)
        self.ln_ffn1 = _layer_norm(d)
        self.mhsa = MHSA(d, heads, dtype, chunk, left_chunks, impl)
        self.ln_mhsa = _layer_norm(d)
        self.conv = ConvModule(d, conv_kernel, dtype, causal=chunk > 0)
        self.ln_conv = _layer_norm(d)
        self.ffn2 = FFN(d, ff_mult, dtype)
        self.ln_ffn2 = _layer_norm(d)
        self.ln_out = _layer_norm(d)

    def forward(self, x, lengths, carries=None, cache_mask=None, pos0=None):
        stream = carries is not None
        mask = time_mask(x.shape[1], lengths)               # [B, T]
        rdt = self.residual_dtype
        x = x.to(rdt)

        def pre(ln, xx):                 # pre-norm, compute dtype for matmuls
            return layer_norm(xx, ln).to(self.dtype)

        x = x + (0.5 * self.ffn1(pre(self.ln_ffn1, x)).to(torch.float32)
                 ).to(rdt)
        if stream:
            att, new_kv = self.mhsa(pre(self.ln_mhsa, x), mask, lengths,
                                    kv_cache=carries[:2],
                                    cache_mask=cache_mask, pos0=pos0)
        else:
            att = self.mhsa(pre(self.ln_mhsa, x), mask, lengths)
        x = x + att.to(rdt)
        if stream:
            cv, new_tail = self.conv(pre(self.ln_conv, x), mask,
                                     h_tail=carries[2])
        else:
            cv = self.conv(pre(self.ln_conv, x), mask)
        x = x + cv.to(rdt)
        x = x + (0.5 * self.ffn2(pre(self.ln_ffn2, x)).to(torch.float32)
                 ).to(rdt)
        x = layer_norm(x, self.ln_out).to(rdt)
        x = x * mask[:, :, None].to(x.dtype)
        return (x, (*new_kv, new_tail)) if stream else x
