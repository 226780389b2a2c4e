"""Strided 2-D conv subsampling stack and the GLU-gated residual conv
block (port of ``models/conv.py``).

Layout and padding follow the flax modules exactly:

* explicit ``((k-1)//2, k//2)`` padding per axis, asymmetric for even
  kernels — ``F.pad`` then a conv with ``padding=0`` (the symmetric
  ``padding=`` argument of ``nn.Conv2d`` would shift every output frame);
* the time mask after every layer;
* the subsampler's output flattens NHWC ``[B, T, F, C] → [B, T, F·C]`` (F
  major, C minor), so torch's NCHW result is permuted back before the
  reshape;
* compute in the model's dtype on fp32 parameters (flax's ``dtype`` /
  ``param_dtype``): input, kernel and bias cast before each product.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def conv_out_length(lengths: torch.Tensor, stride: int) -> torch.Tensor:
    """ceil(len / stride) — the explicit-pad strided conv output size."""
    return -(-lengths // stride)


def conv_out_features(n: int, strides) -> int:
    for s in strides:
        n = math.ceil(n / s)
    return n


class ConvSubsampler(nn.Module):
    """[B, T, F, C] compute-dtype features, [B] lengths →
    ([B, T', F'·C'], [B] subsampled lengths)."""

    def __init__(self, in_channels: int, channels, kernel, stride_time,
                 stride_freq, dtype: torch.dtype):
        super().__init__()
        kt, kf = kernel
        self.dtype = dtype
        self.stride_time = tuple(stride_time)
        # F.pad order: (freq left, freq right, time top, time bottom)
        self.pad = ((kf - 1) // 2, kf // 2, (kt - 1) // 2, kt // 2)
        self.n_layers = len(channels)
        cin = in_channels
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv2d(
                cin, ch, (kt, kf), stride=(stride_time[i], stride_freq[i]),
                padding=0))
            cin = ch

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        x = x.to(self.dtype).permute(0, 3, 1, 2)           # [B, C, T, F]
        for i in range(self.n_layers):
            conv = getattr(self, f"conv{i}")
            x = F.conv2d(F.pad(x, self.pad), conv.weight.to(self.dtype),
                         conv.bias.to(self.dtype), stride=conv.stride)
            x = torch.relu(x)
            lengths = conv_out_length(lengths, self.stride_time[i])
            tmask = (torch.arange(x.shape[2], device=x.device)[None, :]
                     < lengths[:, None])
            x = x * tmask[:, None, :, None].to(x.dtype)
        B, C, T, Fq = x.shape
        return x.permute(0, 2, 3, 1).reshape(B, T, Fq * C), lengths


class GLUConvBlock(nn.Module):
    """GLU-gated residual 1-D conv over time (the reference's
    ``GLUConvBlock``, the ``glu_conv`` preset's blocks): ``[B, T, D]``
    compute-dtype frames, ``[B]`` lengths → ``[B, T, C]``; ``(a, b)`` =
    the ``glu_conv`` Conv1d (D → 2C, ``kernel_time`` frames, explicit
    ``((kt−1)//2, kt//2)`` padding) split on channels, ``y = x' + a ·
    sigmoid(b)`` in the compute dtype with ``x'`` = x, or its ``res_proj``
    Linear where D ≠ C, then the time mask."""

    kernel_time = 5

    def __init__(self, in_dim: int, channels: int, dtype: torch.dtype):
        super().__init__()
        self.channels, self.dtype = channels, dtype
        kt = self.kernel_time
        self.pad = ((kt - 1) // 2, kt // 2)
        self.glu_conv = nn.Conv1d(in_dim, 2 * channels, kt, padding=0)
        self.res_proj = (nn.Linear(in_dim, channels) if in_dim != channels
                         else None)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt)
        gates = F.conv1d(F.pad(x.transpose(1, 2), self.pad),
                         self.glu_conv.weight.to(dt),
                         self.glu_conv.bias.to(dt)).transpose(1, 2)
        a, b = gates[..., :self.channels], gates[..., self.channels:]
        h = a * torch.sigmoid(b)
        if self.res_proj is not None:
            x = F.linear(x, self.res_proj.weight.to(dt),
                         self.res_proj.bias.to(dt))
        y = x + h
        tmask = (torch.arange(y.shape[1], device=y.device)[None, :]
                 < lengths[:, None])
        return y * tmask[:, :, None].to(y.dtype)
