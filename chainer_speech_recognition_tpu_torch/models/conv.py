"""Strided 2-D conv subsampling stack (port of ``models/conv.py``).

Layout and padding follow the flax module exactly:

* explicit ``((k-1)//2, k//2)`` padding per axis, asymmetric for even
  kernels — ``F.pad`` then a conv with ``padding=0`` (the symmetric
  ``padding=`` argument of ``nn.Conv2d`` would shift every output frame);
* the time mask after every layer;
* the output flattens NHWC ``[B, T, F, C] → [B, T, F·C]`` (F major, C
  minor), so torch's NCHW result is permuted back before the reshape.

``GLUConvBlock`` is not on the ported path yet (see ROADMAP.md).
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
