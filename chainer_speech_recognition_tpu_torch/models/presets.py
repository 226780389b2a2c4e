"""Acoustic model assembly (port of ``models/presets.py``'s full-utterance
call): conv subsampler → BiGRU stack → optional tanh ``proj`` → fp32
``output`` projection → logits masked by the subsampled lengths.

``forward(feats [B,T,F,3], frame_lengths) → (logits [B,T',V] fp32, lens)``
with V including the CTC blank at index 0. GLU blocks, attention blocks
and the streaming call are not ported yet and raise.

The port's state_dict names mirror the flax tree (``bridge.py`` maps one
onto the other): ``subsampler.conv{i}`` ≘ ``ConvSubsampler_0/conv{i}``,
``birnn{i}.{in_fwd,in_bwd,rec}``, ``proj``, ``output``.
"""

from __future__ import annotations

import torch
from torch import nn

from chainer_speech_recognition_tpu import constants as C
from chainer_speech_recognition_tpu.config import ModelConfig

from .conv import ConvSubsampler, conv_out_features
from .rnn import BiRNNLayer, linear, time_mask

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"compute dtype {name!r}: expected one of "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[name]


def exact_fp32_on_cuda() -> None:
    """fp32 convolutions default to TF32 under cuDNN; the port holds fp32
    compute to fp32 (matmuls already are, by default), as the reference
    does with HIGHEST precision."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class AcousticModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.glu_blocks or cfg.attn_blocks:
            raise NotImplementedError(
                "GLU and attention blocks are not ported yet (ROADMAP.md, "
                "module queue: the GLU conv block and the attention family)")
        exact_fp32_on_cuda()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.subsampler = ConvSubsampler(
            C.N_FEATURE_CHANNELS, cfg.conv_channels, cfg.conv_kernel,
            cfg.conv_stride_time, cfg.conv_stride_freq, self.dtype)
        dim = (conv_out_features(C.N_MELS, cfg.conv_stride_freq)
               * cfg.conv_channels[-1])
        self.n_rnn = cfg.rnn_layers if cfg.rnn_type != "none" else 0
        for i in range(self.n_rnn):
            self.add_module(f"birnn{i}", BiRNNLayer(
                dim, cfg.rnn_hidden, cell=cfg.rnn_type, dtype=self.dtype,
                impl=cfg.rnn_impl, bidirectional=cfg.rnn_bidirectional))
            dim = 2 * cfg.rnn_hidden
        self.proj = nn.Linear(dim, cfg.proj_dim) if cfg.proj_dim else None
        self.output = nn.Linear(cfg.proj_dim or dim, cfg.vocab_size)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                rnn_carries=None):
        if rnn_carries is not None:
            raise NotImplementedError(
                "streaming AcousticModel calls are not ported yet "
                "(ROADMAP.md, module queue: streaming)")
        x, lens = self.subsampler(feats, lengths)
        for i in range(self.n_rnn):
            x = getattr(self, f"birnn{i}")(x, lens)
        if self.proj is not None:
            x = torch.tanh(linear(x, self.proj, self.dtype))
        # fp32 logits: CTC math is fp32
        logits = linear(x, self.output, torch.float32)
        mask = time_mask(logits.shape[1], lens)
        return logits * mask[:, :, None], lens


def build_model(cfg: ModelConfig) -> AcousticModel:
    return AcousticModel(cfg)
