"""Acoustic model assembly (port of ``models/presets.py``): conv
subsampler → GLU-gated residual conv blocks (``glu_conv``) → optional
``attn_in`` projection and Conformer blocks →
BiGRU, BiLSTM or forward-only GRU/LSTM stack → optional tanh ``proj`` →
fp32 ``output`` projection → logits masked by the subsampled lengths.

``forward(feats [B,T,F,3], frame_lengths) → (logits [B,T',V] fp32, lens)``
with V including the CTC blank at index 0. The streaming call
(``rnn_carries``, ``carry_at``, ``drop_left`` → ``(logits, lens,
new_carries)``) and its helpers (``subsample_factor``,
``init_stream_carries``, ``reset_stream_rows``, ``conv_receptive_margin``,
``conv_right_margin``) serve ``decode/streaming.py``; a conv-only model
(``tiny_conv``, ``glu_conv``) streams with no carries. A chunk-causal
attention model (``conformer_stream``,
``attn_chunk > 0``) streams on the reference's carries: ``[pos0,
total_valid, seg_start]`` ([B] int32: each row's global subsampled index of
the window's first frame, the frames fed so far, the first frame of the
open utterance) and each block's ``[k_cache, v_cache, conv_tail]``, ahead
of the RNN states; a global-attention model (``conformer``) refuses to
stream, as in the reference.

The port's state_dict names mirror the flax tree (``bridge.py`` maps one
onto the other): ``subsampler.conv{i}`` ≘ ``ConvSubsampler_0/conv{i}``,
``glu{i}.{glu_conv,res_proj}``, ``attn_in``, ``conformer{i}.*``
(``models/attention.py``),
``birnn{i}.{in_fwd,in_bwd,rec}``, ``proj``, ``output``.

``init_parameters`` draws a fresh model's weights from flax's default
distributions (``train/state.py::init_state``): ``lecun_normal`` kernels
(dense, conv, GLU conv, depthwise conv), zero biases, unit LayerNorm scales,
``orthogonal`` recurrent weights. The numbers are torch's, not JAX's (the
two generators differ); tests that compare the packages inject the same
weights through ``bridge.py``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import constants as C
from ..config import ModelConfig
from .attention import ConformerBlock
from .conv import ConvSubsampler, GLUConvBlock, conv_out_features
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
        exact_fp32_on_cuda()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.compute_dtype)
        self.subsampler = ConvSubsampler(
            C.N_FEATURE_CHANNELS, cfg.conv_channels, cfg.conv_kernel,
            cfg.conv_stride_time, cfg.conv_stride_freq, self.dtype)
        dim = (conv_out_features(C.N_MELS, cfg.conv_stride_freq)
               * cfg.conv_channels[-1])
        self.n_glu = cfg.glu_blocks
        for i in range(self.n_glu):
            self.add_module(f"glu{i}", GLUConvBlock(dim, cfg.glu_channels,
                                                    self.dtype))
            dim = cfg.glu_channels
        self.n_attn = cfg.attn_blocks
        if self.n_attn:
            self.attn_in = (nn.Linear(dim, cfg.attn_dim)
                            if dim != cfg.attn_dim else None)
            for i in range(self.n_attn):
                self.add_module(f"conformer{i}", ConformerBlock(
                    cfg.attn_dim, heads=cfg.attn_heads,
                    ff_mult=cfg.attn_ff_mult,
                    conv_kernel=cfg.attn_conv_kernel, dtype=self.dtype,
                    chunk=cfg.attn_chunk, left_chunks=cfg.attn_left_chunks,
                    impl=cfg.attn_impl,
                    residual_dtype=torch_dtype(cfg.attn_residual_dtype)))
            dim = cfg.attn_dim
        self.n_rnn = cfg.rnn_layers if cfg.rnn_type != "none" else 0
        for i in range(self.n_rnn):
            self.add_module(f"birnn{i}", BiRNNLayer(
                dim, cfg.rnn_hidden, cell=cfg.rnn_type, dtype=self.dtype,
                impl=cfg.rnn_impl, bidirectional=cfg.rnn_bidirectional))
            dim = (2 if cfg.rnn_bidirectional else 1) * cfg.rnn_hidden
        self.proj = nn.Linear(dim, cfg.proj_dim) if cfg.proj_dim else None
        self.output = nn.Linear(cfg.proj_dim or dim, cfg.vocab_size)

    def forward(self, feats: torch.Tensor, lengths: torch.Tensor,
                rnn_carries=None, carry_at: int | None = None,
                drop_left: int = 0):
        """Full-utterance call → (logits, lens). Streaming call
        (decode/streaming.py): ``rnn_carries`` holds the flat stream state
        carried from the previous chunk (``init_stream_carries``' layout;
        [] for conv-only models), ``carry_at`` the chunk length in
        subsampled frames and ``drop_left`` the subsampled left-margin
        frames to drop after the conv stack → (logits, lens,
        new_carries)."""
        cfg = self.cfg
        stream = rnn_carries is not None
        if stream and carry_at is None:
            raise ValueError("streaming call needs carry_at")
        if stream and self.n_attn and not cfg.attn_chunk:
            # full self-attention has a global receptive field: a chunked
            # call cannot reproduce the offline computation
            raise ValueError(
                "global-attention presets do not support streaming "
                "calls; train a chunk-causal preset (attn_chunk > 0, "
                "e.g. conformer_stream) to serve attention online")
        x, lens = self.subsampler(feats, lengths)
        for i in range(self.n_glu):
            x = getattr(self, f"glu{i}")(x, lens)
        if drop_left:
            x = x[:, drop_left:]
            lens = torch.clamp(lens - drop_left, min=0)
        new_carries = []
        rnn_off = 0
        if self.n_attn:
            if self.attn_in is not None:
                x = linear(x, self.attn_in, self.dtype)
            cache_mask = pos0 = None
            if stream:
                # a cached key slot is attendable iff its global position
                # has been fed real audio (< total_valid) and lies in the
                # open utterance (>= seg_start); padded frames' k/v enter
                # the rolled cache by position but are never attended
                P = cfg.attn_chunk * cfg.attn_left_chunks
                pos0, total_valid, seg_start = rnn_carries[:3]
                kpos = (pos0[:, None] - P + torch.arange(
                    P, dtype=torch.int32, device=pos0.device)[None, :])
                cache_mask = ((kpos >= 0) & (kpos >= seg_start[:, None])
                              & (kpos < total_valid[:, None]))
                new_carries += [pos0 + cfg.attn_chunk,
                                total_valid + lens.to(torch.int32),
                                seg_start]
                rnn_off = 3 + 3 * self.n_attn
            for i in range(self.n_attn):
                block = getattr(self, f"conformer{i}")
                if stream:
                    x, blk = block(x, lens,
                                   carries=rnn_carries[3 + 3 * i:6 + 3 * i],
                                   cache_mask=cache_mask, pos0=pos0)
                    new_carries += list(blk)
                else:
                    x = block(x, lens)
        for i in range(self.n_rnn):
            layer = getattr(self, f"birnn{i}")
            if stream:
                x, h = layer(x, lens, h0_fwd=rnn_carries[rnn_off + i],
                             emit_carry_at=carry_at)
                new_carries.append(h)
            else:
                x = layer(x, lens)
        if self.proj is not None:
            x = torch.tanh(linear(x, self.proj, self.dtype))
        # fp32 logits: CTC math is fp32
        logits = linear(x, self.output, torch.float32)
        mask = time_mask(logits.shape[1], lens)
        logits = logits * mask[:, :, None]
        if stream:
            return logits, lens, new_carries
        return logits, lens

    def subsample_factor(self) -> int:
        f = 1
        for s in self.cfg.conv_stride_time:
            f *= s
        return f

    def init_stream_carries(self, batch: int) -> list:
        """Zero stream state for a fresh stream, a flat list on the model's
        device: a chunk-causal attention model's carries first (``[pos0,
        total_valid, seg_start]`` [batch] int32, then for each block
        ``[k_cache, v_cache]`` [batch, P, heads, dh] and ``conv_tail``
        [batch, k − 1, d] in the compute dtype, P = attn_chunk ·
        attn_left_chunks), then one forward-direction state [batch, H]
        (GRU) or [batch, 2H] (LSTM h‖c) fp32 per RNN layer; [] for
        conv-only models."""
        cfg = self.cfg
        dev = self.output.weight.device
        carries: list = []
        if self.n_attn and cfg.attn_chunk:
            if cfg.attn_left_chunks < 1:
                raise ValueError("attn_chunk > 0 needs attn_left_chunks >= 1")
            P = cfg.attn_chunk * cfg.attn_left_chunks
            dh = cfg.attn_dim // cfg.attn_heads
            carries += [torch.zeros((batch,), dtype=torch.int32, device=dev)
                        for _ in range(3)]
            for _ in range(self.n_attn):
                carries += [
                    torch.zeros((batch, P, cfg.attn_heads, dh),
                                dtype=self.dtype, device=dev),       # k
                    torch.zeros((batch, P, cfg.attn_heads, dh),
                                dtype=self.dtype, device=dev),       # v
                    torch.zeros((batch, cfg.attn_conv_kernel - 1,
                                 cfg.attn_dim), dtype=self.dtype,
                                device=dev)]                          # conv
        dim = cfg.rnn_hidden * (2 if cfg.rnn_type == "lstm" else 1)
        carries += [torch.zeros((batch, dim), dtype=torch.float32, device=dev)
                    for _ in range(self.n_rnn)]
        return carries

    def reset_stream_rows(self, carries: list, rows) -> list:
        """Endpoint reset (decode/streaming.py): a fresh utterance starts
        on ``rows``; other streams keep their state. RNN states and the
        causal-conv tails return to zero (the offline left edge); the KV
        caches stay, and ``seg_start`` advances to the frames already fed,
        so the keys before the boundary become unattendable. ``pos0`` and
        ``total_valid`` keep counting: RoPE scores depend only on relative
        offsets."""
        out = list(carries)
        off = 0
        if self.n_attn and self.cfg.attn_chunk:
            seg_start = carries[2].clone()
            seg_start[rows] = carries[1][rows]
            out[2] = seg_start
            for i in range(self.n_attn):
                j = 3 + 3 * i + 2                       # conv_tail
                out[j] = carries[j].clone()
                out[j][rows] = 0
            off = 3 + 3 * self.n_attn
        for i in range(off, len(carries)):
            out[i] = carries[i].clone()
            out[i][rows] = 0.0
        return out

    def conv_receptive_margin(self) -> int:
        """Input-frame margin that fully covers the conv (+GLU) stack's
        one-sided receptive field: window-edge conv outputs farther than
        this many INPUT frames from the edge equal the full-utterance
        computation (decode/streaming.py's left-margin floor)."""
        cfg = self.cfg
        kt = cfg.conv_kernel[0]
        rf, jump = 1, 1                    # receptive field, input stride
        for st in cfg.conv_stride_time:
            rf += (kt - 1) * jump
            jump *= st
        # the GLU blocks run at the subsampled rate; their extent comes
        # from the module's kernel_time, so the two cannot drift apart
        rf += cfg.glu_blocks * (GLUConvBlock.kernel_time - 1) * jump
        return (rf - 1) // 2 + 1

    def conv_right_margin(self) -> int:
        """INPUT frames of real future context past a chunk's emit region
        that the emitted conv outputs need to equal the full-utterance
        computation (``stream_geometry``'s ``conv_exact``): with the
        stack's ((k−1)//2, k//2) padding the last emitted output reaches
        ``max(0, O − S + 1)`` frames past the emit region, O = Σᵢ
        (kᵢ//2)·Jᵢ (Jᵢ the input jump at layer i, S the total stride); 0
        for the plain subsampling stacks, 48 for ``glu_conv`` (6 stride-1
        GLU blocks of time-kernel 5 at jump 4)."""
        cfg = self.cfg
        kt = cfg.conv_kernel[0]
        off, jump = 0, 1
        for st in cfg.conv_stride_time:
            off += (kt // 2) * jump
            jump *= st
        off += cfg.glu_blocks * (GLUConvBlock.kernel_time // 2) * jump
        return max(0, off - jump + 1)


def build_model(cfg: ModelConfig) -> AcousticModel:
    return AcousticModel(cfg)


# stddev of a standard normal truncated to (-2, 2)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(t: torch.Tensor, fan_in: int, gen: torch.Generator):
    """flax ``lecun_normal``: truncated normal on (-2, 2), scaled to
    variance 1/fan_in."""
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    t.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def _orthogonal_(t: torch.Tensor, gen: torch.Generator):
    """jax ``orthogonal()`` with ``column_axis=-1``: the tensor viewed as a
    [numel/cols, cols] matrix has orthonormal rows or columns (whichever
    side is smaller)."""
    cols = t.shape[-1]
    rows = t.numel() // cols
    a = torch.randn(max(rows, cols), min(rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    t.copy_(q.reshape(t.shape))


@torch.no_grad()
def init_parameters(model: nn.Module, seed: int) -> None:
    """Draw every parameter from flax's default initializers, with a
    ``torch.Generator`` seeded by ``seed`` (``train.seed``)."""
    gen = torch.Generator().manual_seed(seed)
    ln_scales = {f"{m}.weight" for m, mod in model.named_modules()
                 if isinstance(mod, nn.LayerNorm)}
    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        elif name in ln_scales:
            p.fill_(1.0)
        elif name.endswith(".rec"):
            _orthogonal_(p, gen)
        elif p.dim() in (2, 3, 4):
            # Linear [out, in], depthwise Conv1d [d, 1, kt] (flax's [kt, 1,
            # d]: fan_in kt), GLU Conv1d [2C, D, kt] (flax's [kt, D, 2C]:
            # fan_in kt·D), Conv2d [out, in, kt, kf]
            _lecun_normal_(p, p[0].numel(), gen)
        else:
            raise KeyError(f"init_parameters: no rule for {name} "
                           f"{tuple(p.shape)}")
