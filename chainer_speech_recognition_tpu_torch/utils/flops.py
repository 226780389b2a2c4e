"""Analytic model-FLOPs accounting for MFU reporting (port of
``utils/flops.py``), and the datasheet peaks of the cards the port runs on.

Counts matmul/conv MACs×2 of the acoustic model forward pass at a bucket's
PADDED shapes (what the card actually executes); the train step is taken as
3× forward (backward ≈ 2× forward for matmul-dominated graphs). The DFT/mel
front-end and the CTC recursion are excluded — they are <5% of model FLOPs
at contract shapes; MFU here therefore slightly UNDER-counts true device
work (conservative). The counts are the reference's, term for term (a
recurrent layer counts both directions, as the reference counts it).

``CARDS`` maps a card's name as ``torch.cuda.get_device_name()`` gives it
to its dense peaks from the vendor's datasheet: bf16 and fp32 TFLOP/s and
the device memory's TB/s. The H100 SXM's (989, 67, 3.35) are the figures
every bound in PERF.md and ``chip_smoke.bound`` use. A name the table does
not hold gives None, never a guess; no TPU figure applies to the port.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .. import constants as C
from ..config import ModelConfig


@dataclass(frozen=True)
class CardPeaks:
    bf16_tflops: float     # dense tensor-core peak
    fp32_tflops: float     # outside the tensor cores
    hbm_tbs: float         # device memory, TB/s


H100_SXM = "NVIDIA H100 80GB HBM3"
CARDS = {
    H100_SXM: CardPeaks(989.0, 67.0, 3.35),
    "NVIDIA H100 PCIe": CardPeaks(756.5, 51.0, 2.0),
    "NVIDIA H200": CardPeaks(989.0, 67.0, 4.8),
    "NVIDIA A100-SXM4-80GB": CardPeaks(312.0, 19.5, 2.039),
}


def card_peaks(device_name: str) -> CardPeaks | None:
    """The datasheet peaks of the card named exactly ``device_name``."""
    return CARDS.get(device_name)


def peak_tflops(device_kind: str) -> float | None:
    """bf16 peak TFLOP/s of one card, by its ``get_device_name()``."""
    peaks = card_peaks(device_kind)
    return None if peaks is None else peaks.bf16_tflops


def forward_flops_per_utt(cfg: ModelConfig, frames: int,
                          n_mels: int = C.N_MELS,
                          channels: int = C.N_FEATURE_CHANNELS) -> float:
    """Matmul FLOPs of one forward pass on one padded utterance."""
    t, f = frames, n_mels
    cin = channels
    kt, kf = cfg.conv_kernel
    total = 0.0
    for i, ch in enumerate(cfg.conv_channels):
        t = -(-t // cfg.conv_stride_time[i])
        f = -(-f // cfg.conv_stride_freq[i])
        total += 2.0 * t * f * ch * (cin * kt * kf)
        cin = ch
    d = f * cin                                   # flattened conv output dim

    for i in range(cfg.glu_blocks):
        ch = cfg.glu_channels
        total += 2.0 * t * (2 * ch) * (d * 5)     # GLU gate conv (kt=5)
        if d != ch:
            total += 2.0 * t * ch * d             # residual projection
        d = ch

    if cfg.attn_blocks:
        dm = cfg.attn_dim
        if d != dm:
            total += 2.0 * t * d * dm             # attn_in projection
        per_block = 4 * 2.0 * t * dm * dm         # q,k,v,out projections
        # chunk-causal attention bounds each query's key extent to its own
        # chunk + attn_left_chunks cached chunks; global attention sees t
        keys = (min(t, cfg.attn_chunk * (cfg.attn_left_chunks + 1))
                if cfg.attn_chunk else t)
        per_block += 2 * 2.0 * t * keys * dm      # scores + value einsums
        per_block += 2 * 2 * 2.0 * t * dm * (cfg.attn_ff_mult * dm)  # 2 FFNs
        per_block += 2.0 * t * dm * 2 * dm        # conv module pw_in (GLU)
        per_block += 2.0 * t * dm * dm            # conv module pw_out
        total += cfg.attn_blocks * per_block      # (depthwise conv ~0)
        d = dm

    if cfg.rnn_type != "none":
        gates = {"gru": 3, "lstm": 4}[cfg.rnn_type]
        h = cfg.rnn_hidden
        for i in range(cfg.rnn_layers):
            per_dir = 2.0 * t * (d * gates * h)   # hoisted input projection
            per_dir += 2.0 * t * (h * gates * h)  # recurrent matmul
            total += 2 * per_dir                  # both directions
            d = 2 * h

    if cfg.proj_dim:
        total += 2.0 * t * d * cfg.proj_dim
        d = cfg.proj_dim
    total += 2.0 * t * d * cfg.vocab_size
    return total


def train_flops_per_utt(cfg: ModelConfig, frames: int) -> float:
    return 3.0 * forward_flops_per_utt(cfg, frames)


def mfu(flops_per_sec_per_chip: float, device_kind: str) -> float | None:
    """Model FLOP/s of one card over its bf16 peak; None for a card the
    table does not hold or a rate that is not finite."""
    peak = peak_tflops(device_kind)
    if peak is None or not math.isfinite(flops_per_sec_per_chip):
        return None
    return flops_per_sec_per_chip / (peak * 1e12)
