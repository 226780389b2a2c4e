"""Per-component roofline model for the Conformer block (port of
``utils/roofline.py``), on a card's peaks.

Counts, per ConformerBlock forward at a padded [B, T, d] shape, every
MATERIALIZED tensor (GEMM/conv operands and outputs, softmax scores, LN
inputs/outputs, residual reads/writes) under the stated fusion
assumptions, and every matmul FLOP. Each component's time lower bound is
max(flop_time, byte_time) on the card's peaks; components execute
serially, so the block bound is the sum. The backward is modeled as 2×
forward FLOPs and 2× forward bytes (each GEMM gets two transposed
siblings; each materialized activation is re-read once and its cotangent
written once) — the standard matmul-dominated approximation, the same one
utils/flops.py's 3×-forward train count uses.

Fusion assumptions (conservative TOWARD the compiler — fewer bytes than
a naive op-by-op count):
* elementwise chains (swish, GLU sigmoid·mul, scale, mask, residual add)
  fuse into the neighboring GEMM/LN kernel: no extra round trip;
* LayerNorm reads its input once and writes its output once;
* GEMM weights are negligible (d² ≪ B·T·d at these shapes);
* the [B,h,T,T] score tensor materializes twice on the einsum path
  (fp32 write + read by softmax, bf16 probs write + read by the value
  GEMM) — exactly what the flash kernel removes.

The peaks are parameters (bf16 TFLOP/s, GB/s): by default the entry of
``utils/flops.CARDS`` for the card this process runs on, or the H100
SXM's where there is no card (the card the port is measured on). The
reference's component counts are kept; its hard-coded TPU peaks are not.

Run:  python -m chainer_speech_recognition_tpu_torch.utils.roofline
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .flops import CARDS, H100_SXM, card_peaks

BF16 = 2
FP32 = 4


def default_card() -> str:
    """The name of this process's card, or the H100 SXM's without one."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() \
        else H100_SXM


def resolve_peaks(peak_tflops: float | None = None,
                  bw_gbs: float | None = None,
                  card: str | None = None) -> tuple[float, float, str]:
    """(bf16 TFLOP/s, GB/s, label): the given peaks, else ``card``'s (or
    ``default_card()``'s) datasheet entry; raises for a card the table
    does not hold."""
    card = card or default_card()
    if peak_tflops is None or bw_gbs is None:
        peaks = card_peaks(card)
        if peaks is None:
            raise ValueError(f"no datasheet peaks for {card!r} (known: "
                             f"{sorted(CARDS)}): pass peak_tflops and bw_gbs")
        peak_tflops = peak_tflops if peak_tflops is not None \
            else peaks.bf16_tflops
        bw_gbs = bw_gbs if bw_gbs is not None else peaks.hbm_tbs * 1e3
    return peak_tflops, bw_gbs, card


@dataclass
class Component:
    name: str
    flops: float          # forward matmul FLOPs
    bytes_: float         # forward materialized HBM bytes

    def time_us(self, peak_tflops: float, bw_gbs: float) -> float:
        return max(self.flops / (peak_tflops * 1e12),
                   self.bytes_ / (bw_gbs * 1e9)) * 1e6

    def bound(self, peak_tflops: float | None = None,
              bw_gbs: float | None = None) -> str:
        """"bytes" where moving the bytes takes longer than the FLOPs at
        these peaks, else "operations"."""
        peak_tflops, bw_gbs, _ = resolve_peaks(peak_tflops, bw_gbs)
        return ("bytes" if self.bytes_ / (bw_gbs * 1e9)
                > self.flops / (peak_tflops * 1e12) else "operations")


def conformer_block_components(B: int, T: int, d: int, heads: int = 4,
                               ff_mult: int = 4,
                               residual_bytes: int = BF16,
                               flash: bool = False) -> list[Component]:
    S = B * T * d                       # stream elements
    rb = residual_bytes
    comps = []
    # 4 pre-LNs + final LN: read stream (rb), write bf16 matmul input
    comps.append(Component("5 x LayerNorm", 0.0, 5 * S * (rb + BF16)))
    # 4 residual adds: read x + read branch + write x (branch read often
    # fuses into the producing GEMM epilogue — counted there as write)
    comps.append(Component("4 x residual add", 0.0, 4 * S * (rb + rb)))
    # macaron FFN pair: in-GEMM (d->ff*d), out-GEMM (ff*d->d) each
    f = ff_mult
    ffn_flops = 2 * (2.0 * S * f * d + 2.0 * S * f * d)
    ffn_bytes = 2 * (S * BF16            # read ln out
                     + f * S * BF16 * 2  # hidden write + read (swish fused)
                     + S * BF16)         # out write (residual add fused)
    comps.append(Component("2 x FFN (x%d)" % f, ffn_flops, ffn_bytes))
    # attention: fused qkv GEMM + out GEMM
    comps.append(Component("QKV+out GEMMs", 2.0 * S * d * 4,
                           S * BF16 * (1 + 3 + 1 + 1)))
    if flash:
        # flash: q,k,v read + out write; nothing quadratic
        comps.append(Component("flash attention", 2 * 2.0 * B * T * T * d,
                               4 * S * BF16))
    else:
        sc = B * heads * T * T
        comps.append(Component("score+value einsums + softmax",
                               2 * 2.0 * B * T * T * d,
                               3 * S * BF16        # q,k,v reads
                               + sc * FP32 * 2     # scores write+read (fp32)
                               + sc * BF16 * 2     # probs write+read
                               + S * BF16))        # out write
    # conv module: pw_in GLU (d->2d), depthwise (bytes only), LN, pw_out
    comps.append(Component(
        "conv module", 2.0 * S * 2 * d + 2.0 * S * d,
        S * BF16 + 2 * S * BF16 * 2      # ln read + gates write/read
        + S * BF16 * 2                   # dw out write + read
        + S * (FP32 + BF16)              # conv LN (fp32 out per module)
        + S * BF16))
    return comps


def report(B=64, T=256, d=256, blocks=8, residual_bytes=BF16, flash=False,
           peak_tflops=None, bw_gbs=None, measured_block_ms=None,
           card=None):
    """Print the block's components and bounds on the card's peaks (or
    the ones given); → the fwd+bwd bound of ``blocks`` blocks, ms."""
    peak_tflops, bw_gbs, card = resolve_peaks(peak_tflops, bw_gbs, card)
    comps = conformer_block_components(B, T, d, residual_bytes=residual_bytes,
                                       flash=flash)
    print(f"Conformer block roofline @ B={B} T'={T} d={d} "
          f"residual={'bf16' if residual_bytes == BF16 else 'fp32'} "
          f"attn={'flash' if flash else 'einsum'} "
          f"({card}: {peak_tflops} TF bf16, {bw_gbs} GB/s)")
    print(f"{'component':34s} {'GFLOP':>7s} {'MB':>7s} {'us(fwd)':>8s} bound")
    tot_t = tot_f = tot_b = 0.0
    for c in comps:
        t = c.time_us(peak_tflops, bw_gbs)
        tot_t += t
        tot_f += c.flops
        tot_b += c.bytes_
        print(f"{c.name:34s} {c.flops/1e9:7.2f} {c.bytes_/1e6:7.1f} "
              f"{t:8.1f} {c.bound(peak_tflops, bw_gbs)}")
    print(f"{'TOTAL fwd':34s} {tot_f/1e9:7.2f} {tot_b/1e6:7.1f} {tot_t:8.1f}")
    flop_us = tot_f / (peak_tflops * 1e12) * 1e6
    print(f"pure tensor-core time would be {flop_us:.0f} us fwd -> implied "
          f"MFU ceiling {flop_us / tot_t:.2f} at this shape")
    # backward: each GEMM gains two transposed siblings (2x flops); its
    # byte multiplier is BETWEEN 1x (perfect cotangent fusion into the
    # sibling GEMMs) and 2x (every activation re-read + every cotangent
    # round-tripped) — report the resulting band rather than a point
    byte_us = tot_b / (bw_gbs * 1e9) * 1e6
    lo = tot_t + max(2 * flop_us, 1 * byte_us)
    hi = tot_t + max(2 * flop_us, 2 * byte_us)
    print(f"fwd+bwd roofline band: {lo/1e3:.2f}-{hi/1e3:.2f} ms/block "
          f"-> {blocks*lo/1e3:.1f}-{blocks*hi/1e3:.1f} ms "
          f"for {blocks} blocks")
    if measured_block_ms is not None:
        print(f"measured: {measured_block_ms:.2f} ms/block")
    return blocks * lo / 1e3


if __name__ == "__main__":
    report(residual_bytes=FP32)
    print()
    report(residual_bytes=BF16)
