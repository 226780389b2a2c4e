"""Fused log-mel front-end kernel (``csrc/frontend_logmel.cu``).

Port of ``frontend/pallas_frontend.py``'s ``fused_logmel_rows`` /
``batch_features_pallas``: the kernel frames the extended signal in shared
memory and runs window → real FFT power → sparse mel → log without writing
frames or spectra to device memory, on the host tables of ``fft_tables``;
CMVN and Δ/ΔΔ stay in torch (``torch_frontend.postprocess_logmel``), as
they stay in XLA.

``fused_logmel_rows`` launches the kernel for a CUDA tensor and takes the
plain rfft version (``torch_frontend.logmel_from_extended``) for a CPU
tensor; it never falls back from one to the other. ``fused_logmel`` is the
framed-input entry point (``pallas_frontend.fused_logmel``: pre-framed
``[B, T, 512]`` input, the same kernel's framed form, plain version
``logmel_from_frames``); as in the reference, no CLI calls it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _kernels
from .. import constants as C
from .golden_np import hann_periodic, mel_filterbank
from .torch_frontend import (batch_features, logmel_from_extended,
                             logmel_from_frames)

def frames_per_block() -> int:
    """The kernel's tile, frames a block (``kFrames``), as the built library
    reports it (builds it at first use)."""
    return int(_kernels.library().csr_frontend_frames_per_block())


def fft_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's host tables, computed in fp64 and stored fp32 / int32
    (layout shared with ``csrc/frontend_logmel.cu``):

    * floats: the twiddles W₅₁₂ᵏ = e^{−2πik/512} as (re, im) pairs for
      k < 512 (W₂₅₆ʳ = W₅₁₂²ʳ serves the FFT's stages), then the periodic
      Hann window's 400 samples (frame samples 56 … 455; the rest of the
      512 are zero), then each mel filter's nonzero weights in bin order,
      filter after filter;
    * ints: each filter's first bin (n_mels), then each filter's offset
      into the weights (n_mels + 1; the last is their count).

    The weights are ``mel_filterbank``'s fp32 values, so the sparse sum over
    each filter's bins is the plain version's dense mel product without
    its exact zeros."""
    n = C.N_FFT
    ang = 2.0 * np.pi * np.arange(n) / n
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=1).reshape(-1)
    mel = mel_filterbank()                                 # [n_mels, 257]
    first, offs, weights = [], [0], []
    for row in mel:
        nz = np.flatnonzero(row)
        lo, hi = int(nz[0]), int(nz[-1]) + 1
        first.append(lo)
        weights.append(row[lo:hi])
        offs.append(offs[-1] + hi - lo)
    floats = np.concatenate([tw.astype(np.float32),
                             hann_periodic(C.WIN_LENGTH).astype(np.float32),
                             *weights])
    return (np.ascontiguousarray(floats, np.float32),
            np.asarray(first + offs, np.int32))


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    floats, ints = fft_tables()
    return (torch.from_numpy(floats).to(device),
            torch.from_numpy(ints).to(device))


def fused_logmel_rows_cuda(ext: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel launch: ext [B, rows·HOP] fp32 on the card → [B, T, n_mels]."""
    B, ext_len = ext.shape
    _kernels.check_cuda_tensor("ext", ext, torch.float32, (B, ext_len))
    if B < 1 or T < 1:
        raise ValueError(f"fused_logmel_rows: empty batch (B={B}, T={T})")
    if ext_len < (T - 1) * C.HOP_LENGTH + C.N_FFT:
        raise ValueError(f"fused_logmel_rows: {ext_len} extended samples "
                         f"cannot hold {T} frames")
    floats, ints = _device_tables(ext.device)
    out = torch.empty((B, T, C.N_MELS), dtype=torch.float32,
                      device=ext.device)
    _kernels.FRONTEND_LOGMEL.launch(
        ext.data_ptr(), ext_len, B, T, floats.data_ptr(), ints.data_ptr(),
        C.N_MELS, out.data_ptr(), _kernels.stream_ptr(ext))
    return out


def fused_logmel_rows(ext: torch.Tensor, T: int) -> torch.Tensor:
    """Extended signal [B, rows·HOP] → [B, T, n_mels] log-mel: the kernel
    on the card, its plain rfft version on the CPU."""
    if ext.is_cuda:
        return fused_logmel_rows_cuda(ext.contiguous(), T)
    if ext.device.type != "cpu":
        raise ValueError(f"fused_logmel_rows: unsupported device {ext.device}")
    return logmel_from_extended(ext, T)


def fused_logmel_cuda(frames: torch.Tensor) -> torch.Tensor:
    """Kernel launch: frames [B, T, N_FFT] fp32 on the card → [B, T,
    n_mels]."""
    B, T, _ = frames.shape
    _kernels.check_cuda_tensor("frames", frames, torch.float32,
                               (B, T, C.N_FFT))
    if B < 1 or T < 1:
        raise ValueError(f"fused_logmel: empty batch (B={B}, T={T})")
    floats, ints = _device_tables(frames.device)
    out = torch.empty((B, T, C.N_MELS), dtype=torch.float32,
                      device=frames.device)
    _kernels.FRONTEND_LOGMEL_FRAMES.launch(
        frames.data_ptr(), B, T, floats.data_ptr(), ints.data_ptr(),
        C.N_MELS, out.data_ptr(), _kernels.stream_ptr(frames))
    return out


def fused_logmel(frames: torch.Tensor) -> torch.Tensor:
    """Pre-framed, un-windowed input [B, T, N_FFT] → [B, T, n_mels]
    log-mel (``pallas_frontend.fused_logmel``): the kernel on the card, its
    plain rfft version on the CPU."""
    if frames.is_cuda:
        return fused_logmel_cuda(frames.contiguous())
    _kernels.check_cpu_tensor("fused_logmel", frames)
    return logmel_from_frames(frames)


def batch_features_cuda(signals, num_samples, apply_cmvn=True):
    """Drop-in for ``torch_frontend.batch_features`` through the kernel."""
    return batch_features(signals, num_samples, apply_cmvn,
                          logmel_fn=fused_logmel_rows)
