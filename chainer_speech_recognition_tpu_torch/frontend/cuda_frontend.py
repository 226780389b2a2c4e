"""Fused log-mel front-end kernel (``csrc/frontend_logmel.cu``).

Port of ``frontend/pallas_frontend.py``'s ``fused_logmel_rows`` /
``batch_features_pallas``: the kernel frames the extended signal in shared
memory and runs window → DFT power → mel → log without writing frames or
spectra to device memory; CMVN and Δ/ΔΔ stay in torch
(``torch_frontend.postprocess_logmel``), as they stay in XLA.

``fused_logmel_rows`` launches the kernel for a CUDA tensor and takes the
plain rfft version (``torch_frontend.logmel_from_extended``) for a CPU
tensor; it never falls back from one to the other.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from chainer_speech_recognition_tpu import constants as C
from chainer_speech_recognition_tpu.frontend.golden_np import (
    hann_periodic, mel_filterbank)

from .. import _kernels
from .torch_frontend import batch_features, logmel_from_extended

_NBINS = 1 + C.N_FFT // 2                 # 257


def dft_tables() -> tuple[np.ndarray, np.ndarray]:
    """(windowed DFT [N_FFT, 2·257] = cos·win ‖ sin·win, mel [257, n_mels])
    fp32, computed in fp64 on the host."""
    n = C.N_FFT
    t = np.arange(n)[:, None]
    k = np.arange(_NBINS)[None, :]
    ang = -2.0 * np.pi * t * k / n
    win = hann_periodic(C.WIN_LENGTH)
    lpad = (n - C.WIN_LENGTH) // 2
    win_full = np.zeros(n)
    win_full[lpad : lpad + C.WIN_LENGTH] = win
    dft = np.concatenate([np.cos(ang) * win_full[:, None],
                          np.sin(ang) * win_full[:, None]], axis=1)
    mel = mel_filterbank().T                               # [257, n_mels]
    return (np.ascontiguousarray(dft, np.float32),
            np.ascontiguousarray(mel, np.float32))


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    dft, mel = dft_tables()
    return torch.from_numpy(dft).to(device), torch.from_numpy(mel).to(device)


def fused_logmel_rows_cuda(ext: torch.Tensor, T: int) -> torch.Tensor:
    """Kernel launch: ext [B, rows·HOP] fp32 on the card → [B, T, n_mels]."""
    B, ext_len = ext.shape
    _kernels.check_cuda_tensor("ext", ext, torch.float32, (B, ext_len))
    if B < 1 or T < 1:
        raise ValueError(f"fused_logmel_rows: empty batch (B={B}, T={T})")
    if ext_len < (T - 1) * C.HOP_LENGTH + C.N_FFT:
        raise ValueError(f"fused_logmel_rows: {ext_len} extended samples "
                         f"cannot hold {T} frames")
    dft, mel = _device_tables(ext.device)
    out = torch.empty((B, T, C.N_MELS), dtype=torch.float32,
                      device=ext.device)
    _kernels.FRONTEND_LOGMEL.launch(
        ext.data_ptr(), ext_len, B, T, dft.data_ptr(), mel.data_ptr(),
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


def batch_features_cuda(signals, num_samples, apply_cmvn=True):
    """Drop-in for ``torch_frontend.batch_features`` through the kernel."""
    return batch_features(signals, num_samples, apply_cmvn,
                          logmel_fn=fused_logmel_rows)
