"""The window and mel-filterbank helpers of the reference's golden NumPy
front-end (``frontend/golden_np.py``), copied so the port imports nothing
of the JAX package: the periodic Hann window and the slaney mel
filterbank (librosa defaults), computed in fp64 on the host.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

__all__ = ["hann_periodic", "mel_filterbank"]


def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window (scipy get_window('hann', n, fftbins=True))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float64)


# -- mel filterbank (librosa defaults: slaney scale, slaney norm) ------------

def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: int = C.SAMPLE_RATE,
    n_fft: int = C.N_FFT,
    n_mels: int = C.N_MELS,
    fmin: float = C.MEL_FMIN,
    fmax: float = C.MEL_FMAX,
) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular slaney-normalized filterbank."""
    fft_freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz_slaney(
        np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    )
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]          # [n_mels+2, n_bins]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))    # [n_mels, n_bins]
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])  # slaney norm
    weights *= enorm[:, None]
    return weights.astype(np.float32)
