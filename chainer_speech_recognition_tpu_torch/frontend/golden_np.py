"""The reference's golden NumPy front-end (``frontend/golden_np.py``),
copied so the port imports nothing of the JAX package: framing → periodic
Hann window → STFT power spectrum → slaney mel filterbank (librosa
defaults) → log → CMVN (utterance or causal) → Δ/ΔΔ, in fp64 on the host.
The port builds its kernels' tables from the window and the filterbank,
and ``preprocess --cache-features`` writes ``features`` to disk.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

__all__ = [
    "hann_periodic", "mel_filterbank", "stft_power", "log_mel",
    "delta", "cmvn", "cmvn_causal", "features",
]


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


# -- STFT --------------------------------------------------------------------

def stft_power(signal: np.ndarray) -> np.ndarray:
    """Centered power spectrogram [T, 1 + n_fft//2] of a 1-D fp signal."""
    x = np.asarray(signal, dtype=np.float64)
    pad = C.N_FFT // 2
    x = np.pad(x, (pad, pad), mode=C.PAD_MODE)
    n_frames = C.num_frames(len(signal))
    win = hann_periodic(C.WIN_LENGTH)
    # window centered inside the n_fft frame (librosa pads win to n_fft)
    lpad = (C.N_FFT - C.WIN_LENGTH) // 2
    win_full = np.zeros(C.N_FFT)
    win_full[lpad : lpad + C.WIN_LENGTH] = win
    out = np.empty((n_frames, 1 + C.N_FFT // 2), dtype=np.float64)
    for t in range(n_frames):
        frame = x[t * C.HOP_LENGTH : t * C.HOP_LENGTH + C.N_FFT] * win_full
        spec = np.fft.rfft(frame, n=C.N_FFT)
        out[t] = spec.real**2 + spec.imag**2
    return out.astype(np.float32)


def log_mel(signal: np.ndarray) -> np.ndarray:
    """[T, n_mels] natural-log mel spectrogram."""
    power = stft_power(signal).astype(np.float64)
    mel = power @ mel_filterbank().astype(np.float64).T
    return np.log(np.maximum(mel, C.LOG_EPS)).astype(np.float32)


# -- deltas + CMVN -------------------------------------------------------------

def delta(feat: np.ndarray, window: int = C.DELTA_WINDOW) -> np.ndarray:
    """Regression deltas over time (axis 0) with edge replication."""
    x = np.asarray(feat, dtype=np.float64)
    padded = np.pad(x, ((window, window), (0, 0)), mode="edge")
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    out = np.zeros_like(x)
    for n in range(1, window + 1):
        out += n * (padded[window + n : window + n + len(x)]
                    - padded[window - n : window - n + len(x)])
    return (out / denom).astype(np.float32)


def cmvn(feat: np.ndarray) -> np.ndarray:
    """Per-utterance mean/variance normalization over time (axis 0)."""
    x = np.asarray(feat, dtype=np.float64)
    mean = x.mean(axis=0, keepdims=True)
    var = x.var(axis=0, keepdims=True)
    return ((x - mean) / np.sqrt(var + C.CMVN_VAR_EPS)).astype(np.float32)


def cmvn_causal(feat: np.ndarray) -> np.ndarray:
    """Causal (streaming) mean/variance normalization: frame ``t`` is
    normalized by the running statistics of frames ``0..t`` only.

    This is the streamable alternative to per-utterance CMVN — the
    reference's utterance CMVN needs the whole utterance before the first
    frame can be normalized, so an online recognizer cannot use it. The
    causal form is exactly chunk-invariant: computing it over any chunking
    of the stream (carrying count / Σx / Σx² across chunks) reproduces the
    full-utterance result bit-for-bit (decode/streaming.py relies on this;
    differential test in tests/test_streaming.py). Frame 0 normalizes to
    exactly zero (its running mean is itself) — models trained with
    ``features.cmvn_mode="causal"`` adapt to the warm-up transient.
    """
    x = np.asarray(feat, dtype=np.float64)
    cnt = np.arange(1, len(x) + 1, dtype=np.float64)[:, None]
    mean = np.cumsum(x, axis=0) / cnt
    var = np.cumsum(x * x, axis=0) / cnt - mean * mean
    return ((x - mean) / np.sqrt(np.maximum(var, 0.0) + C.CMVN_VAR_EPS)
            ).astype(np.float32)


def features(signal: np.ndarray, apply_cmvn=True) -> np.ndarray:
    """Full front-end: 1-D PCM → float32 [T, n_mels, 3] (static, Δ, ΔΔ).

    CMVN (when enabled) is applied to the static log-mel BEFORE the deltas are
    computed, matching classic fbank pipelines where deltas are taken on the
    normalized stream. ``apply_cmvn``: False | True/"utterance" | "causal"
    (mirrors the device front-ends' argument).
    """
    lm = log_mel(signal)
    if apply_cmvn == "causal":
        lm = cmvn_causal(lm)
    elif apply_cmvn:
        lm = cmvn(lm)
    d1 = delta(lm)
    d2 = delta(d1)
    return np.stack([lm, d1, d2], axis=-1).astype(np.float32)
