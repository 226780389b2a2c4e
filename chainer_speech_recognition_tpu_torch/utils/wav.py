"""Minimal WAV I/O, stdlib + numpy: the port's copy of the reference's
``utils/wav.py`` without its C++ fast path (the port does not build
``native/``). 16-bit PCM; non-16 kHz input is resampled on read with a
polyphase windowed-sinc filter, stereo is downmixed to mono.
"""

from __future__ import annotations

import math
import wave

import numpy as np

from ..constants import SAMPLE_RATE


def resample_sinc(signal: np.ndarray, sr_in: int, sr_out: int,
                  taps_per_phase: int = 24, beta: float = 8.0) -> np.ndarray:
    """Rational polyphase resampling with a Kaiser-windowed sinc filter.

    Quality comparable to scipy.signal.resample_poly defaults; pure NumPy.
    """
    if sr_in == sr_out:
        return np.asarray(signal, np.float32)
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    x = np.asarray(signal, np.float64)
    # lowpass at the tighter Nyquist, windowed sinc of length 2*half*up+1
    cutoff = min(1.0 / up, 1.0 / down)
    half = taps_per_phase * max(up, down) // 2
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(2 * half + 1, beta)
    h *= up  # compensate zero-stuffing gain
    # upsample (zero-stuff) → filter → downsample, done sparsely:
    x_up = np.zeros(len(x) * up, np.float64)
    x_up[::up] = x
    y = np.convolve(x_up, h, mode="full")[half : half + len(x_up)]
    y = y[::down]
    out_len = int(round(len(x) * sr_out / sr_in))
    if len(y) < out_len:
        y = np.pad(y, (0, out_len - len(y)))
    return y[:out_len].astype(np.float32)


def read_wav(path: str, resample: bool = True) -> np.ndarray:
    """→ float32 mono signal in [-1, 1] at SAMPLE_RATE (the reference's
    ``read_wav_py``). ``resample=False`` raises on a rate mismatch."""
    with wave.open(str(path), "rb") as w:
        rate = w.getframerate()
        ch = w.getnchannels()
        if w.getsampwidth() != 2:
            raise ValueError(f"{path}: expected 16-bit PCM")
        raw = w.readframes(w.getnframes())
    sig = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if ch > 1:
        sig = sig.reshape(-1, ch).mean(axis=1)        # downmix
    if rate != SAMPLE_RATE:
        if not resample:
            raise ValueError(f"{path}: expected {SAMPLE_RATE} Hz, got {rate}")
        sig = resample_sinc(sig, rate, SAMPLE_RATE)
    return sig


def write_wav(path: str, signal: np.ndarray, sample_rate: int = SAMPLE_RATE,
              channels: int = 1) -> None:
    sig = np.asarray(signal)
    pcm = np.clip(sig * 32768.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
