"""Batched, length-masked audio front-end in plain PyTorch.

Port of ``frontend/jnp_frontend.py``: the same pipeline on padded batches
(reflect-extension, framing, Hann-window rfft power, slaney mel, log, then
mask → CMVN → Δ/ΔΔ), with the same documented limitation for utterances
shorter than 257 samples (their end reflection reads zero padding, so they
are not bit-golden).

``logmel_from_extended`` (fp32 rfft) is the plain version of the fused
front-end kernel (``cuda_frontend.fused_logmel_rows``) and is also what
``features.frontend_impl="jnp"`` selects.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from chainer_speech_recognition_tpu import constants as C
from chainer_speech_recognition_tpu.frontend.golden_np import (
    hann_periodic, mel_filterbank)

__all__ = ["batch_features", "extend_signal", "frame_lengths",
           "logmel_from_extended", "postprocess_logmel"]

_PAD = C.N_FFT // 2                      # 256: centered-STFT reflect pad
_K = C.N_FFT // C.HOP_LENGTH             # full hop rows per frame (3)


def frame_lengths(num_samples: torch.Tensor) -> torch.Tensor:
    """Per-utterance valid frame counts: 1 + L // HOP."""
    return 1 + num_samples // C.HOP_LENGTH


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(window zero-padded to N_FFT [N_FFT], mel [n_bins, n_mels]) fp32,
    built once per device (callers never write to them)."""
    win = hann_periodic(C.WIN_LENGTH)
    lpad = (C.N_FFT - C.WIN_LENGTH) // 2
    win_full = np.zeros(C.N_FFT, np.float32)
    win_full[lpad : lpad + C.WIN_LENGTH] = win.astype(np.float32)
    mel = mel_filterbank().T                               # [n_bins, n_mels]
    return (torch.from_numpy(win_full).to(device),
            torch.from_numpy(np.ascontiguousarray(mel)).to(device))


def extend_signal(signals: torch.Tensor, lengths: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """[B, N] → [B, n_rows·HOP] centered-reflect-extended signal.

    Position p corresponds to original sample ``p - 256``: the first 256
    samples are the start reflection, and each utterance's end reflection
    (samples L..L+255 ≘ x[L-2]..x[L-257]) is written at its own offset.
    Samples past the end reflection stay as they were (zero padding, or
    the padded batch's own samples); they only feed masked frames."""
    B, N = signals.shape
    total = n_rows * C.HOP_LENGTH
    x = signals.to(torch.float32)
    head = x[:, 1 : _PAD + 1].flip(1)                      # reflect at start
    body_len = total - _PAD
    body = x[:, :body_len] if body_len <= N else F.pad(x, (0, body_len - N))
    ext = torch.cat([head, body], dim=1)                   # [B, total]
    lengths = lengths.to(device=x.device, dtype=torch.int64)
    k = torch.arange(_PAD, device=x.device)
    src = torch.clamp(lengths[:, None] - 2 - k[None, :], 0, N - 1)
    tail = torch.gather(x, 1, src)                         # [B, _PAD]
    off = torch.clamp(lengths + _PAD, 0, total - _PAD)
    return ext.scatter(1, off[:, None] + k[None, :], tail)


def logmel_from_extended(ext: torch.Tensor, t_max: int) -> torch.Tensor:
    """Extended signal [B, rows·HOP] → [B, t_max, n_mels] fp32 log-mel:
    frame (ext[t·HOP : t·HOP + N_FFT]) → window → rfft power → mel → log."""
    win, mel = _tables(ext.device)
    frames = ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :t_max] * win
    spec = torch.fft.rfft(frames, n=C.N_FFT, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return torch.log(torch.clamp(power @ mel, min=C.LOG_EPS))


def _delta(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Regression deltas over time with per-utterance edge replication:
    out[t] = Σₙ n·(x[min(t+n, L-1)] − x[max(t−n, 0)]) / denom."""
    K = C.DELTA_WINDOW
    denom = 2.0 * sum(n * n for n in range(1, K + 1))
    T = x.shape[1]
    xp = torch.cat([x[:, :1]] * K + [x] + [x[:, -1:]] * K, dim=1)
    t = torch.arange(T, device=x.device)[None, :]
    last_idx = torch.clamp(lengths - 1, min=0)[:, None, None]
    last = torch.gather(x, 1, last_idx.expand(-1, 1, x.shape[2]))  # [B,1,F]
    out = torch.zeros_like(x)
    for n in range(1, K + 1):
        plus = xp[:, K + n : K + n + T]
        over = (t + n) >= lengths[:, None]                 # [B, T]
        plus = torch.where(over[:, :, None], last, plus)
        minus = xp[:, K - n : K - n + T]
        out = out + n * (plus - minus)
    return out / denom


def cmvn_causal(logmel: torch.Tensor, tmask: torch.Tensor) -> torch.Tensor:
    """Causal CMVN over a whole utterance (frame t normalized by the
    running stats of frames 0..t), on the shifted stream x − x[0] as in
    ``jnp_frontend.cmvn_causal_jnp``. Streaming carries are not ported."""
    m = tmask[..., None].to(torch.float32)
    x = (logmel - logmel[:, :1]) * m
    cnt = torch.clamp(torch.cumsum(m, dim=1), min=1.0)
    s1 = torch.cumsum(x, dim=1)
    s2 = torch.cumsum(x * x, dim=1)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    return (x - mean) * torch.rsqrt(var + C.CMVN_VAR_EPS) * m


def postprocess_logmel(logmel: torch.Tensor, lengths: torch.Tensor,
                       t_max: int, apply_cmvn):
    """Mask → CMVN over valid frames → Δ/ΔΔ with edge replication → stack.

    ``apply_cmvn``: False | True / "utterance" | "causal"."""
    lengths = lengths.to(device=logmel.device, dtype=torch.int64)
    flens = frame_lengths(lengths)                          # [B]
    tmask = (torch.arange(t_max, device=logmel.device)[None, :]
             < flens[:, None])                              # [B, T]
    logmel = logmel * tmask[..., None]

    if apply_cmvn == "causal":
        logmel = cmvn_causal(logmel, tmask)
    elif apply_cmvn:
        m = tmask[..., None].to(torch.float32)
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (logmel * m).sum(dim=1, keepdim=True) / cnt
        var = ((logmel - mean).square() * m).sum(dim=1, keepdim=True) / cnt
        logmel = (logmel - mean) * torch.rsqrt(var + C.CMVN_VAR_EPS)
        logmel = logmel * m

    d1 = _delta(logmel, flens)
    d2 = _delta(d1, flens)
    feats = torch.stack([logmel, d1, d2], dim=-1)           # [B, T, F, 3]
    feats = feats * tmask[..., None, None]
    return feats.to(torch.float32), flens


def batch_features(signals: torch.Tensor, num_samples: torch.Tensor,
                   apply_cmvn=True, logmel_fn=logmel_from_extended):
    """Padded batch [B, N_max] fp32 + [B] sample counts →
    ([B, T_max, n_mels, 3] fp32, [B] frame lengths). ``logmel_fn(ext, T)``
    is the spectral stage: the plain rfft path by default, the fused
    kernel's wrapper for ``frontend_impl="auto"/"pallas"``."""
    n_max = signals.shape[1]
    t_max = C.num_frames(n_max)
    lengths = num_samples.to(device=signals.device, dtype=torch.int64)
    ext = extend_signal(signals, lengths, t_max + _K + 1)
    logmel = logmel_fn(ext, t_max)
    return postprocess_logmel(logmel, lengths, t_max, apply_cmvn)
