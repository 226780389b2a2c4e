"""The FFT front-end kernel's arithmetic (``csrc/frontend_logmel.cu``),
modelled in numpy fp32 on the kernel's own host tables
(``cuda_frontend.fft_tables``), against ``torch.fft.rfft`` and JAX's
``fused_logmel`` in interpret mode; and the flash backward's gradient bar
derived from bf16 rounding: its helper (``attention_cuda.bf16_ulp``), the
one-ulp rounding it admits and the planted faults it catches.

The model follows the kernel lane by lane: each real 512-sample frame,
windowed, is packed as the 256-point complex sequence z[n] = x[2n] +
i·x[2n+1]; lane n1 of the frame's warp takes z[n1 + 32·n2] (n2 < 8) through
a radix-8 DFT and the twiddle W₂₅₆^{n1·k2}; lane (k2, m1) takes the values of
lanes m1 + 4·m2 through a second radix-8 DFT and the twiddle W₃₂^{m1·j2};
two radix-4 DFTs a lane finish Z[64·j1 + 8·j2 + k2]. The standard post-twiddle
splits Z into the 257 bins of the real frame; the power goes through each
mel filter's bin range (filters 32 and up in quarters, summed pairwise as
the lanes' shuffles sum them), then the log.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainer_speech_recognition_tpu.frontend.jnp_frontend import (
    _K as jax_K, extend_signal as jax_extend, frame_signal)
from chainer_speech_recognition_tpu.frontend.pallas_frontend import (
    fused_logmel as jax_fused_logmel)
from chainer_speech_recognition_tpu_torch import constants as C
from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
    fft_tables)
from chainer_speech_recognition_tpu_torch.frontend.golden_np import (
    hann_periodic, mel_filterbank)
from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac
from chainer_speech_recognition_tpu_torch.ops.attention_cuda import bf16_ulp

LPAD = (C.N_FFT - C.WIN_LENGTH) // 2          # 56
R = np.float32(np.sqrt(0.5))


def _tables():
    floats, ints = fft_tables()
    n_mels = C.N_MELS
    tw = (floats[0:2 * C.N_FFT:2] + 1j * floats[1:2 * C.N_FFT:2]).astype(
        np.complex64)
    win = floats[2 * C.N_FFT:2 * C.N_FFT + C.WIN_LENGTH]
    weights = floats[2 * C.N_FFT + C.WIN_LENGTH:]
    return tw, win, weights, ints[:n_mels], ints[n_mels:]


def _mul(a, w):
    """(a.re·w.re − a.im·w.im, a.re·w.im + a.im·w.re) in fp32."""
    return (a.real * w.real - a.imag * w.imag) + 1j * (
        a.real * w.imag + a.imag * w.real)


def _neg_i(t):
    return t.imag - 1j * t.real


def _dft4(c):
    """Radix-4 DFT over the last axis, the kernel's butterflies."""
    d0, d2 = c[..., 0] + c[..., 2], c[..., 0] - c[..., 2]
    d1, d3 = c[..., 1] + c[..., 3], _neg_i(c[..., 1] - c[..., 3])
    return np.stack([d0 + d1, d2 + d3, d0 - d1, d2 - d3], axis=-1)


def _dft8(a):
    """Radix-8 DFT over the last axis: one radix-2 step (×W₈ⁿ on the
    differences), then two radix-4 DFTs for the even and odd outputs."""
    s = a[..., :4] + a[..., 4:]
    t = a[..., :4] - a[..., 4:]
    t1, t3 = t[..., 1], t[..., 3]
    t = np.stack([t[..., 0],
                  R * (t1.real + t1.imag) + 1j * R * (t1.imag - t1.real),
                  _neg_i(t[..., 2]),
                  R * (t3.imag - t3.real) - 1j * R * (t3.real + t3.imag)],
                 axis=-1)
    out = np.empty(a.shape, np.complex64)
    out[..., 0::2], out[..., 1::2] = _dft4(s), _dft4(t)
    return out


def fft_model(frames):
    """[F, 512] un-windowed frames → (spectrum [F, 257] complex64, log-mel
    [F, n_mels] fp32), computed as the kernel computes them."""
    tw, win, weights, first, offs = _tables()
    F = frames.shape[0]
    x = np.zeros((F, C.N_FFT), np.float32)
    x[:, LPAD:LPAD + C.WIN_LENGTH] = frames[:, LPAD:LPAD + C.WIN_LENGTH] * win
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)      # [F, 256]
    n1, k2 = np.arange(32)[:, None], np.arange(8)[None, :]
    # stage 1: lane n1 holds z[n1 + 32 n2]
    y = _dft8(z.reshape(F, 8, 32).transpose(0, 2, 1))             # [F, n1, k2]
    y = _mul(y, tw[2 * n1 * k2])
    # stage 2: lane (k2, m1) holds y[m1 + 4 m2][k2]
    b = y.reshape(F, 8, 4, 8).transpose(0, 3, 2, 1)               # k2 m1 m2
    m1, j2 = np.arange(4)[:, None], np.arange(8)[None, :]
    u = _mul(_dft8(b), tw[16 * m1 * j2])                          # k2 m1 j2
    # stage 3: a radix-4 DFT over m1 for each (k2, j2) → Z[64 j1 + 8 j2 + k2]
    v = _dft4(u.transpose(0, 1, 3, 2))                            # k2 j2 j1
    Z = v.transpose(0, 3, 2, 1).reshape(F, 256)
    # post-twiddle: X[k] = E[k] + W₅₁₂ᵏ·O[k], k = 0 … 256
    k = np.arange(257)
    Zk, Zn = Z[:, k % 256], Z[:, (256 - k) % 256]
    E = 0.5 * (Zk.real + Zn.real) + 0.5j * (Zk.imag - Zn.imag)
    O = 0.5 * (Zk.imag + Zn.imag) - 0.5j * (Zk.real - Zn.real)
    X = (E + _mul(O, tw[k])).astype(np.complex64)
    power = X.real * X.real + X.imag * X.imag
    mel = np.zeros((F, C.N_MELS), np.float32)
    for m in range(C.N_MELS):
        # filters from 32 on in quarters over four lanes, then two shuffles
        n = offs[m + 1] - offs[m]
        part = n if m < 32 else -(-n // 4)
        acc = [np.zeros(F, np.float32) for _ in range(-(-n // part))]
        for j in range(n):
            acc[j // part] += power[:, first[m] + j] * weights[offs[m] + j]
        acc += [np.zeros(F, np.float32)] * (4 - len(acc) if m >= 32 else 0)
        mel[:, m] = acc[0] if m < 32 else (acc[0] + acc[1]) + (acc[2]
                                                                 + acc[3])
    return X, np.log(np.maximum(mel, np.float32(C.LOG_EPS)))


def _signals(lens, seed):
    """Tones with noise (as the synthetic corpus makes them), silent past
    each length."""
    rng = np.random.default_rng(seed)
    sigs = np.zeros((len(lens), max(lens)), np.float32)
    t = np.arange(max(lens)) / C.SAMPLE_RATE
    for i, L in enumerate(lens):
        f = rng.uniform(200, 3000)
        sigs[i, :L] = (np.sin(2 * np.pi * f * t[:L] + rng.uniform(0, 6))
                       + 0.05 * rng.standard_normal(L))
    return sigs, np.asarray(lens, np.int32)


def _frames(lens, seed):
    sigs, lens = _signals(lens, seed)
    T = C.num_frames(sigs.shape[1])
    frames = np.array(frame_signal(jax_extend(
        jnp.asarray(sigs), jnp.asarray(lens), T + jax_K + 1), T))
    return frames                                  # [B, T, 512]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fft_model_is_the_windowed_rfft(seed):
    """The packed FFT, its twiddles and the post-twiddle give the rfft of
    the windowed frames: within 1e-5 of each frame's largest bin (fp32
    against fp64), on tones, on noise and on silence."""
    rng = np.random.default_rng(seed)
    frames = np.concatenate([
        _frames((9000, 4001), seed).reshape(-1, C.N_FFT),
        rng.standard_normal((7, C.N_FFT)).astype(np.float32),
        np.zeros((1, C.N_FFT), np.float32)])
    X, _ = fft_model(frames)
    win = np.zeros(C.N_FFT)
    win[LPAD:LPAD + C.WIN_LENGTH] = hann_periodic(C.WIN_LENGTH)
    want = np.fft.rfft(frames.astype(np.float64) * win, n=C.N_FFT)
    top = np.abs(want).max(-1, keepdims=True)
    assert np.all(np.abs(X - want) <= 1e-5 * top)
    assert np.all(X[-1] == 0)
    got_t = torch.fft.rfft(torch.from_numpy(frames) * torch.from_numpy(
        win.astype(np.float32)), n=C.N_FFT)
    assert np.all(np.abs(X - got_t.numpy()) <= 1e-5 * top)


@pytest.mark.parametrize("lens", [(8000,), (16000, 9000, 2000)])
def test_fft_model_matches_pallas_interpret(lens):
    """Log-mel of the model against JAX's ``fused_logmel`` in interpret
    mode on the same frames, at the reference test's bar (5e-4)."""
    frames = _frames(lens, len(lens))
    want = np.asarray(jax_fused_logmel(jnp.asarray(frames)))
    _, got = fft_model(frames.reshape(-1, C.N_FFT))
    np.testing.assert_allclose(got.reshape(want.shape), want, atol=5e-4,
                               rtol=0)


def test_sparse_mel_ranges_rebuild_the_filterbank():
    """Each filter's first bin, offset and weights scatter back into the
    dense ``mel_filterbank`` exactly, and no bin feeds more than two
    filters."""
    _, _, weights, first, offs = _tables()
    dense = np.zeros((C.N_MELS, C.N_FFT // 2 + 1), np.float32)
    for m in range(C.N_MELS):
        n = offs[m + 1] - offs[m]
        dense[m, first[m]:first[m] + n] = weights[offs[m]:offs[m + 1]]
    assert np.array_equal(dense, mel_filterbank())
    assert offs[0] == 0 and offs[-1] == weights.size
    assert ((dense > 0).sum(0) <= 2).all()


def test_twiddles_and_window_tables():
    floats, _ = fft_tables()
    k = np.arange(C.N_FFT)
    w = np.exp(-2j * np.pi * k / C.N_FFT)
    assert np.array_equal(floats[0:2 * C.N_FFT:2], w.real.astype(np.float32))
    assert np.array_equal(floats[1:2 * C.N_FFT:2], w.imag.astype(np.float32))
    assert np.array_equal(floats[2 * C.N_FFT:2 * C.N_FFT + C.WIN_LENGTH],
                          hann_periodic(C.WIN_LENGTH).astype(np.float32))


@pytest.mark.parametrize("x,want", [
    (1.0, 2.0 ** -7), (1.5, 2.0 ** -7), (0.9999, 2.0 ** -8),
    (-3.0, 2.0 ** -6), (2.0 ** -20, 2.0 ** -27), (6e4, 2.0 ** 8),
    (2.0 ** -126, 2.0 ** -133),            # the smallest normal
    (2.0 ** -130, 2.0 ** -133),            # subnormal in bf16
    (1e-45, 2.0 ** -133),                  # fp32 subnormal
    (0.0, 2.0 ** -133), (-0.0, 2.0 ** -133)])
def test_bf16_ulp(x, want):
    """One bf16 ulp of x: the spacing of bf16 values in x's binade, the
    subnormal spacing 2⁻¹³³ below 2⁻¹²⁶ and at zero."""
    got = bf16_ulp(torch.tensor([x], dtype=torch.float32))
    assert got.dtype == torch.float32
    assert float(got[0]) == want


def _to_bf16_toward_zero(x):
    """x rounded to bf16 toward zero (at most one ulp from nearest)."""
    return (x.float().view(torch.int32) & -65536).view(torch.float32).to(
        torch.bfloat16)


@pytest.mark.parametrize("chunk,left", [(0, 0), (16, 4)])
def test_derived_bar_admits_one_ulp_and_catches_planted_faults(chunk, left):
    """The bf16 gradients' bar, 2⁻⁷·|b| + ``bwd_rounding_room`` + 1e-3, at
    the long-form length (T' = 701, dh = 64) on the plain versions: every p
    and ds rounded to bf16 toward zero instead of to nearest, each at most
    one ulp away, stays within it; each fault of ``bwd_planted_faults`` (p
    at 3 mantissa bits, one 64-row tile skipped) exceeds it."""
    rng = np.random.default_rng(chunk + 3)
    B, T, h, dh = 2, 701, 2, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, T, h, dh)).astype(np.float32)).to(torch.bfloat16)
        for _ in range(4))
    lens = torch.tensor([T, 600], dtype=torch.int32)
    out, lse = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
    d_rows = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse, d_rows, chunk, left)
    want = (ac.flash_bwd_dq_plain(*args), *ac.flash_bwd_dkv_plain(*args))
    bars = [1e-3 + 2 ** -7 * b.float().abs() + r
            for b, r in zip(want, ac.bwd_rounding_room(*args))]

    def share(grads):
        return max(float(((a.float() - b.float()).abs() / bar).max())
                   for a, b, bar in zip(grads, want, bars))

    p, ds = ac._bwd_terms(*args)
    p0, ds0 = (_to_bf16_toward_zero(x).float() for x in (p, ds))
    scale = dh ** -0.5
    toward_zero = (
        torch.einsum("bhts,bshd->bthd", ds0, k.float()) * scale,
        torch.einsum("bhts,bthd->bshd", ds0, q.float()) * scale,
        torch.einsum("bhts,bthd->bshd", p0, do.float()))
    assert share([g.to(torch.bfloat16) for g in toward_zero]) <= 1
    for name, deltas in ac.bwd_planted_faults(*args).items():
        planted = [(a.float() + d).to(a.dtype) for a, d in zip(want, deltas)]
        assert share(planted) > 1, name
