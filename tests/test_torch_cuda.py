"""The port's CUDA kernels against their plain PyTorch versions at small,
ragged shapes (chip_smoke.py checks them at the decode and training
paths' shapes).

They need a card: marked ``cuda`` and skipped without one. This file
imports no JAX; on the card's machine run it without the repo's conftest,
which configures JAX for the CPU suite:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch import _kernels
from chainer_speech_recognition_tpu_torch import constants as C
from chainer_speech_recognition_tpu_torch.decode.greedy import (
    best_keep_cuda, best_keep_plain)
from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
    fused_logmel_cuda, fused_logmel_rows_cuda)
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    _K, extend_signal, logmel_from_extended, logmel_from_frames)
from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac
from chainer_speech_recognition_tpu_torch.ops.ctc import (
    LOG_ZERO, ctc_alpha_plain, ctc_beta_grad_plain, ctc_inputs)
from chainer_speech_recognition_tpu_torch.ops.ctc_cuda import (
    ctc_bwd_cuda, ctc_fwd_cuda)
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    gru_bwd_cuda, gru_bwd_plain, gru_scan_cuda,
    gru_scan_plain, gru_scan_stream_cuda, gru_scan_stream_plain,
    gru_scan_train_cuda, gru_scan_train_plain, lstm_bwd_cuda,
    lstm_bwd_plain, lstm_scan_cuda, lstm_scan_plain, lstm_scan_stream_cuda,
    lstm_scan_stream_plain, lstm_scan_train_cuda, lstm_scan_train_plain,
    shift_prev)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("lens", [(400,), (16000, 2560, 300),
                                  (160 * 17 + 5,) * 3])
def test_frontend_kernel_matches_plain(dev, lens):
    """T = 3, 101 and 18 frames: one partial tile, several, one + a bit.
    Bar: 5e-4 max abs, the reference's bar for its kernel."""
    rng = np.random.default_rng(len(lens))
    sigs = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        sigs[i, :n] = 0.3 * rng.standard_normal(n)
    T = C.num_frames(sigs.shape[1])
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.tensor(lens, device=dev), T + _K + 1)
    before = _kernels.FRONTEND_LOGMEL.launches
    got = fused_logmel_rows_cuda(ext, T)
    want = logmel_from_extended(ext, T)
    assert _kernels.FRONTEND_LOGMEL.launches == before + 1
    assert got.shape == (len(lens), T, C.N_MELS)
    assert float((got - want).abs().max()) <= 5e-4


@pytest.mark.parametrize("T,B,H", [(1, 1, 32), (7, 3, 64), (40, 5, 96),
                                   (33, 2, 256), (5, 2, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gru_kernel_matches_plain(dev, T, B, H, dtype, tol):
    """Ragged lengths including 0 and T; fp32 held to summation order,
    bf16 to the reference suite's bf16 bar."""
    rng = np.random.default_rng(T * 100 + H)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    lens = torch.from_numpy(lens)
    lo = torch.cat([torch.zeros(B), T - lens])[:, None].to(dev)
    hi = torch.cat([lens, torch.full((B,), float(T))])[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, 3 * H)).astype(np.float32)).to(dev).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    got = gru_scan_cuda(xs, w, lo, hi, dtype)
    want = gru_scan_plain(xs, w, lo, hi, dtype)
    assert float((got - want).abs().max()) <= tol
    if B > 1:
        assert torch.all(got[:, 1] == 0) and torch.all(got[:, B + 1] == 0)


@pytest.mark.parametrize("T,B,H", [(1, 1, 32), (7, 3, 64), (33, 2, 256),
                                   (5, 2, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_gru_train_kernels_match_plain(dev, T, B, H, dtype, tol):
    """Training forward (ys and the gate stream) and backward (dxs, dhn)
    against their plain versions, ragged lengths including 0 and T. The
    backward gets the plain forward's gates, so each kernel is held alone.
    bf16: the reference's bars, 3e-2 forward and 5e-2 gradient
    (tests/test_rnn_pallas.py:81,88)."""
    rng = np.random.default_rng(T * 1000 + H + B)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    lens = torch.from_numpy(lens)
    lo = torch.cat([torch.zeros(B), T - lens])[:, None].to(dev)
    hi = torch.cat([lens, torch.full((B,), float(T))])[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 3 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, 3 * H)).astype(np.float32)).to(dev).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, H)).astype(np.float32)).to(dev)
    before = (_kernels.GRU_FWD_TRAIN.launches, _kernels.GRU_BWD.launches)
    ys, gates = gru_scan_train_cuda(xs, w, lo, hi, dtype)
    ys_p, gates_p = gru_scan_train_plain(xs, w, lo, hi, dtype)
    assert float((ys - ys_p).abs().max()) <= tol
    assert float((gates.float() - gates_p.float()).abs().max()) <= tol
    assert torch.equal(ys, gru_scan_cuda(xs, w, lo, hi, dtype))
    h_prev = shift_prev(ys_p)
    dxs, dhn = gru_bwd_cuda(gates_p, w, lo, hi, h_prev, g, dtype)
    dxs_p, dhn_p = gru_bwd_plain(gates_p, w, lo, hi, h_prev, g, dtype)
    gtol = tol if dtype == torch.float32 else 5e-2
    assert float((dxs.float() - dxs_p.float()).abs().max()) <= gtol
    assert float((dhn.float() - dhn_p.float()).abs().max()) <= gtol
    assert (_kernels.GRU_FWD_TRAIN.launches, _kernels.GRU_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    if B > 1:       # a length-0 row has no live step: zero gradient
        assert torch.all(dxs[:, 1] == 0) and torch.all(dhn[:, B + 1] == 0)


def _lstm_inputs(dev, T, B, H, dtype, seed):
    """Ragged lengths including T and 0; xs in the stream dtype."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    lens = torch.from_numpy(lens)
    lo = torch.cat([torch.zeros(B), T - lens])[:, None].to(dev)
    hi = torch.cat([lens, torch.full((B,), float(T))])[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((2, H, 4 * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, 4 * H)).astype(np.float32)).to(dev).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, H)).astype(np.float32)).to(dev)
    return xs, w, lo, hi, g


@pytest.mark.parametrize("T,B,H", [(1, 1, 32), (7, 3, 64), (40, 5, 96),
                                   (33, 2, 384), (5, 2, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_lstm_kernels_match_plain(dev, T, B, H, dtype, tol):
    """Residual-free forward, training forward (ys, cs and the gate stream)
    and backward (dxs) against their plain versions. The backward runs on
    the plain forward's residuals (the kernel alone), then on the forward
    kernel's own (the training path's chain). bf16: the reference's bars,
    3e-2 forward and 5e-2 gradient (tests/test_rnn_pallas.py:81,88)."""
    xs, w, lo, hi, g = _lstm_inputs(dev, T, B, H, dtype, T * 1000 + H + B)
    before = (_kernels.LSTM_FWD.launches, _kernels.LSTM_FWD_TRAIN.launches,
              _kernels.LSTM_BWD.launches)
    ys0 = lstm_scan_cuda(xs, w, lo, hi, dtype)
    assert float((ys0 - lstm_scan_plain(xs, w, lo, hi, dtype)).abs().max()) \
        <= tol
    ys, cs, gates = lstm_scan_train_cuda(xs, w, lo, hi, dtype)
    ys_p, cs_p, gates_p = lstm_scan_train_plain(xs, w, lo, hi, dtype)
    assert torch.equal(ys, ys0)
    assert float((ys - ys_p).abs().max()) <= tol
    assert float((cs - cs_p).abs().max()) <= tol
    assert float((gates.float() - gates_p.float()).abs().max()) <= tol
    dxs_p = lstm_bwd_plain(gates_p, w, lo, hi, cs_p, g, dtype)
    gtol = tol if dtype == torch.float32 else 5e-2
    for gt, c in ((gates_p, cs_p), (gates, cs)):
        dxs = lstm_bwd_cuda(gt, w, lo, hi, c, g, dtype)
        assert float((dxs.float() - dxs_p.float()).abs().max()) <= gtol
    assert (_kernels.LSTM_FWD.launches, _kernels.LSTM_FWD_TRAIN.launches,
            _kernels.LSTM_BWD.launches) == (before[0] + 1, before[1] + 1,
                                            before[2] + 2)
    if B > 1:       # a length-0 row: h and c stay 0, no gradient
        assert torch.all(ys[:, 1] == 0) and torch.all(cs[:, B + 1] == 0)
        assert torch.all(dxs[:, 1] == 0) and torch.all(dxs[:, B + 1] == 0)


_STREAM = {"gru": (3, gru_scan_stream_cuda, gru_scan_stream_plain,
                   gru_scan_cuda, gru_scan_plain, "GRU_FWD_STREAM"),
           "lstm": (4, lstm_scan_stream_cuda, lstm_scan_stream_plain,
                    lstm_scan_cuda, lstm_scan_plain, "LSTM_FWD_STREAM")}


@pytest.mark.parametrize("ndir,T,B,H", [(1, 16, 5, 256), (2, 20, 3, 96),
                                        (1, 9, 1, 384), (2, 1, 1, 32),
                                        (1, 33, 2, 512)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_kernels_match_plain(dev, cell, ndir, T, B, H, dtype, tol):
    """The stream forms (h0-seeded, carry after emit_t steps) and the
    ndir = 1 inference form against their plain versions: emit_t 0, mid
    and T, ragged lengths (row 1 ends at step 1, before mid), nonzero h0;
    (1, 9, 1, 384) is the R = 1 launch of one forward-only stream. bf16:
    the reference's bar (tests/test_rnn_pallas.py:81)."""
    G, stream_cuda, stream_plain, scan_cuda, scan_plain, kname = _STREAM[cell]
    rng = np.random.default_rng(T * 1000 + H + B + ndir)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = min(T, 1)
    lens = torch.from_numpy(lens)
    lo, hi = torch.zeros(B), lens
    if ndir == 2:
        lo, hi = torch.cat([lo, T - lens]), torch.cat([hi,
                                                       torch.full((B,), T)])
    lo, hi = lo[:, None].float().to(dev), hi[:, None].float().to(dev)
    R, C = ndir * B, H if cell == "gru" else 2 * H
    w = torch.from_numpy((rng.standard_normal((ndir, H, G * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal(
        (T, R, G * H)).astype(np.float32)).to(dev).to(
            torch.float32 if dtype == torch.float32 else torch.bfloat16)
    h0 = torch.from_numpy((0.5 * rng.standard_normal((R, C))).astype(
        np.float32)).to(dev)
    kernel = getattr(_kernels, kname)
    before = kernel.launches
    for emit_t in sorted({0, max(T // 2, 1), T}):
        ys, carry = stream_cuda(xs, w, lo, hi, h0, dtype, emit_t)
        ys_p, carry_p = stream_plain(xs, w, lo, hi, h0, dtype, emit_t)
        assert float((ys - ys_p).abs().max()) <= tol
        assert float((carry - carry_p).abs().max()) <= tol
        if emit_t == 0:
            assert torch.equal(carry, h0)
    assert kernel.launches == before + len({0, max(T // 2, 1), T})
    got = scan_cuda(xs, w, lo, hi, dtype)
    assert float((got - scan_plain(xs, w, lo, hi, dtype)).abs().max()) <= tol


@pytest.mark.parametrize("B,T,V,L", [(1, 1, 3, 1), (6, 40, 7, 9),
                                     (4, 70, 30, 300)])
def test_ctc_kernels_match_plain(dev, B, T, V, L):
    """Loss, alphas and d lp_ext against the plain α/β recursions: ragged
    time and label lengths, label length 0, repeated labels, an impossible
    sample and a length above T; S = 601 takes more states than threads.
    Bars: loss rtol 1e-5, gradient atol 2e-4, fp32
    (tests/test_ctc_pallas.py:35-42); alphas at the loss's rtol plus 1e-4,
    their LOG_ZERO states exactly. The backward runs on the plain alphas
    and on the forward kernel's own, as training does."""
    rng = np.random.default_rng(B * 100 + T)
    logits = torch.from_numpy(
        2 * rng.standard_normal((B, T, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, V, (B, L)).astype(np.int32))
    tl = rng.integers(1, T + 1, B)
    ll = rng.integers(0, L + 1, B)
    if B > 1:
        tl[0], ll[0] = T, min(L, max(T // 3, 1))
        labels[0, :2] = 2                       # repeat: no skip transition
        ll[1] = 0
        tl[2], ll[2] = 2, L                     # impossible
        tl[3] = T + 5                           # clamped to T
    g = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).to(dev)
    lp_ext, allow2, t_len, lab_len = ctc_inputs(
        logits.to(dev), torch.from_numpy(tl).to(dev), labels.to(dev),
        torch.from_numpy(ll).to(dev))
    before = (_kernels.CTC_FWD.launches, _kernels.CTC_BWD.launches)
    alphas, loss = ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len)
    alphas_p, loss_p = ctc_alpha_plain(lp_ext, allow2, t_len, lab_len)
    torch.testing.assert_close(loss, loss_p, rtol=1e-5, atol=0)
    # alphas over all of [B, T, S]: LOG_ZERO states and frozen rows exactly
    sent = alphas_p <= LOG_ZERO / 2
    assert torch.equal(alphas <= LOG_ZERO / 2, sent)
    assert torch.equal(alphas[sent], alphas_p[sent])
    torch.testing.assert_close(alphas[~sent], alphas_p[~sent], rtol=1e-5,
                               atol=1e-4)
    g = torch.where(loss_p < 5e29, g, 0.0)
    grad_p = ctc_beta_grad_plain(lp_ext, allow2, t_len, lab_len, alphas_p,
                                 loss_p, g)
    # on the plain alphas, then on the forward kernel's own
    for a, l in ((alphas_p, loss_p), (alphas, loss)):
        grad = ctc_bwd_cuda(lp_ext, allow2, t_len, lab_len, a, l, g)
        assert float((grad - grad_p).abs().max()) <= 2e-4
    assert (_kernels.CTC_FWD.launches, _kernels.CTC_BWD.launches) == (
        before[0] + 1, before[1] + 2)
    if B > 1:
        assert float(loss[2]) >= 1e29 and torch.all(grad[2] == 0)


@pytest.mark.parametrize("B,T,V", [(1, 1, 1), (3, 70, 5), (2, 130, 100),
                                   (4, 65, 64)])
def test_greedy_kernel_matches_plain(dev, B, T, V):
    """Exact: ties, a NaN in a frame, an all-NaN frame, lengths 0, 1, T."""
    rng = np.random.default_rng(V)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    if V > 3 and T > 5:
        logits[0, 2, [1, 3]] = 9.0
        logits[0, 3, 2] = np.nan
        logits[0, 5, :] = np.nan
    lens = np.asarray([T, 0, 1, T // 2][:B], np.int32)
    lg = torch.from_numpy(logits).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    kb, kk = best_keep_cuda(lg, ln)
    pb, pk = best_keep_plain(lg, ln)
    assert torch.equal(kb, pb) and torch.equal(kk, pk)
    if V > 3 and T > 5:
        assert int(kb[0, 2]) == 1 and int(kb[0, 3]) == 0 \
            and int(kb[0, 5]) == 0


def test_kernels_refuse_what_they_do_not_take(dev):
    xs = torch.zeros(3, 4, 3 * 48, device=dev)
    w = torch.zeros(2, 48, 3 * 48, device=dev)
    lo = torch.zeros(4, 1, device=dev)
    with pytest.raises(ValueError, match="hidden size"):
        gru_scan_cuda(xs, w, lo, lo, torch.float32)
    with pytest.raises(ValueError, match="hidden size"):       # > 512
        gru_scan_cuda(torch.zeros(3, 4, 3 * 544, device=dev),
                      torch.zeros(2, 544, 3 * 544, device=dev), lo, lo,
                      torch.float32)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        gru_scan_cuda(torch.zeros(3, 4, 96, device=dev),
                      torch.zeros(2, 32, 96, device=dev), lo, lo,
                      torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        best_keep_cuda(torch.zeros(1, 2, 3), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="cannot hold"):
        fused_logmel_rows_cuda(torch.zeros(1, 600, device=dev), 5)
    with pytest.raises(ValueError, match="int32"):
        ctc_fwd_cuda(torch.zeros(1, 2, 3, device=dev),
                     torch.zeros(1, 3, device=dev),
                     torch.ones(1, device=dev), torch.ones(1, device=dev))
    with pytest.raises(ValueError, match="hidden size"):
        gru_bwd_cuda(torch.zeros(3, 4, 4 * 48, device=dev), w, lo, lo,
                     torch.zeros(3, 4, 48, device=dev),
                     torch.zeros(3, 4, 48, device=dev), torch.float32)
    with pytest.raises(ValueError, match="lstm kernel: hidden size"):
        lstm_scan_cuda(torch.zeros(3, 4, 4 * 48, device=dev),
                       torch.zeros(2, 48, 4 * 48, device=dev), lo, lo,
                       torch.float32)
    with pytest.raises(ValueError, match="emit_t"):
        gru_scan_stream_cuda(torch.zeros(3, 4, 96, device=dev),
                             torch.zeros(2, 32, 96, device=dev), lo, lo,
                             torch.zeros(4, 32, device=dev), torch.float32, 4)
    with pytest.raises(ValueError, match="multiple of ndir"):
        gru_scan_cuda(torch.zeros(3, 3, 96, device=dev),
                      torch.zeros(2, 32, 96, device=dev), lo[:3], lo[:3],
                      torch.float32)
    with pytest.raises(ValueError, match=r"h0: expected shape \(4, 64\)"):
        lstm_scan_stream_cuda(torch.zeros(3, 4, 128, device=dev),
                              torch.zeros(2, 32, 128, device=dev), lo, lo,
                              torch.zeros(4, 32, device=dev), torch.float32, 1)
    with pytest.raises(ValueError, match=r"expected shape \(2, 32, 128\)"):
        lstm_scan_train_cuda(torch.zeros(3, 4, 128, device=dev),
                             torch.zeros(2, 32, 96, device=dev), lo, lo,
                             torch.float32)


@pytest.mark.parametrize("B,T", [(1, 1), (2, 17), (3, 101)])
def test_frames_frontend_kernel_matches_plain(dev, B, T):
    """The framed form (row 2) on [B, T, 512] frames: one partial tile,
    one + a bit, several. Bar: 5e-4 max abs."""
    rng = np.random.default_rng(B * 100 + T)
    frames = torch.from_numpy(0.3 * rng.standard_normal(
        (B, T, C.N_FFT)).astype(np.float32)).to(dev)
    before = _kernels.FRONTEND_LOGMEL_FRAMES.launches
    got = fused_logmel_cuda(frames)
    want = logmel_from_frames(frames)
    assert _kernels.FRONTEND_LOGMEL_FRAMES.launches == before + 1
    assert got.shape == (B, T, C.N_MELS)
    assert float((got - want).abs().max()) <= 5e-4


def _flash_inputs(dev, B, T, h, dh, dtype, seed, strided):
    """q, k, v [B, T, h, dh] (with ``strided``, views of one [B, T, 3·h·dh]
    tensor, as the model's fused qkv gives them), dO, lengths with 1 and T
    and, for B > 2, 0."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev).to(dtype)
    if strided:
        qkv = f(B, T, 3 * h * dh)
        q, k, v = (qkv[..., i * h * dh:(i + 1) * h * dh].reshape(B, T, h, dh)
                   for i in range(3))
    else:
        q, k, v = f(B, T, h, dh), f(B, T, h, dh), f(B, T, h, dh)
    lens = rng.integers(1, T + 1, B)
    lens[0] = T
    if B > 1:
        lens[1] = 1
    if B > 2:
        lens[2] = 0
    return q, k, v, f(B, T, h, dh), torch.from_numpy(lens).to(dev).to(
        torch.int32)


@pytest.mark.parametrize("B,T,h,dh,chunk,left", [
    (1, 1, 1, 64, 0, 0), (3, 70, 2, 64, 0, 0), (4, 200, 2, 64, 16, 2),
    (2, 130, 3, 64, 0, 0), (3, 300, 2, 64, 16, 4), (2, 65, 1, 64, 8, 1)]
    # the 64-row tile edges, strided (even B) and contiguous (odd B), and
    # the long-form length, whole and in 16/4 chunks
    + [(B, T, 2, 64, 0, 0) for T in (63, 64, 65, 127, 128, 129)
       for B in (2, 3)]
    + [(2, 701, 4, 64, 0, 0), (3, 701, 2, 64, 0, 0), (2, 701, 2, 64, 16, 4),
       (3, 701, 2, 64, 16, 4)])
@pytest.mark.parametrize("dtype,tol,gtol", [
    (torch.float32, (2e-5, 2e-5), (3e-4, 3e-4)),
    (torch.bfloat16, (2 ** -7, 1e-5), (2 ** -7, 1e-3))])
def test_flash_kernels_match_plain(dev, B, T, h, dh, chunk, left, dtype,
                                   tol, gtol):
    """Forward (out and lse), dQ and dK/dV against their plain versions on
    the same inputs, ragged lengths (0, 1, T), strided q/k/v, key tiles
    skipped by the chunk window; every output finite. Bars (rtol, atol),
    elementwise |a - b| <= atol + rtol·s, s = |b|: fp32 the JAX suite's
    (2e-5 forward, 3e-4 gradients). bf16, both sides bf16 on the same
    inputs: out at s = |b| + Σ p·|v| / l, since each side rounds p (the
    kernel against its running max, the plain version against the row's)
    and out to half an ulp (2^-8); gradients one ulp plus 1e-3; lse (fp32
    in both) at the fp32 forward bar."""
    q, k, v, do, lens = _flash_inputs(dev, B, T, h, dh, dtype, T + dh,
                                      strided=B % 2 == 0)
    before = {n: _kernels.KERNELS[n].launches
              for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out, lse = ac.flash_fwd_cuda(q, k, v, lens, chunk, left)
    out_p, lse_p = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    rtol, atol = tol
    scale = out_p.float().abs()
    if dtype == torch.bfloat16:
        scale += ac.flash_fwd_plain(q, k, v.abs(), lens, chunk,
                                    left)[0].float()
    diff = (out.float() - out_p.float()).abs()
    assert bool((diff <= atol + rtol * scale).all()), float(
        (diff / (atol + rtol * scale)).max())
    live = lse_p > ac.NEG / 2              # rows with an allowed key
    assert torch.equal(lse[~live], lse_p[~live])
    torch.testing.assert_close(lse[live], lse_p[live], rtol=2e-5, atol=2e-5)
    d_rows = (do.float() * out_p.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
    dq = ac.flash_bwd_dq_cuda(*args)
    dk, dv = ac.flash_bwd_dkv_cuda(*args)
    dq_p = ac.flash_bwd_dq_plain(*args)
    dk_p, dv_p = ac.flash_bwd_dkv_plain(*args)
    torch.cuda.synchronize()
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=gtol[0],
                                   atol=gtol[1])
    after = {n: _kernels.KERNELS[n].launches for n in before}
    assert after == {n: c + 1 for n, c in before.items()}


@pytest.mark.parametrize("chunk,left", [(0, 0), (16, 4)])
def test_flash_bwd_bf16_is_bitwise_repeatable(dev, chunk, left):
    """Each output tile has one owner block and no atomics: two bf16
    backward calls on the same inputs give the same bits."""
    q, k, v, do, lens = _flash_inputs(dev, 4, 701, 4, 64, torch.bfloat16,
                                      chunk + 1, strided=True)
    out, lse = ac.flash_fwd_cuda(q, k, v, lens, chunk, left)
    d_rows = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse, d_rows, chunk, left)
    runs = [(ac.flash_bwd_dq_cuda(*args), *ac.flash_bwd_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_bwd_bf16_refuses_unaligned_rows(dev):
    """The bf16 backward copies 16-byte pieces of each row: a t stride
    that is not a multiple of 8 values is refused, not misread."""
    B, T, h = 2, 10, 2
    q = torch.zeros(B, T, h * 64 + 4, device=dev, dtype=torch.bfloat16)[
        ..., :h * 64].reshape(B, T, h, 64)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    rows = torch.zeros(B, h, T, device=dev)
    for launch in (ac.flash_bwd_dq_cuda, ac.flash_bwd_dkv_cuda):
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch(q, q, q, lens, q, rows, rows)


def test_flash_mhsa_autograd_on_card(dev):
    """flash_mhsa under autograd launches the three kernels once each and
    gives the gradients of the plain version's autograd."""
    q, k, v, do, lens = _flash_inputs(dev, 3, 90, 2, 64, torch.float32, 5,
                                      strided=True)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = _kernels.FLASH_BWD_DKV.launches
    out = ac.flash_mhsa(*leaves, lens, 16, 2)
    (out * do).sum().backward()
    assert _kernels.FLASH_BWD_DKV.launches == before + 1
    ref = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out_p, _ = ac.flash_fwd_plain(*ref, lens, 16, 2)
    (out_p * do).sum().backward()
    for a, b in zip(leaves, ref):
        assert float((a.grad - b.grad).abs().max()) <= 3e-4


def test_flash_mhsa_bf16_autograd_takes_unaligned_rows(dev):
    """Under autograd the bf16 backward copies operands whose rows are not
    16-byte aligned instead of refusing them: q, k, v and the incoming
    gradient views with a t stride of 2·64 + 4 values give the gradients of
    aligned copies, bit for bit."""
    B, T, h = 2, 70, 2

    def unaligned(t):                      # [B, T, h, 64] → odd t stride
        wide = torch.zeros(B, T, h * 64 + 4, device=dev, dtype=t.dtype)
        wide[..., :h * 64] = t.reshape(B, T, h * 64)
        return wide[..., :h * 64].reshape(B, T, h, 64)

    q, k, v, do, lens = _flash_inputs(dev, B, T, h, 64, torch.bfloat16, 11,
                                      strided=False)
    grads = []
    for make in (unaligned, lambda t: t.clone()):
        leaves = [make(t).requires_grad_() for t in (q, k, v)]
        g = make(do)
        assert ac.rows_aligned16(g) == (make is not unaligned)
        out = ac.flash_mhsa(*leaves, lens)
        grads.append(torch.autograd.grad(out, leaves, g))
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(2, 10, 2, 64, device=dev)
    lens = torch.full((2,), 10, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head width 96"):
        z = torch.zeros(2, 10, 2, 96, device=dev)
        ac.flash_fwd_cuda(z, z, z, lens)
    with pytest.raises(ValueError, match="head dim must be dense"):
        ac.flash_fwd_cuda(q, q, q.transpose(2, 3).contiguous()
                          .transpose(2, 3), lens)
    with pytest.raises(ValueError, match="int32"):
        ac.flash_fwd_cuda(q, q, q, lens.long())
    with pytest.raises(ValueError, match="expected torch.float32"):
        ac.flash_fwd_cuda(q, q, q.half(), lens)
