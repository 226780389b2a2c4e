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
    best_keep_plain, compact_kept, greedy_decode, greedy_decode_cuda)
from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
    _device_tables, frames_per_block, fused_logmel_cuda,
    fused_logmel_rows_cuda)
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    _K, extend_signal, logmel_from_extended, logmel_from_frames)
from chainer_speech_recognition_tpu_torch.ops import attention_cuda as ac
from chainer_speech_recognition_tpu_torch.ops.ctc import (
    LOG_ZERO, ctc_alpha_plain, ctc_beta_grad_plain, ctc_inputs)
from chainer_speech_recognition_tpu_torch.ops.ctc_cuda import (
    MAX_STATES, ctc_bwd_cuda, ctc_fwd_cuda, ctc_plan)
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    dw_cuda, dw_plain, dw_plan, gru_bwd_cuda, gru_bwd_plain, gru_occupancy, gru_plan, gru_scan_cuda,
    gru_scan_plain, gru_scan_stream_cuda, gru_scan_stream_plain,
    gru_scan_train_cuda, gru_scan_train_plain, lstm_bwd_cuda,
    lstm_bwd_plain, lstm_scan_cuda, lstm_scan_plain, lstm_scan_stream_cuda,
    lstm_occupancy, lstm_plan, lstm_scan_stream_plain, lstm_scan_train_cuda,
    lstm_scan_train_plain, shift_prev)

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


@pytest.mark.parametrize("tiles,extra", [(0, 1), (1, -1), (1, 0), (1, 1),
                                         (2, 1)])
@pytest.mark.parametrize("framed", [False, True])
def test_frontend_kernel_tile_edges(dev, tiles, extra, framed):
    """Both forms at T = 1, F - 1, F, F + 1 and 2F + 1 frames for the
    kernel's tile of F frames, as the library reports it: ragged lengths
    whose signal is silent past its length (the batch's zero padding), one
    utterance of T frames; the extended form also on a row length that is
    not a multiple of 4 (its scalar load). Bar: 5e-4 max abs."""
    T = tiles * frames_per_block() + extra
    rng = np.random.default_rng(T)
    n = (T - 1) * C.HOP_LENGTH + 37                  # T frames exactly
    lens = [n, max(n // 2, 1), max(n - 300, 1)]
    sigs = np.zeros((3, n), np.float32)
    for i, L in enumerate(lens):
        sigs[i, :L] = np.sin(0.03 * np.arange(L) * (i + 1)) \
            + 0.05 * rng.standard_normal(L)
    assert C.num_frames(n) == T
    ext = extend_signal(torch.from_numpy(sigs).to(dev),
                        torch.tensor(lens, device=dev), T + _K + 1)
    if framed:
        frames = ext.unfold(1, C.N_FFT, C.HOP_LENGTH)[:, :T].contiguous()
        got, want = fused_logmel_cuda(frames), logmel_from_frames(frames)
    else:
        got, want = fused_logmel_rows_cuda(ext, T), logmel_from_extended(
            ext, T)
        odd = ext[:, :-1].contiguous()               # ext_len % 4 == 3
        assert torch.equal(fused_logmel_rows_cuda(odd, T), got)
    torch.cuda.synchronize()
    assert got.shape == (3, T, C.N_MELS)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 5e-4


@pytest.mark.parametrize("n_mels", [1, 33, 39, 41])
def test_frontend_kernel_refuses_other_mel_counts(dev, n_mels):
    """The tables hold 40 filters and the wide filters' split takes all 32
    lanes of a warp: the entry point refuses any other count."""
    ext = torch.zeros(1, 1024, device=dev)
    out = torch.empty(1, 2, 41, device=dev)
    floats, ints = _device_tables(ext.device)
    with pytest.raises(RuntimeError, match="csr_frontend_logmel: CUDA error"):
        _kernels.FRONTEND_LOGMEL.launch(
            ext.data_ptr(), 1024, 1, 2, floats.data_ptr(), ints.data_ptr(),
            n_mels, out.data_ptr(), _kernels.stream_ptr(ext))


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
    dxs, dhn = gru_bwd_cuda(gates_p, w, lo, hi, ys_p, g, dtype)
    dxs_p, dhn_p = gru_bwd_plain(gates_p, w, lo, hi, shift_prev(ys_p), g,
                                 dtype)
    gtol = tol if dtype == torch.float32 else 5e-2
    assert float((dxs.float() - dxs_p.float()).abs().max()) <= gtol
    assert float((dhn.float() - dhn_p.float()).abs().max()) <= gtol
    assert (_kernels.GRU_FWD_TRAIN.launches, _kernels.GRU_BWD.launches) == (
        before[0] + 1, before[1] + 1)
    if B > 1:       # a length-0 row has no live step: zero gradient
        assert torch.all(dxs[:, 1] == 0) and torch.all(dhn[:, B + 1] == 0)


def _gru_inputs(dev, T, B, H, dtype, seed):
    """Ragged lengths including T and 0; xs in the stream dtype."""
    rng = np.random.default_rng(seed)
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
        (T, 2 * B, 3 * H)).astype(np.float32)).to(dev).to(dtype)
    g = torch.from_numpy(rng.standard_normal(
        (T, 2 * B, H)).astype(np.float32)).to(dev)
    return lens, xs, w, lo, hi, g


@pytest.mark.parametrize("T,B,H", [(9, 15, 256), (6, 16, 96), (5, 17, 512),
                                   (4, 33, 32), (3, 64, 256), (12, 1, 256),
                                   (7, 17, 448), (8, 16, 160), (1, 20, 256)])
def test_gru_bf16_kernels_at_cluster_edges(dev, T, B, H):
    """The bf16 cluster kernels: the residual-free forward (ndir 2 and,
    on the forward rows with their own W, ndir 1), the training forward
    (ys and the gate stream) and the backward (dxs, dhn, on the plain
    forward's residuals and on the kernel's own) against their plain
    versions, at B around the 16-row group (1, 15, 16, 17, 20, 33, 64:
    padded rows of the m16 tile and more than one cluster a direction),
    clusters of 1 to 16 blocks (H = 32 to 512, C = H / 32, and H / 16 in
    the backward up to H = 256: both of its instantiations; 96, 160 and
    448 odd sizes), T = 1 (no exchange), ragged lengths and a length-0
    row.
    The reference's bars, 3e-2 forward and 5e-2 gradient
    (tests/test_rnn_pallas.py:81,88)."""
    cdt = torch.bfloat16
    lens, xs, w, lo, hi, g = _gru_inputs(dev, T, B, H, cdt,
                                         T * 1000 + H + B)
    before = (_kernels.GRU_FWD.launches, _kernels.GRU_FWD_TRAIN.launches,
              _kernels.GRU_BWD.launches)
    ys0 = gru_scan_cuda(xs, w, lo, hi, cdt)
    assert float((ys0 - gru_scan_plain(xs, w, lo, hi, cdt)).abs().max()) \
        <= 3e-2
    x1, w1, lo1 = xs[:, :B].contiguous(), w[:1].contiguous(), lo[:B]
    hi1 = hi[:B]
    ys1 = gru_scan_cuda(x1, w1, lo1, hi1, cdt)
    assert float((ys1 - gru_scan_plain(x1, w1, lo1, hi1, cdt)).abs().max()) \
        <= 3e-2
    ys, gates = gru_scan_train_cuda(xs, w, lo, hi, cdt)
    ys_p, gates_p = gru_scan_train_plain(xs, w, lo, hi, cdt)
    assert torch.equal(ys, ys0)
    assert float((ys - ys_p).abs().max()) <= 3e-2
    assert float((gates.float() - gates_p.float()).abs().max()) <= 3e-2
    dxs_p, dhn_p = gru_bwd_plain(gates_p, w, lo, hi, shift_prev(ys_p), g,
                                 cdt)
    for gt, y in ((gates_p, ys_p), (gates, ys)):
        dxs, dhn = gru_bwd_cuda(gt, w, lo, hi, y, g, cdt)
        assert float((dxs.float() - dxs_p.float()).abs().max()) <= 5e-2
        assert float((dhn.float() - dhn_p.float()).abs().max()) <= 5e-2
    assert (_kernels.GRU_FWD.launches, _kernels.GRU_FWD_TRAIN.launches,
            _kernels.GRU_BWD.launches) == (before[0] + 2, before[1] + 1,
                                           before[2] + 2)
    if B > 1:       # a length-0 row: h stays 0, no gradient
        assert torch.all(ys[:, 1] == 0) and torch.all(ys[:, B + 1] == 0)
        assert torch.all(ys1[:, 1] == 0)
        assert torch.all(dxs[:, 1] == 0) and torch.all(dhn[:, B + 1] == 0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gru_bf16_kernels_are_repeatable(dev, seed):
    """The bf16 cluster kernels three times on the same inputs at bigru's
    width (T = 64, B = 24, H = 256): the forward (both forms, and ndir 1)
    and the backward bitwise equal each time (no atomics; a missing
    cluster barrier would show as rare mismatches)."""
    cdt = torch.bfloat16
    _, xs, w, lo, hi, g = _gru_inputs(dev, 64, 24, 256, cdt, 200 + seed)
    x1, w1 = xs[:, :24].contiguous(), w[:1].contiguous()
    first = None
    for _ in range(3):
        ys0 = gru_scan_cuda(xs, w, lo, hi, cdt)
        ys1 = gru_scan_cuda(x1, w1, lo[:24], hi[:24], cdt)
        ys, gates = gru_scan_train_cuda(xs, w, lo, hi, cdt)
        dxs, dhn = gru_bwd_cuda(gates, w, lo, hi, ys, g, cdt)
        got = [t.view(torch.int16) if t.dtype == cdt else t
               for t in (ys0, ys1, ys, gates, dxs, dhn)]
        if first is None:
            first = got
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    assert torch.equal(first[0], first[2])


@pytest.mark.parametrize("form", ["fwd", "bwd"])
def test_gru_plan_launches_on_card(dev, form):
    """For every hidden size the kernels take, the library computes the
    GRU plan's shared memory to the byte and the card holds at least one
    of its clusters (cudaOccupancyMaxActiveClusters)."""
    for H in range(32, 513, 32):
        p = gru_plan(H, 24, 2, form)
        smem, n = gru_occupancy(H, form)
        assert smem == p.smem
        assert n >= 1, (H, form, p)


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
                                   (33, 2, 384), (5, 2, 512),
                                   (9, 15, 384), (6, 16, 96), (5, 17, 512),
                                   (4, 33, 32), (3, 64, 384), (12, 1, 384),
                                   (7, 17, 448), (8, 16, 160)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_lstm_kernels_match_plain(dev, T, B, H, dtype, tol):
    """Residual-free forward, training forward (ys, cs and the gate stream)
    and backward (dxs) against their plain versions. The backward runs on
    the plain forward's residuals (the kernel alone), then on the forward
    kernel's own (the training path's chain). bf16: the reference's bars,
    3e-2 forward and 5e-2 gradient (tests/test_rnn_pallas.py:81,88). The
    shapes cover the bf16 cluster kernels' edges: B at and around the
    16-row group (1, 15, 16, 17, 33, 64: padded rows of the m16 tile and
    more than one cluster a direction) and clusters of 1 to 16 blocks
    (H = 32 to 512, C = H / 32; 160 and 448 odd sizes), with ragged
    lengths and a length-0 row."""
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lstm_bf16_kernels_are_repeatable(dev, seed):
    """The bf16 cluster kernels three times on the same inputs at
    bilstm_deep's width (T = 64, B = 24, H = 384): the forward (both forms)
    and the backward bitwise equal each time (no atomics; a missing
    cluster barrier would show as rare mismatches)."""
    xs, w, lo, hi, g = _lstm_inputs(dev, 64, 24, 384, torch.bfloat16,
                                    100 + seed)
    cdt = torch.bfloat16
    first = None
    for _ in range(3):
        ys0 = lstm_scan_cuda(xs, w, lo, hi, cdt)
        ys, cs, gates = lstm_scan_train_cuda(xs, w, lo, hi, cdt)
        dxs = lstm_bwd_cuda(gates, w, lo, hi, cs, g, cdt)
        got = [t.view(torch.int16) if t.dtype == cdt else t
               for t in (ys0, ys, cs, gates, dxs)]
        if first is None:
            first = got
        assert all(torch.equal(a, b) for a, b in zip(got, first))
    assert torch.equal(first[0], first[1])


@pytest.mark.parametrize("form", ["fwd", "bwd"])
def test_lstm_plan_launches_on_card(dev, form):
    """For every hidden size the kernels take, the library computes the
    plan's shared memory to the byte and the card holds at least one of
    its clusters (cudaOccupancyMaxActiveClusters)."""
    for H in range(32, 513, 32):
        p = lstm_plan(H, 24, 2, form)
        smem, n = lstm_occupancy(H, form)
        assert smem == p.smem
        assert n >= 1, (H, form, p)


_STREAM = {"gru": (3, gru_scan_stream_cuda, gru_scan_stream_plain,
                   gru_scan_cuda, gru_scan_plain, "GRU_FWD_STREAM"),
           "lstm": (4, lstm_scan_stream_cuda, lstm_scan_stream_plain,
                    lstm_scan_cuda, lstm_scan_plain, "LSTM_FWD_STREAM")}


def _stream_inputs(dev, cell, ndir, T, B, H, dtype, seed):
    """One window: ragged lengths (row 0 runs all T steps, row 1 ends at
    step 1, row 2 is empty), the backward rows' live steps at the right
    edge; xs in the stream dtype; a nonzero h0 on every row → (xs, w, lo,
    hi, h0)."""
    G = _STREAM[cell][0]
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = min(T, 1)
    if B > 2:
        lens[2] = 0
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
    return xs, w, lo, hi, h0


@pytest.mark.parametrize("ndir,T,B,H", [(1, 16, 5, 256), (2, 20, 3, 96),
                                        (1, 9, 1, 384), (2, 1, 1, 32),
                                        (1, 33, 2, 512), (2, 20, 15, 384),
                                        (1, 16, 16, 96), (2, 7, 17, 512),
                                        (1, 5, 33, 32), (2, 20, 33, 384),
                                        (1, 16, 17, 256)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_kernels_match_plain(dev, cell, ndir, T, B, H, dtype, tol):
    """The stream forms (h0-seeded, carry after emit_t steps) and the
    ndir = 1 inference form against their plain versions: emit_t 0, mid
    and T, ragged lengths (row 1 ends at step 1, before mid; row 2 is
    empty), nonzero h0; (1, 9, 1, 384) is the R = 1 launch of one
    forward-only stream. The bf16 forms run on the cluster kernels: B
    around the 16-row group (1, 15, 16, 17, 33: padded rows of the m16
    tile and more than one cluster a direction) and clusters of 1 to 16
    blocks (H = 32 to 512). bf16: the reference's bar
    (tests/test_rnn_pallas.py:81)."""
    _, stream_cuda, stream_plain, scan_cuda, scan_plain, kname = \
        _STREAM[cell]
    xs, w, lo, hi, h0 = _stream_inputs(dev, cell, ndir, T, B, H, dtype,
                                       T * 1000 + H + B + ndir)
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


# the streaming paths' two windows (chip_smoke.stream_cases): uni_gru's
# forward-only GRU and bilstm_deep's BiLSTM, B = 32, emit_t = C/s
_WINDOWS = {"gru": (1, 16, 32, 256, 16), "lstm": (2, 20, 32, 384, 16)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_bf16_kernels_are_repeatable(dev, cell, seed):
    """The bf16 stream form three times on the same window: ys and carry
    bitwise equal each time (partial sums in a fixed order, no atomics; a
    missing cluster barrier would show as rare mismatches)."""
    ndir, T, B, H, emit = _WINDOWS[cell]
    stream_cuda = _STREAM[cell][1]
    xs, w, lo, hi, h0 = _stream_inputs(dev, cell, ndir, T, B, H,
                                       torch.bfloat16, 300 + seed)
    first = stream_cuda(xs, w, lo, hi, h0, torch.bfloat16, emit)
    for _ in range(2):
        got = stream_cuda(xs, w, lo, hi, h0, torch.bfloat16, emit)
        assert all(torch.equal(a, b) for a, b in zip(got, first))


@pytest.mark.parametrize("ndir,T,B,H", [(1, 16, 32, 256), (2, 20, 32, 384),
                                        (1, 9, 1, 96), (2, 5, 17, 512)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_bf16_at_zero_h0_equals_the_scan(dev, cell, ndir, T, B, H):
    """With h0 = 0 the bf16 stream form's ys equal the residual-free
    cluster form's bit for bit: both share the product and the gate math,
    and bf16(0) seeds the first product's A operand."""
    _, stream_cuda, _, scan_cuda, _, _ = _STREAM[cell]
    xs, w, lo, hi, h0 = _stream_inputs(dev, cell, ndir, T, B, H,
                                       torch.bfloat16, 400 + T + H)
    cdt = torch.bfloat16
    ys, carry = stream_cuda(xs, w, lo, hi, torch.zeros_like(h0), cdt, T // 2)
    assert torch.equal(ys, scan_cuda(xs, w, lo, hi, cdt))
    assert torch.equal(carry[:, :H], ys[T // 2 - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_stream_wrapper_counts_one_launch_a_call(dev, cell, dtype):
    """Each stream call adds one to its kernel's launch count and nothing
    to any other kernel's, whichever kernel (cluster or FMA) it takes."""
    ndir, T, B, H, emit = _WINDOWS[cell]
    stream_cuda, kname = _STREAM[cell][1], _STREAM[cell][5]
    xs, w, lo, hi, h0 = _stream_inputs(dev, cell, ndir, T, B, H, dtype, 7)
    for n in range(1, 4):
        before = _kernels.launches()
        stream_cuda(xs, w, lo, hi, h0, dtype, emit)
        after = _kernels.launches()
        assert {k: after[k] - before[k] for k in after if
                after[k] != before[k]} == {kname.lower(): 1}, n


def _ctc_case(dev, B, T, V, L, S, tl_mode):
    """CTC inputs on the card: ragged (or all-1, or all-T) time lengths,
    label lengths from 0 to L (0 beside a full label), repeated labels, an
    impossible sample and a length above T (ragged, B > 3); with S given,
    the extended states cut to S (even S too) and lab_len to fit them.
    The seed and the ragged draws are those the test took before its
    length modes, so its first three cases keep their data."""
    seed = B * 100 + T + 1000 * (S or 0) + 7 * ("ragged", "one",
                                                 "full").index(tl_mode)
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(
        2 * rng.standard_normal((B, T, V)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(1, V, (B, L)).astype(np.int32))
    tl = rng.integers(1, T + 1, B)
    ll = rng.integers(0, L + 1, B)
    if tl_mode != "ragged":
        tl[:] = 1 if tl_mode == "one" else T
        ll[0] = 0
        ll[-1] = L
    elif B > 3:
        tl[0], ll[0] = T, min(L, max(T // 3, 1))
        labels[0, :2] = 2                       # repeat: no skip transition
        ll[1] = 0
        tl[2], ll[2] = 2, L                     # impossible
        tl[3] = T + 5                           # clamped to T
    g = torch.from_numpy(rng.uniform(0.5, 2.0, B).astype(np.float32)).to(dev)
    lp_ext, allow2, t_len, lab_len = ctc_inputs(
        logits.to(dev), torch.from_numpy(tl).to(dev), labels.to(dev),
        torch.from_numpy(ll).to(dev))
    if S is not None:
        lp_ext = lp_ext[:, :, :S].contiguous()
        allow2 = allow2[:, :S].contiguous()
        lab_len = torch.clamp(lab_len, max=(S - 1) // 2)
    return lp_ext, allow2, t_len, lab_len, g


@pytest.mark.parametrize("B,T,V,L,S,tl_mode", [
    (1, 1, 3, 1, None, "ragged"), (6, 40, 7, 9, None, "ragged"),
    (4, 70, 30, 300, None, "ragged"),
    # the lanes kernels' edges, 56 own states a warp: S = 56k - 1, 56k
    # and 56k + 1 (one warp, two, three), six warps, 16 warps, a 66-label
    # alignment over 200 frames across three warps' halos, and 16 warps
    # over 300 frames (75 exchanges for them to drift between)
    (5, 20, 11, 27, None, "ragged"), (5, 20, 11, 28, 56, "ragged"),
    (5, 20, 11, 28, None, "ragged"), (3, 12, 11, 55, None, "ragged"),
    (3, 12, 11, 56, 112, "ragged"), (3, 12, 11, 56, None, "ragged"),
    (5, 30, 11, 144, None, "ragged"), (2, 6, 11, 447, None, "ragged"),
    (4, 200, 20, 80, None, "ragged"), (2, 300, 11, 447, None, "full"),
    # past 16 warps: the wide kernels
    (2, 6, 11, 448, None, "ragged"),
    # every t_len 1, every t_len T, T = 1 below the ring's depth
    (7, 30, 9, 40, None, "one"), (7, 30, 9, 40, None, "full"),
    (5, 1, 9, 4, None, "full")])
def test_ctc_kernels_match_plain(dev, B, T, V, L, S, tl_mode):
    """Loss, alphas and d lp_ext against the plain α/β recursions: ragged
    time and label lengths, label length 0, repeated labels, an impossible
    sample and a length above T; S = 601 takes more states than threads.
    Bars: loss rtol 1e-5, gradient atol 2e-4, fp32
    (tests/test_ctc_pallas.py:35-42); alphas at the loss's rtol plus 1e-4,
    their LOG_ZERO states exactly. The backward runs on the plain alphas
    and on the forward kernel's own, as training does."""
    lp_ext, allow2, t_len, lab_len, g = _ctc_case(dev, B, T, V, L, S,
                                                  tl_mode)
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
    if B > 3 and tl_mode == "ragged":
        assert float(loss[2]) >= 1e29 and torch.all(grad[2] == 0)


@pytest.mark.parametrize("B,T,L", [(24, 256, 128), (5, 40, 300)])
def test_ctc_kernels_are_bitwise_repeatable(dev, B, T, L):
    """Two runs of each kernel give the same bits (no atomics, a fixed
    order of every sum), at the training shape and at S = 601."""
    lp_ext, allow2, t_len, lab_len, g = _ctc_case(dev, B, T, 60, L, None,
                                                  "ragged")
    runs = []
    for _ in range(2):
        alphas, loss = ctc_fwd_cuda(lp_ext, allow2, t_len, lab_len)
        gz = torch.where(loss < 5e29, g, 0.0)
        runs.append([alphas, loss, ctc_bwd_cuda(lp_ext, allow2, t_len,
                                                lab_len, alphas, loss, gz)])
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("form", ["fwd", "bwd"])
def test_ctc_plan_covers_every_state(dev, form):
    """The launch shape the library computes from S: for every S from 1
    to 2·300 + 1 the lanes kernels (2 states a thread) with warps of 56
    own states and no spare warp, within the 232,448 bytes a block may
    take (at S = 257: 5 warps, rings of 8 slots of 64 floats a warp, the
    forward's last row, 256 floats of halo exchange); past 16 warps the
    wide kernels (512 threads, the wavefront's 2·S floats), up to the
    largest S a block holds."""
    for S in range(1, 2 * 300 + 2):
        p = ctc_plan(S, form)
        assert p.states == 2 and p.warps * 56 >= S > (p.warps - 1) * 56
        assert p.smem <= 232448
    rings = 1 if form == "fwd" else 2
    assert tuple(ctc_plan(257, form)) == (
        2, 5, 4 * (rings * 8 * 5 * 64 + (257 if form == "fwd" else 0) + 256))
    assert tuple(ctc_plan(897, form)) == (0, 16, 2 * 897 * 4)
    assert tuple(ctc_plan(MAX_STATES, form)) == (0, 16, 232448)
    with pytest.raises(RuntimeError, match="csr_ctc_plan"):
        ctc_plan(MAX_STATES + 1, form)


@pytest.mark.parametrize("B,T,V,max_len", [
    (1, 1, 1, None), (3, 70, 5, None), (2, 130, 100, 3), (4, 65, 64, None),
    (2, 9, 1, 1), (32, 251, 64, None), (32, 701, 64, None),
    (3, 2048, 3001, None), (5, 1100, 64, 7), (4, 600, 64, 1)])
def test_greedy_kernel_matches_plain(dev, B, T, V, max_len):
    """The one-launch decode (argmax, keep mask and compaction) exactly
    equal to compact_kept(*best_keep_plain(...)): ties, a NaN in a frame,
    an all-NaN frame, an all-NaN utterance, lengths 0, 1 and T, V = 1, 5,
    64 (16-byte loads) and 3001 (scalar loads), T past one chunk of 512
    frames (up to 2048), and max_len below the kept count."""
    rng = np.random.default_rng(V * 7 + T)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    if V > 3 and T > 5:
        logits[0, 2, [1, 3]] = 9.0
        logits[0, 3, 2] = np.nan
        logits[0, 5, :] = np.nan
    if B > 3:
        logits[3] = np.nan
    lens = rng.integers(0, T + 1, B).astype(np.int32)
    lens[: min(B, 3)] = [T, 0, 1][: min(B, 3)]
    lg = torch.from_numpy(logits).to(dev)
    ln = torch.from_numpy(lens).to(dev)
    want_len = max_len or T
    before = _kernels.GREEDY.launches
    ids, out_lens = greedy_decode(lg, ln, max_len)
    assert _kernels.GREEDY.launches == before + 1
    pids, plens = compact_kept(*best_keep_plain(lg, ln), want_len)
    assert ids.shape == (B, want_len) and ids.dtype == torch.int32
    assert torch.equal(ids, pids) and torch.equal(out_lens, plens)
    if max_len is not None and V > 1:      # some row is cut at max_len
        assert bool((plens == max_len).any())
    if B > 1:
        assert int(out_lens[1]) == 0
    if B > 3:
        assert int(out_lens[3]) == 0


def _dw_operands(dev, T, B, H, gru, seed):
    """ys [T, 2B, H] fp32 and the gate gradients: the LSTM's dxs [T, 2B,
    4H], or the GRU's dxs[..., :2H] of a [T, 2B, 3H] tensor (row stride 3H)
    and dhn [T, 2B, H], bf16, with dead rows zero as the backward masks
    them."""
    rng = np.random.default_rng(seed)
    ys = torch.from_numpy(rng.uniform(-1, 1, (T, 2 * B, H)).astype(
        np.float32)).to(dev)
    widths = (3 * H, H) if gru else (4 * H,)
    gs = [torch.from_numpy(rng.standard_normal((T, 2 * B, n)).astype(
        np.float32)).to(dev).to(torch.bfloat16) for n in widths]
    if B > 1:
        for g in gs:
            g[T // 2:, 1] = 0
    return ys, ((gs[0][..., :2 * H], gs[1]) if gru else (gs[0],))


def _dw_fp64(ys, gates, B):
    """The fp64 sum of the same bf16 operands and Σ|h·g| of each element,
    for each of the ys.shape[1] / B directions."""
    hp = shift_prev(ys).to(torch.bfloat16).double()
    g = torch.cat([x.double() for x in gates], dim=2)
    H, N = hp.shape[2], g.shape[2]
    dirs = range(hp.shape[1] // B)
    a = [hp[:, d * B:(d + 1) * B].reshape(-1, H) for d in dirs]
    b = [g[:, d * B:(d + 1) * B].reshape(-1, N) for d in dirs]
    ref = torch.stack([x.T @ y for x, y in zip(a, b)])
    absum = torch.stack([x.abs().T @ y.abs() for x, y in zip(a, b)])
    return ref, absum


@pytest.mark.parametrize("gru", [False, True])
@pytest.mark.parametrize("T", [1, 2, 256])
@pytest.mark.parametrize("B", [1, 7, 24])
@pytest.mark.parametrize("H", [32, 256, 384, 512])
def test_dw_kernel_matches_fp64_sum(dev, H, B, T, gru):
    """The dW kernel against the fp64 sum of the same bf16 operands at
    |Δ| ≤ K·2⁻²³·Σ_k|h_k·g_k| (K = T·B products an element, each exact in
    fp32, added in fp32: the worst-case growth of such a sum), against
    the plain version (today's fp32 product, itself within that bar of
    the fp64 sum: twice the bar between them), and against itself bitwise;
    one launch a call, the GRU's two products in one."""
    ys, gates = _dw_operands(dev, T, B, H, gru, H + 10 * B + T)
    before = _kernels.DW.launches
    got = dw_cuda(ys, gates, B)
    again = dw_cuda(ys, gates, B)
    assert _kernels.DW.launches == before + 2
    N = sum(g.shape[2] for g in gates)
    assert got.shape == (2, H, N) and got.dtype == torch.float32
    ref, absum = _dw_fp64(ys, gates, B)
    bar = T * B * 2.0 ** -23 * absum
    assert bool(((got.double() - ref).abs() <= bar).all())
    plain = torch.cat([dw_plain(ys, g, B, torch.bfloat16) for g in gates], 2)
    assert bool(((got.double() - plain.double()).abs() <= 2 * bar).all())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if T == 1:
        assert bool((got == 0).all())


_UNI = {"gru": (3, gru_scan_train_cuda, gru_scan_train_plain, gru_bwd_cuda,
                gru_bwd_plain),
        "lstm": (4, lstm_scan_train_cuda, lstm_scan_train_plain,
                 lstm_bwd_cuda, lstm_bwd_plain)}


def _uni_bwd(cell, fn, res, w, lo, hi, ys, g, dtype, plain=False):
    """(dxs, and dhn for the GRU) of the backward ``fn`` on residuals
    ``res`` (the GRU's gates, the LSTM's (cs, gates))."""
    if cell == "gru":
        return fn(res[-1], w, lo, hi, shift_prev(ys) if plain else ys, g,
                  dtype)
    return (fn(res[-1], w, lo, hi, res[0], g, dtype),)


@pytest.mark.parametrize("T,B,H", [(1, 1, 32), (7, 3, 64), (9, 15, 256),
                                   (6, 17, 384), (5, 33, 512), (256, 24, 256),
                                   (256, 24, 384)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_forward_only_train_kernels_match_plain(dev, cell, T, B, H, dtype,
                                                tol):
    """The one-direction training forms (ndir = 1: w [1, H, G·H], B rows,
    a forward-only layer's one W): the training forward (ys, the
    residuals), the backward (on the plain forward's residuals and on the
    kernel's own) and, in bf16, dW, against their plain versions at the
    reference's bars (3e-2 forward, 5e-2 gradient; dW within
    K·2⁻²³·Σ|h·g| of the fp64 sum); and, each, bitwise the forward rows of
    the two-direction launch with W duplicated, which is what the TPU path
    runs for a forward-only layer. The bf16 gradient bar adds 2⁻⁷ of the
    gradient's largest |value| to 5e-2 (T' = 256 carries |dxs| past 16).
    Ragged lengths,
    a length-0 row, B
    around the 16-row group, uni_gru's and a forward-only LSTM's training
    shape (B = 24, T' = 256)."""
    G, fwd, fwd_p, bwd, bwd_p = _UNI[cell]
    rng = np.random.default_rng(T * 1000 + H + B + G)
    lens = rng.integers(0, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    lo = torch.zeros(B, 1, device=dev)
    hi = torch.from_numpy(lens)[:, None].to(dev)
    w = torch.from_numpy((rng.standard_normal((1, H, G * H))
                          / np.sqrt(H)).astype(np.float32)).to(dev)
    xs = torch.from_numpy(rng.standard_normal((T, B, G * H)).astype(
        np.float32)).to(dev).to(dtype)
    g = torch.from_numpy(rng.standard_normal((T, B, H)).astype(
        np.float32)).to(dev)
    k_fwd, k_bwd = {"gru": (_kernels.GRU_FWD_TRAIN, _kernels.GRU_BWD),
                    "lstm": (_kernels.LSTM_FWD_TRAIN,
                             _kernels.LSTM_BWD)}[cell]
    before = (k_fwd.launches, k_bwd.launches)
    out = fwd(xs, w, lo, hi, dtype)
    out_p = fwd_p(xs, w, lo, hi, dtype)
    assert out[0].shape == (T, B, H)
    for a, b in zip(out, out_p):
        assert float((a.float() - b.float()).abs().max()) <= tol
    ys, ys_p = out[0], out_p[0]
    want = _uni_bwd(cell, bwd_p, out_p[1:], w, lo, hi, ys_p, g, dtype, True)
    # bf16 gradients: 5e-2 plus 2⁻⁷ of the tensor's largest |value|: each
    # step rounds the carried gradient's operands to bf16 on both sides, so
    # over T' = 256 steps the two drift apart in proportion to the
    # gradients' scale (|dxs| passes 16, where one bf16 ulp is 0.125)
    gtol, grel = (tol, 0.0) if dtype == torch.float32 else (5e-2, 2 ** -7)
    for res, y in ((out_p[1:], ys_p), (out[1:], ys)):
        got = _uni_bwd(cell, bwd, res, w, lo, hi, y, g, dtype)
        for a, b in zip(got, want):
            d = float((a.float() - b.float()).abs().max())
            scale = float(b.float().abs().max())
            assert d <= gtol + grel * scale, (d, scale)
    assert (k_fwd.launches, k_bwd.launches) == (before[0] + 1,
                                                before[1] + 2)
    # the TPU path's form: 2B rows, W duplicated; its forward rows
    w2 = torch.cat([w, w]).contiguous()
    x2 = torch.cat([xs, xs], dim=1).contiguous()
    lo2, hi2 = torch.cat([lo, lo]), torch.cat([hi, hi])
    g2 = torch.cat([g, g], dim=1).contiguous()
    out2 = fwd(x2, w2, lo2, hi2, dtype)
    for a, b in zip(out, out2):
        assert same_bits(a, b[:, :B].contiguous())
    got2 = _uni_bwd(cell, bwd, out2[1:], w2, lo2, hi2, out2[0], g2, dtype)
    for a, b in zip(got, got2):
        assert same_bits(a, b[:, :B].contiguous())
    if B > 1:       # a length-0 row: no live step, no gradient
        assert torch.all(ys[:, 1] == 0) and torch.all(got[0][:, 1] == 0)
    if dtype == torch.bfloat16:
        dgates = ((got[0][..., :2 * H], got[1]) if cell == "gru"
                  else (got[0],))
        n = _kernels.DW.launches
        dw = dw_cuda(ys, dgates, B)
        assert _kernels.DW.launches == n + 1
        assert dw.shape == (1, H, (2 if cell == "gru" else 4) * H + (
            H if cell == "gru" else 0))
        ref, absum = _dw_fp64(ys, dgates, B)
        bar = T * B * 2.0 ** -23 * absum
        assert bool(((dw.double() - ref).abs() <= bar).all())
        plain = torch.cat([dw_plain(ys, x, B, dtype) for x in dgates], 2)
        assert bool(((dw.double() - plain.double()).abs() <= 2 * bar).all())


def same_bits(a, b) -> bool:
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    return a.dtype == b.dtype and torch.equal(a.view(view[a.dtype]),
                                              b.view(view[b.dtype]))


def test_dw_plan_tiles_k_by_whole_wgmma_steps(dev):
    """The library's launch plan: a K-tile is kt frames of bc rows with
    kt·bc a multiple of 16 (a bf16 wgmma k-step) and at most 64, every row
    of B covered; bilstm_deep's and bigru's training shapes split K."""
    for B in range(1, 130):
        p = dw_plan(256, B, 384, 1536)
        assert (p.rows * p.frames) % 16 == 0 and p.rows * p.frames <= 64
        nbc = -(-B // p.rows)
        assert p.ktiles == -(-255 // p.frames) * nbc
        assert p.smem <= 232448 and 1 <= p.split <= 8
    assert dw_plan(256, 24, 384, 1536)[:2] == (24, 2)
    assert dw_plan(1, 24, 384, 1536).ktiles == 0
    # a forward-only layer: one direction's tiles, K split the same way
    uni = dw_plan(256, 24, 256, 768, 1)
    assert uni.tiles == 6 and uni[:3] == (24, 2, 128) and uni.split == 8


# past H = 512 (the persistent form of every bf16 form): (cell, T, B, H,
# ndir) — a short last block (544, 1056), streamed k-steps of W (1536 at
# ndir 1, 1792 and 2048 at ndir 2), B around the 16-row group
WIDE_CASES = [("gru", 9, 3, 544, 2), ("gru", 7, 17, 768, 1),
              ("gru", 5, 16, 2048, 2), ("gru", 40, 5, 1056, 2),
              ("lstm", 9, 3, 640, 2), ("lstm", 7, 17, 1024, 1),
              ("lstm", 5, 16, 2048, 2), ("lstm", 33, 2, 1536, 1),
              ("lstm", 6, 33, 1792, 2)]


def _wide_inputs(dev, cell, T, B, H, ndir, dtype, seed):
    """Ragged lengths (the first T, the second 0 where B > 1), W, xs in
    the stream dtype, g, and h0 nonzero on the forward rows."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    G = 3 if cell == "gru" else 4
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, T + 1, B).astype(np.float32)
    lens[0] = T
    if B > 1:
        lens[1] = 0
    lo, hi = np.zeros(B, np.float32), lens
    if ndir == 2:
        lo, hi = np.concatenate([lo, T - lens]), np.concatenate(
            [hi, np.full(B, T, np.float32)])
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    w = f(rng.standard_normal((ndir, H, G * H)) / np.sqrt(H))
    xs = f(rng.standard_normal((T, ndir * B, G * H))).to(
        rc.stream_dtype(dtype))
    g = f(rng.standard_normal((T, ndir * B, H)))
    Cw = H if cell == "gru" else 2 * H
    h0 = torch.zeros(ndir * B, Cw, device=dev)
    h0[:B] = f(0.5 * rng.standard_normal((B, Cw)))
    return xs, w, f(lo)[:, None], f(hi)[:, None], g, h0


def _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, emit, plain,
                only=None):
    """Every form of ``cell`` (the kernels' wrappers, or ``plain``): ys
    of the residual-free form, the training form's outputs, the backward
    on the plain training forward's residuals, the stream form's (ys,
    carry) at ``emit``; ``only``: that form's outputs alone."""
    sfx = "_plain" if plain else "_cuda"
    train_p = getattr(rc, f"{cell}_scan_train_plain")(xs, w, lo, hi, dtype)

    def bwd():
        if cell == "gru":
            return (rc.gru_bwd_plain(train_p[1], w, lo, hi,
                                     rc.shift_prev(train_p[0]), g, dtype)
                    if plain else rc.gru_bwd_cuda(train_p[1], w, lo, hi,
                                                  train_p[0], g, dtype))
        return (getattr(rc, f"lstm_bwd{sfx}")(train_p[2], w, lo, hi,
                                              train_p[1], g, dtype),)

    forms = {"fwd": lambda: (getattr(rc, f"{cell}_scan{sfx}")(
                 xs, w, lo, hi, dtype),),
             "train": lambda: getattr(rc, f"{cell}_scan_train{sfx}")(
                 xs, w, lo, hi, dtype),
             "bwd": bwd,
             "stream": lambda: getattr(rc, f"{cell}_scan_stream{sfx}")(
                 xs, w, lo, hi, h0, dtype, emit)}
    if only is not None:
        return forms[only]()
    return {n: f() for n, f in forms.items()}


@pytest.mark.parametrize("cell,T,B,H,ndir", WIDE_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_wide_kernels_match_plain(dev, cell, T, B, H, ndir, dtype, tol):
    """Past H = 512 (the persistent form in bf16, several units a thread
    in fp32)
    every form against its plain version: the residual-free and training
    forwards, the backward, the stream form at emit_t T // 2; one launch a
    call. Bars: 1e-4 fp32; bf16 3e-2 forward, and 5e-2 + 2⁻⁷ of the
    gradient's largest |value| backward (test_forward_only_train_kernels_
    match_plain's). A length-0 row keeps h = 0 and gets no gradient."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    xs, w, lo, hi, g, h0 = _wide_inputs(dev, cell, T, B, H, ndir, dtype,
                                        T * 10000 + H + B + ndir)
    names = (f"{cell}_fwd", f"{cell}_fwd_train", f"{cell}_bwd",
             f"{cell}_fwd_stream")
    before = [_kernels.KERNELS[n].launches for n in names]
    got = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, T // 2, False)
    assert [_kernels.KERNELS[n].launches - b
            for n, b in zip(names, before)] == [1, 1, 1, 1]
    want = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, T // 2, True)
    for form in got:
        for a, b in zip(got[form], want[form]):
            d = float((a.float() - b.float()).abs().max())
            bar = tol
            if form == "bwd" and dtype == torch.bfloat16:
                bar = 5e-2 + 2 ** -7 * float(b.float().abs().max())
            assert d <= bar, (form, d, bar)
    assert torch.equal(got["train"][0], got["fwd"][0])
    if B > 1:
        assert torch.all(got["fwd"][0][:, 1] == 0)
        assert torch.all(got["bwd"][0][:, 1] == 0)


@pytest.mark.parametrize("cell,H", [("gru", 768), ("lstm", 1024),
                                    ("lstm", 2048)])
def test_wide_planted_faults_exceed_the_bars(dev, cell, H, monkeypatch):
    """The bf16 bars catch what a bug in the operand fragments would do:
    the B fragments one k-step late, and one owner's fragments swapped
    with the next one's (block 0's slice and block 1's), in the
    persistent layouts of all four kernels: the GRU's forwards and
    backward, the LSTM's forwards and backward."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    dtype = torch.bfloat16
    xs, w, lo, hi, g, h0 = _wide_inputs(dev, cell, 12, 5, H, 2, dtype, H)
    want = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, 6, True)
    swap = lambda t, d: t.index_select(d, torch.tensor(
        [1, 0] + list(range(2, t.shape[d])), device=t.device))

    def faults(attr, form, ks_dim, owner_dim):
        f = getattr(rc, attr)
        return [(attr, lambda *a: f(*a).roll(1, dims=ks_dim), form),
                (attr, lambda *a: swap(f(*a), owner_dim), form)]

    if cell == "gru":
        faults = (faults("persist_fwd_weights", "train", 2, 1)
                  + faults("persist_gru_bwd_weights", "bwd", 2, 1))
    else:
        faults = (faults("persist_lstm_fwd_weights", "train", 2, 1)
                  + faults("persist_bwd_weights", "bwd", 2, 1))
    for attr, layout, form in faults:
        with monkeypatch.context() as m:
            m.setattr(rc, attr, layout)
            got = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, 6,
                              False)[form]
        worst = max(float((a.float() - b.float()).abs().max())
                    - (5e-2 + 2 ** -7 * float(b.float().abs().max())
                       if form == "bwd" else 3e-2)
                    for a, b in zip(got, want[form]))
        assert worst > 0, (attr, form)


@pytest.mark.parametrize("ndir", [2, 1])
@pytest.mark.parametrize("B", [1, 33])
@pytest.mark.parametrize("H", [544, 1024, 2048])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_persist_forms_match_plain(dev, cell, H, B, ndir):
    """The persistent form (every bf16 form of both cells: the three
    forwards and the backward; A staged in shared memory in the LSTM's
    forwards and the GRU's backward) at a short last block (544), the
    training width (1024) and the widest (2048: one, two or four tiles a
    block, streamed k-steps at ndir 2), one row and 33 rows (two passes of
    32): every form against its plain version at
    test_wide_kernels_match_plain's bf16 bars, one launch a call, a second
    call bitwise the first, and a CUDA graph's replay bitwise the eager
    call."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    dtype, T = torch.bfloat16, 7
    xs, w, lo, hi, g, h0 = _wide_inputs(dev, cell, T, B, H, ndir, dtype,
                                        H + B + ndir)
    forms = ("fwd", "train", "stream", "bwd")
    names = {"fwd": f"{cell}_fwd", "train": f"{cell}_fwd_train",
             "stream": f"{cell}_fwd_stream", "bwd": f"{cell}_bwd"}
    want = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, 3, True)
    for form in forms:
        fn = lambda form=form: _wide_forms(rc, cell, xs, w, lo, hi, g, h0,
                                           dtype, 3, False, only=form)
        before = _kernels.KERNELS[names[form]].launches
        got = fn()
        assert _kernels.KERNELS[names[form]].launches == before + 1
        for a, b in zip(got, want[form]):
            d = float((a.float() - b.float()).abs().max())
            bar = (5e-2 + 2 ** -7 * float(b.float().abs().max())
                   if form == "bwd" else 3e-2)
            assert d <= bar, (form, d, bar)
        assert all(torch.equal(a, b) for a, b in zip(got, fn()))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, got))


def test_persist_plan_on_card(dev):
    """For every width past 512, both direction counts and all four
    kernels, the library's persistent plan is the wrapper's
    (``persist_plan``) at every SM count from ndir to the card's at B =
    24, and at the card's count, an H100 PCIe's 114, 60 and 16 at B = 1
    and 33: workspace bytes, the staged ring's chunk and the groups
    included, and the card holds all of its blocks at once (no count is
    refused: a block of more than four tiles runs them in groups); the
    library refuses a count above the card's or below ndir; a launch given
    another block count raises instead of running."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    card = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in rc.PERSIST:
        for ndir in (1, 2):
            for H in range(544, rc.MAX_HIDDEN + 1, 32):
                cases = [(sms, 24) for sms in range(ndir, card + 1)]
                cases += [(sms, B) for sms in (card, 114, 60, 16)
                          for B in (1, 33) if sms <= card]
                for sms, B in cases:
                    p = rc.persist_plan(name, H, B, ndir, sms)
                    got = rc.persist_occupancy(name, H, ndir, B, sms)
                    assert got[:4] + got[5:] == (p.blocks, p.tiles,
                                                 p.resident, p.smem, p.work,
                                                 p.chunk, p.groups), \
                        (name, H, ndir, sms, B, got, p)
                    assert got[4] >= ndir * p.blocks, (name, H, ndir, got)
                for sms in (ndir - 1, card + 1):
                    with pytest.raises(RuntimeError, match="CUDA error 1 "):
                        rc.persist_occupancy(name, H, ndir, 24, sms)
    xs, w, lo, hi, g, h0 = _wide_inputs(dev, "gru", 4, 3, 1024, 2,
                                        torch.bfloat16, 0)
    wk, C = rc._gru_launch_args(w, 3, torch.bfloat16, "fwd")
    ys = torch.empty(4, 6, 1024, device=dev)
    work = rc._work("gru", "fwd", w, 3, torch.bfloat16)
    for c, sms in ((C + 1, card), (C, card + 1), (C, 1)):
        with pytest.raises(RuntimeError, match="csr_gru_fwd"):
            _kernels.GRU_FWD.launch(xs.data_ptr(), wk.data_ptr(),
                                    lo.data_ptr(), hi.data_ptr(),
                                    ys.data_ptr(), work.data_ptr(), 4, 3,
                                    1024, 2, c, sms, 1,
                                    _kernels.stream_ptr(xs))


@pytest.mark.parametrize("B", [5, 33])
@pytest.mark.parametrize("sms,H", [(114, 1856), (114, 2048), (16, 1024)])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_persist_forms_on_a_smaller_card(dev, cell, sms, H, B, monkeypatch):
    """The four persistent kernels where a block runs its tiles in groups
    (ndir 2): an H100 PCIe's 114 SMs at H = 1856 and 2048 (5 tiles a block
    in 2 groups) and a 16-SM MIG slice at 1024 (16 in 4), emulated on this
    card by ``rnn_cuda._sms`` (its grid the smaller card's), one pass (B =
    5) and two (33): every form (the residual-free and training forwards,
    the backward, the stream form at emit_t 0 and mid-window) against its
    plain version at chip_smoke phase 32's bars (3e-2 forward; 5e-2 +
    2⁻⁷·max|b| backward), exactly one launch a call, a second call bitwise
    the first."""
    import chainer_speech_recognition_tpu_torch.ops.rnn_cuda as rc

    if sms > torch.cuda.get_device_properties(dev).multi_processor_count:
        pytest.skip(f"the card has fewer than {sms} SMs")
    monkeypatch.setattr(rc, "_sms", lambda t: sms)
    for form in ("fwd", "bwd"):
        p = getattr(rc, f"{cell}_plan")(H, B, 2, form, sms)
        assert p.groups > 1 and 2 * p.blocks <= sms
    dtype, T = torch.bfloat16, 9
    xs, w, lo, hi, g, h0 = _wide_inputs(dev, cell, T, B, H, 2, dtype,
                                        H + B + sms)
    names = {"fwd": f"{cell}_fwd", "train": f"{cell}_fwd_train",
             "stream": f"{cell}_fwd_stream", "bwd": f"{cell}_bwd"}
    for emit in (0, T // 2):
        want = _wide_forms(rc, cell, xs, w, lo, hi, g, h0, dtype, emit, True)
        for form in (("fwd", "train", "bwd", "stream") if emit
                     else ("stream",)):
            fn = lambda form=form: _wide_forms(rc, cell, xs, w, lo, hi, g,
                                               h0, dtype, emit, False,
                                               only=form)
            before = _kernels.KERNELS[names[form]].launches
            got = fn()
            assert _kernels.KERNELS[names[form]].launches == before + 1
            for a, b in zip(got, want[form]):
                d = float((a.float() - b.float()).abs().max())
                bar = (5e-2 + 2 ** -7 * float(b.float().abs().max())
                       if form == "bwd" else 3e-2)
                assert d <= bar, (form, emit, d, bar)
            assert all(torch.equal(a, b) for a, b in zip(got, fn()))


def test_kernels_refuse_what_they_do_not_take(dev):
    xs = torch.zeros(3, 4, 3 * 48, device=dev)
    w = torch.zeros(2, 48, 3 * 48, device=dev)
    lo = torch.zeros(4, 1, device=dev)
    with pytest.raises(ValueError, match="hidden size"):
        gru_scan_cuda(xs, w, lo, lo, torch.float32)
    with pytest.raises(ValueError, match="hidden size"):       # > 2048
        gru_scan_cuda(torch.zeros(3, 4, 3 * 2080, device=dev),
                      torch.zeros(2, 2080, 3 * 2080, device=dev), lo, lo,
                      torch.float32)
    with pytest.raises(ValueError, match="expected torch.bfloat16"):
        gru_scan_cuda(torch.zeros(3, 4, 96, device=dev),
                      torch.zeros(2, 32, 96, device=dev), lo, lo,
                      torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        greedy_decode_cuda(torch.zeros(1, 2, 3),
                           torch.ones(1, dtype=torch.int32), 2)
    ys, (dg,) = _dw_operands(dev, 4, 2, 32, False, 0)
    with pytest.raises(ValueError, match="strides"):        # row stride 132
        dw_cuda(ys, (torch.zeros(4, 4, 132, device=dev,
                                 dtype=torch.bfloat16)[..., 4:],), 2)
    with pytest.raises(ValueError, match="bf16 CUDA tensor"):
        dw_cuda(ys, (dg.float(),), 2)
    with pytest.raises(ValueError, match="G % 64"):         # 2 maps, n1 = 32
        dw_cuda(ys, (dg[..., :32], dg[..., 32:64]), 2)
    with pytest.raises(ValueError, match="cannot hold"):
        fused_logmel_rows_cuda(torch.zeros(1, 600, device=dev), 5)
    with pytest.raises(ValueError, match="int32"):
        ctc_fwd_cuda(torch.zeros(1, 2, 3, device=dev),
                     torch.zeros(1, 3, device=dev),
                     torch.ones(1, device=dev), torch.ones(1, device=dev))
    with pytest.raises(ValueError, match="extended states"):   # > 227 KB
        ctc_fwd_cuda(torch.zeros(1, 2, 29057, device=dev),
                     torch.zeros(1, 29057, device=dev),
                     torch.ones(1, dtype=torch.int32, device=dev),
                     torch.ones(1, dtype=torch.int32, device=dev))
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
       (3, 701, 2, 64, 16, 4)]
    # the wider heads the kernels take (dh = 64n, n = 2 .. 8: the head dim
    # split over blocks in 64-column slices) at the tile edges, in chunk
    # windows and at the long-form length
    + [(B, 129, 1, dh, 0, 0) for dh in range(128, 513, 64) for B in (2, 3)]
    + [(3, 70, 2, 128, 16, 2), (2, 300, 1, 512, 16, 4), (2, 65, 2, 192, 8, 1),
       (2, 701, 2, 128, 0, 0), (3, 701, 1, 256, 0, 0),
       (2, 701, 1, 512, 16, 4)]
    # the wide backward where a tile's 8 n-tiles do not split evenly over
    # the warp groups (3/3/2 at dh 192 and 320, one block of 4 and one of
    # 3 slices at dh 448), at the tile edges in 16/2 chunk windows,
    # contiguous with a length-0 row
    + [(3, T, 1, dh, 16, 2) for dh in (192, 320, 448) for T in (63, 65, 129)])
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
    and out to half an ulp (2^-8); gradients one ulp plus the rounding
    room of p and ds (``attention_cuda.bwd_rounding_room``: the tensor
    cores may round a p or ds one bf16 ulp the other way) plus 1e-3; lse
    (fp32 in both) at the fp32 forward bar."""
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
    room = ac.bwd_rounding_room(*args) if dtype == torch.bfloat16 \
        else (0.0, 0.0, 0.0)
    for got, want, r in zip((dq, dk, dv), (dq_p, dk_p, dv_p), room):
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        diff = (got.float() - want.float()).abs()
        bar = gtol[1] + gtol[0] * want.float().abs() + r
        assert bool((diff <= bar).all()), float((diff / bar).max())
    after = {n: _kernels.KERNELS[n].launches for n in before}
    assert after == {n: c + 1 for n, c in before.items()}


@pytest.mark.parametrize("seed", [11, 12, 13])
@pytest.mark.parametrize("B,T,chunk,left", [(8, 701, 0, 0), (8, 701, 16, 4),
                                            (8, 256, 0, 0)])
def test_flash_bwd_bf16_within_derived_bar(dev, seed, B, T, chunk, left):
    """The bf16 backward at the long-form, chunk 16/4 and training widths
    (h = 4) on seeds of its own: every gradient within 2^-7·|b| plus the
    rounding room (one bf16 ulp of each p or ds times its partner operand,
    summed: attention_cuda.bwd_rounding_room) plus 1e-3."""
    q, k, v, do, lens = _flash_inputs(dev, B, T, 4, 64, torch.bfloat16, seed,
                                      strided=True)
    o_p, lse_p = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
    d_rows = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
    got = (ac.flash_bwd_dq_cuda(*args), *ac.flash_bwd_dkv_cuda(*args))
    want = (ac.flash_bwd_dq_plain(*args), *ac.flash_bwd_dkv_plain(*args))
    for a, b, r in zip(got, want, ac.bwd_rounding_room(*args)):
        diff = (a.float() - b.float()).abs()
        bar = 1e-3 + 2 ** -7 * b.float().abs() + r
        assert bool((diff <= bar).all()), float((diff / bar).max())


@pytest.mark.parametrize("B,T,chunk,left,h,dh", [
    (8, 701, 0, 0, 4, 64), (8, 701, 16, 4, 4, 64), (8, 256, 0, 0, 4, 64),
    (4, 701, 0, 0, 2, 128), (4, 256, 16, 4, 1, 320), (4, 701, 0, 0, 1, 512)])
def test_flash_bwd_bf16_bar_catches_planted_faults(dev, B, T, chunk, left, h,
                                                   dh):
    """The derived bar has power: each fault of
    ``attention_cuda.bwd_planted_faults`` (p at 3 mantissa bits, one 64-row
    tile skipped), added to the kernels' own bf16 gradients, exceeds it in
    some gradient, while the kernels' gradients stay within it, at the
    presets' head width and at wider ones."""
    q, k, v, do, lens = _flash_inputs(dev, B, T, h, dh, torch.bfloat16, 7,
                                      strided=True)
    o_p, lse_p = ac.flash_fwd_plain(q, k, v, lens, chunk, left)
    d_rows = (do.float() * o_p.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse_p, d_rows, chunk, left)
    got = (ac.flash_bwd_dq_cuda(*args), *ac.flash_bwd_dkv_cuda(*args))
    want = (ac.flash_bwd_dq_plain(*args), *ac.flash_bwd_dkv_plain(*args))
    bars = [1e-3 + 2 ** -7 * b.float().abs() + r
            for b, r in zip(want, ac.bwd_rounding_room(*args))]

    def share(grads):
        return max(float(((a.float() - b.float()).abs() / bar).max())
                   for a, b, bar in zip(grads, want, bars))

    assert share(got) <= 1
    for name, deltas in ac.bwd_planted_faults(*args).items():
        planted = [(a.float() + d).to(a.dtype) for a, d in zip(got, deltas)]
        assert share(planted) > 1, name


@pytest.mark.parametrize("chunk,left,h,dh", [(0, 0, 4, 64), (16, 4, 4, 64),
                                             (0, 0, 1, 384), (0, 0, 2, 128),
                                             (16, 2, 1, 192), (0, 0, 1, 448)])
def test_flash_bwd_bf16_is_bitwise_repeatable(dev, chunk, left, h, dh):
    """Each output tile has one owner block and no atomics: two bf16
    backward calls on the same inputs give the same bits."""
    q, k, v, do, lens = _flash_inputs(dev, 4, 701, h, dh, torch.bfloat16,
                                      chunk + 1, strided=True)
    out, lse = ac.flash_fwd_cuda(q, k, v, lens, chunk, left)
    d_rows = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, lens, do, lse, d_rows, chunk, left)
    runs = [(ac.flash_bwd_dq_cuda(*args), *ac.flash_bwd_dkv_cuda(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("B,chunk,left,h,dh", [
    (4, 0, 0, 2, 128), (4, 16, 2, 1, 192), (4, 0, 0, 1, 256),
    (4, 0, 0, 1, 384), (4, 0, 0, 1, 512), (32, 0, 0, 1, 256),
    (32, 16, 2, 1, 448)])
def test_flash_fwd_bf16_is_bitwise_repeatable(dev, B, chunk, left, h, dh):
    """The wide forward's warp groups meet only at barriers and each
    output has one owner thread: two bf16 forward calls on the same inputs
    give the same bits, with one warp group (dh 128) and four, in blocks
    of 32 rows (dh 192 and 256 at B = 4) and of whole 64-row tiles
    (``attention_cuda.flash_fwd_plan``)."""
    q, k, v, _, lens = _flash_inputs(dev, B, 701, h, dh, torch.bfloat16,
                                     chunk + 1, strided=True)
    runs = [ac.flash_fwd_cuda(q, k, v, lens, chunk, left) for _ in range(2)]
    torch.cuda.synchronize()
    (o1, lse1), (o2, lse2) = runs
    assert torch.equal(o1.view(torch.int16), o2.view(torch.int16))
    assert torch.equal(lse1.view(torch.int32), lse2.view(torch.int32))


@pytest.mark.parametrize("tiles", [96, 192, 352])
@pytest.mark.parametrize("dh", ac.KERNEL_DHS[1:])
def test_flash_fwd_plan_is_the_library_s(dev, dh, tiles):
    """The wide forward's launch as the library computes it on a grid of
    ``tiles`` 64-row query tiles (rows and warp groups a block, the n-tiles
    each warp group owns, chunks a ring stage, shared memory) is
    ``attention_cuda.flash_fwd_plan``'s, and an SM holds such a block."""
    plan, blocks = ac.flash_fwd_occupancy(dh, tiles)
    assert plan == ac.flash_fwd_plan(dh, tiles)
    assert blocks >= 1


@pytest.mark.parametrize("form", ["dq", "dkv"])
@pytest.mark.parametrize("dh", ac.KERNEL_DHS[1:])
def test_flash_bwd_plan_is_the_library_s(dev, dh, form):
    """The wide backward's launch as the library computes it (slices and
    warp groups a block, blocks a tile, the n-tiles each warp group owns,
    shared memory) is ``attention_cuda.flash_bwd_plan``'s, and an SM holds
    such a block (the launch would be refused otherwise)."""
    plan, blocks = ac.flash_bwd_occupancy(dh, form)
    assert plan == ac.flash_bwd_plan(dh, form)
    assert blocks >= 1


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
    outs, grads = [], []
    for make in (unaligned, lambda t: t.clone()):
        leaves = [make(t).requires_grad_() for t in (q, k, v)]
        g = make(do)
        assert ac.rows_aligned16(g) == (make is not unaligned)
        outs.append(ac.flash_mhsa(*leaves, lens))
        grads.append(torch.autograd.grad(outs[-1], leaves, g))
    assert torch.equal(outs[0].view(torch.int16), outs[1].view(torch.int16))
    for a, b in zip(*grads):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_flash_fwd_bf16_refuses_unaligned_rows(dev):
    """The bf16 forward copies 16-byte pieces of q, k and v rows too: its
    wrapper refuses a t stride that is not a multiple of 8 values
    (``FlashAttention.forward`` copies such operands first)."""
    B, T, h = 2, 10, 2
    q = torch.zeros(B, T, h * 64 + 4, device=dev, dtype=torch.bfloat16)[
        ..., :h * 64].reshape(B, T, h, 64)
    lens = torch.full((B,), T, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="forward kernels need 16-byte"):
        ac.flash_fwd_cuda(q, q, q, lens)
    out, _ = ac.flash_fwd_cuda(q.float(), q.float(), q.float(), lens)
    assert torch.equal(out, torch.zeros_like(out))    # fp32: no such rule


def test_flash_kernels_refuse_what_they_do_not_take(dev):
    q = torch.zeros(2, 10, 2, 64, device=dev)
    lens = torch.full((2,), 10, dtype=torch.int32, device=dev)
    for dh in (32, 96, 576):               # outside the reference's set
        z = torch.zeros(2, 10, 2, dh, device=dev)
        with pytest.raises(ValueError, match=f"head width {dh} .*dh % 64"):
            ac.flash_fwd_cuda(z, z, z, lens)
        rows = torch.zeros(2, 2, 10, device=dev)
        with pytest.raises(ValueError, match=f"head width {dh}"):
            ac.flash_bwd_dq_cuda(z, z, z, lens, z, rows, rows)
        with pytest.raises(ValueError, match=f"head width {dh}"):
            ac.flash_bwd_dkv_cuda(z, z, z, lens, z, rows, rows)
    with pytest.raises(ValueError, match="head dim must be dense"):
        ac.flash_fwd_cuda(q, q, q.transpose(2, 3).contiguous()
                          .transpose(2, 3), lens)
    with pytest.raises(ValueError, match="int32"):
        ac.flash_fwd_cuda(q, q, q, lens.long())
    with pytest.raises(ValueError, match="expected torch.float32"):
        ac.flash_fwd_cuda(q, q, q.half(), lens)


def test_packed_batch_crosses_as_int16_and_native_builds(dev, tmp_path):
    """The packed corpus's wire: ``to_device`` of a ``PackedBatchLoader``
    batch gives int16 PCM on the card, whose features (converted there,
    ``step._features``: the front-end kernel) equal bitwise those of the
    float32 batch that ``BatchLoader`` reads from the wavs of the same
    PCM. The host edit distance builds on the card's machine and equals
    its plain version."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import Utterance
    from chainer_speech_recognition_tpu_torch.data.packed import (
        PackedBatchLoader, PackedCorpus, pack_corpus)
    from chainer_speech_recognition_tpu_torch.data.sampler import BatchLoader
    from chainer_speech_recognition_tpu_torch.decode.metrics import (
        edit_distance_batch, edit_distance_py)
    from chainer_speech_recognition_tpu_torch.train.loop import to_device
    from chainer_speech_recognition_tpu_torch.train.step import _features
    from chainer_speech_recognition_tpu_torch.utils.wav import write_wav
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    rng = np.random.default_rng(0)
    vocab = Vocab(["<blank>", "a", "b", "c"])
    utts = []
    for i, n in enumerate((16000, 9000, 12345)):
        path = str(tmp_path / f"u{i}.wav")
        write_wav(path, 0.3 * rng.standard_normal(n).astype(np.float32))
        utts.append(Utterance(f"u{i}", path, "abc"[: i + 1], n))
    pack_corpus(str(tmp_path / "p"), utts, vocab)
    cfg = preset_config("bigru").override({"buckets.boundaries": [128],
                                           "buckets.batch_sizes": [3]})
    idxs = np.arange(3)
    pb = to_device(PackedBatchLoader(PackedCorpus(str(tmp_path / "p")),
                                     cfg.buckets).load(0, idxs), dev)
    wb = to_device(BatchLoader(utts, vocab, cfg.buckets).load(0, idxs), dev)
    assert pb["signals_i16"].dtype == torch.int16
    assert pb["signals_i16"].device.type == wb["signals"].device.type \
        == dev.type
    assert "signals" not in pb and wb["signals"].dtype == torch.float32
    before = _kernels.FRONTEND_LOGMEL.launches
    fp, lp = _features(cfg, pb)
    fw, lw = _features(cfg, wb)
    assert _kernels.FRONTEND_LOGMEL.launches == before + 2
    assert torch.equal(lp, lw) and torch.equal(fp, fw)
    hyps = [list(rng.integers(0, 9, rng.integers(0, 30))) for _ in range(50)]
    refs = [list(rng.integers(0, 9, rng.integers(0, 30))) for _ in range(50)]
    np.testing.assert_array_equal(
        edit_distance_batch(hyps, refs),
        [edit_distance_py(h, r) for h, r in zip(hyps, refs)])


# ------------------------------------------------------------ the beam --

def _beam_case(dev, B, T, V, K, kind, seed):
    from chainer_speech_recognition_tpu_torch.decode import beam as tb
    from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, T, V)) * 2).astype(np.float32)
    path = rng.integers(0, V, (B, T))
    for b in range(B):
        x[b, np.arange(T), path[b]] += 3.0
    lens = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lens[0] = T
    lm = None
    if kind != "none":
        order = int("".join(c for c in kind.split("_")[0] if c.isdigit()))
        lm = NGramLM(order, V)
        lm.logp[0][()] = {c: float(np.log(0.8 / (V - 1)))
                          for c in range(1, V, 3)}
        for k in range(1, order):
            for ctx in {tuple(int(c) for c in rng.integers(1, V, k))
                        for _ in range(60)}:
                succ = rng.integers(1, V, size=5)
                lp = np.log(rng.dirichlet(np.ones(5)) * 0.7)
                lm.logp[k][ctx] = {int(c): float(p)
                                   for c, p in zip(succ, lp)}
                lm.backoff[k][ctx] = float(np.log(0.3))
        if kind == "dense3":
            lm = lm.to_dense()
        else:
            lm = lm.to_hashed(rows_dtype=np.float16 if kind.endswith("16")
                              else np.float32)
    lp = tb._log_probs(torch.from_numpy(x).to(dev))
    dlm = tb.lm_on_device(lm, V, dev)
    return tb, lp, lens.to(dev), dlm, 0.6, 0.8


@pytest.mark.parametrize("B,T,V,K,kind,split", [
    (1, 1, 2, 1, "none", 1), (3, 17, 5, 8, "none", 1),
    (5, 40, 64, 4, "dense3", 1), (4, 33, 64, 8, "hashed4", 1),
    (4, 33, 64, 8, "hashed4_fp16", 1), (2, 20, 3000, 8, "hashed4", 2),
    (3, 25, 64, 32, "none", 2), (2, 12, 64, 9, "dense3", 1),
    (1, 1700, 8, 32, "none", 1),                            # tb in scratch
    (2, 6, 13000, 2, "none", 2),                            # lp unstaged
    (1, 1300, 8, 8, "none", 1),       # static + dynamic shared past 48 KB
    (3, 25, 64, 16, "dense3", 2), (3, 25, 64, 24, "hashed4", 2),
    (2, 20, 2048, 8, "none", 2),                     # 256 threads a row
    (2, 20, 100, 8, "hashed4", 1),                   # ... 128 up to 1,024
    (1, 30, 64, 8, "dense3", 1), (33, 20, 64, 8, "dense3", 1),
    (1, 20, 64, 64, "none", 1), (33, 12, 64, 64, "dense3", 1),
    # the wide form: K > 32, an LM context past 8 lanes, or a row past the
    # narrow form's shared memory; one block a row or a cluster
    (3, 25, 64, 33, "none", 1), (2, 30, 64, 64, "dense3", 1),
    (2, 20, 64, 100, "hashed4", 2), (1, 12, 64, 256, "hashed4_fp16", 2),
    (2, 15, 64, 64, "hashed12", 1), (2, 15, 64, 8, "hashed12", 1),
    (3, 12, 5, 128, "none", 1),                       # dead-beam ties
    (1, 300, 9, 256, "none", 1),                      # tb in scratch
    (1, 6, 5, 2000, "none", 1),                       # workspace in scratch
    (1, 4, 30, 2000, "none", 1),              # ... and keys recomputed
    (1, 4, 13000, 40, "none", 4),             # lp unstaged, keys recomputed
    (2, 10, 2048, 32, "none", 2),             # narrow K, wide row: 2 blocks
    (2, 12, 2048, 64, "hashed4", 4),          # 4 blocks, keys in each
    (2, 12, 64, 128, "hashed4", 2), (2, 10, 3000, 40, "none", 4),
])
@pytest.mark.parametrize("ordered,keep", [(True, 1), (True, 0), (False, -1)])
def test_beam_kernel_matches_plain(dev, B, T, V, K, kind, split, ordered,
                                   keep):
    """The beam kernel against its plain version on the same log-probs and
    state: chars, counts, parent beams and the integer state exactly,
    scores within 1e-4 (chip_smoke phases 23 and 34 hold the decode
    shape); exactly one launch, of the form the plan names, at the split
    the case is there for (the narrow form's threads / 128, the wide
    form's blocks a row). keep 0 = all K beams best-first, -1 = all in
    place (the streaming form)."""
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda

    tb, lp, lens, dlm, a, b = _beam_case(dev, B, T, V, K, kind, V + K + T)
    keep = keep if keep > 0 else K
    s0 = tb.beam_stream_init(B, K, dlm.ctx_len, dev)
    plan = beam_cuda.beam_plan(T, V, K, dlm.ctx_len)
    assert plan.wide == (K > 32 or dlm.ctx_len > 8 or (V, K) == (2048, 32))
    assert plan.split == split
    _kernels.reset_launches()
    got = beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, keep, T,
                                    ordered)
    torch.cuda.synchronize()
    assert {k: n for k, n in _kernels.launches().items() if n} == {
        "beam_wide" if plan.wide else "beam": 1}
    want = tb.beam_chunk_plain(lp, lens, s0, dlm, a, b, keep, T, ordered)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    for g, w in zip(got[4][2:], want[4][2:]):
        assert torch.equal(g, w)
    for g, w in ((got[3], want[3]), (got[4][0], want[4][0]),
                 (got[4][1], want[4][1])):
        assert float((g - w).abs().max()) <= 1e-4


@pytest.mark.parametrize("K,kind", [(1, "none"), (8, "dense3"),
                                    (8, "hashed4_fp16"), (16, "dense3"),
                                    (16, "hashed4"), (24, "none"),
                                    (32, "none"), (32, "hashed4")])
def test_beam_wide_form_equals_narrow(dev, K, kind):
    """Where both forms take a call, the wide form's outputs equal the
    narrow form's exactly (the same arithmetic in the same order; only the
    selection differs), in the n-best and chunk forms, up to the routing
    boundary (K = 32): at V = 64 with the wide form on one block a row,
    and at V = 2048 (K = 8 and 16 without a dense LM, whose table would
    not fit the host) on two."""
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda

    for V in (64, 2048):
        if V == 2048 and (K not in (8, 16) or kind == "dense3"):
            continue
        tb, lp, lens, dlm, a, b = _beam_case(dev, 3, 30, V, K, kind, K + 7)
        assert not beam_cuda.beam_plan(30, V, K, dlm.ctx_len).wide
        assert beam_cuda.beam_plan(30, V, K, dlm.ctx_len,
                                   wide=True).split == (1 if V == 64 else 2)
        s0 = tb.beam_stream_init(3, K, dlm.ctx_len, dev)
        for ordered in (True, False):
            narrow = beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, K,
                                               30, ordered)
            _kernels.reset_launches()
            wide = beam_cuda.beam_chunk_cuda(lp, lens, s0, dlm, a, b, K, 30,
                                             ordered, wide=True)
            torch.cuda.synchronize()
            assert _kernels.launches()["beam_wide"] == 1
            assert _kernels.launches()["beam"] == 0
            for g, w in zip((*wide[:4], *wide[4]), (*narrow[:4], *narrow[4])):
                assert torch.equal(g, w)


def test_beam_kernel_chunks_equal_offline_and_width_cut(dev):
    """Carried-state chunks of 7 frames equal one offline launch (state,
    emissions chained), in both forms; a width below the emissions keeps
    the first ones, as the plain version does."""
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda

    for K in (8, 64):
        tb, lp, lens, dlm, a, b = _beam_case(dev, 3, 40, 64, K, "dense3", 5)
        s = tb.beam_stream_init(3, K, dlm.ctx_len, dev)
        full = beam_cuda.beam_chunk_cuda(lp, lens, s, dlm, a, b, K, 40,
                                         False)
        for c0 in range(0, 40, 7):
            n = torch.clamp(lens - c0, 0, 7)
            s = beam_cuda.beam_chunk_cuda(lp[:, c0 : c0 + 7].contiguous(), n,
                                          s, dlm, a, b, K, 7, False)[4]
        for g, w in zip(s, full[4]):
            assert torch.equal(g, w)
        cut = beam_cuda.beam_chunk_cuda(lp, lens, tb.beam_stream_init(
            3, K, dlm.ctx_len, dev), dlm, a, b, 1, 3, True)
        want = tb.beam_chunk_plain(lp, lens, tb.beam_stream_init(
            3, K, dlm.ctx_len, dev), dlm, a, b, 1, 3, True)
        assert torch.equal(cut[0], want[0]) and torch.equal(cut[1], want[1])


def test_beam_refuses_wide_beams_on_the_card(dev):
    """Wide beams are taken on the card now, not refused: K = 33, 64, 100
    and 256 and an 11-lane hashed context (order 12) each go through
    ``beam_chunk``, the entry every decoder calls, as one launch of the
    wide form equal to the plain version. What the kernel cannot take
    still raises, never the plain version: a vocabulary past 32767 (the
    reference's limit) and a beam past 32767 (the tracebacks' 16-bit
    parents)."""
    from chainer_speech_recognition_tpu_torch.decode import beam as tb
    from chainer_speech_recognition_tpu_torch.ops import beam_cuda

    for K, kind in ((33, "none"), (64, "dense3"), (100, "hashed4"),
                    (256, "none"), (8, "hashed12")):
        _, lp, lens, dlm, a, b = _beam_case(dev, 2, 20, 64, K, kind, K)
        s0 = tb.beam_stream_init(2, K, dlm.ctx_len, dev)
        _kernels.reset_launches()
        got = tb.beam_chunk(lp, lens, s0, dlm, a, b, K, 20, True)
        torch.cuda.synchronize()
        assert {k: n for k, n in _kernels.launches().items() if n} == {
            "beam_wide": 1}
        want = tb.beam_chunk_plain(lp, lens, s0, dlm, a, b, K, 20, True)
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w)
        assert float((got[3] - want[3]).abs().max()) <= 1e-4
    logits = torch.zeros((1, 4, 6), device=dev)
    _kernels.reset_launches()
    assert len(tb.beam_decode(logits, [4], beam=32)) == 1
    assert _kernels.BEAM.launches == 1
    with pytest.raises(ValueError, match="32767"):
        tb.beam_decode(torch.zeros((1, 2, 32768), device=dev), [2], beam=2)
    with pytest.raises(ValueError, match="outside 1..32767"):
        beam_cuda.beam_chunk_cuda(
            tb._log_probs(logits), torch.tensor([4], device=dev),
            tb.beam_stream_init(1, 32768, 1, dev), tb.NO_LM, 0.0, 0.0, 1, 4,
            True)


@pytest.mark.parametrize("preset", ["bigru", "bilstm_deep"])
def test_cached_dispatch_replay_equals_eager_steps(dev, tmp_path, preset):
    """Two dispatches of K = 8 cached steps (bf16 feature cache, full width,
    bilstm_deep with SpecAugment): the first runs eagerly and captures the
    graph, the second is one replay. After it the parameters, Adam moments
    and counts and the dispatch's metrics equal those of the same 16 steps
    run eagerly, bitwise, with the default algorithms; two eager runs are
    bitwise equal too (the CTC emission gather's backward is repeatable).
    The replay adds each captured launch to the counts."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.data.corpus import load_index
    from chainer_speech_recognition_tpu_torch.data.device_cache import (
        DeviceCorpusCache)
    from chainer_speech_recognition_tpu_torch.data.sampler import (
        BatchLoader, BucketSampler)
    from chainer_speech_recognition_tpu_torch.data.synthetic import (
        write_tone_corpus)
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model, init_parameters)
    from chainer_speech_recognition_tpu_torch.train.state import init_state
    from chainer_speech_recognition_tpu_torch.train.step import (
        make_cached_train_step)
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    K = 8
    cfg = preset_config(preset).override({
        "buckets.boundaries": [256], "buckets.batch_sizes": [8],
        "optim.warmup_steps": 2})
    root = str(tmp_path)
    write_tone_corpus(root, np.random.default_rng(5), {"train": 40},
                      cfg.model.vocab_size, (1.5, 2.5))
    utts = load_index(f"{root}/train_index.jsonl")
    loader = BatchLoader(utts, Vocab.load(f"{root}/vocab.txt"), cfg.buckets)
    cache = DeviceCorpusCache(loader, BucketSampler(utts, cfg.buckets), dev,
                              features_cfg=cfg.features)
    plan = [cache.epoch_dispatches(e, K)[0] for e in (0, 1)]

    def run(eager: bool):
        model = build_model(cfg.model)
        init_parameters(model, 0)
        model.to(dev)
        state = init_state(model, cfg.optim, 0)
        step = make_cached_train_step(model, cfg, cache, K, _eager=eager)
        assert step.graphs == (not eager)
        ms = []
        for bid, slots in plan:
            before = _kernels.launches()
            ms.append(step(state, bid, torch.from_numpy(slots).to(dev)))
            after = _kernels.launches()
            ms[-1]["launches"] = {k: after[k] - before[k] for k in after}
        torch.cuda.synchronize()
        return state, ms

    def gap(a, b) -> float:
        (sa, ma), (sb, mb) = a, b
        out = [float((x.float() - y.float()).abs().max()) for x, y in zip(
            sa.model.state_dict().values(), sb.model.state_dict().values())]
        for key in ("mu", "nu"):
            ta, tb = sa.opt_state["1"]["0"][key], sb.opt_state["1"]["0"][key]
            out += [float((ta[k] - tb[k]).abs().max()) for k in ta]
        out += [abs(float(x[k]) - float(y[k])) for x, y in zip(ma, mb)
                for k in ("loss", "grad_norm", "valid_frac")]
        return max(out)

    e1, e2, g = run(True), run(True), run(False)
    assert int(g[0].opt_state["1"]["0"]["count"]) == 2 * K
    assert g[0].step == e1[0].step == 2 * K
    # the replay counts what eager steps launch
    assert g[1][1]["launches"] == e1[1][1]["launches"]
    assert g[1][1]["launches"][f"{cfg.model.rnn_type}_bwd"] == \
        K * cfg.model.rnn_layers
    assert gap(e1, e2) == 0
    assert gap(g, e1) == 0
