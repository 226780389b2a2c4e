"""The port's CUDA kernels against their plain PyTorch versions at small,
ragged shapes (chip_smoke.py checks them at the decode path's shapes).

They need a card: marked ``cuda`` and skipped without one. This file
imports no JAX; on the card's machine run it without the repo's conftest,
which configures JAX for the CPU suite:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu import constants as C
from chainer_speech_recognition_tpu_torch import _kernels
from chainer_speech_recognition_tpu_torch.decode.greedy import (
    best_keep_cuda, best_keep_plain)
from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
    fused_logmel_rows_cuda)
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    _K, extend_signal, logmel_from_extended)
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    gru_scan_cuda, gru_scan_plain)

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
