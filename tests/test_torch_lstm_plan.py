"""The bf16 LSTM cluster kernels' host side, on the CPU: the launch plan
(``rnn_cuda.lstm_plan``), the weight layouts the kernels index
(``csrc/lstm_fwd.cu``, ``csrc/lstm_bwd.cu``, ``csrc/rnn_mma.cuh``) and the
stream form's launch arguments (``rnn_cuda.stream_launch_args``).

The kernels themselves need a card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.ops import rnn_cuda
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    RESIDENT_MAX, ROWS, UNITS, kernel_takes, lstm_bwd_tc_weights,
    lstm_fwd_tc_weights, lstm_plan, lstm_smem, lstm_units, wide_units)

HIDDEN = [H for H in range(1, 4097) if kernel_takes(H)]
SMEM_LIMIT = 232448     # shared memory a block may use on an H100 (227 KB)


def test_kernel_takes_keeps_its_range():
    assert HIDDEN == list(range(32, 2049, 32))


@pytest.mark.parametrize("form", ["fwd", "bwd"])
@pytest.mark.parametrize("H", HIDDEN)
def test_plan_fits_every_hidden_size(H, form):
    """For every H the kernels take and B = 1 .. 96: a block's slice of W
    (resident up to H = 512) and its buffers fit the H100's 227 KB a
    block; the cluster has C ≤ 16 blocks (the largest cluster Hopper
    schedules) of 32 units each up to H = 512, of the streamed-W form's
    U = 8·⌈H / 128⌉ above (the last block the rest, a multiple of 8), so
    the units fill n8 tiles; one m16 tile of rows a cluster; the grid
    holds every row."""
    U = lstm_units(H)
    assert U == (UNITS if H <= RESIDENT_MAX else wide_units(H))
    for ndir in ((1, 2) if form == "fwd" else (2,)):
        for B in range(1, 97):
            p = lstm_plan(H, B, ndir, form)
            assert 1 <= p.cluster <= 16
            if H <= RESIDENT_MAX:
                assert p.cluster * UNITS == H and UNITS % 8 == 0
            else:
                assert p.cluster == -(-H // U) and U % 8 == 0
                assert 0 < H - (p.cluster - 1) * U <= U
            assert p.rows == ROWS == 16
            assert p.smem == lstm_smem(form, H)
            assert p.smem <= SMEM_LIMIT and p.smem % 16 == 0
            assert p.clusters == ndir * -(-B // p.rows)
            assert (p.clusters // ndir) * p.rows >= B


@pytest.mark.parametrize("H,form,want", [
    (384, "fwd", (12, 166400)), (384, "bwd", (12, 157952)),
    (512, "fwd", (16, 207360)), (512, "bwd", (16, 209152)),
    (32, "fwd", (1, 53760)), (32, "bwd", (1, 17152))])
def test_plan_by_hand(H, form, want):
    """The byte counts of ``csrc/rnn_mma.cuh`` worked by hand. bilstm_deep
    (H = 384): forward, W 128 rows + h 2 × 16 rows of 2·384 + 16 bytes
    and the k-quarters' partial sums 4 × 4 × 16 × 40 fp32; backward, W 384
    rows + dg 16 rows of 2·128 + 16 bytes, partial sums 2 × 16 × 384 fp32.
    H = 512 fills the most: 209 KB backward."""
    p = lstm_plan(H, 24, 2, form)
    assert (p.cluster, p.smem) == want
    assert lstm_smem("fwd", 384) == (128 + 32) * 784 + 4 * 4 * 16 * 40 * 4
    assert lstm_smem("bwd", 384) == (384 + 16) * 272 + 2 * 16 * 384 * 4


def test_plan_refuses_sizes_the_kernels_do_not_take():
    for H in (0, 16, 48, 1040, 2080, 4096):
        with pytest.raises(ValueError):
            lstm_plan(H, 4, 2, "fwd")


@pytest.mark.parametrize("ndir,H", [(2, 32), (1, 64), (2, 96), (2, 384),
                                    (1, 160)])
def test_fwd_weight_layout_matches_the_kernel_index(ndir, H):
    """The forward's slices place W[d, k, g·H + 32c + u] at the flat index
    the kernel reads, ((d·C + c)·128 + g·32 + u)·H + k (block c's 128 gate
    columns, k-major), checked against a hand-written loop; bf16; the
    wrapper's launch arguments are these slices and the plan's C."""
    rng = np.random.default_rng(H)
    w = torch.from_numpy(rng.standard_normal((ndir, H, 4 * H)).astype(
        np.float32))
    C = H // UNITS
    wk, Cp = rnn_cuda._lstm_launch_args(w, 5, torch.bfloat16, "fwd")
    assert Cp == C == lstm_plan(H, 5, ndir, "fwd").cluster
    flat = wk.reshape(-1)
    assert torch.equal(flat, lstm_fwd_tc_weights(w, C).reshape(-1))
    assert flat.dtype == torch.bfloat16 and flat.numel() == w.numel()
    assert torch.equal(flat, _fwd_by_kernel_index(w, C))


def _fwd_by_kernel_index(w, C: int) -> torch.Tensor:
    """The forward's slices by a hand-written loop: W[d, k, g·H + 32c + u]
    (bf16) at ((d·C + c)·128 + g·32 + u)·H + k."""
    ndir, H = w.shape[:2]
    wb = w.to(torch.bfloat16)
    want = torch.empty(w.numel(), dtype=torch.bfloat16)
    for d in range(ndir):
        for c in range(C):
            for g in range(4):
                for u in range(UNITS):
                    base = ((d * C + c) * 4 * UNITS + g * UNITS + u) * H
                    want[base:base + H] = wb[d, :, g * H + c * UNITS + u]
    return want


@pytest.mark.parametrize("ndir,H", [(2, 384), (1, 64), (2, 32), (1, 512)])
def test_stream_launch_args(ndir, H):
    """The stream form's launch arguments: under fp32 the FMA kernel's
    k-quads (element [d, k4, col, kk] = W[d, 4·k4 + kk, col]) and C = 0;
    under bf16 the plan's C and the cluster forward's slices, at the flat
    index the kernel reads (the stream form runs lstm_fwd_tc_kernel)."""
    rng = np.random.default_rng(H + ndir + 9)
    w = torch.from_numpy(rng.standard_normal((ndir, H, 4 * H)).astype(
        np.float32))
    wq, C = rnn_cuda.stream_launch_args("lstm", w, 32, torch.float32)
    assert C == 0 and wq.shape == (ndir, H // 4, 4 * H, 4)
    assert torch.equal(wq, w.reshape(ndir, H // 4, 4, 4 * H).transpose(2, 3))
    assert torch.equal(wq[ndir - 1, 3, 17], w[ndir - 1, 12:16, 17])
    wk, C = rnn_cuda.stream_launch_args("lstm", w, 32, torch.bfloat16)
    assert C == H // UNITS == lstm_plan(H, 32, ndir, "fwd").cluster
    assert wk.dtype == torch.bfloat16
    assert torch.equal(wk.reshape(-1), _fwd_by_kernel_index(w, C))


@pytest.mark.parametrize("H", [32, 96, 384])
def test_bwd_weight_layout_matches_the_kernel_index(H):
    """The backward's slices place W[d, j, g·H + 32c + u] at the flat
    index the kernel reads, ((d·C + c)·H + j)·128 + g·32 + u (block c's
    gate columns of every row j of W), against a hand-written loop."""
    rng = np.random.default_rng(H + 1)
    w = torch.from_numpy(rng.standard_normal((2, H, 4 * H)).astype(
        np.float32))
    C = H // UNITS
    wk, Cp = rnn_cuda._lstm_launch_args(w, 5, torch.bfloat16, "bwd")
    assert Cp == C == lstm_plan(H, 5, 2, "bwd").cluster
    flat = wk.reshape(-1)
    assert torch.equal(flat, lstm_bwd_tc_weights(w, C).reshape(-1))
    wb = w.to(torch.bfloat16)
    want = torch.empty_like(flat)
    for d in range(2):
        for c in range(C):
            for j in range(H):
                base = ((d * C + c) * H + j) * 4 * UNITS
                for g in range(4):
                    want[base + g * UNITS:base + (g + 1) * UNITS] = \
                        wb[d, j, g * H + c * UNITS:g * H + (c + 1) * UNITS]
    assert torch.equal(flat, want)


def test_fp32_launch_keeps_the_k_quads():
    """Under fp32 the launch arguments are the FMA kernels' k-quads and
    C = 0: the fp32 forms are unchanged."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((2, 64, 256)).astype(
        np.float32))
    wq, C = rnn_cuda._lstm_launch_args(w, 3, torch.float32, "fwd")
    assert C == 0
    assert torch.equal(wq[1, 3, 17], w[1, 12:16, 17])
    wtq, C = rnn_cuda._lstm_launch_args(w, 3, torch.float32, "bwd")
    assert C == 0
    assert torch.equal(wtq[0, 5, 9], w[0, 9, 20:24])
