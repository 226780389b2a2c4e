"""The bf16 GRU cluster kernels' host side, on the CPU: the launch plan
(``rnn_cuda.gru_plan``), the weight layouts the kernels index
(``csrc/gru_fwd.cu``, ``csrc/gru_bwd.cu``, ``csrc/rnn_mma.cuh``) and the
stream form's launch arguments (``rnn_cuda.stream_launch_args``), the
LSTM's plan left as it was by the plan's generalisation to a gate count,
and the C entry points' parameters against the argument types the loader
gives them (``_kernels``).

The kernels themselves need a card (``tests/test_torch_cuda.py``)."""

import os
import re

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch import _kernels
from chainer_speech_recognition_tpu_torch.ops import rnn_cuda
from chainer_speech_recognition_tpu_torch.ops.rnn_cuda import (
    RESIDENT_MAX, ROWS, UNITS, gru_bwd_tc_weights, gru_fwd_tc_weights,
    gru_plan, gru_smem, gru_units, kernel_takes, lstm_plan, lstm_smem,
    wide_units)

HIDDEN = [H for H in range(1, 4097) if kernel_takes(H)]
SMEM_LIMIT = 232448     # shared memory a block may use on an H100 (227 KB)


@pytest.mark.parametrize("form", ["fwd", "bwd"])
@pytest.mark.parametrize("H", HIDDEN)
def test_plan_fits_every_hidden_size(H, form):
    """For every H the kernels take and B = 1 .. 96: a block's slice of W
    (resident up to H = 512) and its buffers fit the H100's 227 KB a
    block; the cluster has C ≤ 16 blocks (the largest cluster Hopper
    schedules) of 16 or 32 units each up to H = 512, of the streamed-W
    form's U = 8·⌈H / 128⌉ above (the last block the rest, a multiple of
    8), so the units fill n8 tiles; one m16 tile of rows a cluster; the
    grid holds every row."""
    U = gru_units(H, form)
    for ndir in ((1, 2) if form == "fwd" else (2,)):
        for B in range(1, 97):
            p = gru_plan(H, B, ndir, form)
            assert 1 <= p.cluster <= 16
            if H <= RESIDENT_MAX:
                assert p.cluster * U == H and U in (16, UNITS)
            else:
                assert U == wide_units(H) and U % 8 == 0
                assert p.cluster == -(-H // U)
                assert 0 < H - (p.cluster - 1) * U <= U
            assert p.rows == ROWS == 16
            assert p.smem == gru_smem(form, H)
            assert p.smem <= SMEM_LIMIT and p.smem % 16 == 0
            assert p.clusters == ndir * -(-B // p.rows)
            assert (p.clusters // ndir) * p.rows >= B


@pytest.mark.parametrize("H,form,want", [
    (256, "fwd", (8, 98304)), (256, "bwd", (16, 63232)),
    (512, "fwd", (16, 163840)), (512, "bwd", (16, 175360)),
    (32, "fwd", (1, 40960)), (32, "bwd", (2, 9472))])
def test_plan_by_hand(H, form, want):
    """The byte counts of ``csrc/rnn_mma.cuh`` with three gates worked by
    hand. bigru (H = 256): forward, 8 blocks of 32 units: W 96 rows + h 2
    × 16 rows of 2·256 + 16 bytes and the k-quarters' partial sums 4 × 3
    × 16 × 40 fp32; backward, 16 blocks of 16 units: W 256 rows + the
    gate gradients 16 rows of 2·48 + 16 bytes, partial sums 2 × 16 × 256
    fp32. H = 512 (32 units a block in both) fills the most: 175 KB
    backward."""
    p = gru_plan(H, 24, 2, form)
    assert (p.cluster, p.smem) == want
    assert gru_smem("fwd", 256) == (96 + 32) * 528 + 4 * 3 * 16 * 40 * 4
    assert gru_smem("bwd", 256) == (256 + 16) * 112 + 2 * 16 * 256 * 4
    assert gru_smem("bwd", 512) == (512 + 16) * 208 + 2 * 16 * 512 * 4


def test_units_a_block():
    """The backward takes 16 units a block up to H = 256 and 32 above (16
    would need more than 16 blocks a cluster); the forward always 32; past
    H = 512 both take the streamed-W form's 8·⌈H / 128⌉."""
    for H in HIDDEN:
        if H > RESIDENT_MAX:
            assert gru_units(H, "fwd") == gru_units(H, "bwd") == \
                wide_units(H) == 8 * -(-H // 128)
        else:
            assert gru_units(H, "fwd") == UNITS == 32
            assert gru_units(H, "bwd") == (16 if H <= 256 else 32)
        assert -(-H // gru_units(H, "bwd")) <= 16


def test_plan_refuses_sizes_the_kernels_do_not_take():
    for H in (0, 16, 48, 1040, 2080, 4096):
        for form in ("fwd", "bwd"):
            with pytest.raises(ValueError, match="gru_plan"):
                gru_plan(H, 4, 2, form)


@pytest.mark.parametrize("form", ["fwd", "bwd"])
def test_lstm_plan_is_unchanged(form):
    """The LSTM's plan after its generalisation to a gate count: the byte
    counts it had before, written out, for every H of the resident form
    and a few B (the streamed-W form's in tests/test_torch_rnn_wide.py)."""
    for H in (H for H in HIDDEN if H <= RESIDENT_MAX):
        want = ((H + 16) * (8 * 32 + 16) + 2 * 16 * H * 4 if form == "bwd"
                else (4 * 32 + 2 * 16) * (2 * H + 16) + 16 * 16 * 40 * 4)
        assert lstm_smem(form, H) == want
        for B in (1, 16, 17, 24, 64):
            assert tuple(lstm_plan(H, B, 2, form)) == (
                H // 32, 16, want, 2 * -(-B // 16))


@pytest.mark.parametrize("ndir,H", [(2, 32), (1, 64), (2, 96), (2, 256),
                                    (1, 256), (1, 160)])
def test_fwd_weight_layout_matches_the_kernel_index(ndir, H):
    """The forward's slices place W[d, k, g·H + 32c + u] at the flat index
    the kernel reads, ((d·C + c)·96 + g·32 + u)·H + k (block c's 96 gate
    columns, k-major), checked against a hand-written loop; bf16; the
    wrapper's launch arguments are these slices and the plan's C."""
    rng = np.random.default_rng(H + ndir)
    w = torch.from_numpy(rng.standard_normal((ndir, H, 3 * H)).astype(
        np.float32))
    C = H // UNITS
    wk, Cp = rnn_cuda._gru_launch_args(w, 5, torch.bfloat16, "fwd")
    assert Cp == C == gru_plan(H, 5, ndir, "fwd").cluster
    flat = wk.reshape(-1)
    assert torch.equal(flat, gru_fwd_tc_weights(w, C).reshape(-1))
    assert flat.dtype == torch.bfloat16 and flat.numel() == w.numel()
    assert torch.equal(flat, _fwd_by_kernel_index(w, C))


def _fwd_by_kernel_index(w, C: int) -> torch.Tensor:
    """The forward's slices by a hand-written loop: W[d, k, g·H + 32c + u]
    (bf16) at ((d·C + c)·96 + g·32 + u)·H + k."""
    ndir, H = w.shape[:2]
    wb = w.to(torch.bfloat16)
    want = torch.empty(w.numel(), dtype=torch.bfloat16)
    for d in range(ndir):
        for c in range(C):
            for g in range(3):
                for u in range(UNITS):
                    base = ((d * C + c) * 3 * UNITS + g * UNITS + u) * H
                    want[base:base + H] = wb[d, :, g * H + c * UNITS + u]
    return want


@pytest.mark.parametrize("ndir,H", [(1, 256), (2, 96), (1, 32), (2, 512)])
def test_stream_launch_args(ndir, H):
    """The stream form's launch arguments: under fp32 the FMA kernel's W as
    it is and C = 0; under bf16 the plan's C and the cluster forward's
    slices, at the flat index the kernel reads (the stream form runs
    gru_fwd_tc_kernel)."""
    rng = np.random.default_rng(H + ndir + 5)
    w = torch.from_numpy(rng.standard_normal((ndir, H, 3 * H)).astype(
        np.float32))
    wk, C = rnn_cuda.stream_launch_args("gru", w, 32, torch.float32)
    assert C == 0 and torch.equal(wk, w) and wk.is_contiguous()
    wk, C = rnn_cuda.stream_launch_args("gru", w, 32, torch.bfloat16)
    assert C == H // UNITS == gru_plan(H, 32, ndir, "fwd").cluster
    assert wk.dtype == torch.bfloat16
    assert torch.equal(wk.reshape(-1), _fwd_by_kernel_index(w, C))


@pytest.mark.parametrize("H", [32, 96, 256, 288])
def test_bwd_weight_layout_matches_the_kernel_index(H):
    """The backward's slices place W[d, j, g·H + Uc + u] at the flat
    index the kernel reads, ((d·C + c)·H + j)·3U + g·U + u (block c's
    gate columns of every row j of W; U = 16 up to H = 256, 32 above),
    against a hand-written loop."""
    rng = np.random.default_rng(H + 1)
    w = torch.from_numpy(rng.standard_normal((2, H, 3 * H)).astype(
        np.float32))
    U = gru_units(H, "bwd")
    C = H // U
    wk, Cp = rnn_cuda._gru_launch_args(w, 5, torch.bfloat16, "bwd")
    assert Cp == C == gru_plan(H, 5, 2, "bwd").cluster
    flat = wk.reshape(-1)
    assert torch.equal(flat, gru_bwd_tc_weights(w, C).reshape(-1))
    wb = w.to(torch.bfloat16)
    want = torch.empty_like(flat)
    for d in range(2):
        for c in range(C):
            for j in range(H):
                base = ((d * C + c) * H + j) * 3 * U
                for g in range(3):
                    want[base + g * U:base + (g + 1) * U] = \
                        wb[d, j, g * H + c * U:g * H + (c + 1) * U]
    assert torch.equal(flat, want)


def test_fp32_launch_keeps_the_fma_kernels_weights():
    """Under fp32 the launch arguments are the FMA kernels' W (forward)
    and Wᵀ (backward) with C = 0: the fp32 forms are unchanged."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.standard_normal((2, 64, 192)).astype(
        np.float32))
    wk, C = rnn_cuda._gru_launch_args(w, 3, torch.float32, "fwd")
    assert C == 0 and torch.equal(wk, w) and wk.is_contiguous()
    wt, C = rnn_cuda._gru_launch_args(w, 3, torch.float32, "bwd")
    assert C == 0 and wt.is_contiguous()
    assert torch.equal(wt, w.transpose(1, 2))


def _entry_points() -> dict:
    """{symbol: [parameter declarations]} of every ``CSR_API`` function in
    ``csrc/*.cu``."""
    out = {}
    csrc = os.path.join(os.path.dirname(_kernels.__file__), "csrc")
    for name in sorted(os.listdir(csrc)):
        if name.endswith(".cu"):
            with open(os.path.join(csrc, name)) as f:
                text = f.read()
            for m in re.finditer(r"CSR_API\s+[\w\s\*]+?\b(csr_\w+)\(([^)]*)\)",
                                 text):
                out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("symbol", sorted(
    [k.symbol for k in _kernels.KERNELS.values()] + list(_kernels.HELPERS)))
def test_entry_point_matches_its_argument_types(symbol):
    """Each entry point the loader binds takes as many parameters as its
    ctypes argument list has, a pointer (or the stream) where the list
    has ``c_void_p`` or a pointer type and an ``int`` where it has
    ``c_int``: a mismatch would pass a pointer cut to 32 bits, or shift
    every argument after it."""
    params = _entry_points()[symbol]
    argtypes = ([k.argtypes for k in _kernels.KERNELS.values()
                 if k.symbol == symbol] or [_kernels.HELPERS[symbol]])[0]
    assert len(params) == len(argtypes), (params, argtypes)
    for p, a in zip(params, argtypes):
        if a is _kernels._I:
            assert re.fullmatch(r"int \w+", p), p
        else:
            assert "*" in p or p.startswith("cudaStream_t"), p
