"""The recurrences past H = 512 on the CPU: at H = 640 the port's plain
versions of every form (``*_scan``, ``*_scan_train``, ``*_scan_stream``,
``*_bwd`` through ``BiGRUScan`` / ``BiLSTMScan``) against the JAX
package's ``birnn_pallas``, ``birnn_pallas_stream`` and custom VJP in
interpret mode, for both cells, ndir 1 and 2, fp32 and bf16; a two-layer
``bilstm_deep`` at H = 640 (logits and one train step) against the JAX
model with weights carried over by the bridge; and the host side of the
streamed-W kernels (``csrc/rnn_mma.cuh``): the operand-fragment layouts
at the flat index the kernels read, and the plan's geometry. The kernels
themselves need a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 32).

Bars as the narrower suites state them (tests/test_torch_lstm.py,
tests/test_torch_stream_kernels.py, tests/test_torch_rnn_train.py): the
forward fp32 1e-5 (stream form 1e-4), bf16 3e-2; gradients fp32 atol 2e-5
/ rtol 1e-4, bf16 5e-2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.frontend.jnp_frontend import batch_features
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu.ops.rnn_pallas import (
    birnn_pallas, birnn_pallas_stream)
from chainer_speech_recognition_tpu.train.state import init_state
from chainer_speech_recognition_tpu.train.step import _forward_loss
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params)
from chainer_speech_recognition_tpu_torch.config import Config
from chainer_speech_recognition_tpu_torch.models.presets import build_model
from chainer_speech_recognition_tpu_torch.ops import rnn_cuda as rc
from chainer_speech_recognition_tpu_torch.train.step import forward_loss

H = 640                 # the narrowest width past the resident form
T = 6
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FWD_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
_STREAM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
_GRAD_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "bfloat16": dict(atol=5e-2, rtol=5e-2)}
_G = {"gru": 3, "lstm": 4}


def _inputs(cell, ndir, seed, lens=(T, 0, 4)):
    """Port-layout inputs, B = 3: xs [T, ndir·B, G·H], w [ndir, H, G·H],
    lo/hi [ndir·B, 1] (the backward rows live at the right edge), h0
    [ndir·B, C] and gy [T, ndir·B, H]."""
    rng = np.random.default_rng(seed)
    B, G = len(lens), _G[cell]
    R = ndir * B
    xs = rng.standard_normal((T, R, G * H)).astype(np.float32)
    w = (rng.standard_normal((ndir, H, G * H)) / np.sqrt(H)).astype(
        np.float32)
    lens = np.asarray(lens, np.float32)
    lo, hi = np.zeros(B, np.float32), lens
    if ndir == 2:
        lo = np.concatenate([lo, T - lens])
        hi = np.concatenate([hi, np.full(B, T, np.float32)])
    C = H if cell == "gru" else 2 * H
    h0 = (0.5 * rng.standard_normal((R, C))).astype(np.float32)
    gy = rng.standard_normal((T, R, H)).astype(np.float32)
    return xs, w, lo[:, None], hi[:, None], h0, gy


def _jax_layout(xs, w, lo, hi, h0, gy):
    """The JAX kernels' layout of a forward-only layer: its one W
    duplicated over two row halves; an odd row count gets its last row
    repeated (only the real rows are compared)."""
    if w.shape[0] == 2:
        return xs, w, lo, hi, h0, gy
    R = xs.shape[1]
    w = np.concatenate([w, w])
    if R % 2:
        pick = np.r_[np.arange(R), R - 1]
        xs, lo, hi, h0, gy = (xs[:, pick], lo[pick], hi[pick], h0[pick],
                              gy[:, pick])
    return xs, w, lo, hi, h0, gy


def _stream(x, dtype):
    """A JAX stream-dtype array as the port's tensor of the same values."""
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        rc.stream_dtype(_TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndir", [2, 1])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_forward_forms_match_birnn_pallas(cell, ndir, dtype):
    """``*_scan`` and the ys of ``*_scan_train`` against ``birnn_pallas``:
    the residual-free and the training forward compute the same ys; a
    length-0 row never leaves h = 0."""
    xs, w, lo, hi, h0, gy = _inputs(cell, ndir, seed=ndir)
    R = xs.shape[1]
    xj, wj, loj, hij, _, _ = _jax_layout(xs, w, lo, hi, h0, gy)
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(xj).astype(sdt)
    ys_j = np.asarray(birnn_pallas(xj, jnp.asarray(wj), jnp.asarray(loj),
                                   jnp.asarray(hij), cell, dtype))[:, :R]
    args = (_stream(xj, dtype)[:, :R], torch.from_numpy(w),
            torch.from_numpy(lo), torch.from_numpy(hi), _TORCH[dtype])
    ys_t = getattr(rc, f"{cell}_scan_plain")(*args)
    np.testing.assert_allclose(ys_t.numpy(), ys_j, atol=_FWD_TOL[dtype],
                               rtol=0)
    ys_tr = getattr(rc, f"{cell}_scan_train_plain")(*args)[0]
    assert torch.equal(ys_tr, ys_t)
    assert torch.all(ys_t[:, 1] == 0)


@pytest.mark.parametrize("emit_t", [0, 3, T])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndir", [2, 1])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_plain_stream_form_matches_birnn_pallas_stream(cell, ndir, dtype,
                                                        emit_t):
    """``*_scan_stream_plain`` against ``birnn_pallas_stream``: ys and the
    carry after ``emit_t`` steps, seeded from a nonzero h0; a length-0
    row carries h0 through."""
    xs, w, lo, hi, h0, gy = _inputs(cell, ndir, seed=10 + ndir + emit_t)
    R = xs.shape[1]
    xj, wj, loj, hij, h0j, _ = _jax_layout(xs, w, lo, hi, h0, gy)
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(xj).astype(sdt)
    ys_j, carry_j = birnn_pallas_stream(
        xj, jnp.asarray(wj), jnp.asarray(loj), jnp.asarray(hij),
        jnp.asarray(h0j), cell, dtype, emit_t)
    ys_t, carry_t = getattr(rc, f"{cell}_scan_stream_plain")(
        _stream(xj, dtype)[:, :R], torch.from_numpy(w), torch.from_numpy(lo),
        torch.from_numpy(hi), torch.from_numpy(h0), _TORCH[dtype], emit_t)
    tol = _STREAM_TOL[dtype]
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j)[:, :R],
                               atol=tol, rtol=0)
    np.testing.assert_allclose(carry_t.numpy(), np.asarray(carry_j)[:R],
                               atol=tol, rtol=0)
    assert np.array_equal(carry_t[1].numpy(), h0[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndir", [2, 1])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_scan_vjp_matches_pallas(cell, ndir, dtype):
    """``BiGRUScan`` / ``BiLSTMScan`` (the training forward, the backward
    ``*_bwd_plain`` and dW) against ``jax.vjp(birnn_pallas)``: ys, the
    gradients of xs and of W (a forward-only layer's dW is the JAX side's
    sum over its duplicated halves)."""
    xs, w, lo, hi, h0, gy = _inputs(cell, ndir, seed=20 + ndir)
    R = xs.shape[1]
    xj, wj, loj, hij, _, gyj = _jax_layout(xs, w, lo, hi, h0, gy)
    if ndir == 1 and R % 2:     # the repeated row's gradient is not ours
        gyj = gyj.copy()
        gyj[:, R:] = 0
    sdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(xj).astype(sdt)
    yj, vjp = jax.vjp(lambda x, ww: birnn_pallas(
        x, ww, jnp.asarray(loj), jnp.asarray(hij), cell, dtype), xj,
        jnp.asarray(wj))
    dxj, dwj = vjp(jnp.asarray(gyj))
    dwj = np.asarray(dwj)
    if ndir == 1:
        dwj = dwj[:1] + dwj[1:]
    fn = rc.BiGRUScan if cell == "gru" else rc.BiLSTMScan
    xt = _stream(xj, dtype)[:, :R].clone().requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = fn.apply(xt, wt, torch.from_numpy(lo), torch.from_numpy(hi),
                  _TORCH[dtype])
    yt.backward(torch.from_numpy(gy))
    tol = _GRAD_TOL[dtype]
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj)[:, :R],
                               **tol)
    np.testing.assert_allclose(
        xt.grad.float().numpy(), np.asarray(dxj.astype(jnp.float32))[:, :R],
        **tol)
    np.testing.assert_allclose(wt.grad.numpy(), dwj, **tol)
    assert torch.all(xt.grad[:, 1] == 0)


# ---------------------------------------------------------------------------
# a cut bilstm_deep at H = 640 against the JAX model

LSTM_OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": H,
             "model.rnn_layers": 2, "model.vocab_size": 6,
             "model.compute_dtype": "float32", "model.rnn_impl": "pallas",
             "train.ctc_impl": "pallas", "parallel.num_devices": 1,
             "specaugment.enabled": False}


def _batch(seed=0, lens=(4000, 2400), label_lens=(3, 2)):
    rng = np.random.default_rng(seed)
    sig = np.zeros((len(lens), max(lens)), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n] = 0.3 * rng.standard_normal(n)
    labels = np.full((len(lens), max(label_lens)), -1, np.int32)
    for i, nl in enumerate(label_lens):
        labels[i, :nl] = rng.integers(1, 6, nl)
    return {"signals": sig, "num_samples": np.asarray(lens, np.int32),
            "labels": labels,
            "label_lengths": np.asarray(label_lens, np.int32)}


@pytest.fixture(scope="module")
def lstm_pair():
    cfg = preset_config("bilstm_deep").override(LSTM_OVER)
    jm = build_jax_model(cfg.model)
    b = _batch()
    feats, flens = batch_features(jnp.asarray(b["signals"]),
                                  jnp.asarray(b["num_samples"]))
    jstate = init_state(jm, cfg.optim, jax.random.key(0), feats, flens)
    tcfg = Config.from_json(cfg.to_json())
    tm = build_model(tcfg.model)
    load_flax_params(tm, jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]))
    return cfg, jm, jstate, tcfg, tm, b, feats, flens


def test_bilstm_deep_wide_logits_match_jax(lstm_pair):
    """Two BiLSTM layers of 640 (rec [2, 640, 2560]): fp32 logits and
    output lengths of the port (the kernels' plain versions) against the
    JAX model's Pallas path in interpret mode."""
    cfg, jm, jstate, tcfg, tm, b, feats, flens = lstm_pair
    assert tuple(tm.state_dict()["birnn0.rec"].shape) == (2, H, 4 * H)
    assert rc.kernel_takes(H) and H > rc.RESIDENT_MAX
    lj, olj = jm.apply(jstate.params, feats, flens)
    with torch.no_grad():
        lt, olt = tm(torch.from_numpy(np.array(feats)),
                     torch.from_numpy(np.array(flens)))
    np.testing.assert_array_equal(olt.numpy(), np.asarray(olj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)


def test_bilstm_deep_wide_step_matches_jax(lstm_pair):
    """One training step's weighted-mean loss and fp32 gradients, the port
    against ``jax.value_and_grad(_forward_loss)`` (summation order only:
    atol 2e-5, rtol 1e-3, as the H = 32 cut in test_torch_train_step.py)."""
    cfg, jm, jstate, tcfg, tm, b, _, _ = lstm_pair
    (lj, _), gj = jax.value_and_grad(
        lambda p: _forward_loss(jm, cfg, p, {k: jnp.asarray(v)
                                             for k, v in b.items()},
                                jax.random.key(0), train=True),
        has_aux=True)(jstate.params)
    tm.zero_grad()
    lt, _, _, _ = forward_loss(tm, tcfg, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gj["params"]))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-3, err_msg=name)


# ---------------------------------------------------------------------------
# the streamed-W kernels' host side

WIDE = [H for H in range(544, rc.MAX_HIDDEN + 1, 32)]


@pytest.mark.parametrize("H", WIDE)
def test_streamed_geometry(H):
    """U = 8·⌈H / 128⌉ units a block in C = ⌈H / U⌉ ≤ 16 blocks, the last
    owning a positive multiple of 8; the forward a warp per unit block;
    the backward's reduction extent covers G·U in whole pairs of k-steps;
    shared memory within 227 KB, one partial-sum buffer only where two do
    not fit."""
    U = rc.wide_units(H)
    for cell, G in _G.items():
        for form in ("fwd", "bwd"):
            p = getattr(rc, f"{cell}_plan")(H, 17, 2, form)
            assert p.cluster == -(-H // U) <= 16 and U % 8 == 0
            assert 0 < H - U * (p.cluster - 1) <= U
            assert (H - U * (p.cluster - 1)) % 8 == 0
            assert p.rows == rc.ROWS and p.clusters == 2 * 2
            assert p.smem <= rc.SMEM_MAX and p.smem % 16 == 0
        assert 4 * U <= 512                       # forward threads
        K = rc.wide_bwd_k(H, G)
        assert K % 32 == 0 and G * U <= K < G * U + 32
        part = rc.ROWS * -(-H // U) * U * 4
        bufs = rc.wide_bwd_bufs(H, G)
        assert rc._tc_smem("bwd", H, G) == rc.ROWS * (2 * K + 16) + \
            bufs * part
        assert rc._tc_smem("fwd", H, G) == 2 * rc.ROWS * (2 * H + 16)
        assert bufs == 2 or rc.ROWS * (2 * K + 16) + 2 * part > rc.SMEM_MAX


@pytest.mark.parametrize("H,want", [
    (640, (40, 16, 160, 2, 41472, 87296)),
    (768, (48, 16, 192, 2, 49664, 104704)),
    (1024, (64, 16, 256, 2, 66048, 139520)),
    (2048, (128, 16, 512, 1, 131584, 147712))])
def test_streamed_plan_by_hand(H, want):
    """The LSTM's streamed-W geometry worked by hand: (U, C, K, buffers,
    forward and backward shared memory). H = 1024: 2 × 16 rows of h of
    2·1024 + 16 bytes forward; backward 16 rows of 2·256 + 16 bytes of gate
    gradients and 2 × 16 × 1024 fp32 partial sums. H = 2048: two buffers
    would need 16,640 + 262,144 bytes, so one."""
    U, C, K, bufs, fwd, bwd = want
    assert (rc.wide_units(H), rc.lstm_plan(H, 24, 2, "fwd").cluster,
            rc.wide_bwd_k(H, 4), rc.wide_bwd_bufs(H, 4)) == (U, C, K, bufs)
    assert rc.lstm_smem("fwd", H) == fwd == 2 * 16 * (2 * H + 16)
    assert rc.lstm_smem("bwd", H) == bwd == 16 * (2 * K + 16) + \
        bufs * 16 * C * U * 4
    assert rc.gru_units(H, "fwd") == rc.gru_units(H, "bwd") == U


@pytest.mark.parametrize("cell,ndir,H", [("lstm", 2, 640), ("gru", 1, 544),
                                         ("gru", 2, 1056),
                                         ("lstm", 1, 768)])
def test_wide_fwd_layout_matches_the_kernel_index(cell, ndir, H):
    """The streamed-W forward's fragments: W[d, k, g·H + 8·ub + n] (bf16)
    at flat index ((((d·H/8 + ub)·H/16 + ks)·G + g)·32 + l)·4 + e with
    k = 16·ks + 2·(l % 4) + (e % 2) + 8·(e // 2), n = l // 4 (a warp's
    fragments [ks][g][l], its lane's four values), against a hand-written
    loop; the wrapper's launch arguments are these fragments and the
    plan's C."""
    G = _G[cell]
    rng = np.random.default_rng(H + ndir)
    w = torch.from_numpy(rng.standard_normal((ndir, H, G * H)).astype(
        np.float32))
    args = getattr(rc, f"_{cell}_launch_args")
    wk, C = args(w, 5, torch.bfloat16, "fwd")
    assert C == getattr(rc, f"{cell}_plan")(H, 5, ndir, "fwd").cluster
    flat = wk.reshape(-1)
    assert flat.dtype == torch.bfloat16 and flat.numel() == w.numel()
    wb = w.to(torch.bfloat16)
    d, ub, ks = rng.integers(ndir), rng.integers(H // 8), rng.integers(H // 16)
    for g in range(G):
        for l in range(32):
            for e in range(4):
                k = 16 * ks + 2 * (l % 4) + e % 2 + 8 * (e // 2)
                i = ((((d * (H // 8) + ub) * (H // 16) + ks) * G + g) * 32
                     + l) * 4 + e
                assert flat[i] == wb[d, k, g * H + 8 * ub + l // 4]
    # every element once: the layout is a permutation of W
    assert torch.equal(flat.sort().values, wb.reshape(-1).sort().values)


@pytest.mark.parametrize("cell,H", [("lstm", 640), ("gru", 544),
                                    ("gru", 2048)])
def test_wide_bwd_layout_matches_the_kernel_index(cell, H):
    """The streamed-W backward's fragments of block c: B[k, j] =
    W[d, j, g·H + U·c + u] at k = g·U + u (zero past G·U and for units
    past H) at flat index ((((((d·C + c)·H/32 + ng)·K/16 + ks)·4 + q)·32
    + l)·4 + e), j = 32·ng + 8·q + l // 4, against a hand-written loop."""
    G = _G[cell]
    rng = np.random.default_rng(H + 3)
    w = torch.from_numpy(rng.standard_normal((2, H, G * H)).astype(
        np.float32))
    U, K = rc.wide_units(H), rc.wide_bwd_k(H, G)
    C = -(-H // U)
    wk, Cp = getattr(rc, f"_{cell}_launch_args")(w, 3, torch.bfloat16, "bwd")
    assert Cp == C
    flat = wk.reshape(-1)
    assert flat.numel() == 2 * C * K * H
    wb = w.to(torch.bfloat16)
    for c in (0, C - 1):
        d, ng, ks = rng.integers(2), rng.integers(H // 32), \
            rng.integers(K // 16)
        for q in range(4):
            for l in range(32):
                for e in range(4):
                    k = 16 * ks + 2 * (l % 4) + e % 2 + 8 * (e // 2)
                    j = 32 * ng + 8 * q + l // 4
                    g, u = k // U, k % U
                    live = k < G * U and U * c + u < H
                    want = wb[d, j, g * H + U * c + u] if live else 0
                    i = ((((((d * C + c) * (H // 32) + ng) * (K // 16) + ks)
                           * 4 + q) * 32 + l) * 4 + e)
                    assert flat[i] == want


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_stream_launch_args(cell):
    """The stream wrappers' cache keeps the streamed-W fragments past
    H = 512: the same tensor on a second call, laid out anew after an
    in-place update."""
    G = _G[cell]
    w = torch.randn(1, H, G * H)
    wk, C = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert torch.equal(wk, rc.wide_fwd_weights(w)) and C == 16
    again, _ = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert again is wk
    with torch.no_grad():
        w.add_(1.0)
    fresh, _ = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert fresh is not wk and torch.equal(fresh, rc.wide_fwd_weights(w))


def test_kernel_takes_and_refuses():
    """Every H % 32 == 0 in [32, 2048] — every H % 128 == 0 the
    reference's kernels take up to 2048 among them — and nothing else;
    the plans and the launch checks refuse the rest by name."""
    takes = [h for h in range(1, 4097) if rc.kernel_takes(h)]
    assert takes == list(range(32, rc.MAX_HIDDEN + 1, 32))
    for h in (2080, 4096, 1040, 16):
        with pytest.raises(ValueError, match="unsupported"):
            rc.lstm_plan(h, 4, 2, "fwd")
        with pytest.raises(ValueError, match="2048"):
            rc._check_sizes(4, 8, h, torch.bfloat16, "gru", 2)
