"""The recurrences past H = 512 on the CPU: at H = 640 the port's plain
versions of every form (``*_scan``, ``*_scan_train``, ``*_scan_stream``,
``*_bwd`` through ``BiGRUScan`` / ``BiLSTMScan``) against the JAX
package's ``birnn_pallas``, ``birnn_pallas_stream`` and custom VJP in
interpret mode, for both cells, ndir 1 and 2, fp32 and bf16; a two-layer
``bilstm_deep`` at H = 640 (logits and one train step) against the JAX
model with weights carried over by the bridge; and the host side of the
persistent kernels (``csrc/rnn_mma.cuh``): the operand-fragment layouts
at the flat index the kernels read, and the plan's geometry, the staged
ring of A included. The kernels
themselves need a card (``tests/test_torch_cuda.py``, ``chip_smoke.py``
phase 32).

Bars as the narrower suites state them (tests/test_torch_lstm.py,
tests/test_torch_stream_kernels.py, tests/test_torch_rnn_train.py): the
forward fp32 1e-5 (stream form 1e-4), bf16 3e-2; gradients fp32 atol 2e-5
/ rtol 1e-4, bf16 5e-2."""

import os

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
# the persistent kernels' host side

WIDE = [H for H in range(544, rc.MAX_HIDDEN + 1, 32)]
# the kernels that stage A in shared memory: (cell, form) of their plans
STAGED = (("lstm", "fwd"), ("gru", "bwd"))


@pytest.mark.parametrize("H", WIDE)
def test_streamed_geometry(H):
    """Every (cell, form) past H = 512 takes the persistent form's plan;
    the two that stage A (the LSTM's forwards, the GRU's backward) at
    ndir 1 and 2 and B ∈ {1, 24, 33}: the ring has ``STAGES`` slots a warp
    of ``chunk`` ≥ 1 k-steps; where a warp keeps all of its kq = ⌈K /
    warps⌉ k-steps of W, its slots hold A alone (1024 bytes a k-step) and
    a chunk is as large as fits up to ⌈kq / STAGES⌉, which holds the whole
    of its A; where W does not fit, the slots are ``STREAM_CHUNK`` k-steps
    of A and the streamed B (a product's columns: the LSTM forward at 16
    columns runs halves of 8), and the resident k-steps are as many as fit
    beside them (at least one); shared memory = the partial sums + the resident W +
    the rings, within ``SMEM_MAX``; the workspace holds the counter, two A
    buffers and the one carried fp32 [ndir·B, H] array (c, or dh)."""
    for cell in ("gru", "lstm"):
        for form in ("fwd", "bwd"):
            p = getattr(rc, f"{cell}_plan")(H, 17, 2, form)
            assert p == rc.persist_plan(f"{cell}_{form}", H, 17, 2)
            if (cell, form) not in STAGED:
                assert p.chunk == 0
                continue
            cols, warps, per_unit, carried, ncmax = \
                rc.PERSIST[f"{cell}_{form}"]
            for ndir in (1, 2):
                for B in (1, 24, 33):
                    q = rc.persist_plan(f"{cell}_{form}", H, B, ndir)
                    K, nc = int(H * per_unit), cols * q.tiles
                    kq = -(-K // warps)
                    ncw = nc if nc <= ncmax else nc // 2
                    part = warps * 2 * nc * 512
                    room = (rc.SMEM_MAX - part) // warps
                    assert q.chunk >= 1 and 1 <= q.resident <= kq
                    if q.resident == kq:
                        slot = q.chunk * 1024
                        assert kq * nc * 256 + rc.STAGES * slot <= room
                        assert q.chunk == -(-kq // rc.STAGES) or (
                            kq * nc * 256 + rc.STAGES * (slot + 1024)
                            > room)
                    else:
                        slot = rc.STREAM_CHUNK * (1024 + ncw * 256)
                        assert q.chunk == rc.STREAM_CHUNK
                        assert kq * nc * 256 + rc.STAGES * 1024 > room
                        assert (q.resident + 1) * nc * 256 + \
                            rc.STAGES * slot > room
                    assert q.smem == part + warps * (
                        q.resident * nc * 256 + rc.STAGES * slot)
                    assert q.smem <= rc.SMEM_MAX and q.smem % 16 == 0
                    assert q.work == 256 + 2 * ndir * q.passes * 1024 * K \
                        + carried * ndir * B * H * 4


@pytest.mark.parametrize("H,want", [
    (640, ((40, 2, 10, 3, 163840, 286976),
           (40, 2, 15, 4, 208896, 614656))),
    (768, ((48, 2, 12, 3, 180224, 344320),
           (48, 2, 18, 4, 221184, 737536))),
    (1024, ((64, 2, 16, 4, 229376, 459008),
            (64, 2, 24, 3, 212992, 983296))),
    (2048, ((64, 4, 4, 2, 229376, 917760),
            (64, 4, 8, 2, 229376, 1966336)))])
def test_streamed_plan_by_hand(H, want):
    """The staged kernels' plans worked by hand on 132 SMs at ndir 2 and B
    = 24: (blocks a direction, tiles a block, resident k-steps a warp,
    k-steps a slot of the ring, shared memory, workspace) of the LSTM's
    forwards, then of the GRU's backward. LSTM, H = 1024: 128 tiles over
    66 SMs a direction → 2 a block, 64 blocks; 4 warps × 2 m-tiles × 8
    columns × 512 bytes of partial sums = 32,768; each warp's 16 k-steps
    of W (8 × 256 bytes each) and 4 slots of 4 k-steps of A (1024 bytes
    each: the whole of its A): 32,768 + 4 × (32,768 + 16,384) = 229,376;
    the workspace 256 + 2 × 2 × 1024 × 64 + 2 × 24 × 1024 × 4 (c). GRU
    backward, H = 1024: K = 192, 24 k-steps a warp of 8, W 24 × 512 bytes,
    and 27,008 − 12,288 bytes left a warp hold 3 k-steps a slot:
    16,384 + 8 × (12,288 + 12,288) = 212,992. H = 2048: 4 tiles a block;
    W does not fit (the LSTM: 32 × 4096 bytes a warp), so slots of two
    k-steps of A and a product's streamed B (the LSTM's 16 columns in
    halves of 8: 1024 + 2048 bytes a k-step; the GRU's 4 columns: 1024 +
    1024) and 4 (8) resident k-steps beside them: 65,536 + 4 × (4 × 4096
    + 4 × 2 × 3072) and 32,768 + 8 × (8 × 1024 + 4 × 2 × 2048). The ring's
    constants are the C plan's (``csrc/rnn_mma.cuh``)."""
    csrc = os.path.join(os.path.dirname(rc.__file__), "..", "csrc")
    with open(os.path.join(csrc, "rnn_mma.cuh")) as f:
        text = f.read()
    assert f"constexpr int kStages = {rc.STAGES};" in text
    assert f"constexpr int kStreamChunk = {rc.STREAM_CHUNK};" in text
    for name, (nb, nt, kr, ck, smem, work) in zip(("lstm_fwd", "gru_bwd"),
                                                  want):
        p = rc.persist_plan(name, H, 24, 2)
        assert (p.blocks, p.tiles, p.resident, p.chunk, p.smem, p.work) == \
            (nb, nt, kr, ck, smem, work)
    assert isinstance(rc.lstm_plan(H, 24, 2, "fwd"), rc.PersistPlan)
    assert isinstance(rc.gru_plan(H, 24, 2, "bwd"), rc.PersistPlan)


def _warp_steps(w, nw, K, kr):
    """``csrc/rnn_mma.cuh``'s warp_steps: (first k-step, k-steps, resident
    k-steps) of warp w."""
    kb = K * w // nw
    kw = K * (w + 1) // nw - kb
    return kb, kw, min(kw, kr)


# SM counts the plans are checked at besides an H100 SXM's: an H100 PCIe,
# MIG slices and smaller (ndir itself is added: one block a direction)
SMALL_SMS = (114, 64, 60, 32, 16)


def _owners(p, H):
    """{unit tile: (block, group, tile of the group)} of plan ``p``: the
    slots of the kernels' groups, nw8 = ⌈nt / ng⌉ tiles a group, that own
    a tile (within the block's nt and below H / 8)."""
    out = {}
    for c in range(p.blocks):
        for g in range(p.groups):
            for i in range(p.width):
                ib, tg = g * p.width + i, c * p.tiles + g * p.width + i
                if ib < p.tiles and tg < H // 8:
                    assert tg not in out
                    out[tg] = (c, g, i)
    return out


@pytest.mark.parametrize("H", WIDE)
def test_persist_plan_covers_w(H):
    """The persistent form at every width, ndir 1 and 2, B ∈ {1, 24, 32,
    33, 64} and a card of 132, 114, 64, 60, 32, 16 or ndir SMs: a plan at
    every count (no refusal), of ng = ⌈nt / GROUP_TILES⌉ groups of at most
    ``GROUP_TILES`` tiles (one group wherever nt ≤ 4, so every plan on 132
    SMs); each unit is owned by exactly one slot of one block's groups
    (whole n8 tiles, the last block the rest); each warp's k-steps,
    resident then streamed, cover the K k-steps of W exactly once; shared
    memory holds one group's partial sums and the resident k-steps of every
    group within ``SMEM_MAX``; the grid is at most the SMs (one block an
    SM); the passes cover B; the workspace holds the counter, two A buffers
    and the carried arrays (the LSTM backward's dc and dh_total, the LSTM
    forward's c, the GRU backward's dh); the staged kernels' rings beside
    W within ``SMEM_MAX`` (``test_streamed_geometry`` has their sizes)."""
    for name, (cols, warps, per_unit, carried, _) in rc.PERSIST.items():
        for ndir in (1, 2):
            for sms in (rc.SMS, *SMALL_SMS, ndir):
                for B in (1, 24, 32, 33, 64):
                    p = rc.persist_plan(name, H, B, ndir, sms)
                    assert p.groups == -(-p.tiles // rc.GROUP_TILES)
                    assert 1 <= p.width <= rc.GROUP_TILES
                    assert p.width * p.groups >= p.tiles > \
                        p.width * (p.groups - 1)
                    assert (p.groups == 1) == (p.tiles <= rc.GROUP_TILES)
                    if sms == rc.SMS:
                        assert p.groups == 1
                    assert p.blocks * ndir <= sms
                    owner = _owners(p, H)
                    assert sorted(owner) == list(range(H // 8))
                    assert max(c for c, _, _ in owner.values()) == \
                        p.blocks - 1
                    K = int(H * per_unit)
                    assert p.ksteps == K and p.warps == warps
                    seen = []
                    for w in range(warps):
                        kb, kw, kres = _warp_steps(w, warps, K, p.resident)
                        seen += list(range(kb, kb + kres))        # resident
                        seen += list(range(kb + kres, kb + kw))   # streamed
                    assert seen == list(range(K))
                    nc = cols * p.width
                    wk = p.groups * nc * 256
                    assert p.smem - p.chunk * rc.STAGES * warps * 1024 >= \
                        warps * 2 * nc * 512 + warps * p.resident * wk
                    if p.chunk == 0:
                        assert p.smem == warps * 2 * nc * 512 + \
                            warps * p.resident * wk
                    assert p.smem <= rc.SMEM_MAX and p.resident >= 0
                    # the instantiations that never stream hold it all
                    if (name, p.width) in (("gru_fwd", 1), ("gru_fwd", 2),
                                           ("lstm_bwd", 1)):
                        assert p.groups == 1 and p.resident * warps >= K
                    assert (p.passes - 1) * 32 < B <= p.passes * 32
                    work = 256 + 2 * ndir * p.passes * 2 * K * 32 * 16
                    assert p.work == work + carried * ndir * B * H * 4


@pytest.mark.parametrize("name,H,ndir,sms,tiles,groups,blocks", [
    ("gru_fwd", 1824, 2, 114, 4, 1, 57), ("gru_fwd", 1856, 2, 114, 5, 2, 47),
    ("lstm_bwd", 1824, 2, 114, 4, 1, 57),
    ("lstm_bwd", 2048, 2, 114, 5, 2, 52),
    ("gru_fwd", 2048, 2, 128, 4, 1, 64), ("lstm_bwd", 2048, 2, 127, 5, 2, 52),
    ("gru_fwd", 2048, 1, 64, 4, 1, 64), ("lstm_bwd", 1024, 1, 31, 5, 2, 26),
    ("lstm_fwd", 1824, 2, 114, 4, 1, 57),
    ("lstm_fwd", 1856, 2, 114, 5, 2, 47),
    ("gru_bwd", 2048, 2, 128, 4, 1, 64), ("gru_bwd", 2048, 2, 114, 5, 2, 52),
    ("lstm_fwd", 1024, 1, 31, 5, 2, 26), ("gru_bwd", 2048, 1, 64, 4, 1, 64)])
def test_persist_plan_refuses_tiles_it_has_no_kernel_for(name, H, ndir, sms,
                                                          tiles, groups,
                                                          blocks):
    """The kernels are built for groups of 1 to ``GROUP_TILES`` unit tiles
    (``csrc/rnn_mma.cuh``'s kGroupTiles, a ``case`` of each
    ``with_persist_kernel`` a group width, any other width refused there),
    and a block of more tiles runs them as ⌈nt / GROUP_TILES⌉ groups: no
    tile count is left without a kernel, so no card is refused. Around the
    old limit of ndir · H / 32 SMs (an H100 PCIe's 114 at H = 1824 and
    1856–2048 bidirectional; 127, 128, 64 and 31 SMs), worked by hand: nt
    = ⌈(H / 8) / (sms // ndir)⌉, ng = ⌈nt / 4⌉, NB = ⌈(H / 8) / nt⌉; e.g.
    1856 at ndir 2 on 114 SMs: 232 tiles over 57 SMs a direction → 5 a
    block in 2 groups of 3 (the second group's third tile a zero column),
    47 blocks."""
    csrc = os.path.join(os.path.dirname(rc.__file__), "..", "csrc")
    with open(os.path.join(csrc, "rnn_mma.cuh")) as f:
        assert (f"constexpr int kGroupTiles = {rc.GROUP_TILES};"
                in f.read())
    for src in ("gru_fwd.cu", "lstm_bwd.cu", "lstm_fwd.cu", "gru_bwd.cu"):
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        body = text[text.index("int with_persist_kernel("):]
        body = body[:body.index("\n}\n")]
        assert "switch (p.width)" in body or "switch (width)" in body
        assert [f"case {n}:" in body for n in range(1, 6)] == \
            [True] * rc.GROUP_TILES + [False]
        assert "default:\n      return static_cast<int>(" \
            "cudaErrorInvalidValue);" in body
    p = rc.persist_plan(name, H, 24, ndir, sms)
    assert (p.tiles, p.groups, p.blocks) == (tiles, groups, blocks)
    assert p.blocks * ndir <= sms and p.width <= rc.GROUP_TILES


@pytest.mark.parametrize("name,H,ndir,want", [
    ("gru_fwd", 1024, 1, (128, 1, 16, 61440)),
    ("gru_fwd", 1024, 2, (64, 2, 16, 122880)),
    ("gru_fwd", 2048, 1, (128, 2, 32, 221184)),
    ("gru_fwd", 2048, 2, (64, 4, 14, 221184)),
    ("lstm_bwd", 640, 2, (40, 2, 20, 98304)),
    ("lstm_bwd", 1024, 2, (64, 2, 32, 147456)),
    ("lstm_bwd", 2048, 2, (64, 4, 24, 229376))])
def test_persist_plan_by_hand(name, H, ndir, want):
    """The persistent form's geometry worked by hand on 132 SMs: (blocks a
    direction, tiles a block, resident k-steps a warp, shared memory).
    GRU, H = 2048, ndir 1: 256 tiles over 132 blocks → 2 a block, 128
    blocks; 4 warps × 2 m-tiles × 6 columns × 512 bytes of partial sums and
    all 32 k-steps of each warp's share, 6 × 256 bytes each: 221,184
    bytes, the whole slice resident. ndir 2: 4 tiles a block over 64, 14
    of each warp's 32 k-steps resident. LSTM backward, H = 2048, ndir 2: K
    = 512, 8 warps × 2 × 4 × 512 = 32,768 bytes of partial sums and 24 of
    each warp's 64 k-steps of 4 × 256 bytes."""
    p = rc.persist_plan(name, H, 24, ndir)
    assert (p.blocks, p.tiles, p.resident, p.smem) == want


def _a_words(h, K):
    """The A buffer of one pass as the kernels write it: each slot (m-tile
    m, unit tile tg, lane l) stores bf16 pairs (h[16 m + l/4 + 8 i, k],
    h[.., k + 1]), k = 8 tg + 2 (l % 4), into word 2 i + k / 8 % 2 of
    lane l's uint4 at k-step k / 16 (``rnn_mma.cuh``'s a_word) → [2][K][32]
    [4 words][2 values]."""
    a = np.full((2, K, 32, 4, 2), np.nan, np.float32)
    for m in range(2):
        for tg in range(2 * K):
            for l in range(32):
                k = 8 * tg + 2 * (l % 4)
                for i in range(2):
                    a[m, k // 16, l, 2 * i + k // 8 % 2] = \
                        h[16 * m + l // 4 + 8 * i, k:k + 2]
    return a


@pytest.mark.parametrize("H", [544, 1024])
def test_persist_a_buffer_is_the_mma_fragment(H):
    """Every word of the A buffer is written exactly once, and lane l's
    uint4 at k-step ks holds the m16n8k16 A fragment the products read, in
    the order (a0, a2, a1, a3) = rows (l/4, l/4, l/4 + 8, l/4 + 8) at
    columns 16 ks + 2 (l % 4) + {0, 1} (+ 8 for a2, a3): rows 0-7 of the
    m-tile in the first 8 bytes, which is all a pass reads where rows 8-15
    are past B. The LSTM's backward writes its dg at column g·H + j, the
    same rule with k offset by g·H."""
    K = H // 16
    h = np.random.default_rng(H).standard_normal((32, H)).astype(np.float32)
    a = _a_words(h, K)
    assert not np.isnan(a).any()
    for ks in (0, K // 2, K - 1):
        for l in range(32):
            r, c = l // 4, 16 * ks + 2 * (l % 4)
            for m in range(2):
                for q in range(4):
                    rr = 16 * m + r + 8 * (q // 2)
                    cc = c + 8 * (q % 2)
                    np.testing.assert_array_equal(a[m, ks, l, q],
                                                  h[rr, cc:cc + 2])


@pytest.mark.parametrize("ndir,H,B", [(1, 544, 5), (2, 1056, 3),
                                      (2, 2048, 2), (1, 2048, 2)])
def test_persist_fwd_layout_matches_the_kernel_index(ndir, H, B):
    """``_check_persist_fwd`` at the edges of the plan: one, two and four
    tiles a block, a short last block (544, 1056)."""
    _check_persist_fwd(ndir, H, B)


def _check_persist_fwd(ndir, H, B, cell="gru", sms=rc.SMS):
    """A persistent forward's fragments (the GRU's: G = 3, gates r, z, n;
    the LSTM's: G = 4, gates i, f, o, u) on a card of ``sms`` SMs: block
    c's group g, its tile i, gate gt at k-step ks, lane l's value e is W[d,
    16·ks + 2·(l % 4) + e % 2 + 8·(e // 2), gt·H + 8·(nt·c + nw8·g + i) +
    l // 4] (zero where nw8·g + i ≥ nt or the unit passes H) at flat index
    (((((((d·NB + c)·ng + g)·K + ks)·nw8 + i)·G + gt)·32 + l)·4 + e), nw8 =
    ⌈nt / ng⌉, against a hand-written loop at the first and last blocks;
    the wrapper's launch arguments (its plan at ``_sms``) are these
    fragments and the plan's NB; the B operand they give, multiplied out,
    is W's columns of the block."""
    G = _G[cell]
    rng = np.random.default_rng(H + ndir)
    w = torch.from_numpy(rng.standard_normal((ndir, H, G * H)).astype(
        np.float32))
    p = rc.persist_plan(f"{cell}_fwd", H, B, ndir, sms)
    K, nt, ng, nw = H // 16, p.tiles, p.groups, p.width
    with pytest.MonkeyPatch.context() as m:   # a card of `sms` SMs
        m.setattr(rc, "_sms", lambda t: sms)
        wk, C = getattr(rc, f"_{cell}_launch_args")(w, B, torch.bfloat16,
                                                    "fwd")
    assert C == p.blocks and wk.shape == (ndir, p.blocks, ng * K, nw, G, 32,
                                          4)
    layout = (rc.persist_fwd_weights if cell == "gru"
              else rc.persist_lstm_fwd_weights)
    assert torch.equal(wk, layout(w, p.blocks, p.tiles, p.groups))
    flat, wb = wk.reshape(-1), w.to(torch.bfloat16)
    for c in (0, p.blocks - 1):
        d, ks = rng.integers(ndir), rng.integers(K)
        for g in range(ng):
            for i in range(nw):
                for gt in range(G):
                    for l in range(32):
                        for e in range(4):
                            k = 16 * ks + 2 * (l % 4) + e % 2 + 8 * (e // 2)
                            u = 8 * (nt * c + nw * g + i) + l // 4
                            want = (wb[d, k, gt * H + u]
                                    if u < H and nw * g + i < nt else 0)
                            idx = ((((((((d * p.blocks + c) * ng + g) * K
                                       + ks) * nw + i) * G + gt) * 32 + l)
                                    * 4) + e)
                            assert flat[idx] == want
    # every element of W once, zeros elsewhere
    nz = flat[flat != 0]
    assert torch.equal(nz.sort().values, wb[wb != 0].reshape(-1).sort()
                       .values)


@pytest.mark.parametrize("ndir,H,B", [(2, 640, 3), (1, 1088, 5),
                                      (2, 2048, 24)])
def test_persist_bwd_layout_matches_the_kernel_index(ndir, H, B):
    """``_check_persist_bwd`` at one, two and four tiles a block."""
    _check_persist_bwd(ndir, H, B)


def _check_persist_bwd(ndir, H, B, cell="lstm", sms=rc.SMS):
    """A persistent backward's fragments (the LSTM's over its 4H gate
    columns, the GRU's over its 3H) of block c on a card of ``sms`` SMs:
    B[k, j] = W[d, j, k], group g, its tile i, lane l, value e at flat
    index ((((((d·NB + c)·ng + g)·K + ks)·nw8 + i)·32 + l)·4 + e) with K =
    G·H / 16, nw8 = ⌈nt / ng⌉, j = 8·(nt·c + nw8·g + i) + l // 4 (zero
    where nw8·g + i ≥ nt or j passes H) and k = 16·ks + 2·(l % 4) + e % 2
    + 8·(e // 2), against a hand-written loop; the wrapper's launch
    arguments (its plan at ``_sms``) are these fragments and the plan's
    NB."""
    G = _G[cell]
    rng = np.random.default_rng(H + 3)
    w = torch.from_numpy(rng.standard_normal((ndir, H, G * H)).astype(
        np.float32))
    p = rc.persist_plan(f"{cell}_bwd", H, B, ndir, sms)
    with pytest.MonkeyPatch.context() as m:   # a card of `sms` SMs
        m.setattr(rc, "_sms", lambda t: sms)
        wk, C = getattr(rc, f"_{cell}_launch_args")(w, B, torch.bfloat16,
                                                    "bwd")
    assert C == p.blocks
    layout = (rc.persist_bwd_weights if cell == "lstm"
              else rc.persist_gru_bwd_weights)
    assert torch.equal(wk, layout(w, p.blocks, p.tiles, p.groups))
    flat, wb = wk.reshape(-1), w.to(torch.bfloat16)
    K, nt, ng, nw = G * H // 16, p.tiles, p.groups, p.width
    assert flat.numel() == ndir * p.blocks * ng * K * nw * 128
    for c in (0, p.blocks - 1):
        d, ks = rng.integers(ndir), rng.integers(K)
        for g in range(ng):
            for i in range(nw):
                for l in range(32):
                    for e in range(4):
                        k = 16 * ks + 2 * (l % 4) + e % 2 + 8 * (e // 2)
                        j = 8 * (nt * c + nw * g + i) + l // 4
                        want = wb[d, j, k] if j < H and nw * g + i < nt else 0
                        idx = (((((((d * p.blocks + c) * ng + g) * K + ks)
                                  * nw + i) * 32 + l) * 4) + e)
                        assert flat[idx] == want
    nz = flat[flat != 0]
    assert torch.equal(nz.sort().values, wb[wb != 0].reshape(-1).sort()
                       .values)


@pytest.mark.parametrize("cell,ndir,H", [("lstm", 2, 640), ("gru", 1, 544),
                                         ("gru", 2, 1056),
                                         ("lstm", 1, 768)])
def test_wide_fwd_layout_matches_the_kernel_index(cell, ndir, H):
    """Both cells' persistent forward fragments (``_check_persist_fwd``):
    the LSTM's four gate columns a tile at two tiles a block (640, ndir 2)
    and one (768, ndir 1), the GRU's three at a short last block."""
    _check_persist_fwd(ndir, H, 5, cell)


@pytest.mark.parametrize("cell,H", [("lstm", 640), ("gru", 544),
                                    ("gru", 2048)])
def test_wide_bwd_layout_matches_the_kernel_index(cell, H):
    """Both cells' persistent backward fragments (``_check_persist_bwd``,
    ndir 2): the GRU's over its 3H gate columns at a short last block
    (544) and at four tiles a block (2048), the LSTM's at 640."""
    _check_persist_bwd(2, H, 3, cell)


@pytest.mark.parametrize("cell,form,ndir,H,sms", [
    ("gru", "fwd", 2, 1856, 114), ("lstm", "fwd", 2, 2048, 114),
    ("gru", "bwd", 2, 2048, 114), ("lstm", "bwd", 2, 1856, 114),
    ("gru", "fwd", 1, 1024, 16), ("lstm", "fwd", 2, 1024, 16),
    ("gru", "bwd", 2, 1024, 16), ("lstm", "bwd", 1, 1024, 16),
    ("gru", "fwd", 2, 544, 4), ("lstm", "bwd", 1, 1088, 9)])
def test_persist_layouts_in_groups_match_the_kernel_index(cell, form, ndir,
                                                          H, sms):
    """The four persistent layouts where a block runs its tiles in more
    than one group (``_check_persist_fwd``, ``_check_persist_bwd``): an
    H100 PCIe's 114 SMs at H = 1856 / 2048 bidirectional (5 tiles in 2
    groups of 3, the second's last a zero column), 16 SMs at H = 1024 (16
    tiles in 4 groups of 4 bidirectional; 8 in 2 forward-only), 4 SMs at
    544 (34 tiles, 9 groups of 4, the last short) and 9 at 1088
    forward-only (16 tiles, 4 groups of 4, a short last block)."""
    assert rc.persist_plan(f"{cell}_{form}", H, 5, ndir, sms).groups > 1
    check = _check_persist_fwd if form == "fwd" else _check_persist_bwd
    check(ndir, H, 5, cell, sms)


@pytest.mark.parametrize("cell,H,sms", [("lstm", 1856, 114),
                                        ("gru", 1856, 114),
                                        ("lstm", 1024, 16),
                                        ("gru", 1024, 16)])
def test_wide_launch_args_on_a_smaller_card(cell, H, sms, monkeypatch):
    """A BiLSTM and a BiGRU past the old limit of ndir · H / 32 SMs (an
    H100 PCIe's 114 at H = 1856; a 16-SM MIG slice at 1024) build every
    bf16 form's launch arguments without raising, with ``_sms`` patched as
    on such a card: the plan's blocks, in groups, and the layout of its
    geometry."""
    G = _G[cell]
    w = torch.randn(2, H, G * H)
    monkeypatch.setattr(rc, "_sms", lambda t: sms)
    for form in ("fwd", "bwd"):
        p = getattr(rc, f"{cell}_plan")(H, 24, 2, form, rc._sms(w))
        assert isinstance(p, rc.PersistPlan) and p.groups > 1
        assert p.blocks * 2 <= sms
        wk, C = getattr(rc, f"_{cell}_launch_args")(w, 24, torch.bfloat16,
                                                    form)
        assert C == p.blocks and wk.shape[2] == p.groups * p.ksteps
    wk, C = rc.stream_launch_args(cell, w, 24, torch.bfloat16)
    p = rc.persist_plan(f"{cell}_fwd", H, 24, 2, sms)
    assert C == p.blocks and wk.shape[3] == p.width


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_wide_stream_launch_args(cell):
    """The stream wrappers' cache keeps the forward's persistent fragments
    past H = 512 (``persist_fwd_weights``, ``persist_lstm_fwd_weights``)
    and the plan's blocks: the same tensor on a second call, laid out anew
    after an in-place update and where the plan's tiles a block change at
    the same C."""
    G = _G[cell]
    w = torch.randn(1, H, G * H)
    p = rc.persist_plan(f"{cell}_fwd", H, 32, 1)
    f = rc.persist_fwd_weights if cell == "gru" else \
        rc.persist_lstm_fwd_weights
    layout = lambda x: f(x, p.blocks, p.tiles)
    wk, C = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert torch.equal(wk, layout(w)) and C == p.blocks
    again, _ = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert again is wk
    with torch.no_grad():
        w.add_(1.0)
    fresh, _ = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert fresh is not wk and torch.equal(fresh, layout(w))
    # another geometry at the same C (a plan of one more tile a block in
    # two groups, here made up): laid out anew, then the real one again
    plan = getattr(rc, f"{cell}_plan")
    other = p._replace(tiles=p.tiles + 1, groups=2)
    try:
        setattr(rc, f"{cell}_plan", lambda *a: other)
        moved, C = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    finally:
        setattr(rc, f"{cell}_plan", plan)
    assert C == p.blocks and moved.shape != fresh.shape
    assert torch.equal(moved, f(w, other.blocks, other.tiles, 2))
    back, _ = rc.stream_launch_args(cell, w, 32, torch.bfloat16)
    assert back is not moved and torch.equal(back, layout(w))


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
