"""The port's streaming path (frontend/torch_frontend.cmvn_causal with
carries, decode/streaming.py, the streaming call of models/presets.py)
against the JAX package's on the CPU, at cut widths, fp32, with weights
bridged from flax.

Bars: causal CMVN 1e-5; window logits and RNN carries 1e-4; the carried
CMVN running sums (Σx² reaches 1e2-1e4) the same plus 1e-6 of their size,
fp32's rounding of such sums. The recognizer's emitted ids are held to
JAX's in tests/test_torch_stream_recognizer.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import preset_config as jpreset
from chainer_speech_recognition_tpu.decode import streaming as jstream
from chainer_speech_recognition_tpu.frontend.jnp_frontend import (
    cmvn_causal_jnp)
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu_torch.bridge import load_flax_params
from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    cmvn_causal)
from chainer_speech_recognition_tpu_torch.models.presets import build_model

torch.set_num_threads(1)
CUT = {"model.conv_channels": [8, 8], "model.rnn_hidden": 32,
       "model.rnn_layers": 2}


def _setup(name, *, seed=0, cmvn_mode="causal", cmvn=True, **model_over):
    """(port cfg, port model, JAX cfg, JAX model, JAX params): the same
    fp32 weights in both packages."""
    over = {"features.cmvn_mode": cmvn_mode, "features.cmvn": cmvn,
            "model.vocab_size": 8, "model.compute_dtype": "float32"}
    if name != "tiny_conv":
        over.update(CUT)
    over.update({f"model.{k}": v for k, v in model_over.items()})
    jcfg = jpreset(name).override(over)
    jm = build_jax_model(jcfg.model)
    params = jax.jit(jm.init)(jax.random.key(seed),
                              jnp.zeros((1, 32, 40, 3), jnp.float32),
                              jnp.asarray([32]))
    cfg = preset_config(name).override(over)
    tm = build_model(cfg.model)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                params["params"]))
    return cfg, tm.eval(), jcfg, jm, params


def _pcm(shape, seed=0):
    return np.asarray(
        np.random.default_rng(seed).uniform(-0.5, 0.5, shape), np.float32)


# --------------------------------------------------------------- CMVN --

@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("carry_index", [None, 0, 6])
def test_cmvn_causal_carry_matches_jax(carry_index, with_carry):
    rng = np.random.default_rng(1)
    B, T, F = 3, 11, 40
    x = (rng.standard_normal((B, T, F)) * 3 - 20).astype(np.float32)
    tmask = np.arange(T)[None, :] < np.asarray([T, 7, 1])[:, None]
    x = x * tmask[..., None]
    carry = None
    if with_carry:
        carry = (np.full((B, 1, 1), 5.0, np.float32),
                 rng.standard_normal((B, 1, F)).astype(np.float32),
                 (5 + rng.uniform(0, 1, (B, 1, F))).astype(np.float32),
                 (rng.standard_normal((B, 1, F)) - 20).astype(np.float32))
    jo, jc = cmvn_causal_jnp(
        jnp.asarray(x), jnp.asarray(tmask),
        carry=None if carry is None else tuple(map(jnp.asarray, carry)),
        carry_index=carry_index)
    to, tc = cmvn_causal(
        torch.from_numpy(x), torch.from_numpy(tmask),
        carry=None if carry is None else tuple(map(torch.from_numpy, carry)),
        carry_index=carry_index)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    assert len(tc) == len(jc) == 4
    for a, b in zip(tc, jc):       # running sums (Σx² ~ 1e2): 1e-5 + 1e-6 rel
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-6)


# ----------------------------------------------------------- geometry --

@pytest.mark.parametrize("name", ["tiny_conv", "bigru", "uni_gru",
                                  "bilstm_deep"])
def test_stream_geometry_matches_jax(name):
    jm = build_jax_model(jpreset(name).model)
    tm = build_model(preset_config(name).override(CUT).model)
    assert tm.subsample_factor() == jm.subsample_factor()
    assert tm.conv_receptive_margin() == jm.conv_receptive_margin()
    assert tm.conv_right_margin() == jm.conv_right_margin()
    for chunk, right, left in ((13, 3, None), (64, 16, None), (64, 0, None),
                               (16, 8, None), (1, 0, None), (40, 9, 12)):
        assert tstream.stream_geometry(tm, chunk, right, left) == \
            jstream.stream_geometry(jm, chunk, right, left)


# ------------------------------------------------------ window logits --

def _window_args(rec, first):
    g = rec.geo
    s, D = g["s"], tstream._D
    if first:
        return dict(W_lm=g["W_first"], lo=0, W_ft=g["C"] + g["R"],
                    drop_left=0, carry_at=g["C"] // s,
                    cmvn_index=g["C"] - g["La"] - D)
    return dict(W_lm=g["W_mid"], lo=D, W_ft=g["La"] + g["C"] + g["R"],
                drop_left=g["La"] // s, carry_at=g["C"] // s,
                cmvn_index=g["C"])


@pytest.mark.parametrize("first", [True, False])
@pytest.mark.parametrize("name,right", [("uni_gru", 0), ("bigru", 8),
                                        ("bilstm_deep", 16)])
def test_window_logits_match_jax(name, right, first):
    """One window's logits, lengths, CMVN carry and RNN carries: the first
    window (offline start edge) and a steady one (margins, carried CMVN
    stats and RNN states), the second stream ending inside the window."""
    cfg, tm, jcfg, jm, params = setup = _setup(name, seed=3)
    ns = [16000, 9000]
    pcm = _pcm((2, max(ns)), seed=4)
    pcm[1, ns[1]:] = 0.0
    trec = tstream.StreamingRecognizer(tm, cfg, batch=2, chunk_frames=32,
                                       right_frames=right)
    trec.accept(pcm, drain=False)
    g = trec.geo
    args = _window_args(trec, first)
    g0 = 0 if first else 2 * g["C"] - g["La"] - tstream._D
    ext = trec._assemble(g0, args["W_lm"], np.asarray(ns))
    fv = np.clip(1 + np.asarray(ns) // 160 - g0, 0, args["W_lm"])
    rng = np.random.default_rng(5)
    C = g["C"] - g["La"] - tstream._D
    dim = 2 * 32 if cfg.model.rnn_type == "lstm" else 32
    rnn = [(0.3 * rng.standard_normal((2, dim))).astype(np.float32)
           for _ in range(2)]
    cmvn = None if first else (
        np.full((2, 1, 1), float(C), np.float32),
        rng.standard_normal((2, 1, 40)).astype(np.float32),
        (C + rng.uniform(0, 1, (2, 1, 40))).astype(np.float32),
        (rng.standard_normal((2, 1, 40)) - 15).astype(np.float32))
    step = jax.jit(lambda *a: jstream._window_logits(jm, *a, use_cmvn=True,
                                                       **args))
    jl, jlens, jcmvn, jrnn = step(
        params, jnp.asarray(ext), jnp.asarray(fv.astype(np.int32)),
        None if cmvn is None else tuple(map(jnp.asarray, cmvn)),
        [jnp.asarray(h) for h in rnn])
    with torch.inference_mode():
        tl, tlens, tcmvn, trnn = tstream._window_logits(
            tm, torch.from_numpy(ext), torch.from_numpy(fv),
            None if cmvn is None else tuple(map(torch.from_numpy, cmvn)),
            [torch.from_numpy(h) for h in rnn], use_cmvn=True, **args)
    assert np.array_equal(tlens.numpy(), np.asarray(jlens))
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    for a, b in zip(trnn, jrnn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)
    for a, b in zip(tcmvn, jcmvn):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-6)
