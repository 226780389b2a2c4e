"""The ``glu_conv`` preset in the port against the JAX package on the CPU:
``GLUConvBlock`` alone (with and without ``res_proj``), a narrow model's
logits, the stream margins, the bridge both ways, the train step and
streaming at the exact lookahead.

Bars: fp32 1e-5 for the block and 1e-4 for a model's logits (summation
order), bf16 3e-2 (the port's bf16 bar against flax: the two frameworks
round at other places), for the block's bf16 output plus 2^-7 of |b|, one
ulp of a bf16 value beyond 4 being 2^-5 > 3e-2; the train step at
``test_torch_train_step.py``'s bars; stream window logits at 1e-4 (``test_torch_streaming.py``'s)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import preset_config as jpreset
from chainer_speech_recognition_tpu.decode import streaming as jstream
from chainer_speech_recognition_tpu.models.conv import (
    GLUConvBlock as JaxGLUConvBlock)
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, state_dict_to_flax)
from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    batch_features)
from chainer_speech_recognition_tpu_torch.models.conv import GLUConvBlock
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from test_torch_models import _cfg, _pair
from test_torch_streaming import _pcm, _setup
from test_torch_train_step import OVER, _gradients_loss_and_counts, \
    _three_steps
from test_torch_train_step import _pair as _step_pair

torch.set_num_threads(1)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}
# the preset's six blocks, narrow: D = 10 · 8 = 80 from the cut subsampler
GLU = {"model.glu_channels": 16}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D,C", [(40, 24), (24, 24)])
def test_glu_block_matches_flax(D, C, dtype):
    """One block on [B, T, D] frames with ragged lengths: res_proj where D
    ≠ C, the bare residual where D = C; padded frames come out zero."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(D + C)
    x = rng.standard_normal((3, 37, D)).astype(np.float32)
    lens = np.asarray([37, 20, 1], np.int32)
    jb = JaxGLUConvBlock(channels=C, dtype=jdt)
    params = jb.init(jax.random.key(D), jnp.asarray(x, jdt),
                     jnp.asarray(lens))
    want = np.asarray(jb.apply(params, jnp.asarray(x, jdt),
                               jnp.asarray(lens)), np.float32)
    tb = GLUConvBlock(D, C, tdt)
    tb.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, params["params"])), strict=True)
    assert (tb.res_proj is None) == (D == C)
    with torch.inference_mode():
        got = tb(torch.from_numpy(x).to(tdt), torch.from_numpy(lens).long())
    assert got.dtype == tdt and got.shape == (3, 37, C)
    got = got.float().numpy()
    assert not got[1, 20:].any() and not got[2, 1:].any()
    rtol = 2 ** -7 if tdt == torch.bfloat16 else 0.0
    np.testing.assert_allclose(got, want, atol=tol, rtol=rtol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_glu_conv_logits_match_flax(dtype, tol):
    """A 2-block glu_conv (block 0 projects the subsampler's 80 features
    to 16 channels, block 1 is the bare residual) vs flax's model."""
    (lj, olj), (lt, olt), _, tm = _pair(
        _cfg("glu_conv", dtype, **GLU, **{"model.glu_blocks": 2}))
    assert tm.n_glu == 2 and tm.glu0.res_proj is not None \
        and tm.glu1.res_proj is None
    assert np.array_equal(olj, olt)
    assert lt.dtype == np.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, atol=tol, rtol=0)


def test_glu_conv_margins_match_reference():
    """The full preset's stream margins, from the module's kernel_time:
    48 input frames of right reach (6 blocks of 5 at jump 4), and the
    geometry the JAX package derives from them."""
    jm = build_jax_model(jpreset("glu_conv").model)
    tm = build_model(preset_config("glu_conv").model)
    assert tm.conv_right_margin() == jm.conv_right_margin() == 48
    assert tm.conv_receptive_margin() == jm.conv_receptive_margin()
    for chunk, right in ((64, 16), (64, 48), (32, 50), (16, 0)):
        g = tstream.stream_geometry(tm, chunk, right)
        assert g == jstream.stream_geometry(jm, chunk, right)
        assert g["conv_exact"] == (g["R"] >= 48)


def test_glu_conv_bridges_both_ways():
    """glu{i}/glu_conv/kernel [kt, D, 2C] ↔ glu{i}.glu_conv.weight [2C, D,
    kt] and glu{i}/res_proj, every leaf bitwise both ways; the port's
    init draws the conv at fan_in kt·D, as flax's lecun_normal does."""
    _, _, params, tm = _pair(_cfg("glu_conv", "float32", **GLU))
    sd = flax_to_state_dict(params)
    assert tuple(sd["glu0.glu_conv.weight"].shape) == (32, 80, 5)
    assert tuple(sd["glu0.res_proj.weight"].shape) == (16, 80)
    assert tuple(sd["glu5.glu_conv.weight"].shape) == (32, 16, 5)
    assert "glu1.res_proj.weight" not in sd
    back = state_dict_to_flax(tm.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf))
    init_parameters(tm, 0)
    w = tm.glu0.glu_conv.weight.detach()
    assert abs(float(w.std()) - (5 * 80) ** -0.5) < 0.1 * (5 * 80) ** -0.5
    assert not tm.glu0.glu_conv.bias.any()


@pytest.fixture(scope="module")
def glu_pair():
    return _step_pair("glu_conv", {**OVER, **GLU, "model.glu_blocks": 2})


def test_glu_conv_gradients_match(glu_pair):
    """fp32 gradients of the weighted-mean loss through the GLU blocks,
    at test_gradients_loss_and_counts_match's bars."""
    assert glu_pair[-1].n_glu == 2
    _gradients_loss_and_counts(glu_pair)


def test_glu_conv_three_steps_match(glu_pair):
    """Three glu_conv steps: metrics every step, parameters and Adam
    moments after three, at test_three_steps_match's bars."""
    _three_steps(glu_pair)


def _chained_logits(tm, cfg, pcm, ns, right):
    """The recognizer's emit-region logits of each stream, chained over
    the windows (read where it hands them to its greedy collapse), and the
    recognizer."""
    taken = []
    collapse = tstream._emit_greedy

    def spy(logits, lens, prev_id, C_s):
        taken.append((logits[:, :C_s].float(), torch.clamp(lens, 0, C_s)))
        return collapse(logits, lens, prev_id, C_s)

    tstream._emit_greedy = spy
    try:
        rec = tstream.StreamingRecognizer(tm, cfg, batch=len(ns),
                                          chunk_frames=32,
                                          right_frames=right)
        rec.accept(pcm, drain=False)
        rec.flush(num_samples=ns)
    finally:
        tstream._emit_greedy = collapse
    return [torch.cat([lg[b, : int(n[b])] for lg, n in taken])
            for b in range(len(ns))], rec


def test_glu_conv_streams_exactly_at_right_48():
    """The six-block preset (narrow) streams with no carries: at
    --right-frames 48 the chained window logits equal the offline logits,
    and the emitted ids equal the JAX recognizer's; at 16 (the CLI's
    default for a model without attention) the geometry is not exact."""
    cfg, tm, jcfg, jm, params = _setup("glu_conv", seed=50, **{
        "glu_channels": 16})
    assert tm.init_stream_carries(2) == []
    ns = np.asarray([9600, 7040])
    pcm = _pcm((2, int(ns.max())), seed=51)
    pcm[1, ns[1]:] = 0.0
    chained, trec = _chained_logits(tm, cfg, pcm, ns, right=48)
    assert trec.geo["conv_exact"]
    with torch.inference_mode():
        feats, flens = batch_features(torch.from_numpy(pcm),
                                      torch.from_numpy(ns),
                                      apply_cmvn="causal")
        offline, olens = tm(feats, flens)
    for b in range(2):
        assert chained[b].shape[0] == int(olens[b])
        np.testing.assert_allclose(chained[b].numpy(),
                                   offline[b, : int(olens[b])].numpy(),
                                   atol=1e-4, rtol=0)
    jrec = jstream.StreamingRecognizer(jm, params, jcfg, batch=2,
                                       chunk_frames=32, right_frames=48)
    jrec.accept(pcm, drain=False)
    jrec.flush(num_samples=ns)
    assert trec.emitted == jrec.emitted and any(trec.emitted)
    assert not tstream.stream_geometry(tm, 32, 16)["conv_exact"]
