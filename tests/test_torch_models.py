"""PyTorch AcousticModel through the bridge vs the flax AcousticModel, on
the CPU (the kernels' plain versions)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params, state_dict_to_flax)
from chainer_speech_recognition_tpu_torch.models.presets import build_model

SMALL = {"model.conv_channels": [8, 8], "model.rnn_hidden": 32,
         "model.rnn_layers": 2, "model.vocab_size": 12}


def _cfg(preset, dtype, **extra):
    return preset_config(preset).override(
        {**SMALL, "model.compute_dtype": dtype, **extra}).model


def _pair(mcfg, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((3, 50, 40, 3)).astype(np.float32)
    lens = np.asarray([50, 33, 1], np.int32)
    jm = build_jax_model(mcfg)
    params = jm.init(jax.random.key(seed), jnp.asarray(feats),
                     jnp.asarray(lens))
    lj, olj = jm.apply(params, jnp.asarray(feats), jnp.asarray(lens))
    tm = build_model(mcfg)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                params["params"]))
    with torch.inference_mode():
        lt, olt = tm(torch.from_numpy(feats), torch.from_numpy(lens).long())
    return (np.asarray(lj), np.asarray(olj)), (lt.numpy(), olt.numpy()), \
        params["params"], tm


@pytest.mark.parametrize("preset,extra", [
    ("bigru", {}),
    ("bigru", {"model.proj_dim": 16}),
    ("bigru", {"model.conv_kernel": [4, 4]}),    # asymmetric padding
    ("tiny_conv", {}),
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_logits_match_flax(preset, extra, dtype, tol):
    (lj, olj), (lt, olt), _, _ = _pair(_cfg(preset, dtype, **extra))
    assert np.array_equal(olj, olt)
    assert lt.dtype == np.float32 and lt.shape == lj.shape
    np.testing.assert_allclose(lt, lj, atol=tol, rtol=0)


def test_bridge_round_trip_and_strictness():
    _, _, params, tm = _pair(_cfg("bigru", "float32", **{"model.proj_dim": 16}))
    back = state_dict_to_flax(tm.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf))
    sd = flax_to_state_dict(params)
    assert tuple(sd["subsampler.conv0.weight"].shape) == (8, 3, 3, 3)
    assert tuple(sd["birnn0.in_fwd.weight"].shape) == (96, 80)
    assert tuple(sd["birnn1.rec"].shape) == (2, 32, 96)
    bad = dict(params, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unknown"):
        load_flax_params(tm, bad)
    missing = {k: v for k, v in params.items() if k != "proj"}
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(tm, missing)


def test_unported_blocks_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(preset_config("glu_conv").model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(preset_config("conformer").model)
