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
# the attention presets cut to 2 blocks, d = 128, h = 2 (dh = 64)
ATTN = {"model.attn_blocks": 2, "model.attn_dim": 128, "model.attn_heads": 2}


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
    ("bilstm_deep", {}),                         # BiLSTM, rec [2, H, 4H]
    ("uni_gru", {}),                             # forward-only, rec [1, H, 3H]
    ("conformer", ATTN),                         # attn_in + 2 blocks, einsum
    ("conformer", {**ATTN, "model.attn_impl": "flash"}),
    ("conformer_stream", ATTN),                  # chunk 16 / left 4, causal
    ("conformer_stream", {**ATTN, "model.attn_impl": "flash"}),
    ("conformer", {**ATTN, "model.attn_residual_dtype": "bfloat16"}),
])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 3e-2)])
def test_logits_match_flax(preset, extra, dtype, tol):
    if extra.get("model.attn_residual_dtype") == "bfloat16":
        tol = 3e-2                     # a bf16 residual stream: the bf16 bar
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


def test_bilstm_deep_bridges_unchanged():
    """The flax tree of bilstm_deep maps onto the port's state_dict as it
    is: the recurrent weights keep the kernel's [2, H, 4H] layout."""
    _, _, params, tm = _pair(_cfg("bilstm_deep", "float32"))
    sd = flax_to_state_dict(params)
    assert tuple(sd["birnn1.rec"].shape) == (2, 32, 128)
    assert tuple(sd["birnn0.in_bwd.weight"].shape) == (128, 80)
    back = state_dict_to_flax(tm.state_dict())
    assert np.array_equal(back["birnn1"]["rec"],
                          np.asarray(params["birnn1"]["rec"]))


def test_uni_gru_bridges_forward_only():
    """A forward-only stack maps as it is: in_fwd and rec [1, H, 3H], no
    in_bwd, and the next layer reads H features, not 2H."""
    _, _, params, tm = _pair(_cfg("uni_gru", "float32"))
    sd = flax_to_state_dict(params)
    assert tuple(sd["birnn1.rec"].shape) == (1, 32, 96)
    assert tuple(sd["birnn1.in_fwd.weight"].shape) == (96, 32)
    assert not any("in_bwd" in k for k in sd)
    back = state_dict_to_flax(tm.state_dict())
    assert np.array_equal(back["birnn0"]["rec"],
                          np.asarray(params["birnn0"]["rec"]))


def test_unported_blocks_raise():
    """Every preset of the JAX package builds in the port: glu_conv with
    the reference's module names (glu0-5, block 0's res_proj from the
    subsampler's 320 features to 256 channels, held to flax in
    tests/test_torch_glu.py); the attention presets too (conformer refuses
    a streaming call, conformer_stream streams:
    tests/test_torch_attention.py, tests/test_torch_attention_stream.py)."""
    jm = build_jax_model(preset_config("glu_conv").model)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 40, 40, 3)),
                     jnp.asarray([40]))["params"]
    model = build_model(preset_config("glu_conv").model)
    assert model.n_glu == 6 and model.n_attn == 0 and model.n_rnn == 0
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert "glu0.res_proj.weight" in want and want[
        "glu0.glu_conv.weight"] == (512, 320, 5)
    for preset in ("conformer", "conformer_stream"):
        model = build_model(preset_config(preset).model)
        assert model.n_attn == 8 and model.attn_in is not None


def test_conformer_bridges_layer_norm_and_depthwise_leaves():
    """LayerNorm ``scale`` ↔ ``weight`` and the depthwise kernel [kt, 1, d]
    ↔ Conv1d [d, 1, kt], both ways, every leaf bitwise; flax's init and
    the port's init_parameters agree on which leaves are ones, zeros and
    lecun-normal with fan_in = kt."""
    from chainer_speech_recognition_tpu_torch.models.presets import (
        init_parameters)

    mcfg = _cfg("conformer", "float32", **ATTN)
    _, _, params, tm = _pair(mcfg)
    sd = flax_to_state_dict(params)
    blk = params["conformer1"]
    assert tuple(sd["conformer1.conv.dw.weight"].shape) == (128, 1, 15)
    np.testing.assert_array_equal(
        sd["conformer1.conv.dw.weight"].numpy(),
        np.asarray(blk["conv"]["dw"]["kernel"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["conformer1.ln_out.weight"].numpy(),
                                  np.asarray(blk["ln_out"]["scale"]))
    assert "conformer0.ffn1.in.weight" in sd and "attn_in.weight" in sd
    back = state_dict_to_flax(tm.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert np.array_equal(node, np.asarray(leaf)), path
    init_parameters(tm, 0)
    got = tm.state_dict()
    for key, t in got.items():
        ref = sd[key].numpy()
        if key.endswith(".bias") or np.all(ref == 1.0):
            assert np.array_equal(t.numpy(), ref), key     # zeros and ones
        else:
            fan_in = int(np.prod(t.shape[1:]))
            assert abs(float(t.std()) * np.sqrt(fan_in) - 1.0) < 0.25, key
