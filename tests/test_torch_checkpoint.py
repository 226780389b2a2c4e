"""The port's stdlib+numpy msgpack reader/writer vs flax.serialization on
real reference checkpoints."""

import os

import flax.serialization
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.models.presets import build_model
from chainer_speech_recognition_tpu.train.checkpoint import save_checkpoint
from chainer_speech_recognition_tpu.train.state import init_state
from chainer_speech_recognition_tpu_torch import checkpoint as ck


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (a.keys(), b.keys())
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, (x, y)
        assert np.array_equal(x, y)


def _reference_ckpt(tmp_path, steps=(7,)):
    cfg = preset_config("bigru").override({
        "model.conv_channels": [4, 4], "model.rnn_hidden": 32,
        "model.rnn_layers": 1, "model.vocab_size": 9})
    model = build_model(cfg.model)
    state = init_state(model, cfg.optim, jax.random.key(0),
                       jnp.zeros((1, 16, 40, 3)), jnp.asarray([16]))
    d = str(tmp_path / "ckpt")
    for i, s in enumerate(steps):
        st = state.replace(step=jnp.asarray(s, jnp.int32), params=jax.tree.map(
            lambda x: x + i, state.params))
        save_checkpoint(d, st, cfg, keep=5)
    return d, cfg


def test_reader_matches_flax_msgpack_restore(tmp_path):
    d, cfg = _reference_ckpt(tmp_path)
    path = ck.latest_checkpoint(d)
    assert os.path.basename(path) == "step_00000007.msgpack"
    raw = open(path, "rb").read()
    ref = flax.serialization.msgpack_restore(raw)
    ours = ck.msgpack_restore(raw)
    _tree_equal(ref, ours)
    assert ck.load_config(d).to_json() == cfg.to_json()   # the port's Config
    _tree_equal(ref["params"]["params"], ck.read_params(path))


def test_average_last_matches_reference_rule(tmp_path):
    d, _ = _reference_ckpt(tmp_path, steps=(1, 2, 3))
    avg, desc = ck.load_params(d, average_last=2)
    assert desc.startswith("avg[") and "step_00000003" in desc
    last = ck.read_params(ck.latest_checkpoint(d))
    prev = ck.read_params(os.path.join(d, "step_00000002.msgpack"))
    want = jax.tree.map(lambda a, b: ((a.astype(np.float32)
                                       + b.astype(np.float32)) * 0.5), prev,
                        last)
    _tree_equal(jax.tree.map(np.asarray, want), avg)
    with pytest.raises(SystemExit, match="only 3"):
        ck.load_params(d, average_last=4)


@pytest.mark.parametrize("preset", ["conformer", "conformer_stream"])
def test_conformer_checkpoint_round_trip(tmp_path, preset):
    """A reference checkpoint of a cut conformer (LayerNorm ``scale`` and
    depthwise ``[kt, 1, d]`` leaves) loads into the port's model through
    the decode CLI's loader, and the port's writer gives back a file that
    flax restores to the same tree, bitwise."""
    import torch

    from chainer_speech_recognition_tpu_torch.bridge import (
        flax_to_state_dict, state_dict_to_flax)
    from chainer_speech_recognition_tpu_torch.cli.decode import load_model

    cfg = preset_config(preset).override({
        "model.conv_channels": [4, 4], "model.attn_blocks": 2,
        "model.attn_dim": 64, "model.attn_heads": 1,
        "model.vocab_size": 9})
    state = init_state(build_model(cfg.model), cfg.optim, jax.random.key(0),
                       jnp.zeros((1, 16, 40, 3)), jnp.asarray([16]))
    d = str(tmp_path / "ref")
    save_checkpoint(d, state, cfg, keep=1)
    ref = jax.tree.map(np.asarray, state.params["params"])
    tcfg, model, _ = load_model(d, device=torch.device("cpu"))
    assert tcfg.model.attn_blocks == 2
    want = flax_to_state_dict(ref)
    assert tuple(want["conformer0.conv.dw.weight"].shape) == (64, 1, 15)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    path = ck.save_params(str(tmp_path / "port"),
                          state_dict_to_flax(model.state_dict()), tcfg)
    back = flax.serialization.msgpack_restore(open(path, "rb").read())
    _tree_equal(ref, back["params"]["params"])


def test_writer_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    tree = {
        "params": {"a": {"kernel": rng.standard_normal((3, 70)).astype(
            np.float32), "bias": np.zeros(0, np.float32)},
            "big": rng.integers(-9, 9, (300, 300)).astype(np.int8)},
        "step": np.asarray(70000, np.int32),
        "scalars": [np.float32(1.5), np.int64(-7), 3, -200, 2 ** 40, -2 ** 40,
                    0.25, True, False, None, "x" * 40, b"\x00\x01"],
        "nested": {str(i): {"v": np.arange(i, dtype=np.uint16)}
                   for i in range(20)},
    }
    data = ck.msgpack_serialize(tree)
    _tree_equal(tree, ck.msgpack_restore(data))
    _tree_equal(tree, flax.serialization.msgpack_restore(data))
    with pytest.raises(ValueError, match="cannot pack"):
        ck.msgpack_serialize({"x": object()})
    with pytest.raises(ValueError):
        ck.msgpack_restore(data[:-3])

    cfg = preset_config("bigru")
    path = ck.save_params(str(tmp_path / "c"), tree["params"], cfg, step=12)
    assert os.path.basename(path) == "step_00000012.msgpack"
    _tree_equal(tree["params"], ck.read_params(path))
    assert ck.load_config(str(tmp_path / "c")).to_json() == cfg.to_json()


def test_load_model_defaults_to_the_card(tmp_path):
    """``cli.decode.load_model`` without ``device`` runs on the card: on a
    host without one it refuses (no silent CPU fallback) before it reads
    the checkpoint."""
    import torch

    from chainer_speech_recognition_tpu_torch.cli.decode import load_model

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default loads onto it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        load_model(str(tmp_path / "absent"))
