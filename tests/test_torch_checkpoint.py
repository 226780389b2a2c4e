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
    assert ck.load_config(d) == cfg
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
    assert ck.load_config(str(tmp_path / "c")) == cfg
