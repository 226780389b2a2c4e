"""Training checkpoints of the port: exact resume through the train loop,
keep-N and atomic writes, and both directions with the JAX package (its
``restore_checkpoint`` loads a port checkpoint, the port resumes from a
JAX checkpoint, and both decode CLIs read a port-trained checkpoint)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.cli import decode as jax_decode
from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu.train import checkpoint as jck
from chainer_speech_recognition_tpu.train.state import init_state as jinit
from chainer_speech_recognition_tpu_torch import checkpoint as ck
from chainer_speech_recognition_tpu_torch.bridge import flax_to_state_dict
from chainer_speech_recognition_tpu_torch.cli import decode as torch_decode
from chainer_speech_recognition_tpu_torch.config import Config
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    write_tone_corpus)
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.train.loop import train
from chainer_speech_recognition_tpu_torch.train.state import init_state

OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": 32,
        "model.rnn_layers": 1, "model.vocab_size": 6,
        "model.compute_dtype": "float32", "buckets.boundaries": [64],
        "buckets.batch_sizes": [2], "buckets.max_label_len": 8,
        "train.data_mode": "stream", "train.loader_workers": 1,
        "optim.warmup_steps": 1, "optim.learning_rate": 0.01}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    vocab = write_tone_corpus(root, np.random.default_rng(0),
                              {"train": 5, "dev": 2}, 6, (0.3, 0.5))
    return root, vocab, load_index(os.path.join(root, "train_index.jsonl"))


def _cfg(ckpt_dir, **extra):
    return Config().override({**OVER, "train.checkpoint_dir": ckpt_dir,
                              **extra})


def _flat(state):
    out = {f"p/{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = v.clone()
    walk("opt", state.opt_state)
    return out


def test_resume_is_bitwise_exact(corpus, tmp_path):
    """4 straight steps == 2 steps, a restart from their checkpoint, and 2
    more (3 batches an epoch, so the resume crosses an epoch boundary)."""
    root, vocab, utts = corpus
    a = train(_cfg(str(tmp_path / "a"), **{"train.total_steps": 4}), utts,
              vocab, device="cpu")
    train(_cfg(str(tmp_path / "b"), **{"train.total_steps": 2}), utts, vocab,
          device="cpu")
    b = train(_cfg(str(tmp_path / "b"), **{"train.total_steps": 4}), utts,
              vocab, device="cpu")
    assert a.step == b.step == 4
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb) and len(fa) > 10
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    # the finished run resumes to a no-op
    c = train(_cfg(str(tmp_path / "b"), **{"train.total_steps": 4}), utts,
              vocab, device="cpu")
    assert c.step == 4 and torch.equal(
        _flat(c)["p/output.weight"], fa["p/output.weight"])


def test_keep_n_and_atomic_write(tmp_path):
    cfg = _cfg(str(tmp_path))
    model = build_model(cfg.model)
    init_parameters(model, 0)
    state = init_state(model, cfg.optim, 0)
    d = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="keep=0"):
        ck.save_checkpoint(d, state, cfg, keep=0)
    assert not os.path.exists(d)
    for s in (1, 2, 3, 10, 100_000_000):
        state.step = s
        ck.save_checkpoint(d, state, cfg, keep=2)
    assert sorted(os.listdir(d)) == ["config.json", "step_00000010.msgpack",
                                     "step_100000000.msgpack"]
    assert ck.load_config(d).to_json() == cfg.to_json()


def _trained_state(tmp_path, corpus, steps=2, **extra):
    root, vocab, utts = corpus
    cfg = _cfg(str(tmp_path / "ck"), **{"train.total_steps": steps, **extra})
    state = train(cfg, utts, vocab, device="cpu")
    return cfg, state, ck.latest_checkpoint(cfg.train.checkpoint_dir)


def test_jax_restores_a_port_checkpoint(corpus, tmp_path):
    cfg, state, path = _trained_state(tmp_path, corpus)
    jcfg = preset_config("bigru").override(OVER)
    jm = build_jax_model(jcfg.model)
    template = jinit(jm, jcfg.optim, jax.random.key(5),
                     jnp.zeros((1, 64, 40, 3)), jnp.asarray([64]))
    js = jck.restore_checkpoint(path, template)
    assert int(js.step) == state.step == 2
    np.testing.assert_array_equal(np.asarray(js.rng), state.rng)
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   js.params["params"]))
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    adam = js.opt_state[1][0]
    assert int(adam.count) == 2 and int(js.opt_state[1][1].count) == 2
    for key in ("mu", "nu"):
        got = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(adam, key)["params"]))
        want = state.opt_state["1"]["0"][key]
        assert float(want["output.weight"].abs().max()) > 0
        for k, v in want.items():
            assert torch.equal(got[k], v), (key, k)


def test_port_resumes_from_a_jax_checkpoint(tmp_path):
    jcfg = preset_config("bigru").override(OVER)
    jm = build_jax_model(jcfg.model)
    js = jinit(jm, jcfg.optim, jax.random.key(1), jnp.zeros((1, 64, 40, 3)),
               jnp.asarray([64]))
    leaves, treedef = jax.tree.flatten(js)
    rng = np.random.default_rng(0)
    leaves = [jnp.asarray(rng.integers(1, 9, np.shape(l)).astype(
        np.asarray(l).dtype)) for l in leaves]
    js = jax.tree.unflatten(treedef, leaves)
    d = str(tmp_path / "jck")
    jck.save_checkpoint(d, js, jcfg)
    cfg = ck.load_config(d)
    model = build_model(cfg.model)
    state = init_state(model, cfg.optim, 0)
    ck.restore_checkpoint(ck.latest_checkpoint(d), state)
    assert state.step == int(js.step)
    np.testing.assert_array_equal(state.rng, np.asarray(js.rng))
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   js.params["params"]))
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k
    mu = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, js.opt_state[1][0].mu["params"]))
    for k, v in state.opt_state["1"]["0"]["mu"].items():
        assert torch.equal(mu[k], v), k
    assert int(state.opt_state["1"]["1"]["count"]) == int(
        js.opt_state[1][1].count)
    # a params-only serving checkpoint cannot resume training
    sd_tree = ck.read_params(ck.latest_checkpoint(d))
    ck.save_params(str(tmp_path / "serve"), sd_tree, cfg, step=3)
    with pytest.raises(ValueError, match="no optimizer state"):
        ck.restore_checkpoint(ck.latest_checkpoint(str(tmp_path / "serve")),
                              state)


def test_both_decode_clis_read_a_port_trained_checkpoint(corpus, tmp_path,
                                                         capsys):
    root, vocab, utts = corpus
    cfg, _, _ = _trained_state(tmp_path, corpus, steps=12,
                               **{"optim.learning_rate": 0.05})
    capsys.readouterr()
    wavs = [u.wav for u in utts[:3]]
    args = ["--ckpt-dir", cfg.train.checkpoint_dir, "--vocab",
            os.path.join(root, "vocab.txt")]
    jax_decode.main(args + wavs)
    ref = capsys.readouterr().out.splitlines()
    torch_decode.main(args + ["--device", "cpu"] + wavs)
    got = capsys.readouterr().out.splitlines()
    assert got == ref and [l.split("\t")[0] for l in got] == wavs
    assert any(l.split("\t")[1] for l in got)              # not all blank


def test_bilstm_deep_train_state_both_ways(corpus, tmp_path):
    """A cut bilstm_deep (1 BiLSTM layer, H=32) trained by the port with
    SpecAugment on: the JAX package restores its whole TrainState, writes
    it back with its own writer, and the port resumes from that file to
    the same state, bitwise."""
    root, vocab, utts = corpus
    cfg = _cfg(str(tmp_path / "ck"), **{
        "model.preset": "bilstm_deep", "model.rnn_type": "lstm",
        "specaugment.enabled": True, "train.total_steps": 2})
    state = train(cfg, utts, vocab, device="cpu")
    jcfg = preset_config("bilstm_deep").override(OVER)
    for part in ("model", "specaugment", "optim"):
        assert json.loads(jcfg.to_json())[part] == \
            json.loads(cfg.to_json())[part], part
    jm = build_jax_model(jcfg.model)
    template = jinit(jm, jcfg.optim, jax.random.key(5),
                     jnp.zeros((1, 64, 40, 3)), jnp.asarray([64]))
    js = jck.restore_checkpoint(ck.latest_checkpoint(str(tmp_path / "ck")),
                                template)
    assert int(js.step) == state.step == 2
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   js.params["params"]))
    assert tuple(sd["birnn0.rec"].shape) == (2, 32, 128)
    for k, v in state.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    d = str(tmp_path / "jck")
    jck.save_checkpoint(d, js, jcfg)
    model = build_model(ck.load_config(d).model)
    back = init_state(model, cfg.optim, 0)
    ck.restore_checkpoint(ck.latest_checkpoint(d), back)
    fa, fb = _flat(state), _flat(back)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    np.testing.assert_array_equal(back.rng, state.rng)
    assert back.step == 2
