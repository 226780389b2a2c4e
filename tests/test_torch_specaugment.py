"""The port's SpecAugment (ops/specaugment.py) against the JAX package's:
the masking exactly, on JAX's own draws; the reference suite's invariants
for the port's sampler; and the port's sampling rule, deterministic in the
train state's (rng, step), so a resumed run masks what an unbroken one
does."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import (
    SpecAugmentConfig as JaxSpecAugmentConfig, preset_config as jax_preset)
from chainer_speech_recognition_tpu.ops.specaugment import (
    apply_specaugment as jax_apply)
from chainer_speech_recognition_tpu_torch.config import (
    Config, SpecAugmentConfig, preset_config)
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    write_tone_corpus)
from chainer_speech_recognition_tpu_torch.ops.specaugment import (
    apply_specaugment, specaugment_draws, step_generator)
from chainer_speech_recognition_tpu_torch.train.loop import train
from chainer_speech_recognition_tpu_torch.train.step import step_draws

CFGS = [
    {},                                                   # bilstm_deep's
    {"time_mask_max": 80, "freq_mask_max": 39},           # wider than lens
    {"num_time_masks": 3, "num_freq_masks": 0},
]


def _jax_draws(key, B, cfg):
    """The reference's random numbers for ``key``, drawn as
    ``ops/specaugment.py`` draws them, in the port's draws layout."""
    n = cfg.num_time_masks + cfg.num_freq_masks
    keys = jax.random.split(key, 2 * n)
    rows, k = [], 0
    for count, max_width in ((cfg.num_time_masks, cfg.time_mask_max),
                             (cfg.num_freq_masks, cfg.freq_mask_max)):
        for _ in range(count):
            width = jax.random.randint(keys[k], (B, 1), 0, max_width + 1)
            u = jax.random.uniform(keys[k + 1], (B, 1))
            rows.append(np.stack([np.asarray(width[:, 0], np.float32),
                                  np.asarray(u[:, 0], np.float32)]))
            k += 2
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("over", CFGS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masking_matches_jax_exactly_on_its_draws(over, seed):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((4, 100, 40, 3)).astype(np.float32)
    lens = np.asarray([100, 60, 30, 10], np.int32)
    jcfg = JaxSpecAugmentConfig(enabled=True, **over)
    tcfg = SpecAugmentConfig(enabled=True, **over)
    key = jax.random.key(seed)
    want = np.asarray(jax_apply(key, jnp.asarray(feats), jnp.asarray(lens),
                                jcfg))
    got = apply_specaugment(torch.from_numpy(feats), torch.from_numpy(lens),
                            _jax_draws(key, 4, jcfg), tcfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() > 0.01


def test_port_sampler_keeps_the_reference_invariants():
    """tests/test_train.py::test_specaugment_invariants with the port's
    draws: pure masking, per-utterance masks, time masks inside each
    utterance's valid length, identity when disabled."""
    cfg = preset_config("bilstm_deep").specaugment
    feats = torch.ones((4, 100, 40, 3))
    lens = torch.tensor([100, 60, 30, 10])
    out = apply_specaugment(feats, lens, specaugment_draws(
        step_generator(np.asarray([0, 0], np.uint32), 0), 4, cfg), cfg)
    assert out.shape == feats.shape
    assert torch.all((out == 0) | (out == 1))
    assert float((out == 0).float().mean()) > 0.01
    assert not torch.equal(out[0], out[1])
    for step in range(8):
        draws = specaugment_draws(step_generator(
            np.asarray([0, 0], np.uint32), step), 4, cfg)
        assert draws.shape == (4, 2, 4) and draws.dtype == torch.float32
        widths = draws[:, 0]
        assert torch.all(widths == widths.round()) and torch.all(widths >= 0)
        assert torch.all(widths[:2] <= cfg.time_mask_max)
        assert torch.all(widths[2:] <= cfg.freq_mask_max)
        assert torch.all((draws[:, 1] >= 0) & (draws[:, 1] < 1))
        zero_rows = (apply_specaugment(feats, lens, draws, cfg) == 0).all(
            dim=3).all(dim=2)                               # [B, T]
        for b, L in enumerate(lens.tolist()):
            hit = torch.nonzero(zero_rows[b]).flatten()
            assert hit.numel() == 0 or int(hit.max()) < L + cfg.time_mask_max
    off = preset_config("tiny_conv").specaugment
    assert torch.equal(apply_specaugment(feats, lens, draws, off), feats)


def test_draws_are_deterministic_in_rng_and_step():
    cfg = preset_config("bilstm_deep").specaugment
    rng = np.asarray([0, 7], np.uint32)
    a = specaugment_draws(step_generator(rng, 3), 5, cfg)
    assert torch.equal(a, specaugment_draws(step_generator(rng, 3), 5, cfg))
    assert not torch.equal(a, specaugment_draws(step_generator(rng, 4), 5,
                                                cfg))
    assert not torch.equal(a, specaugment_draws(step_generator(
        np.asarray([0, 8], np.uint32), 3), 5, cfg))
    # the train step draws from its state's (rng, step), for a batch of 5
    state = SimpleNamespace(rng=rng, step=3)
    batch = {"labels": torch.zeros((5, 4), dtype=torch.int32)}
    assert torch.equal(step_draws(preset_config("bilstm_deep"), state, batch),
                       a)
    assert step_draws(preset_config("bigru"), state, batch) is None


OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": 32,
        "model.rnn_type": "lstm", "model.rnn_layers": 1,
        "model.vocab_size": 6, "model.compute_dtype": "float32",
        "specaugment.enabled": True, "specaugment.time_mask_max": 8,
        "buckets.boundaries": [64], "buckets.batch_sizes": [2],
        "buckets.max_label_len": 8, "train.data_mode": "stream",
        "train.loader_workers": 1, "optim.warmup_steps": 1,
        "optim.learning_rate": 0.01}


def test_resumed_run_masks_what_an_unbroken_one_does(tmp_path):
    """4 straight steps with SpecAugment == 2 steps, a restart from their
    checkpoint and 2 more, bitwise; and SpecAugment changes the result."""
    root = str(tmp_path / "corpus")
    vocab = write_tone_corpus(root, np.random.default_rng(0),
                              {"train": 5}, 6, (0.3, 0.5))
    utts = load_index(os.path.join(root, "train_index.jsonl"))

    def run(ckpt, steps, **extra):
        cfg = Config().override({**OVER, "train.checkpoint_dir": ckpt,
                                 "train.total_steps": steps, **extra})
        return train(cfg, utts, vocab, device="cpu")

    a = run(str(tmp_path / "a"), 4)
    run(str(tmp_path / "b"), 2)
    b = run(str(tmp_path / "b"), 4)
    assert a.step == b.step == 4
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    c = run(str(tmp_path / "c"), 4, **{"specaugment.enabled": False})
    assert not torch.equal(a.model.state_dict()["output.weight"],
                           c.model.state_dict()["output.weight"])


def test_jax_and_port_presets_agree_on_specaugment():
    assert preset_config("bilstm_deep").specaugment == SpecAugmentConfig(
        **vars(jax_preset("bilstm_deep").specaugment))
