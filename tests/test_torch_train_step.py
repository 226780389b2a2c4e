"""The port's train step against the JAX package's, from the same weights
(bridged from ``init_state``) and batches: a tiny ``bigru`` (conv [4,4],
H=32, 2 BiGRU layers, V=6) at fp32 compute with ``model.rnn_impl=pallas``
and ``train.ctc_impl=pallas`` (the Pallas kernels in interpret mode on the
JAX side, the kernels' plain versions on the port's), and the same cut of
``bilstm_deep`` with SpecAugment off (the two packages draw different
random numbers; the masking itself is held in test_torch_specaugment.py).
A SpecAugment step of the port equals a step on features masked
beforehand with the same draws. Then the optimizer chain alone against
optax.

The schedule starts at learning rate 0 (``warmup_cosine_decay_schedule``
with ``init_value=0``), so the first update is zero whatever the
optimizer does; the step test therefore runs three steps and also holds
the gradients and the Adam moments."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import OptimConfig, preset_config
from chainer_speech_recognition_tpu.data.synthetic import make_utterance
from chainer_speech_recognition_tpu.frontend.jnp_frontend import batch_features
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu.parallel.mesh import make_mesh, shard_batch
from chainer_speech_recognition_tpu.train.state import (
    init_state, make_optimizer as jax_optimizer)
from chainer_speech_recognition_tpu.train.step import (
    _forward_loss, make_train_step as jax_train_step)
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params)
from chainer_speech_recognition_tpu_torch.config import Config
from chainer_speech_recognition_tpu_torch.frontend import select_frontend
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.ops.specaugment import (
    apply_specaugment, specaugment_draws, step_generator)
from chainer_speech_recognition_tpu_torch.train import state as tstate
from chainer_speech_recognition_tpu_torch.train.step import (
    forward_loss, make_train_step)

LR, WARMUP = 1e-3, 4
OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": 32,
        "model.rnn_layers": 2, "model.vocab_size": 6,
        "model.compute_dtype": "float32", "model.rnn_impl": "pallas",
        "train.ctc_impl": "pallas", "parallel.num_devices": 1,
        "optim.learning_rate": LR, "optim.warmup_steps": WARMUP,
        "optim.decay_steps": 50}


def _batch(seed, n_max, lens, label_lens, weight=None):
    """Padded batch; a label too long for its frames makes a sample with no
    alignment, ``weight`` 0 marks a padded remainder row."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    sig = np.zeros((B, n_max), np.float32)
    labels = np.full((B, max(label_lens)), -1, np.int32)
    for i, (n, nl) in enumerate(zip(lens, label_lens)):
        ids = [int(k) for k in rng.integers(1, 6, nl)]
        s, _ = make_utterance(rng, ids, tone_len=max(n // max(nl, 1), 1))
        sig[i, : min(n, len(s))] = s[:n]
        labels[i, :nl] = ids
    b = {"signals": sig, "num_samples": np.asarray(lens, np.int32),
         "labels": labels, "label_lengths": np.asarray(label_lens, np.int32)}
    if weight is not None:
        b["sample_weight"] = np.asarray(weight, np.float32)
    return b


BATCHES = [
    _batch(0, 4800, [4800, 3600, 800, 4800], [4, 3, 8, 2], [1, 1, 1, 0]),
    _batch(1, 3200, [3200, 3000, 2000, 1500], [3, 2, 1, 0]),
    _batch(2, 4800, [4000, 4800, 2500, 3000], [2, 4, 3, 3], [1, 1, 0, 0]),
]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pair(preset, over):
    cfg = preset_config(preset).override(over)
    jm = build_jax_model(cfg.model)
    feats, flens = batch_features(jnp.asarray(BATCHES[0]["signals"]),
                                  jnp.asarray(BATCHES[0]["num_samples"]))
    jstate = init_state(jm, cfg.optim, jax.random.key(0), feats, flens)
    tcfg = Config.from_json(cfg.to_json())
    tm = build_model(tcfg.model)
    load_flax_params(tm, jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]))
    return cfg, jm, jstate, tcfg, tm


@pytest.fixture(scope="module")
def pair():
    return _pair("bigru", OVER)


LSTM_OVER = {**OVER, "specaugment.enabled": False}


@pytest.fixture(scope="module")
def lstm_pair():
    return _pair("bilstm_deep", LSTM_OVER)


def _gradients_loss_and_counts(pair):
    cfg, jm, jstate, tcfg, tm = pair
    b = BATCHES[0]
    (lj, ((nvj, nrj), _, _)), gj = jax.value_and_grad(
        lambda p: _forward_loss(jm, cfg, p, {k: jnp.asarray(v)
                                             for k, v in b.items()},
                                jax.random.key(0), train=True),
        has_aux=True)(jstate.params)
    tm.zero_grad()
    lt, (nvt, nrt), _, _ = forward_loss(tm, tcfg, _torch_batch(b))
    lt.backward()
    assert float(nvt) == float(nvj) == 2.0 and float(nrt) == float(nrj) == 3.0
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gj["params"]))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-3, err_msg=name)


def test_gradients_loss_and_counts_match(pair):
    """fp32 gradients of the weighted-mean loss (remainder row weighted 0,
    impossible sample masked) agree to summation order."""
    _gradients_loss_and_counts(pair)


def test_three_steps_match(pair):
    """Metrics every step; parameters and Adam moments after three.

    Moments: tight (they are sums of the matching gradients). Parameters:
    Adam divides by sqrt(ν̂) + 1e-8, so where a gradient is ~0 two
    gradients that agree to 1e-9 can still move a weight by up to the
    step's learning rate in opposite directions; the bar is therefore
    2 · Σ lr over the steps taken (0 + lr/4 + lr/2 with a 4-step warmup),
    and most weights agree far better (checked via the median)."""
    _three_steps(pair)


def _three_steps(pair):
    cfg, jm, jstate, tcfg, tm = pair
    mesh = make_mesh(cfg.parallel)
    jstep = jax_train_step(jm, cfg, mesh)
    tm = build_model(tcfg.model)
    load_flax_params(tm, jax.tree_util.tree_map(
        np.asarray, jstate.params["params"]))
    ts = tstate.init_state(tm, tcfg.optim, 0)
    step = make_train_step(tcfg)
    js = jstate
    for b in BATCHES:
        js, mj = jstep(js, shard_batch(mesh, b))
        mt = step(ts, _torch_batch(b))
        for k in ("loss", "grad_norm", "valid_frac"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == 3
    bar = 2 * LR * (0 + 1 / 4 + 2 / 4)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     js.params["params"]))
    diffs = []
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= bar, (name, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7
    adam_j = js.opt_state[1][0]
    adam_t = ts.opt_state["1"]["0"]
    assert int(adam_t["count"]) == int(adam_j.count) == 3
    assert int(ts.opt_state["1"]["1"]["count"]) == 3
    for key, tol in (("mu", 1e-5), ("nu", 1e-6)):
        wj = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(adam_j, key)["params"]))
        for name, t in adam_t[key].items():
            np.testing.assert_allclose(t.numpy(), wj[name].numpy(),
                                       atol=tol, rtol=1e-3,
                                       err_msg=f"{key}/{name}")


@pytest.fixture(scope="module")
def uni_pair():
    return _pair("uni_gru", OVER)


def test_uni_gru_gradients_match(uni_pair):
    """The forward-only preset (2 GRU layers, rec [1, H, 3H]): the port's
    one-direction training forward, backward and dW (plain versions on the
    CPU) give JAX's gradients, whose Pallas path duplicates W and sums the
    two halves' dW."""
    assert tuple(uni_pair[-1].birnn0.rec.shape) == (1, 32, 96)
    _gradients_loss_and_counts(uni_pair)


def test_uni_gru_three_steps_match(uni_pair):
    """Three uni_gru steps: metrics every step, parameters and Adam
    moments after three, at test_three_steps_match's bars."""
    _three_steps(uni_pair)


def test_bilstm_deep_step_matches_jax(lstm_pair):
    """The cut bilstm_deep (2 BiLSTM layers, H=32): fp32 gradients of the
    weighted-mean loss, then two optimizer steps' metrics and parameters
    (bars as for bigru above)."""
    cfg, jm, jstate, tcfg, tm = lstm_pair
    assert tcfg.model.rnn_type == "lstm" and not tcfg.specaugment.enabled
    b = BATCHES[0]
    (lj, ((nvj, nrj), _, _)), gj = jax.value_and_grad(
        lambda p: _forward_loss(jm, cfg, p, {k: jnp.asarray(v)
                                             for k, v in b.items()},
                                jax.random.key(0), train=True),
        has_aux=True)(jstate.params)
    tm.zero_grad()
    lt, (nvt, nrt), _, _ = forward_loss(tm, tcfg, _torch_batch(b))
    lt.backward()
    assert float(nvt) == float(nvj) and float(nrt) == float(nrj)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gj["params"]))
    assert tuple(want["birnn0.rec"].shape) == (2, 32, 128)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-3, err_msg=name)
    mesh = make_mesh(cfg.parallel)
    jstep = jax_train_step(jm, cfg, mesh)
    ts = tstate.init_state(tm, tcfg.optim, 0)
    step = make_train_step(tcfg)
    js = jstate
    for b in BATCHES[:2]:
        js, mj = jstep(js, shard_batch(mesh, b))
        mt = step(ts, _torch_batch(b))
        for k in ("loss", "grad_norm", "valid_frac"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-4, err_msg=k)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     js.params["params"]))
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * LR * (0 + 1 / 4), (name, d.max())


CONF_OVER = {**OVER, "model.attn_blocks": 2, "model.attn_dim": 128,
             "model.attn_heads": 2, "model.attn_impl": "flash",
             "specaugment.enabled": False}


@pytest.mark.parametrize("preset", ["conformer", "conformer_stream"])
def test_conformer_step_matches_jax(preset):
    """A cut conformer (2 blocks, d = 128, h = 2) with ``attn_impl=flash``
    (the Pallas kernels in interpret mode on the JAX side, the kernels'
    plain versions through ``FlashAttention`` on the port's): fp32
    gradients of the weighted-mean loss, then two optimizer steps'
    metrics, parameters and Adam moments (bars as for bigru above). The
    port's train step and state need nothing of their own for it."""
    cfg, jm, jstate, tcfg, tm = _pair(preset, CONF_OVER)
    assert tcfg.model.rnn_type == "none" and tcfg.model.attn_impl == "flash"
    b = BATCHES[0]
    (lj, ((nvj, nrj), _, _)), gj = jax.value_and_grad(
        lambda p: _forward_loss(jm, cfg, p, {k: jnp.asarray(v)
                                             for k, v in b.items()},
                                jax.random.key(0), train=True),
        has_aux=True)(jstate.params)
    tm.zero_grad()
    lt, (nvt, nrt), _, _ = forward_loss(tm, tcfg, _torch_batch(b))
    lt.backward()
    assert float(nvt) == float(nvj) and float(nrt) == float(nrj)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     gj["params"]))
    assert tuple(want["conformer1.conv.dw.weight"].shape) == (128, 1, 15)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=1e-3, err_msg=name)
    mesh = make_mesh(cfg.parallel)
    jstep = jax_train_step(jm, cfg, mesh)
    ts = tstate.init_state(tm, tcfg.optim, 0)
    step = make_train_step(tcfg)
    js = jstate
    for b in BATCHES[:2]:
        js, mj = jstep(js, shard_batch(mesh, b))
        mt = step(ts, _torch_batch(b))
        for k in ("loss", "grad_norm", "valid_frac"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-4, err_msg=k)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     js.params["params"]))
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= 2 * LR * (0 + 1 / 4), (name, d.max())
    adam_j = js.opt_state[1][0]
    adam_t = ts.opt_state["1"]["0"]
    assert int(adam_t["count"]) == int(adam_j.count) == 2
    for key, tol in (("mu", 1e-5), ("nu", 1e-6)):
        wj = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(adam_j, key)["params"]))
        for name, t in adam_t[key].items():
            np.testing.assert_allclose(t.numpy(), wj[name].numpy(),
                                       atol=tol, rtol=1e-3,
                                       err_msg=f"{key}/{name}")


def test_specaugment_step_equals_step_on_premasked_features():
    """Two train steps with SpecAugment on from signals == two steps with
    it off on features masked beforehand with the step's own draws
    (``step_generator(rng, step)``): bitwise, loss, gradient norm and
    parameters."""
    cfg = Config.from_json(preset_config("bilstm_deep").override(
        {**OVER, "optim.warmup_steps": 1}).to_json())
    assert cfg.specaugment.enabled
    off = cfg.override({"specaugment.enabled": False})
    states = []
    for _ in range(2):
        m = build_model(cfg.model)
        init_parameters(m, 3)
        states.append(tstate.init_state(m, cfg.optim, 3))
    sa, pre = states
    step_sa, step_off = make_train_step(cfg), make_train_step(off)
    for b in BATCHES[1:]:
        tb = _torch_batch(b)
        feats, flens = select_frontend(cfg.features)(
            tb["signals"], tb["num_samples"],
            apply_cmvn=cfg.features.cmvn_arg)
        draws = specaugment_draws(step_generator(pre.rng, pre.step),
                                  feats.shape[0], cfg.specaugment)
        masked = apply_specaugment(feats, flens, draws, cfg.specaugment)
        assert not torch.equal(masked, feats)
        fb = {"features": masked, "frame_lengths": flens,
              **{k: tb[k] for k in ("labels", "label_lengths")}}
        if "sample_weight" in tb:
            fb["sample_weight"] = tb["sample_weight"]
        ma, mb = step_sa(sa, tb), step_off(pre, fb)
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    for (k, va), vb in zip(sa.model.state_dict().items(),
                           pre.model.state_dict().values()):
        assert torch.equal(va, vb), k


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_chain_matches_optax(kind):
    """Five updates with clipping active (clip_norm below the gradient
    norm) through the warmup into the cosine decay."""
    ocfg = OptimConfig(optimizer="sgd" if kind == "sgd" else "adam",
                       learning_rate=0.1, warmup_steps=2, decay_steps=6,
                       clip_norm=0.5,
                       weight_decay=0.01 if kind == "adamw" else 0.0)
    rng = np.random.default_rng(3)
    params = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)},
              "b": {"bias": rng.standard_normal(5).astype(np.float32)}}
    names = {"a.weight": ("a", "kernel"), "b.bias": ("b", "bias")}
    tx = jax_optimizer(ocfg)
    js = tx.init(params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    topt = tstate.Optimizer(ocfg)
    tp = {n: torch.from_numpy(params[m][l].copy())
          for n, (m, l) in names.items()}
    ts = topt.init(tp)
    for i in range(5):
        g = {"a": {"kernel": rng.standard_normal((3, 4)).astype(np.float32)},
             "b": {"bias": rng.standard_normal(5).astype(np.float32)}}
        assert float(optax.global_norm(g)) > ocfg.clip_norm
        uj, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, uj)
        ut, ts = topt.update({n: torch.from_numpy(g[m][l])
                              for n, (m, l) in names.items()}, ts, tp)
        tp = {n: tp[n] + ut[n] for n in tp}
        for n, (m, l) in names.items():
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[m][l]),
                                       atol=1e-6, rtol=1e-5,
                                       err_msg=f"step {i} {n}")
    last = max(ts["1"], key=int)            # the schedule's state
    assert int(ts["1"][last]["count"]) == int(js[1][-1].count) == 5


def test_schedule_matches_optax():
    for ocfg in (OptimConfig(), OptimConfig(warmup_steps=3, decay_steps=10,
                                            learning_rate=0.2),
                 OptimConfig(warmup_steps=0, decay_steps=4)):
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=ocfg.learning_rate,
            warmup_steps=ocfg.warmup_steps,
            decay_steps=max(ocfg.decay_steps, ocfg.warmup_steps + 1),
            end_value=ocfg.learning_rate * ocfg.end_lr_scale)
        ours = tstate.warmup_cosine(ocfg)
        for c in (0, 1, 2, 3, 4, 9, 10, 11, 500, 100_001):
            np.testing.assert_allclose(
                float(ours(torch.tensor(c, dtype=torch.int32))),
                float(sched(jnp.asarray(c, jnp.int32))), rtol=1e-6,
                atol=1e-12, err_msg=f"count {c}")
