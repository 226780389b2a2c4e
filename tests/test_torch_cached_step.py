"""The port's cached train step (``train/step.make_cached_train_step``)
against the JAX package's on a one-device CPU mesh, from the same weights
(bridged from ``init_state``) and the same cache rows: a tiny ``bigru``
(conv [4,4], H=32, 2 BiGRU layers, V=6) at fp32 compute, K = 1 and K = 3
steps a dispatch, PCM mode (the front-end in the step) and feature mode
(bf16 features; the port's cache is given the JAX cache's features, so the
step alone is compared: the features themselves are held in
test_torch_device_cache.py). Bars as in test_torch_train_step.py. Then
``train()`` in the cached modes: exact resume from a dispatch-boundary
checkpoint (bitwise) and a finished run resuming to a no-op."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.data import device_cache as jdc
from chainer_speech_recognition_tpu.data.corpus import (
    load_index as jload_index)
from chainer_speech_recognition_tpu.data.sampler import (
    BatchLoader as JLoader, BucketSampler as JSampler)
from chainer_speech_recognition_tpu.models.presets import (
    build_model as build_jax_model)
from chainer_speech_recognition_tpu.train.state import init_state
from chainer_speech_recognition_tpu.train.step import (
    make_cached_train_step as jax_cached_step)
from chainer_speech_recognition_tpu.vocab import Vocab as JVocab
from chainer_speech_recognition_tpu_torch.bridge import (
    flax_to_state_dict, load_flax_params)
from chainer_speech_recognition_tpu_torch.checkpoint import list_checkpoints
from chainer_speech_recognition_tpu_torch.config import Config
from chainer_speech_recognition_tpu_torch.data import device_cache as tdc
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.data.sampler import (
    BatchLoader, BucketSampler)
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    write_tone_corpus)
from chainer_speech_recognition_tpu_torch.models.presets import build_model
from chainer_speech_recognition_tpu_torch.train import state as tstate
from chainer_speech_recognition_tpu_torch.train.loop import train
from chainer_speech_recognition_tpu_torch.train.step import (
    make_cached_train_step)
from chainer_speech_recognition_tpu_torch.vocab import Vocab

LR, WARMUP, STEPS = 1e-3, 4, 3
OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": 32,
        "model.rnn_layers": 2, "model.vocab_size": 6,
        "model.compute_dtype": "float32", "parallel.num_devices": 1,
        "optim.learning_rate": LR, "optim.warmup_steps": WARMUP,
        "optim.decay_steps": 50, "buckets.boundaries": [160],
        "buckets.batch_sizes": [3], "buckets.max_label_len": 24}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cached_step"))
    write_tone_corpus(root, np.random.default_rng(2), {"train": 8, "dev": 2},
                      6, (0.6, 1.5))
    return root


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("features", [False, True])
def test_cached_step_matches_jax(corpus, mesh, K, features):
    """Three steps in dispatches of K from the two packages' caches:
    each dispatch's metrics (the mean over its steps), then parameters,
    Adam moments and counts."""
    cfg = preset_config("bigru").override(OVER)
    tcfg = Config.from_json(cfg.to_json())
    jutts = jload_index(f"{corpus}/train_index.jsonl")
    utts = load_index(f"{corpus}/train_index.jsonl")
    jsampler = JSampler(jutts, cfg.buckets, seed=0)
    jcache = jdc.DeviceCorpusCache(
        mesh, JLoader(jutts, JVocab.load(f"{corpus}/vocab.txt"), cfg.buckets),
        jsampler, features_cfg=cfg.features if features else None)
    tcache = tdc.DeviceCorpusCache(
        BatchLoader(utts, Vocab.load(f"{corpus}/vocab.txt"), tcfg.buckets),
        BucketSampler(utts, tcfg.buckets, seed=0), "cpu",
        features_cfg=tcfg.features if features else None)
    if features:        # the same bf16 rows on both sides
        for bid, b in tcache.buckets.items():
            b["features"].copy_(torch.from_numpy(np.asarray(
                jcache.buckets[bid]["features"], np.float32)))
    plan = [d for e in range(STEPS) for d in tcache.epoch_dispatches(e, K)]
    plan = plan[:STEPS // K]

    jm = build_jax_model(cfg.model)
    ex = jnp.zeros((1, 160, 40, 3), jnp.float32)
    js = init_state(jm, cfg.optim, jax.random.key(0), ex,
                    jnp.asarray([160]))
    tm = build_model(tcfg.model)
    load_flax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                js.params["params"]))
    ts = tstate.init_state(tm, tcfg.optim, 0)
    jstep = jax_cached_step(jm, cfg, mesh, jcache, steps_per_dispatch=K)
    tstep = make_cached_train_step(tm, tcfg, tcache, K)
    assert not tstep.graphs
    for bid, slots in plan:
        js, mj = jstep(js, bid, jnp.asarray(slots))
        mt = tstep(ts, bid, torch.from_numpy(slots))
        for k in ("loss", "grad_norm", "valid_frac"):
            np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                       rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == STEPS
    bar = 2 * LR * sum(min(i, WARMUP) / WARMUP for i in range(STEPS))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     js.params["params"]))
    diffs = []
    for name, p in tm.named_parameters():
        d = np.abs(p.detach().numpy() - want[name].numpy())
        assert d.max() <= bar, (name, d.max())
        diffs.append(d.ravel())
    assert np.median(np.concatenate(diffs)) < 1e-7
    adam_j, adam_t = js.opt_state[1][0], ts.opt_state["1"]["0"]
    assert int(adam_t["count"]) == int(adam_j.count) == STEPS
    assert int(ts.opt_state["1"]["1"]["count"]) == STEPS
    for key, tol in (("mu", 1e-5), ("nu", 1e-6)):
        wj = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, getattr(adam_j, key)["params"]))
        for name, t in adam_t[key].items():
            np.testing.assert_allclose(t.numpy(), wj[name].numpy(),
                                       atol=tol, rtol=1e-3,
                                       err_msg=f"{key}/{name}")


TRAIN_OVER = {"model.conv_channels": [4, 4], "model.rnn_hidden": 32,
              "model.rnn_layers": 1, "buckets.boundaries": [160],
              "buckets.batch_sizes": [2], "buckets.max_label_len": 24,
              "optim.warmup_steps": 2, "train.log_every": 1,
              "train.eval_every": 1000}


def _train(corpus, ckpt, steps, **over):
    cfg = Config().override({**TRAIN_OVER, **{
        f"train.{k}": v for k, v in over.items()},
        "train.total_steps": steps, "train.checkpoint_dir": ckpt})
    cfg = cfg.override({"model.vocab_size": 6})
    utts = load_index(f"{corpus}/train_index.jsonl")
    vocab = Vocab.load(f"{corpus}/vocab.txt")
    return train(cfg, utts, vocab, device="cpu",
                 metrics_path=os.path.join(ckpt, "m.jsonl"))


def _bytes(ckpt):
    name = list_checkpoints(ckpt)[-1]
    with open(os.path.join(ckpt, name), "rb") as f:
        return name, f.read()


@pytest.mark.parametrize("mode,K,over", [
    ("device_cache", 1, {}), ("device_cache", 3, {}),
    ("rotating", 2, {"device_cache_budget_gb": 4e-4})])
def test_cached_train_resumes_exactly(corpus, tmp_path, mode, K, over):
    """An unbroken run of 4 dispatches and one stopped after 2 (its
    checkpoint on the dispatch boundary) and resumed write the same final
    checkpoint, byte for byte; rerunning the finished run is a no-op."""
    kw = dict(data_mode="auto", steps_per_dispatch=K,
              checkpoint_every=2 * K, **over)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for d in (a, b):
        os.makedirs(d)
    sa = _train(corpus, a, 4 * K, **kw)
    _train(corpus, b, 2 * K, **kw)
    sb = _train(corpus, b, 4 * K, **kw)
    assert sa.step == sb.step == 4 * K
    assert _bytes(a) == _bytes(b)
    with open(os.path.join(a, "m.jsonl")) as f:
        events = [json.loads(l) for l in f]
    dm = [e for e in events if e["kind"] == "data_mode"][0]
    assert dm["mode"] == mode and dm["steps_per_dispatch"] == K
    assert not dm["graphs"]
    if mode == "rotating":
        assert dm["n_windows"] >= 3
    assert [e["step"] for e in events if e["kind"] == "train"] == [
        K, 2 * K, 3 * K, 4 * K]
    before = _bytes(a)
    n_events = len(events)
    sc = _train(corpus, a, 4 * K, **kw)
    assert sc.step == 4 * K and _bytes(a) == before
    with open(os.path.join(a, "m.jsonl")) as f:
        assert not [l for l in f.readlines()[n_events:] if '"train"' in l]


def test_capture_holds_only_launches_into_capturing_streams(monkeypatch):
    """While a CUDA graph is captured (``_kernels.capturing``), launches
    into the capturing stream (the capturing thread's, and autograd's
    thread's for the backward) leave the counts and are gathered for the
    replays to add; a launch into another stream meanwhile (a rotating
    window's fetch building features on its own stream) counts as usual.
    Captures do not nest."""
    import threading

    from chainer_speech_recognition_tpu_torch import _kernels

    class Library:
        def __getattr__(self, symbol):
            return lambda *args: 0

    on_capture_stream = threading.local()
    monkeypatch.setattr(_kernels, "library", lambda: Library())
    monkeypatch.setattr(_kernels, "_stream_capturing", lambda: getattr(
        on_capture_stream, "yes", False))

    def launch_into_capture(kernel):
        on_capture_stream.yes = True
        kernel.launch()

    _kernels.reset_launches()
    gru, fe = _kernels.KERNELS["gru_bwd"], _kernels.KERNELS["frontend_logmel"]
    try:
        with _kernels.capturing() as captured:
            launch_into_capture(gru)
            for target, args in ((launch_into_capture, (gru,)),
                                 (fe.launch, ())):
                other = threading.Thread(target=target, args=args)
                other.start()
                other.join()
            with pytest.raises(RuntimeError, match="nested"):
                with _kernels.capturing():
                    pass
            gru.launch()
        assert captured == {"gru_bwd": 3}
        counts = _kernels.launches()
        assert counts["gru_bwd"] == 0 and counts["frontend_logmel"] == 1
        _kernels.add_launches(captured)
        assert _kernels.launches()["gru_bwd"] == 3
        fe.launch()
        assert _kernels.launches()["frontend_logmel"] == 2
    finally:
        _kernels.reset_launches()
