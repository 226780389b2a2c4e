"""Data-parallel training (config 5) of the port on two CPU ranks in a
gloo group (spawned once for the module, ``torch_ranks.run_ranks``):

* two train steps of a cut ``bigru`` and of a cut ``conformer``
  (``attn_impl=einsum``) over 2 ranks against the JAX package's step on
  one device and on a 2-device mesh, from the same bridged weights, with
  a first batch where rank 0 holds a padded row (``sample_weight`` 0) and
  rank 1 a row with no valid alignment: loss at rtol 1e-5, gradients,
  parameters and Adam moments at atol 2e-5, rtol 1e-3 (the bars of
  test_torch_train_step.py);
* the cached step (each rank's shard of a ``DeviceCorpusCache``, K = 2)
  and the rotating one (two windows advancing in lockstep) over 2 ranks
  against one device's steps on the same global rows;
* ``cli/train.py --device cpu --set parallel.num_devices=2``: the CLI
  starts the ranks itself; one checkpoint set and one metrics stream,
  parameters equal to ``num_devices=1``, and a resume;
* ``cli/evaluate.py`` on the 2 ranks prints what one rank prints
  (greedy, ``--compare --beam``, ``--streaming``);
* the refusals: bucket batches that do not divide the ranks, in the loop
  and in the cache.

fp32, one layer of 16 (conformer: one block, d = 32, h = 2), V = 12,
SpecAugment off."""

import concurrent.futures
import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
from chainer_speech_recognition_tpu_torch.checkpoint import (
    latest_checkpoint, list_checkpoints, msgpack_restore, save_params)
from chainer_speech_recognition_tpu_torch.cli import evaluate as eval_cli
from chainer_speech_recognition_tpu_torch.cli import train as train_cli
from chainer_speech_recognition_tpu_torch.config import Config, preset_config
from chainer_speech_recognition_tpu_torch.data import device_cache as tdc
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.data.sampler import (
    BatchLoader, BucketSampler)
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    make_utterance, write_tone_corpus)
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, dispatch_rows, make_mesh, shard_batch)
from chainer_speech_recognition_tpu_torch.train import state as tstate
from chainer_speech_recognition_tpu_torch.train.loop import train
from chainer_speech_recognition_tpu_torch.train.step import (
    make_cached_train_step, make_train_step)
from chainer_speech_recognition_tpu_torch.vocab import Vocab
from torch_ranks import run_ranks

WORLD, STEPS, K = 2, 2, 2
LR, WARMUP = 2e-5, 4          # Adam moves a weight by <= lr a step: the
#                               param bar holds where gradients are ~0
CPU = torch.device("cpu")
OVER = {"model.vocab_size": 12, "model.compute_dtype": "float32",
        "model.rnn_layers": 1, "model.rnn_hidden": 16,
        "model.conv_channels": [4, 4], "specaugment.enabled": False,
        "optim.learning_rate": LR, "optim.warmup_steps": WARMUP,
        "optim.decay_steps": 50}
CONF_OVER = {**OVER, "model.attn_blocks": 1, "model.attn_dim": 32,
             "model.attn_heads": 2, "model.attn_impl": "einsum"}
PRESETS = {"bigru": OVER, "conformer": CONF_OVER}
DATA_SETS = ["buckets.boundaries=[96]", "buckets.batch_sizes=[4]",
             "buckets.max_label_len=12", "train.loader_workers=1"]


def _batch(seed, lens, label_lens, weight):
    """A padded batch of 4800 samples and 8 labels a row (one shape, so
    each JAX step compiles once); a label too long for its frames makes
    a row with no alignment, ``weight`` 0 marks a padded remainder row."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    sig = np.zeros((B, 4800), np.float32)
    labels = np.full((B, 8), -1, np.int32)
    for i, (n, nl) in enumerate(zip(lens, label_lens)):
        ids = [int(k) for k in rng.integers(1, 12, nl)]
        s, _ = make_utterance(rng, ids, tone_len=max(n // max(nl, 1), 1))
        sig[i, : min(n, len(s))] = s[:n]
        labels[i, :nl] = ids
    return {"signals": sig, "num_samples": np.asarray(lens, np.int32),
            "labels": labels,
            "label_lengths": np.asarray(label_lens, np.int32),
            "sample_weight": np.asarray(weight, np.float32)}


# rank 0: rows 0-1 (row 1 padded); rank 1: rows 2-3 (row 2: 8 labels in
# 800 samples, no alignment)
BATCHES = [
    _batch(0, [4800, 3600, 800, 4800], [4, 3, 8, 2], [1, 0, 1, 1]),
    _batch(1, [3200, 3000, 2000, 1500], [3, 2, 1, 2], [1, 1, 1, 1]),
]


def _tcfg(preset: str) -> Config:
    return preset_config(preset).override(PRESETS[preset])


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _numpy(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _moments(state) -> dict:
    adam = state.opt_state["1"]["0"]
    return {"mu": _numpy(adam["mu"]), "nu": _numpy(adam["nu"]),
            "count": int(adam["count"])}


def _recording_grads(grads: list):
    """Patch the optimizer to keep the gradients it is given (after the
    all-reduce and the mean): → the patch's undo."""
    update = tstate.Optimizer.update

    def recorded(self, g, state, params):
        grads.append(_numpy(g))
        return update(self, g, state, params)

    tstate.Optimizer.update = recorded
    return lambda: setattr(tstate.Optimizer, "update", update)


def _steps(preset: str, init: dict, mesh) -> dict:
    """STEPS train steps of ``preset`` from ``init`` on BATCHES (this
    rank's rows over ``mesh``)."""
    cfg = _tcfg(preset)
    model = build_model(cfg.model)
    model.load_state_dict(_tensors(init))
    state = tstate.init_state(model, cfg.optim, 0)
    step = make_train_step(cfg, mesh=mesh)
    grads, metrics = [], []
    undo = _recording_grads(grads)
    try:
        for b in BATCHES:
            m = step(state, _tensors(shard_batch(mesh, b)))
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        undo()
    return {"metrics": metrics, "grads": grads,
            "params": _numpy(model.state_dict()), **_moments(state)}


def _data_cfg() -> Config:
    return _tcfg("bigru").override({
        "buckets.boundaries": [96], "buckets.batch_sizes": [4],
        "buckets.max_label_len": 12})


def _cached(data: str, mesh, rotating: bool) -> dict:
    """Two dispatches of K steps on this rank's shard (PCM mode) → the
    state, the metrics and each step's global corpus rows."""
    cfg = _data_cfg()
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    loader = BatchLoader(utts, Vocab.load(os.path.join(data, "vocab.txt")),
                         cfg.buckets)
    sampler = BucketSampler(utts, cfg.buckets, seed=0)
    model = build_model(cfg.model)
    init_parameters(model, 0)
    state = tstate.init_state(model, cfg.optim, 0)
    rows, metrics = [], []
    if rotating:
        cost = sum(2 * tdc._pcm_row_bytes(s) * len(i)
                   for s, i in zip(sampler.shapes, sampler.buckets))
        cache = tdc.RotatingDeviceCache(loader, sampler, cost // 2 + 1, CPU,
                                        mesh=mesh)
        plan = cache.epoch_plan(0, K)
        windows = [w for w, _, _ in plan]
        step = make_cached_train_step(model, cfg, cache, K, mesh=mesh)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            for w, (bid, slots) in zip(windows, tdc.rotating_dispatches(
                    cache, 0, plan, pool)):
                mat = cache._window_rows(cache._epoch_perms(0), w)[bid]
                k = slots.shape[1] // cache.n
                rows += [np.concatenate([mat[d][s[d * k:(d + 1) * k]]
                                         for d in range(cache.n)])
                         for s in slots]
                m = step(state, bid, torch.from_numpy(
                    dispatch_rows(mesh, slots)).long())
                metrics.append({k_: float(v) for k_, v in m.items()})
        extra = {"n_windows": cache.n_windows, "windows": windows}
    else:
        cache = tdc.DeviceCorpusCache(loader, sampler, CPU, mesh=mesh)
        step = make_cached_train_step(model, cfg, cache, K, mesh=mesh)
        for e in (0, 1):
            bid, slots = cache.epoch_dispatches(e, K)[0]
            rows += [cache.utterance_indices(bid, s) for s in slots]
            m = step(state, bid, torch.from_numpy(
                dispatch_rows(mesh, slots)).long())
            metrics.append({k_: float(v) for k_, v in m.items()})
        extra = {"shard_rows": {b: int(v["labels"].shape[0])
                                for b, v in cache.buckets.items()}}
    return {"rows": rows, "metrics": metrics,
            "params": _numpy(model.state_dict()), **_moments(state), **extra}


EVAL_RUNS = {
    "greedy": [],
    "compare": ["--compare", "--beam", "4"],
    "streaming": ["--streaming", "--stream-batch", "2", "--stream-chunk",
                  "16", "--stream-right", "8"],
}


def _evaluate(ckpt: str, data: str, extra: list) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        eval_cli.main(["--ckpt-dir", ckpt, "--data-dir", data, "--device",
                       "cpu", "--set", "buckets.boundaries=[96]",
                       "buckets.batch_sizes=[2]", *extra])
    return out.getvalue()


def _on_ranks(rank: int, inits: dict, data: str, ckpt: str) -> dict:
    mesh = make_mesh(_tcfg("bigru").parallel, CPU)
    out = {"mesh": (mesh.rank, mesh.size)}
    out["steps"] = {p: _steps(p, inits[p], mesh) for p in PRESETS}
    out["cached"] = _cached(data, mesh, rotating=False)
    out["rotating"] = _cached(data, mesh, rotating=True)
    out["evaluate"] = {k: _evaluate(ckpt, data, v)
                       for k, v in EVAL_RUNS.items()}
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    try:                 # raised before any collective, on every rank
        train(_data_cfg().override({"buckets.batch_sizes": [3]}), utts,
              Vocab.load(os.path.join(data, "vocab.txt")), device="cpu")
        out["refusal"] = None
    except ValueError as e:
        out["refusal"] = str(e)
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_data"))
    write_tone_corpus(root, np.random.default_rng(5),
                      {"train": 8, "dev": 4}, 12, (0.4, 0.7))
    return root


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """Random weights of the cut bigru with causal CMVN (it streams)."""
    cfg = _tcfg("bigru").override({"features.cmvn_mode": "causal"})
    model = build_model(cfg.model)
    init_parameters(model, 3)
    path = str(tmp_path_factory.mktemp("dp_ckpt"))
    save_params(path, state_dict_to_flax(_numpy(model.state_dict())), cfg)
    return path


@pytest.fixture(scope="module")
def jax_pairs():
    """Per preset: the JAX package's initial state and model, and the
    bridged initial state dict."""
    import jax
    import jax.numpy as jnp

    from chainer_speech_recognition_tpu.config import (
        preset_config as jax_preset)
    from chainer_speech_recognition_tpu.frontend.jnp_frontend import (
        batch_features)
    from chainer_speech_recognition_tpu.models.presets import (
        build_model as build_jax_model)
    from chainer_speech_recognition_tpu.train.state import init_state
    from chainer_speech_recognition_tpu_torch.bridge import load_flax_params

    out = {}
    for preset, over in PRESETS.items():
        cfg = jax_preset(preset).override(over)
        jm = build_jax_model(cfg.model)
        feats, flens = batch_features(jnp.asarray(BATCHES[0]["signals"]),
                                      jnp.asarray(BATCHES[0]["num_samples"]))
        js = init_state(jm, cfg.optim, jax.random.key(0), feats, flens)
        tm = build_model(_tcfg(preset).model)
        load_flax_params(tm, jax.tree_util.tree_map(np.asarray,
                                                    js.params["params"]))
        out[preset] = (cfg, jm, js, _numpy(tm.state_dict()))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_pairs, data, ckpt):
    torch.set_num_threads(1)
    inits = {p: v[3] for p, v in jax_pairs.items()}
    return run_ranks(_on_ranks, WORLD, tmp_path_factory.mktemp("dp"),
                     inits, data, ckpt)


def _jax_runs(preset, jax_pairs):
    """The JAX package's STEPS steps on one device and on a 2-device mesh
    → per run the metrics, parameters and Adam moments, as state dicts,
    and the clipped gradients of the first (uneven) batch: the first
    moment after one step is (1 - b1) times them."""
    import jax
    import jax.numpy as jnp

    from chainer_speech_recognition_tpu.parallel.mesh import (
        make_mesh as jax_mesh, shard_batch as jax_shard)
    from chainer_speech_recognition_tpu.train.step import (
        make_train_step as jax_step)
    from chainer_speech_recognition_tpu_torch.bridge import (
        flax_to_state_dict)

    cfg, jm, js0, _ = jax_pairs[preset]
    sd = lambda tree: _numpy(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, tree["params"])))
    runs = {}
    for n in (1, 2):
        c = cfg.override({"parallel.num_devices": n})
        mesh = jax_mesh(c.parallel)
        step = jax_step(jm, c, mesh)
        js, metrics, grads = jax.tree_util.tree_map(jnp.copy, js0), [], []
        for i, b in enumerate(BATCHES):
            js, m = step(js, jax_shard(mesh, b))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads.append({k: v / (1 - c.optim.b1) for k, v in
                              sd(js.opt_state[1][0].mu).items()})
        adam = js.opt_state[1][0]
        runs[n] = {"metrics": metrics, "grads": grads,
                   "params": sd(js.params), "mu": sd(adam.mu),
                   "nu": sd(adam.nu), "count": int(adam.count)}
    return runs


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-3,
                                   err_msg=f"{what}/{k}")


@pytest.mark.parametrize("preset", list(PRESETS))
def test_two_rank_step_matches_jax_one_device_and_mesh(ranks, jax_pairs,
                                                       preset):
    """The 2-rank step (an uneven first batch: a padded row on rank 0,
    an impossible one on rank 1) against JAX on 1 device and on a
    2-device mesh; both ranks hold the same state."""
    got = ranks[0]["steps"][preset]
    for out in ranks[1:]:
        for k, v in out["steps"][preset]["params"].items():
            np.testing.assert_array_equal(v, got["params"][k])
    runs = _jax_runs(preset, jax_pairs)
    assert got["metrics"][0]["valid_frac"] == pytest.approx(2 / 3)
    for n, want in runs.items():
        for mg, mw in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(mg["loss"], mw["loss"], rtol=1e-5)
            np.testing.assert_allclose(mg["grad_norm"], mw["grad_norm"],
                                       rtol=1e-4)
            assert mg["valid_frac"] == pytest.approx(mw["valid_frac"])
        assert got["count"] == want["count"] == STEPS
        for key in ("params", "mu", "nu"):
            _close(got[key], want[key], f"{n} device(s) {key}")
    # the first step's gradients, clipped as the optimizer clips them
    clip = min(1.0, _tcfg(preset).optim.clip_norm
               / got["metrics"][0]["grad_norm"])
    for n, want in runs.items():
        _close({k: v * clip for k, v in got["grads"][0].items()},
               want["grads"][0], f"{n} device(s) first gradients")


def _one_device_steps(data: str, rows: list) -> dict:
    """The stream train step of one device on the given global rows."""
    cfg = _data_cfg()
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    loader = BatchLoader(utts, Vocab.load(os.path.join(data, "vocab.txt")),
                         cfg.buckets)
    model = build_model(cfg.model)
    init_parameters(model, 0)
    state = tstate.init_state(model, cfg.optim, 0)
    step = make_train_step(cfg)
    losses = []
    for idxs in rows:
        b = loader.load(0, np.asarray(idxs))
        b.pop("bucket_id")
        losses.append(float(step(state, _tensors(b))["loss"]))
    return {"losses": losses, "params": _numpy(model.state_dict()),
            **_moments(state)}


@pytest.mark.parametrize("mode", ["cached", "rotating"])
def test_cached_steps_two_ranks_match_one_device(ranks, data, mode):
    """Each rank keeps its shard of the corpus (rows d, d+2, ...) and
    trains on its segment of every dispatch; the two ranks together take
    the steps one device takes on the same global rows. Rotating windows
    advance in lockstep (both ranks' plans and windows are equal)."""
    got = ranks[0][mode]
    assert len(got["rows"]) == 2 * K and all(
        np.array_equal(a, b) for a, b in zip(ranks[1][mode]["rows"],
                                             got["rows"]))
    if mode == "rotating":
        assert got["n_windows"] == 2 and got["windows"] == [0, 1]
        assert ranks[1][mode]["windows"] == got["windows"]
    else:
        assert got["shard_rows"] == {0: 4}     # 8 utterances, 2 ranks
    want = _one_device_steps(data, got["rows"])
    assert got["count"] == want["count"] == 2 * K
    for i, m in enumerate(got["metrics"]):
        np.testing.assert_allclose(m["loss"], np.mean(
            want["losses"][i * K:(i + 1) * K]), rtol=1e-5)
    for key in ("params", "mu", "nu"):
        _close(got[key], want[key], key)
    for k, v in ranks[1][mode]["params"].items():
        np.testing.assert_array_equal(v, got["params"][k])


def test_evaluate_cli_two_ranks_prints_what_one_rank_prints(ranks, data,
                                                            ckpt):
    for name, extra in EVAL_RUNS.items():
        want = _evaluate(ckpt, data, extra)
        assert "CER" in want
        assert ranks[0]["evaluate"][name] == want, name
        assert ranks[1]["evaluate"][name] == "", name


def test_refusals_of_batches_that_do_not_split(ranks, data):
    for out in ranks:
        assert "not divisible by the 2-device data-parallel mesh" in \
            out["refusal"]
    cfg = _data_cfg().override({"buckets.batch_sizes": [3]})
    utts = load_index(os.path.join(data, "train_index.jsonl"))
    two = Mesh(rank=0, size=2, device=CPU, shape=(2,), axis_names=("data",))
    cache = tdc.DeviceCorpusCache(
        BatchLoader(utts, Vocab.load(os.path.join(data, "vocab.txt")),
                    cfg.buckets), BucketSampler(utts, cfg.buckets), CPU,
        mesh=two)
    with pytest.raises(ValueError, match="not divisible by 2 devices"):
        cache.epoch_batches(0)


def _params(path: str) -> dict:
    """A checkpoint's parameters, by path in the tree."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())["params"]
    out = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k, x in v.items():
                walk(f"{prefix}/{k}", x)
        else:
            out[prefix] = np.asarray(v)

    walk("", tree)
    return out


def _cli(data: str, root, name: str, n: int, steps: int,
         run: str = "") -> list:
    metrics = os.path.join(str(root), f"{name}{run}.jsonl")
    train_cli.main(["--data-dir", data, "--preset", "bigru", "--device",
                    "cpu", "--ckpt-dir", os.path.join(str(root), name),
                    "--metrics", metrics, "--set", *DATA_SETS,
                    *(f"{k}={json.dumps(v)}" for k, v in OVER.items()),
                    "train.data_mode=stream", f"train.total_steps={steps}",
                    "train.log_every=1", "train.eval_every=2",
                    "train.eval_beam=2", "train.checkpoint_every=2",
                    f"parallel.num_devices={n}"])
    with open(metrics) as f:
        return [json.loads(l) for l in f]


def test_train_cli_on_two_cpu_ranks_writes_once_and_resumes(data, tmp_path):
    """``parallel.num_devices=2``: the CLI spawns the ranks; rank 0 alone
    writes the one metrics stream and checkpoint set; the parameters and
    the dev eval (greedy and a beam column, split over the ranks) equal
    one device's on the same global batches; the run resumes."""
    ev2 = _cli(data, tmp_path, "two", 2, 4)
    ev1 = _cli(data, tmp_path, "one", 1, 4)
    for ev in (ev2, ev1):
        assert [e["step"] for e in ev if e["kind"] == "train"] == [1, 2, 3, 4]
        evals = [e for e in ev if e["kind"] == "eval"]
        assert [e["step"] for e in evals] == [2, 4]
        assert all("cer_beam" in e for e in evals)
        assert [e["devices"] for e in ev if e["kind"] == "data_mode"] == [
            2 if ev is ev2 else 1]
    for a, b in zip([e for e in ev2 if e["kind"] in ("train", "eval")],
                    [e for e in ev1 if e["kind"] in ("train", "eval")]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert a.get("cer") == b.get("cer")
        assert a.get("cer_beam") == b.get("cer_beam")
    two, one = (os.path.join(str(tmp_path), n) for n in ("two", "one"))
    assert list_checkpoints(two) == list_checkpoints(one) == [
        "step_00000002.msgpack", "step_00000004.msgpack"]
    p2, p1 = (_params(latest_checkpoint(d)) for d in (two, one))
    _close(p2, p1, "params")
    ev = _cli(data, tmp_path, "two", 2, 6, run="_resumed")
    assert [e["step"] for e in ev if e["kind"] == "resume"] == [4]
    assert [e["step"] for e in ev if e["kind"] == "train"] == [5, 6]
    assert list_checkpoints(two)[-1] == "step_00000006.msgpack"
