"""The port's device-resident corpus (``data/device_cache.py``) against the
JAX package's on a one-device CPU mesh, from the same tone corpus: the data
order (``epoch_batches``, ``epoch_dispatches``, ``utterance_indices``, the
rotating cache's window sizing and ``epoch_plan``) exactly, the cached bf16
features at the reference's bf16 bar (``tests/test_packed.py``: atol 0.04,
rtol 0.02) with exact frame lengths and labels, rotating windows bitwise
the full cache's rows, and the data-mode rule with its per-device
budget."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from chainer_speech_recognition_tpu.config import Config as JConfig
from chainer_speech_recognition_tpu.data import device_cache as jdc
from chainer_speech_recognition_tpu.data.corpus import (
    load_index as jload_index)
from chainer_speech_recognition_tpu.data.sampler import (
    BatchLoader as JLoader, BucketSampler as JSampler)
from chainer_speech_recognition_tpu.train.loop import (
    _resolve_data_mode as j_resolve)
from chainer_speech_recognition_tpu.vocab import Vocab as JVocab
from chainer_speech_recognition_tpu_torch.config import Config
from chainer_speech_recognition_tpu_torch.data import device_cache as tdc
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.data.sampler import (
    BatchLoader, BucketSampler)
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    write_tone_corpus)
from chainer_speech_recognition_tpu_torch.train.loop import _resolve_data_mode
from chainer_speech_recognition_tpu_torch.vocab import Vocab

OVER = {"buckets.boundaries": [96, 160, 256], "buckets.batch_sizes": [4, 3, 2],
        "buckets.max_label_len": 24}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Tone utterances of 0.3-2.4 s over three buckets (one of them with
    fewer rows than the others)."""
    root = str(tmp_path_factory.mktemp("cache_corpus"))
    write_tone_corpus(root, np.random.default_rng(7), {"train": 26}, 6,
                      (0.3, 2.4))
    cfg = Config().override(OVER)
    jcfg = JConfig.from_json(cfg.to_json())
    utts = load_index(f"{root}/train_index.jsonl")
    jutts = jload_index(f"{root}/train_index.jsonl")
    loader = BatchLoader(utts, Vocab.load(f"{root}/vocab.txt"), cfg.buckets)
    jloader = JLoader(jutts, JVocab.load(f"{root}/vocab.txt"), jcfg.buckets)
    sampler = BucketSampler(utts, cfg.buckets, seed=3)
    jsampler = JSampler(jutts, jcfg.buckets, seed=3)
    assert [len(b) for b in sampler.buckets] == [
        len(b) for b in jsampler.buckets]
    assert sum(len(b) > 0 for b in sampler.buckets) >= 2
    return cfg, jcfg, loader, jloader, sampler, jsampler


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _same_plan(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


@pytest.mark.parametrize("features", [False, True])
def test_estimate_bytes_matches_reference(corpus, features):
    cfg, _, _, _, sampler, jsampler = corpus
    assert tdc.estimate_bytes(sampler, features) == jdc.estimate_bytes(
        jsampler, features)


def test_data_order_matches_reference(corpus, mesh):
    """PCM caches of both packages: the rows each bucket holds, and for
    epochs 0-2 the batches, the dispatches at K = 1, 3 and 8 and the corpus
    indices behind every batch, exactly."""
    cfg, jcfg, loader, jloader, sampler, jsampler = corpus
    t = tdc.DeviceCorpusCache(loader, sampler, "cpu", seed=11)
    j = jdc.DeviceCorpusCache(mesh, jloader, jsampler, seed=11)
    assert sorted(t.buckets) == sorted(j.buckets)
    for bid in t.buckets:
        np.testing.assert_array_equal(t.utt_map[bid], j.utt_map[bid])
        np.testing.assert_array_equal(t.real_counts[bid], j.real_counts[bid])
        for k in ("signals_i16", "num_samples", "labels", "label_lengths"):
            np.testing.assert_array_equal(t.buckets[bid][k].numpy(),
                                          np.asarray(j.buckets[bid][k]))
    for epoch in range(3):
        batches = t.epoch_batches(epoch)
        _same_plan(batches, j.epoch_batches(epoch))
        for bid, slots in batches:
            np.testing.assert_array_equal(t.utterance_indices(bid, slots),
                                          j.utterance_indices(bid, slots))
        for K in (1, 3, 8):
            _same_plan(t.epoch_dispatches(epoch, K),
                       j.epoch_dispatches(epoch, K))


def test_cached_features_match_reference(corpus, mesh):
    """Feature mode: the front-end runs once at build time in 32-row calls
    and the cache keeps bf16 features; they agree with the JAX cache's at
    the bf16 bar, frame lengths and labels exactly."""
    cfg, jcfg, loader, jloader, sampler, jsampler = corpus
    t = tdc.DeviceCorpusCache(loader, sampler, "cpu",
                              features_cfg=cfg.features)
    j = jdc.DeviceCorpusCache(mesh, jloader, jsampler,
                              features_cfg=jcfg.features)
    for bid, tb in t.buckets.items():
        jb = j.buckets[bid]
        assert set(tb) == set(jb) == {"features", "frame_lengths", "labels",
                                      "label_lengths"}
        assert tb["features"].dtype == torch.bfloat16
        assert tuple(tb["features"].shape) == tuple(jb["features"].shape)
        np.testing.assert_allclose(tb["features"].float().numpy(),
                                   np.asarray(jb["features"], np.float32),
                                   atol=0.04, rtol=0.02)
        for k in ("frame_lengths", "labels", "label_lengths"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert t.nbytes() == sum(
        v.numel() * v.element_size() for b in t.buckets.values()
        for v in b.values())


@pytest.mark.parametrize("features,budget", [
    (False, 400_000), (False, 2_000_000), (True, 500_000), (True, 3_000_000)])
def test_rotating_plan_matches_reference(corpus, mesh, features, budget):
    """Window count, rows a window and the epoch plans at K = 1, 2 and 3,
    for a budget that cuts a bucket into windows of one or two rows and
    one that forces a few windows, in both modes (their residency peaks
    differ)."""
    cfg, jcfg, loader, jloader, sampler, jsampler = corpus
    t = tdc.RotatingDeviceCache(
        loader, sampler, budget, "cpu", seed=5,
        features_cfg=cfg.features if features else None)
    j = jdc.RotatingDeviceCache(
        mesh, jloader, jsampler, budget, seed=5,
        features_cfg=jcfg.features if features else None)
    assert t.n_windows == j.n_windows and t.rows_per_window == \
        j.rows_per_window
    assert 2 <= t.n_windows
    for epoch in range(2):
        for K in (1, 2, 3):
            _same_plan(t.epoch_plan(epoch, K), j.epoch_plan(epoch, K))


@pytest.mark.parametrize("features,budget", [(False, 1_000_000),
                                             (True, 1_500_000)])
def test_rotating_windows_hold_the_full_caches_rows(corpus, features, budget):
    """Every row of every window (both buffer sets in turn) equals, bit for
    bit, the full cache's row of the same utterance."""
    cfg, _, loader, _, sampler, _ = corpus
    fcfg = cfg.features if features else None
    full = tdc.DeviceCorpusCache(loader, sampler, "cpu", features_cfg=fcfg)
    rot = tdc.RotatingDeviceCache(loader, sampler, budget, "cpu",
                                  features_cfg=fcfg)
    assert rot.n_windows >= 3
    where = {bid: {int(u): r for r, u in enumerate(full.utt_map[bid][0])}
             for bid in full.buckets}
    perms = rot._epoch_perms(1)
    checked = 0
    for w in range(rot.n_windows):
        s = w % 2
        rot.fetch_window(1, w, s)
        rot.set_window(s)
        counts = rot._window_counts(perms, w)
        for bid, mat in rot._window_rows(perms, w).items():
            if int(counts[bid].max()) == 0:
                continue
            got = rot.buckets[bid]
            for r, u in enumerate(mat[0]):
                want = full.buckets[bid]
                for k in got:
                    assert torch.equal(got[k][r], want[k][where[bid][int(u)]])
                checked += 1
    assert checked >= len(sampler.buckets[0]) + len(sampler.buckets[1])


@pytest.mark.parametrize("mode,budget_gb,n_devices", [
    ("auto", 1.0, 1), ("auto", 1e-4, 1), ("auto", 1e-4, 64),
    ("auto", 1e-6, 64), ("stream", 1e-6, 1), ("rotating", 1.0, 1),
    ("device_cache", 1e-6, 1)])
def test_resolve_data_mode_matches_reference(corpus, mode, budget_gb,
                                             n_devices):
    """The rule of ``auto``: the corpus's build-peak bytes against
    ``n_devices`` times the per-device budget."""
    cfg, jcfg, _, _, sampler, jsampler = corpus
    over = {"train.data_mode": mode, "train.device_cache_budget_gb":
            budget_gb}
    got = _resolve_data_mode(cfg.override(over), sampler, n_devices)
    assert got == j_resolve(jcfg.override(over), jsampler, n_devices)
    est = tdc.estimate_bytes(sampler, True)
    if mode == "auto":
        fits = est <= budget_gb * 1e9 * n_devices
        assert got == ("device_cache" if fits else "rotating")
