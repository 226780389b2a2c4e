"""Resumable bucketed sampler + padded-batch loader + background prefetch
(the port's copy of the reference's ``data/sampler.py``; for the same
utterances and seed it gives the same batches, which
``tests/test_torch_copies.py`` checks).

The batch sequence is a pure function of (seed, epoch), so a checkpoint's
step count and a replay reproduce training exactly.
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading

import numpy as np

from .. import constants as C
from ..config import BucketConfig
from ..vocab import Vocab
from ..utils.wav import read_wav
from .buckets import BucketShape, assign_bucket, bucket_shapes
from .corpus import RecordingCache, Utterance, load_signal


class BucketSampler:
    """Groups utterances into length buckets; yields (bucket_id, utt_idx[])."""

    def __init__(self, utts: list[Utterance], cfg: BucketConfig, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.shapes = bucket_shapes(cfg)
        nf = np.asarray([u.num_frames for u in utts])
        nl = np.asarray([len(u.text) for u in utts])
        bidx = assign_bucket(nf, cfg)
        fits_label = nl <= cfg.max_label_len
        # CTC needs enough (subsampled) frames per label; a loose static
        # pre-filter (labels can't exceed raw frames) avoids inf losses.
        fits_ctc = nl * 2 + 1 <= nf
        keep = (bidx >= 0) & fits_label & fits_ctc
        self.num_dropped = int((~keep).sum())
        self.buckets = [np.nonzero(keep & (bidx == i))[0]
                        for i in range(len(cfg.boundaries))]

    def epoch_batches(self, epoch: int) -> list[tuple[int, np.ndarray, int]]:
        """Deterministic shuffled batch list for one epoch: (bucket_id,
        utt indices [batch_size], n_valid). The per-bucket remainder is
        padded to the static batch shape by repeating its first utterance;
        n_valid < batch_size marks the padded rows, which the loader masks
        to zero sample weight (they contribute NO gradient)."""
        rng = np.random.default_rng([self.seed, epoch])
        batches = []
        for bid, (idxs, shape) in enumerate(zip(self.buckets, self.shapes)):
            perm = idxs[rng.permutation(len(idxs))]
            bs = shape.batch_size
            for i in range(0, len(perm) - bs + 1, bs):
                batches.append((bid, perm[i : i + bs], bs))
            rem = len(perm) % bs
            if rem:
                chunk = perm[len(perm) - rem:]
                pad = np.full(bs - rem, chunk[0], dtype=chunk.dtype)
                batches.append((bid, np.concatenate([chunk, pad]), rem))
        order = rng.permutation(len(batches))
        return [batches[i] for i in order]

    def eval_batches(self) -> list[tuple[int, np.ndarray, int]]:
        """Deterministic FULL coverage for evaluation: every utterance is
        scored exactly once. Partial final batches are padded (static
        shapes!) by repeating the first utterance; the third element is the
        number of REAL utterances in the batch — score only those."""
        batches = []
        for bid, (idxs, shape) in enumerate(zip(self.buckets, self.shapes)):
            bs = shape.batch_size
            for i in range(0, len(idxs), bs):
                chunk = idxs[i : i + bs]
                n_valid = len(chunk)
                if n_valid < bs:
                    pad = np.full(bs - n_valid, chunk[0], dtype=chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                batches.append((bid, chunk, n_valid))
        return batches


class BatchLoader:
    """(bucket_id, utt indices) → padded host batch dict (static shapes).

    Two modes (SURVEY.md §2.1 "Feature cache"):
    * signals (default): pads raw PCM; features are computed on-device
      inside the jitted train/eval step (the TPU-native path);
    * cached features (``use_cached_features=True`` and utterances carry a
      ``feat`` .npy path): pads precomputed [T, n_mels, 3] tensors — the
      reference's precompute-to-disk workflow.
    """

    def __init__(self, utts: list[Utterance], vocab: Vocab,
                 bucket_cfg: BucketConfig, read_fn=read_wav,
                 use_cached_features: bool = False):
        self.utts = utts
        self.vocab = vocab
        self.shapes = bucket_shapes(bucket_cfg)
        self.read_fn = read_fn
        self.use_cached_features = use_cached_features
        if use_cached_features and any(u.feat is None for u in utts):
            raise ValueError("use_cached_features=True but some utterances "
                             "have no cached feature path (re-run preprocess "
                             "with --cache-features)")

    def _labels(self, idxs, shape):
        B = len(idxs)
        labels = np.full((B, shape.max_label_len), C.PAD_LABEL_ID, np.int32)
        label_lengths = np.zeros(B, np.int32)
        for i, u_idx in enumerate(idxs):
            ids = self.vocab.encode(self.utts[int(u_idx)].text)
            labels[i, : len(ids)] = ids
            label_lengths[i] = len(ids)
        return labels, label_lengths

    def load(self, bucket_id: int, idxs: np.ndarray,
             n_valid: int | None = None) -> dict:
        shape: BucketShape = self.shapes[bucket_id]
        labels, label_lengths = self._labels(idxs, shape)
        B = len(idxs)
        extra = {}
        if n_valid is not None and n_valid < B:   # masked remainder padding
            extra["sample_weight"] = (
                np.arange(B) < n_valid).astype(np.float32)
        if self.use_cached_features:
            feats = np.zeros((B, shape.max_frames, C.N_MELS,
                              C.N_FEATURE_CHANNELS), np.float32)
            frame_lengths = np.zeros(B, np.int32)
            for i, u_idx in enumerate(idxs):
                f = np.load(self.utts[int(u_idx)].feat)
                t = min(len(f), shape.max_frames)
                feats[i, :t] = f[:t]
                frame_lengths[i] = t
            return {"features": feats, "frame_lengths": frame_lengths,
                    "labels": labels, "label_lengths": label_lengths,
                    "bucket_id": bucket_id, **extra}
        signals = np.zeros((B, shape.max_samples), np.float32)
        num_samples = np.zeros(B, np.int32)
        cached_read = RecordingCache(self.read_fn)
        # visit rows grouped by recording (output order unchanged): shuffled
        # batches over a segments corpus interleave many lecture recordings,
        # and without grouping nearly every row would re-decode its full
        # multi-minute recording through the 2-slot cache (ADVICE r1). The
        # packed corpus (data/packed.py) remains the intended path for
        # segment corpora at scale; this keeps the fallback off the cliff.
        by_rec = sorted(range(B),
                        key=lambda i: (self.utts[int(idxs[i])].wav,
                                       self.utts[int(idxs[i])].offset_samples))
        for i in by_rec:
            u = self.utts[int(idxs[i])]
            sig = load_signal(u, cached_read)
            n = min(len(sig), shape.max_samples)
            signals[i, :n] = sig[:n]
            num_samples[i] = n
        return {"signals": signals, "num_samples": num_samples,
                "labels": labels, "label_lengths": label_lengths,
                "bucket_id": bucket_id, **extra}


class Prefetcher:
    """Parallel background batch loading, order-preserving (SURVEY.md §3.2
    hot loop; VERDICT.md round-1 Weak #1 — one loader thread could not feed
    the chip).

    ``num_workers`` threads assemble whole batches concurrently — the hot
    work (memmap slice-copies / WAV parse via the C++ RIFF parser) releases
    the GIL, so threads scale without multiprocessing's pickling tax — and
    iteration yields batches in exactly the submitted order, preserving the
    (seed, epoch)-deterministic resume contract.

    ``stop()`` (or abandoning iteration early, e.g. total_steps reached
    mid-epoch) cancels queued work and terminates the workers promptly.
    """

    def __init__(self, loader, batches, depth: int = 8,
                 num_workers: int = 4):
        self.loader = loader
        self.batches = list(batches)
        self.depth = max(depth, num_workers)
        self._stop = threading.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=num_workers, thread_name_prefix="csr-loader")

    def stop(self):
        self._stop.set()
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __iter__(self):
        pending: collections.deque = collections.deque()
        it = iter(self.batches)
        try:
            while True:
                while len(pending) < self.depth and not self._stop.is_set():
                    nxt = next(it, None)
                    if nxt is None:
                        break
                    # (bucket_id, idxs[, n_valid]) passes straight through
                    pending.append(self._pool.submit(self.loader.load, *nxt))
                if not pending or self._stop.is_set():
                    return
                yield pending.popleft().result()
        finally:
            self.stop()
