"""Device-resident training corpus (port of ``data/device_cache.py``): the
corpus crosses to the card once, and each training dispatch sends only its
[K, B] slot ids.

* ``DeviceCorpusCache``: every bucket's padded rows on the device. PCM
  mode keeps int16 signals; feature mode runs the front-end once at build
  time (``FE_CHUNK`` rows a call, ``select_frontend``: on the card the
  ``frontend_logmel`` kernel) and keeps ``cache_dtype`` (bf16) features
  with their frame lengths. The host assembles ``PUT_ROWS`` rows at a time
  into one preallocated int16 buffer (pinned on the card), which then
  crosses in one copy a bucket and array.
* ``RotatingDeviceCache``: corpora over the budget, in fixed-size windows
  of rows. Each bucket has two fixed buffer sets (A/B): a fetch thread
  fills the idle set on a stream of its own (host assembly, the pinned
  copy and, in feature mode, the front-end), while the training stream
  reads the other. Row counts are fixed a bucket, so a CUDA graph captured
  on a set is replayed on every window that set holds.

Over a data-parallel mesh of ``n`` ranks (``parallel/mesh.py``) each
rank builds only its own shard, the reference's device d: rows d, d+n,
d+2n, ... of each bucket. Every rank draws the same slot plan from the
same seed (segment d of each [B] slot vector indexes device d's rows),
rotating windows advance in lockstep, and the budget is a device's. The
slot draws are the reference's, so the data order equals its order on a
mesh of the same size.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from .sampler import BucketSampler


def _to_int16(host: dict) -> np.ndarray:
    """int16 view of a loaded batch: packed loaders carry int16 signals;
    float (wav) loaders are requantized (the source was PCM16, so the
    round trip is lossless)."""
    sig = host.get("signals_i16")
    if sig is None:
        sig = np.clip(host["signals"] * 32768.0,
                      -32768, 32767).astype(np.int16)
    return sig


def _pcm_row_bytes(shape) -> int:
    return shape.max_samples * 2 + shape.max_label_len * 4 + 8


def _feat_row_bytes(shape, cache_dtype: str) -> int:
    itemsize = _torch_dtype(cache_dtype).itemsize
    return (shape.max_frames * C.N_MELS * C.N_FEATURE_CHANNELS * itemsize
            + shape.max_label_len * 4 + 8)


def _torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[name]


def estimate_bytes(sampler: BucketSampler, features: bool = False,
                   cache_dtype: str = "bfloat16") -> int:
    """Device bytes of the cache. ``features=True`` counts the build peak:
    the features plus the largest bucket's transient PCM (buckets build
    one at a time), so the ``auto`` decision holds while building too."""
    total, max_bucket_pcm = 0, 0
    for shape, idxs in zip(sampler.shapes, sampler.buckets):
        if features:
            total += _feat_row_bytes(shape, cache_dtype) * len(idxs)
            max_bucket_pcm = max(max_bucket_pcm,
                                 shape.max_samples * 2 * len(idxs))
        else:
            total += _pcm_row_bytes(shape) * len(idxs)
    return total + max_bucket_pcm


def _host_buffer(shape: tuple, dtype: np.dtype, pinned: bool) -> torch.Tensor:
    """An empty host tensor of numpy ``dtype``, pinned for the card."""
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=pinned)


def _build_features(sig: torch.Tensor, num: torch.Tensor, features_cfg,
                    out: torch.Tensor, out_lens: torch.Tensor) -> None:
    """The front-end over device-resident int16 rows, ``FE_CHUNK`` rows a
    call (bounds the transient fp32 memory), into ``out`` [R, T, M, 3]
    (cache dtype) and ``out_lens`` [R] int32."""
    from ..frontend import select_frontend

    frontend = select_frontend(features_cfg)
    step = DeviceCorpusCache.FE_CHUNK
    for r0 in range(0, sig.shape[0], step):
        f, fl = frontend(sig[r0:r0 + step].to(torch.float32) / 32768.0,
                         num[r0:r0 + step],
                         apply_cmvn=features_cfg.cmvn_arg)
        out[r0:r0 + step].copy_(f)
        out_lens[r0:r0 + step].copy_(fl)


class DeviceCorpusCache:
    """Per-bucket device-resident padded corpus.

    ``buckets[bid]`` is a dict of tensors on ``device``: this rank's R
    rows (device d of the reference's device-major layout, R the largest
    device's count; the shorter ones pad with rows never sampled):
      PCM mode:     signals_i16 [R, S] int16, num_samples [R] int32
      feature mode: features [R, T, n_mels, 3] cache_dtype,
                    frame_lengths [R] int32
      both:         labels [R, L] int32, label_lengths [R] int32
    ``epoch_batches`` gives device-local slot ids: segment d of each [B]
    vector indexes device d's rows, so rank d trains on its segment
    (``parallel.mesh.dispatch_rows``)."""

    FE_CHUNK = 32          # rows a front-end call at build time
    PUT_ROWS = 256         # rows a host load chunk (bounds host RAM)

    def __init__(self, loader, sampler: BucketSampler, device,
                 seed: int = 0, features_cfg=None,
                 cache_dtype: str = "bfloat16", mesh=None):
        self.n = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.seed = seed
        self.shapes = sampler.shapes
        self.device = torch.device(device)
        pinned = self.device.type == "cuda"
        self.buckets: dict[int, dict] = {}
        self.real_counts: dict[int, np.ndarray] = {}   # [n] per device
        self.utt_map: dict[int, np.ndarray] = {}       # [n, R] → corpus idx
        for bid, idxs in enumerate(sampler.buckets):
            if len(idxs) == 0:
                continue
            local = [idxs[d::self.n] for d in range(self.n)]
            R = max(len(l) for l in local)
            counts = np.asarray([len(l) for l in local], np.int32)
            padded = np.stack([
                np.concatenate([l, np.full(R - len(l), idxs[0],
                                           dtype=idxs.dtype)])
                for l in local])                        # [n, R]
            host: dict | None = None
            for r0 in range(0, R, self.PUT_ROWS):
                sel = padded[self.rank, r0:r0 + self.PUT_ROWS]  # this rank's
                part = loader.load(bid, sel)
                arrs = {"signals_i16": _to_int16(part),
                        "num_samples": part["num_samples"].astype(np.int32),
                        "labels": part["labels"],
                        "label_lengths": part["label_lengths"]}
                if host is None:
                    host = {k: _host_buffer((R,) + v.shape[1:], v.dtype,
                                            pinned)
                            for k, v in arrs.items()}
                for k, v in arrs.items():
                    host[k].numpy()[r0:r0 + len(sel)] = v
            dev = {k: v.to(self.device, non_blocking=True)
                   for k, v in host.items()}
            if features_cfg is not None:
                sig, num = dev.pop("signals_i16"), dev.pop("num_samples")
                feats = torch.empty(
                    (sig.shape[0], self.shapes[bid].max_frames, C.N_MELS,
                     C.N_FEATURE_CHANNELS),
                    dtype=_torch_dtype(cache_dtype), device=self.device)
                flens = torch.empty(sig.shape[0], dtype=torch.int32,
                                    device=self.device)
                _build_features(sig, num, features_cfg, feats, flens)
                del sig, num             # the transient PCM goes here
                dev = {"features": feats, "frame_lengths": flens, **dev}
            self.buckets[bid] = dev
            self.real_counts[bid] = counts
            self.utt_map[bid] = padded

    def nbytes(self) -> int:
        """Device bytes the cache holds."""
        return sum(t.numel() * t.element_size()
                   for b in self.buckets.values() for t in b.values())

    def epoch_dispatches(self, epoch: int, steps_per_dispatch: int
                         ) -> list[tuple[int, np.ndarray]]:
        """The epoch's batches grouped into [K, B] slot matrices of one
        bucket each: a bucket's batch count is rounded up to a multiple of
        K by wrapping, and the dispatch order is shuffled."""
        k = steps_per_dispatch
        if k <= 1:
            return self.epoch_batches(epoch)
        per_bucket: dict[int, list[np.ndarray]] = {}
        for bid, slots in self.epoch_batches(epoch):
            per_bucket.setdefault(bid, []).append(slots)
        rng = np.random.default_rng([self.seed, epoch, 0xD15B])
        out = []
        for bid, vecs in per_bucket.items():
            while len(vecs) % k:
                vecs.append(vecs[len(vecs) % k - 1])     # wrap-pad
            for j in range(0, len(vecs), k):
                out.append((bid, np.stack(vecs[j:j + k])))
        order = rng.permutation(len(out))
        return [out[i] for i in order]

    def epoch_batches(self, epoch: int) -> list[tuple[int, np.ndarray]]:
        """(bucket_id, local slot ids [B]) for one epoch, deterministic in
        (seed, epoch): ceil(max rows a device / (B/n)) batches a bucket,
        so every row is visited; devices with fewer rows wrap around their
        permutation."""
        rng = np.random.default_rng([self.seed, epoch, 0xCACE])
        out = []
        for bid in self.buckets:
            B = self.shapes[bid].batch_size
            if B % self.n:
                raise ValueError(
                    f"bucket {bid}: batch size {B} not divisible by "
                    f"{self.n} devices — adjust buckets.batch_sizes")
            k = B // self.n
            counts = self.real_counts[bid]
            nb = -(-int(max(counts)) // k)
            perms = [np.resize(rng.permutation(int(c)), nb * k)
                     for c in counts]
            for j in range(nb):
                seg = [p[j * k:(j + 1) * k] for p in perms]
                out.append((bid, np.concatenate(seg).astype(np.int32)))
        order = rng.permutation(len(out))
        return [out[i] for i in order]

    def utterance_indices(self, bid: int, slot_ids: np.ndarray) -> np.ndarray:
        """One batch's local slot ids → corpus indices."""
        k = len(slot_ids) // self.n
        return np.concatenate([
            self.utt_map[bid][d][slot_ids[d * k:(d + 1) * k]]
            for d in range(self.n)])


class RotatingDeviceCache:
    """Device-resident windows of a corpus larger than the budget.

    Each epoch, every bucket's rows are permuted (seed, epoch) and cut
    into ``n_windows`` slices of ``rows_per_window`` rows, sized so that
    the residency peak fits the budget: two PCM windows in PCM mode; two
    feature windows and the next window's transient PCM in feature mode.
    Training runs window w from one buffer set while window w+1 fills the
    other (``rotating_dispatches``). The fetch into a set waits, on the
    device, for the last dispatch that read the window before from it
    (``release``); the training stream waits for the fetch before its
    first dispatch on the set (``set_window``)."""

    def __init__(self, loader, sampler: BucketSampler, budget_bytes: int,
                 device, seed: int = 0, features_cfg=None,
                 cache_dtype: str = "bfloat16", mesh=None):
        """``budget_bytes`` is the whole mesh's: a device's budget times
        the ranks (as the reference's loop passes it)."""
        self.n = 1 if mesh is None else mesh.size
        self.rank = 0 if mesh is None else mesh.rank
        self.seed = seed
        self.loader = loader
        self.shapes = sampler.shapes
        self.device = torch.device(device)
        self.features_cfg = features_cfg
        self.cache_dtype = cache_dtype
        self.bucket_rows: dict[int, list[np.ndarray]] = {}   # per device
        total_cost = 0
        for bid, idxs in enumerate(sampler.buckets):
            if len(idxs) == 0:
                continue
            self.bucket_rows[bid] = [idxs[d::self.n] for d in range(self.n)]
            shape = self.shapes[bid]
            if features_cfg is not None:
                cost = 2 * _feat_row_bytes(shape, cache_dtype) \
                    + _pcm_row_bytes(shape)
            else:
                cost = 2 * _pcm_row_bytes(shape)
            total_cost += cost * len(idxs)
        if not self.bucket_rows:
            raise ValueError("rotating cache: no non-empty buckets")
        self.n_windows = max(1, -(-total_cost // max(int(budget_bytes), 1)))
        self.rows_per_window: dict[int, int] = {}
        for bid, per_dev in self.bucket_rows.items():
            r_max = max(len(l) for l in per_dev)
            self.rows_per_window[bid] = -(-r_max // self.n_windows)
        # the current window's buffers (read by the cached train step)
        self.buckets: dict[int, dict] = {}
        self._sets: list[dict[int, dict]] = [{}, {}]
        self._ready: list = [None, None]      # fetch done (an event)
        self._released: list = [None, None]   # last read of the set done
        self.current = 1          # the set in use; the first fetch takes 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    # ---- epoch plan -------------------------------------------------------

    def _epoch_perms(self, epoch: int) -> dict[int, list[np.ndarray]]:
        rng = np.random.default_rng([self.seed, epoch, 0x307A7E])
        return {bid: [l[rng.permutation(len(l))] for l in per_dev]
                for bid, per_dev in self.bucket_rows.items()}

    def _window_rows(self, perms, w: int) -> dict[int, np.ndarray]:
        """[n, R_w] corpus indices per bucket for window w (wrap-padded;
        padded slots are never sampled)."""
        out = {}
        for bid, per_dev in perms.items():
            R = self.rows_per_window[bid]
            fallback = next(l for l in per_dev if len(l))
            rows = []
            for l in per_dev:
                if len(l) == 0:
                    rows.append(np.broadcast_to(fallback[:1], (R,)).copy())
                    continue
                rows.append(l[np.arange(w * R, (w + 1) * R) % len(l)])
            out[bid] = np.stack(rows)
        return out

    def _window_counts(self, perms, w: int) -> dict[int, np.ndarray]:
        """Real (unwrapped) rows per device in window w, per bucket."""
        out = {}
        for bid, per_dev in perms.items():
            R = self.rows_per_window[bid]
            out[bid] = np.asarray(
                [max(0, min((w + 1) * R, len(l)) - w * R) for l in per_dev],
                np.int32)
        return out

    def epoch_plan(self, epoch: int, steps_per_dispatch: int):
        """[(window_id, bucket_id, slots [K, B] or [B])], window ids
        contiguous and non-decreasing."""
        k = max(1, steps_per_dispatch)
        perms = self._epoch_perms(epoch)
        rng = np.random.default_rng([self.seed, epoch, 0x307A7F])
        plan = []
        for w in range(self.n_windows):
            counts = self._window_counts(perms, w)
            vecs_by_bucket: dict[int, list[np.ndarray]] = {}
            for bid, c in counts.items():
                B = self.shapes[bid].batch_size
                if B % self.n:
                    raise ValueError(
                        f"bucket {bid}: batch size {B} not divisible by "
                        f"{self.n} devices")
                kb = B // self.n
                if int(max(c)) == 0:
                    continue
                nb = -(-int(max(c)) // kb)
                perms_local = [np.resize(rng.permutation(max(int(ci), 1)),
                                         nb * kb) for ci in c]
                for j in range(nb):
                    seg = [p[j * kb:(j + 1) * kb] for p in perms_local]
                    vecs_by_bucket.setdefault(bid, []).append(
                        np.concatenate(seg).astype(np.int32))
            wplan = []
            for bid, vecs in vecs_by_bucket.items():
                if k == 1:
                    wplan.extend((w, bid, v) for v in vecs)
                else:
                    while len(vecs) % k:
                        vecs.append(vecs[len(vecs) % k - 1])
                    wplan.extend((w, bid, np.stack(vecs[j:j + k]))
                                 for j in range(0, len(vecs), k))
            order = rng.permutation(len(wplan))
            plan.extend(wplan[i] for i in order)
        return plan

    # ---- buffers ----------------------------------------------------------

    def _buffers(self, s: int, bid: int, host: dict) -> dict:
        """Set ``s``'s fixed tensors of bucket ``bid`` (made at first use)."""
        bufs = self._sets[s].get(bid)
        if bufs is None:
            dev = self.device
            R = self.rows_per_window[bid]          # this rank's rows
            shape = self.shapes[bid]
            labels = {
                "labels": torch.empty(host["labels"].shape, dtype=torch.int32,
                                      device=dev),
                "label_lengths": torch.empty(R, dtype=torch.int32,
                                             device=dev)}
            if self.features_cfg is not None:
                bufs = {"features": torch.empty(
                            (R, shape.max_frames, C.N_MELS,
                             C.N_FEATURE_CHANNELS),
                            dtype=_torch_dtype(self.cache_dtype), device=dev),
                        "frame_lengths": torch.empty(R, dtype=torch.int32,
                                                     device=dev),
                        **labels}
            else:
                bufs = {"signals_i16": torch.empty(
                            (R, shape.max_samples), dtype=torch.int16,
                            device=dev),
                        "num_samples": torch.empty(R, dtype=torch.int32,
                                                   device=dev),
                        **labels}
            self._sets[s][bid] = bufs
        return bufs

    def _await_release(self, s: int) -> None:
        """Make the fetch stream wait for the last dispatch that read set
        ``s`` (the fetch overwrites it)."""
        if self._released[s] is not None:
            self._stream.wait_event(self._released[s])

    def fetch_window(self, epoch: int, w: int, s: int) -> None:
        """Fill set ``s`` with window w; safe on a background thread (on
        the card it runs on the cache's own stream and records
        ``_ready[s]``)."""
        perms = self._epoch_perms(epoch)
        rows = self._window_rows(perms, w)
        counts = self._window_counts(perms, w)
        cuda = self._stream is not None
        with torch.cuda.stream(self._stream):      # None: no-op (CPU)
            if cuda:
                self._await_release(s)
            for bid, mat in rows.items():
                if int(counts[bid].max()) == 0:
                    continue     # the plan dispatches no batch of it here
                host = self.loader.load(bid, mat[self.rank])
                arrs = {"signals_i16": _to_int16(host),
                        "num_samples": host["num_samples"].astype(np.int32),
                        "labels": host["labels"],
                        "label_lengths": host["label_lengths"]}
                src = {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in arrs.items()}
                if cuda:
                    src = {k: v.pin_memory() for k, v in src.items()}
                bufs = self._buffers(s, bid, host)
                for k in ("labels", "label_lengths"):
                    bufs[k].copy_(src[k], non_blocking=True)
                if self.features_cfg is None:
                    bufs["signals_i16"].copy_(src["signals_i16"],
                                              non_blocking=True)
                    bufs["num_samples"].copy_(src["num_samples"],
                                              non_blocking=True)
                else:
                    sig = src["signals_i16"].to(self.device,
                                                non_blocking=True)
                    num = src["num_samples"].to(self.device,
                                                non_blocking=True)
                    _build_features(sig, num, self.features_cfg,
                                    bufs["features"], bufs["frame_lengths"])
            if cuda:
                self._ready[s] = torch.cuda.Event()
                self._ready[s].record(self._stream)

    def set_window(self, s: int) -> None:
        """Train from set ``s`` next: the current stream waits for its
        fetch."""
        if self._ready[s] is not None:
            torch.cuda.current_stream(self.device).wait_event(self._ready[s])
        self.buckets = self._sets[s]
        self.current = s

    def release(self, s: int) -> None:
        """Mark the end of the dispatches that read set ``s``."""
        if self._stream is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._released[s] = ev


def rotating_dispatches(cache: RotatingDeviceCache, epoch: int, plan, pool):
    """Iterate a rotating (sub-)plan with double-buffered window fetches:
    window w+1 fills the idle set on ``pool`` while window w trains.
    Yields (bucket_id, slots) with the right window current; the caller
    enqueues each dispatch before asking for the next. A fetch may run
    while the caller captures a bucket's graph on the current set: the
    capture is thread-local and counts only its own thread's launches
    (``train/step.make_cached_train_step``)."""
    window_seq: list[int] = []
    for w, _, _ in plan:
        if not window_seq or window_seq[-1] != w:
            window_seq.append(w)
    if not window_seq:
        return
    first = 1 - cache.current
    sets = [(first + i) % 2 for i in range(len(window_seq))]
    futures = {0: pool.submit(cache.fetch_window, epoch, window_seq[0],
                              sets[0])}
    cur = None
    try:
        for w, bid, slots in plan:
            if w != cur:
                if cur is not None:
                    cache.release(cache.current)
                i = window_seq.index(w)
                futures.pop(i).result()
                cache.set_window(sets[i])
                cur = w
                if i + 1 < len(window_seq):
                    futures[i + 1] = pool.submit(
                        cache.fetch_window, epoch, window_seq[i + 1],
                        sets[i + 1])
            yield bid, slots
        cache.release(cache.current)
    finally:
        for f in futures.values():
            f.cancel()
