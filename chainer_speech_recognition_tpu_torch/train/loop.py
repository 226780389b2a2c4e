"""Host-side training loop (port of ``train/loop.py``, stream data mode, one
device): a background ``Prefetcher`` assembles padded host batches, each is
copied to the device and trained on, with structured metrics, periodic
greedy dev evaluation, keep-N checkpoints and exact resume (data order
included).

Only the "stream" data mode is ported. ``_resolve_data_mode`` is the
reference's; when it resolves to "device_cache" or "rotating" (the
default "auto" does for a corpus that fits the budget) the port raises
instead of switching mode.
"""

from __future__ import annotations

import os
import signal
import time

import numpy as np
import torch

from .. import constants as C
from ..checkpoint import (latest_checkpoint, restore_checkpoint,
                          save_checkpoint)
from ..config import Config
from ..data.buckets import padding_waste
from ..data.corpus import Utterance
from ..data.sampler import BatchLoader, BucketSampler, Prefetcher
from ..decode.greedy import greedy_decode
from ..decode.metrics import CERAccumulator
from ..models.presets import build_model, init_parameters
from ..ops.ctc import LOG_ZERO
from ..vocab import Vocab
from .metrics import MetricsLogger
from .state import init_state
from .step import check_trainable, make_eval_step, make_train_step


def estimate_bytes(sampler: BucketSampler, features: bool = False,
                   cache_dtype: str = "bfloat16") -> int:
    """Device bytes the reference's corpus cache would take
    (``data/device_cache.py::estimate_bytes``): the data-mode decision of
    ``_resolve_data_mode`` depends on it."""
    total, max_bucket_pcm = 0, 0
    for shape, idxs in zip(sampler.shapes, sampler.buckets):
        if features:
            itemsize = np.dtype(cache_dtype).itemsize
            row = (shape.max_frames * C.N_MELS * C.N_FEATURE_CHANNELS
                   * itemsize + shape.max_label_len * 4 + 8)
            total += row * len(idxs)
            max_bucket_pcm = max(max_bucket_pcm,
                                 shape.max_samples * 2 * len(idxs))
        else:
            total += (shape.max_samples * 2 + shape.max_label_len * 4
                      + 8) * len(idxs)
    return total + max_bucket_pcm


def _resolve_data_mode(cfg: Config, sampler: BucketSampler,
                       n_devices: int = 1) -> str:
    """The reference's rule: "stream", "device_cache" or "rotating"."""
    mode = cfg.train.data_mode
    if mode not in ("auto", "stream", "device_cache", "rotating"):
        raise ValueError(f"unknown train.data_mode: {mode!r}")
    if cfg.features.use_cache:           # precomputed-feature batches: stream
        if mode not in ("auto", "stream"):
            raise ValueError(
                f"train.data_mode={mode!r} is incompatible with "
                "features.use_cache=true (the disk feature cache feeds "
                "per-step streamed batches) — drop one of the two")
        return "stream"
    if mode == "auto":
        est = estimate_bytes(sampler, features=cfg.train.cache_features,
                             cache_dtype=cfg.train.cache_dtype)
        fits = est <= cfg.train.device_cache_budget_gb * 1e9 * n_devices
        return "device_cache" if fits else "rotating"
    return mode


def to_device(batch: dict, device: torch.device) -> dict:
    """Host batch (numpy) → tensors on ``device``; on the card through
    pinned memory, so the copy does not wait for the steps in flight."""
    out = {}
    for k, v in batch.items():
        if k == "bucket_id":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def evaluate(eval_step, loader: BatchLoader, batches, vocab: Vocab, utts,
             device: torch.device):
    """Dev-set greedy decode → (CERAccumulator, mean loss over samples with
    an alignment), scoring only the real rows of padded batches
    (``evaluate_multi`` with the greedy decoder)."""
    acc = CERAccumulator()
    total_loss, n = 0.0, 0
    for bid, idxs, n_valid in batches:
        losses, logits, olens = eval_step(
            to_device(loader.load(bid, idxs), device))
        ids, out_lens = greedy_decode(logits, olens)
        ids, out_lens = ids.cpu().numpy(), out_lens.cpu().numpy()
        refs = [utts[int(idxs[i])].text for i in range(n_valid)]
        acc.add_batch([vocab.decode(ids[i, : out_lens[i]])
                       for i in range(n_valid)], refs)
        losses = losses.cpu().numpy()[:n_valid]
        fin = np.isfinite(losses) & (losses < -LOG_ZERO / 2)
        total_loss += float(losses[fin].sum())
        n += int(fin.sum())
    return acc, total_loss / max(n, 1)


def train(cfg: Config, train_utts: list[Utterance], vocab: Vocab,
          dev_utts: list[Utterance] | None = None,
          metrics_path: str | None = None, resume: bool = True,
          profile_dir: str | None = None, device: str | torch.device = "cuda",
          loader: BatchLoader | None = None, debug_nans: bool = False):
    """Train ``cfg.model`` on ``train_utts`` → the final TrainState;
    ``debug_nans`` checks every step's loss and gradients
    (``step.backward_finite``)."""
    if cfg.train.keep_checkpoints < 1:
        raise ValueError("train.keep_checkpoints must be >= 1")
    check_trainable(cfg)
    device = torch.device(device)
    log = MetricsLogger(metrics_path)

    sampler = BucketSampler(train_utts, cfg.buckets, seed=cfg.train.seed)
    data_mode = _resolve_data_mode(cfg, sampler)
    if data_mode != "stream":
        raise NotImplementedError(
            f"train.data_mode resolved to {data_mode!r}: the device-resident "
            "corpus cache is not ported yet (ROADMAP.md §1 item 8); pass "
            "--set train.data_mode=stream")
    if loader is None:
        loader = BatchLoader(train_utts, vocab, cfg.buckets,
                             use_cached_features=cfg.features.use_cache)
    if sampler.num_dropped:
        log.log("data", dropped_utts=sampler.num_dropped,
                total_utts=len(train_utts))
    if not sampler.epoch_batches(0):
        raise ValueError(
            "no trainable batches: every utterance was filtered (too long "
            "for the bucket boundaries / max_label_len) or buckets are "
            "smaller than their batch sizes — adjust buckets.* config")
    waste = padding_waste([u.num_frames for u in train_utts], cfg.buckets)
    log.log("data", padding_waste=round(waste, 4),
            buckets=[len(b) for b in sampler.buckets])

    model = build_model(cfg.model)
    init_parameters(model, cfg.train.seed)
    model.to(device)
    state = init_state(model, cfg.optim, cfg.train.seed)
    ckpt = latest_checkpoint(cfg.train.checkpoint_dir) if resume else None
    if ckpt:
        restore_checkpoint(ckpt, state)
        log.log("resume", checkpoint=ckpt, step=state.step)
    train_step = make_train_step(cfg, debug_nans)
    eval_step = make_eval_step(model, cfg)
    log.log("data_mode", mode=data_mode)

    dev_batches = None
    if dev_utts:
        dev_sampler = BucketSampler(dev_utts, cfg.buckets, seed=0)
        dev_loader = BatchLoader(dev_utts, vocab, cfg.buckets,
                                 use_cached_features=cfg.features.use_cache)
        dev_batches = dev_sampler.eval_batches()

    t_last, utts_since = time.perf_counter(), 0
    seen_buckets: set[int] = set()
    epoch = 0
    done = state.step >= cfg.train.total_steps

    # SIGTERM / SIGINT: finish the step in flight, checkpoint, return
    stop_sig: dict = {"num": None}
    prev_handlers: dict = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[s] = signal.signal(
                s, lambda num, frame: stop_sig.__setitem__("num", num))
        except ValueError:          # not the main thread
            pass
    prof = None

    def timed_step(bucket_id, batch):
        """One step; the first hit of a bucket logs its time (kernel build
        and cuDNN planning included), steps 10-14 are profiled."""
        nonlocal prof
        if profile_dir and prof is None and state.step == 10:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                *([torch.profiler.ProfilerActivity.CUDA]
                  if device.type == "cuda" else [])])
            prof.__enter__()
        first = bucket_id not in seen_buckets
        t_c = time.perf_counter()
        m = train_step(state, batch)
        if first:
            _ = float(m["loss"])
            log.log("compile", bucket_id=int(bucket_id),
                    seconds=round(time.perf_counter() - t_c, 2))
            seen_buckets.add(bucket_id)
        if prof is not None and state.step >= 15:
            _stop_profile()
        return m

    def _stop_profile(steps: str = "10-14"):
        nonlocal prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(path)
        prof = None
        log.log("profile", trace=path, steps=steps)

    def crossed(every: int) -> bool:
        return state.step % every == 0

    def bookkeep(m, bucket_id, batch_utts) -> bool:
        nonlocal t_last, utts_since
        utts_since += batch_utts
        step = state.step
        if crossed(cfg.train.log_every):
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            now = time.perf_counter()
            log.log("train", step=step, epoch=epoch, loss=loss,
                    grad_norm=gnorm, valid_frac=float(m["valid_frac"]),
                    utt_per_sec=utts_since / (now - t_last),
                    bucket_id=int(bucket_id))
            t_last, utts_since = now, 0
        if dev_batches and crossed(cfg.train.eval_every):
            acc, dev_loss = evaluate(eval_step, dev_loader, dev_batches,
                                     vocab, dev_utts, device)
            log.log("eval", step=step, cer=acc.cer, loss=dev_loss,
                    num_utts=acc.num_utts)
        if crossed(cfg.train.checkpoint_every):
            path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg,
                                   keep=cfg.train.keep_checkpoints)
            log.log("checkpoint", step=step, path=path)
        if stop_sig["num"] is not None:
            log.log("signal_stop", step=step, signum=int(stop_sig["num"]))
            return True
        return step >= cfg.train.total_steps

    try:
        prior = 0           # batches of the epochs before the current one
        while not done:
            batches = sampler.epoch_batches(epoch)
            # exact resume: skip the batches already consumed this epoch
            consumed = state.step - prior
            if consumed >= len(batches):
                prior += len(batches)
                epoch += 1
                continue
            prefetch = Prefetcher(loader, batches[max(consumed, 0):],
                                  depth=cfg.train.prefetch_depth,
                                  num_workers=cfg.train.loader_workers)
            try:
                for batch in prefetch:
                    bucket_id = batch["bucket_id"]
                    m = timed_step(bucket_id, to_device(batch, device))
                    n_real = (int(batch["sample_weight"].sum())
                              if "sample_weight" in batch
                              else batch["labels"].shape[0])
                    if bookkeep(m, bucket_id, n_real):
                        done = True
                        break
            finally:
                prefetch.stop()
            prior += len(batches)
            epoch += 1
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if prof is not None:            # the run ended inside the window
            _stop_profile("partial")
    save_checkpoint(cfg.train.checkpoint_dir, state, cfg,
                    keep=cfg.train.keep_checkpoints)
    log.close()
    return state
