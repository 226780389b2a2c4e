"""Host-side training loop (port of ``train/loop.py``): feeds the train
step in one of the reference's data modes, with structured metrics,
periodic dev evaluation (greedy, plus the ``train.eval_beam`` and
``train.eval_lm`` columns), keep-N checkpoints and exact resume (data
order included).

Data parallelism (config 5): every rank of the process group runs this
loop on its own device over the same plan (``parallel/mesh.make_mesh``;
the bucket batch sizes must divide over the ranks). Each rank trains on
its segment of every global batch: its own rows in stream mode, its own
shard of the corpus in the cached modes. The parameters and moments are
broadcast from rank 0 after init or resume, the dev eval splits its rows
over the ranks and gathers the results in the global order, and rank 0
alone writes the metrics, the logs and the checkpoints while the others
wait at a barrier.

``_resolve_data_mode`` picks the mode as the reference does:

* "stream": a background ``Prefetcher`` assembles padded host batches,
  each copied to the device and trained on;
* "device_cache" (``auto``'s choice for a corpus within
  ``train.device_cache_budget_gb``): the corpus crosses to the device once
  (``data/device_cache.DeviceCorpusCache``, bf16 features by default) and
  each dispatch of ``train.steps_per_dispatch`` steps sends its [K, B]
  slot ids, copied while the dispatch before runs; on the card a dispatch
  is one CUDA-graph replay (``step.make_cached_train_step``);
* "rotating" (a corpus over the budget): the same steps on fixed-size
  windows of the corpus, the next window filled on a thread while the
  current one trains (``RotatingDeviceCache``, ``rotating_dispatches``).

The step count advances by K a dispatch; logging, evaluation and
checkpoints happen where a dispatch crosses their cadence.
"""

from __future__ import annotations

import concurrent.futures
import os
import signal
import time
from contextlib import ExitStack

import numpy as np
import torch

from ..checkpoint import (latest_checkpoint, restore_checkpoint,
                          save_checkpoint)
from ..config import Config
from ..data.buckets import padding_waste
from ..data.corpus import Utterance
from ..data.device_cache import (DeviceCorpusCache, RotatingDeviceCache,
                                 estimate_bytes, rotating_dispatches)
from ..data.sampler import BatchLoader, BucketSampler, Prefetcher
from ..decode.beam import beam_decode
from ..decode.greedy import greedy_decode
from ..decode.lm import NGramLM, device_lm
from ..decode.metrics import CERAccumulator
from ..models.presets import build_model, init_parameters
from ..ops.ctc import LOG_ZERO
from ..parallel.mesh import (any_rank, broadcast_, dispatch_rows, make_mesh,
                             row_segment)
from ..utils.runtime import TRACE, profile_trace
from ..vocab import Vocab
from .metrics import MetricsLogger
from .state import init_state
from .step import (make_auto_eval, make_cached_train_step, make_train_step,
                   to_device)


def _resolve_data_mode(cfg: Config, sampler: BucketSampler,
                       n_devices: int = 1) -> str:
    """The reference's rule: "stream", "device_cache" or "rotating".
    ``train.device_cache_budget_gb`` is a device's: the corpus fits where
    its bytes are within ``n_devices`` times the budget."""
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


def _greedy_fn(logits, olens) -> list:
    ids, out_lens = greedy_decode(logits, olens)
    ids, out_lens = ids.cpu().numpy(), out_lens.cpu().numpy()
    return [ids[i, : out_lens[i]] for i in range(ids.shape[0])]


def evaluate_multi(eval_fn, loader: BatchLoader, batches, vocab: Vocab,
                   utts, decoders: dict, sink: list | None = None,
                   sink_decoder: str | None = None):
    """One forward pass per batch, scored by SEVERAL decoders at once
    (the reference's ``evaluate_multi``, e.g. {"greedy": None, "beam8":
    fn, "beam8+lm": fn}; decoder value None = greedy on the device, fn
    (logits, olens) → id lists otherwise). ``eval_fn`` takes the host
    batch (``step.make_auto_eval``: over a mesh each rank runs its rows,
    and every rank scores the gathered batch). Only the ``n_valid`` real
    rows of a padded batch are scored, and the mean loss leaves out the
    samples with no alignment (the ``-LOG_ZERO`` sentinel). Returns
    ({name: CERAccumulator}, mean_loss). When ``sink`` is a list,
    ``sink_decoder``'s hypotheses are appended as (utt_index, text)
    pairs: the evaluate CLI's ``--hyp-out``."""
    accs = {name: CERAccumulator() for name in decoders}
    total_loss, n = 0.0, 0
    for entry in batches:
        bid, idxs = entry[0], entry[1]
        n_valid = entry[2] if len(entry) > 2 else len(idxs)
        losses, logits, olens = eval_fn(loader.load(bid, idxs))
        refs = [utts[int(idxs[i])].text for i in range(n_valid)]
        for name, fn in decoders.items():
            hyps = (_greedy_fn if fn is None else fn)(logits, olens)
            # one native edit-distance call per (decoder, batch)
            texts = [vocab.decode(h) for h in hyps[:n_valid]]
            accs[name].add_batch(texts, refs)
            if sink is not None and name == sink_decoder:
                sink.extend((int(idxs[i]), t) for i, t in enumerate(texts))
        losses = losses.cpu().numpy()[:n_valid]
        # impossible CTC samples carry the -LOG_ZERO sentinel loss — drop
        # them from the mean exactly as step.forward_loss's valid mask does
        fin = np.isfinite(losses) & (losses < -LOG_ZERO / 2)
        total_loss += float(losses[fin].sum())
        n += int(fin.sum())
    return accs, total_loss / max(n, 1)


def _slots_to(slots: np.ndarray, device: torch.device) -> torch.Tensor:
    """A dispatch's slot ids on ``device`` (int64; on the card through
    pinned memory, so the copy does not wait for the steps in flight)."""
    t = torch.from_numpy(np.ascontiguousarray(slots, np.int64))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def _state_tensors(state) -> list:
    """Every tensor of the replicated state: parameters, buffers, moments
    and counts."""
    out = list(state.model.state_dict().values())

    def walk(d):
        for v in d.values():
            if isinstance(v, dict):
                walk(v)
            else:
                out.append(v)

    walk(state.opt_state)
    return out


def _local_batches(mesh, batches) -> list:
    """This rank's rows of each global (bucket_id, idxs, n_valid) batch;
    its real rows are those of the global batch's first n_valid in its
    segment."""
    out = []
    for bid, idxs, n_valid in batches:
        seg = row_segment(mesh, len(idxs))
        out.append((bid, idxs[seg],
                    int(np.clip(n_valid - seg.start, 0, len(idxs[seg])))))
    return out


def train(cfg: Config, train_utts: list[Utterance], vocab: Vocab,
          dev_utts: list[Utterance] | None = None,
          metrics_path: str | None = None, resume: bool = True,
          profile_dir: str | None = None, device: str | torch.device = "cuda",
          loader: BatchLoader | None = None, debug_nans: bool = False):
    """Train ``cfg.model`` on ``train_utts`` → the final TrainState (on
    every rank of a data-parallel run: ``parallel/mesh.launch`` starts
    the ranks, each calling this with its own device); ``loader`` feeds
    the training batches from another source (the packed corpus's
    ``data.packed.PackedBatchLoader``; default: a ``BatchLoader`` over the
    wavs); ``debug_nans`` checks every step's loss and gradients
    (``step.backward_finite``; the cached modes then run eagerly)."""
    if cfg.train.keep_checkpoints < 1:
        raise ValueError("train.keep_checkpoints must be >= 1")
    device = torch.device(device)
    mesh = make_mesh(cfg.parallel, device)
    n_dev = mesh.size
    bad = [(i, bs) for i, bs in enumerate(cfg.buckets.batch_sizes)
           if bs % n_dev]
    if bad:
        raise ValueError(
            f"bucket batch sizes {bad} (bucket_id, batch) are not divisible "
            f"by the {n_dev}-device data-parallel mesh — adjust "
            "buckets.batch_sizes or parallel.num_devices")
    with ExitStack() as stack:
        quiet = None
        if not mesh.is_writer:           # rank 0 alone writes and prints
            quiet = stack.enter_context(open(os.devnull, "w"))
            metrics_path = profile_dir = None
        return _train(cfg, train_utts, vocab, dev_utts, metrics_path, resume,
                      profile_dir, device, loader, debug_nans, mesh,
                      MetricsLogger(metrics_path, stream=quiet))


def _train(cfg, train_utts, vocab, dev_utts, metrics_path, resume,
           profile_dir, device, loader, debug_nans, mesh, log):
    n_dev = mesh.size
    sampler = BucketSampler(train_utts, cfg.buckets, seed=cfg.train.seed)
    data_mode = _resolve_data_mode(cfg, sampler, n_dev)
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
    ckpt = latest_checkpoint(cfg.train.checkpoint_dir) if resume else None
    if not ckpt:             # a checkpoint sets every parameter (strictly)
        init_parameters(model, cfg.train.seed)
    model.to(device)
    state = init_state(model, cfg.optim, cfg.train.seed)
    if ckpt:                             # every rank reads it
        restore_checkpoint(ckpt, state)
        log.log("resume", checkpoint=ckpt, step=state.step)
    broadcast_(mesh, _state_tensors(state))

    k_dispatch = 1
    if data_mode in ("device_cache", "rotating"):
        k_dispatch = max(1, cfg.train.steps_per_dispatch)
        features_cfg = cfg.features if cfg.train.cache_features else None
        cache_bytes = estimate_bytes(sampler,
                                     features=cfg.train.cache_features,
                                     cache_dtype=cfg.train.cache_dtype)
        t_c = time.perf_counter()
        if data_mode == "rotating":
            corpus_cache = RotatingDeviceCache(
                loader, sampler,
                budget_bytes=int(cfg.train.device_cache_budget_gb * 1e9
                                 * n_dev),
                device=device, seed=cfg.train.seed,
                features_cfg=features_cfg, cache_dtype=cfg.train.cache_dtype,
                mesh=mesh)
            epoch_batches = (lambda e: corpus_cache.epoch_plan(e, k_dispatch))
            extra = {"n_windows": corpus_cache.n_windows,
                     "corpus_bytes": cache_bytes}
        else:
            corpus_cache = DeviceCorpusCache(
                loader, sampler, device=device, seed=cfg.train.seed,
                features_cfg=features_cfg, cache_dtype=cfg.train.cache_dtype,
                mesh=mesh)
            epoch_batches = (lambda e: corpus_cache.epoch_dispatches(
                e, k_dispatch))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            extra = {"cache_bytes": cache_bytes,
                     "device_bytes": corpus_cache.nbytes(),
                     "build_seconds": round(time.perf_counter() - t_c, 2)}
        train_step = make_cached_train_step(model, cfg, corpus_cache,
                                            k_dispatch, debug_nans, mesh)
        log.log("data_mode", mode=data_mode, steps_per_dispatch=k_dispatch,
                cache_features=cfg.train.cache_features,
                graphs=train_step.graphs, devices=n_dev, **extra)
    else:
        train_step = make_train_step(cfg, debug_nans, mesh)
        epoch_batches = sampler.epoch_batches
        log.log("data_mode", mode=data_mode, devices=n_dev)
    # dev eval rides the same mesh as training: eval_batches pads every
    # batch to its bucket's size, which the check above splits evenly
    eval_fn = make_auto_eval(model, cfg, mesh)

    dev_batches = None
    if dev_utts:
        dev_sampler = BucketSampler(dev_utts, cfg.buckets, seed=0)
        dev_loader = BatchLoader(dev_utts, vocab, cfg.buckets,
                                 use_cached_features=cfg.features.use_cache)
        dev_batches = dev_sampler.eval_batches()

    # periodic-eval decoder columns: greedy always; train.eval_beam adds a
    # prefix-beam column and train.eval_lm a beam+LM column, all from one
    # forward pass a batch (evaluate_multi); the beams split their rows
    # over the mesh
    eval_decoders: dict = {"greedy": None}
    if cfg.train.eval_beam > 0:
        kb = cfg.train.eval_beam

        def _beam_fn(lg, ol, _lm=None, _a=0.0, _b=0.0):
            return beam_decode(lg, ol, beam=kb, lm=_lm, alpha=_a, beta=_b,
                               mesh=mesh)

        eval_decoders["beam"] = _beam_fn
        if cfg.train.eval_lm:
            # "auto": the dense table while it is small, the hashed LM
            # beyond it
            eval_lm = device_lm(
                NGramLM.from_arpa(cfg.train.eval_lm, vocab), "auto")
            eval_decoders["beam_lm"] = (
                lambda lg, ol: _beam_fn(lg, ol, eval_lm,
                                        cfg.train.eval_lm_alpha,
                                        cfg.train.eval_lm_beta))

    if not epoch_batches(0):
        raise ValueError(
            "no trainable batches in the selected data mode — in "
            "device_cache mode every bucket needs at least batch_size/"
            "num_devices utterances per device")

    t_last, utts_since = time.perf_counter(), 0
    seen_buckets: set[int] = set()
    epoch = 0
    # a run that already reached total_steps resumes to a no-op
    done = state.step >= cfg.train.total_steps

    # SIGTERM / SIGINT: finish the dispatch in flight, checkpoint, return
    stop_sig: dict = {"num": None}
    prev_handlers: dict = {}
    for s in (signal.SIGTERM, signal.SIGINT):
        try:
            prev_handlers[s] = signal.signal(
                s, lambda num, frame: stop_sig.__setitem__("num", num))
        except ValueError:          # not the main thread
            pass
    prof = None

    def timed_step(bucket_id, *args):
        """One dispatch (K steps); the first hit of a bucket logs its time
        (kernel build, cuDNN planning and the graph capture included), the
        dispatches that hold steps 10-14 are profiled (whole replays)."""
        nonlocal prof
        if (profile_dir and prof is None
                and state.step <= 10 < state.step + k_dispatch):
            prof = profile_trace(profile_dir, device)
            prof.__enter__()
        first = bucket_id not in seen_buckets
        t_c = time.perf_counter()
        m = train_step(state, *args)
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
        prof.__exit__(None, None, None)
        prof = None
        log.log("profile", trace=os.path.join(profile_dir, TRACE),
                steps=steps)

    def crossed(every: int) -> bool:
        """Did the last dispatch cross a multiple of ``every``?"""
        return (state.step // every) != ((state.step - k_dispatch) // every)

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
            accs, dev_loss = evaluate_multi(eval_fn, dev_loader,
                                            dev_batches, vocab, dev_utts,
                                            eval_decoders)
            extra_cols = {f"cer_{nm}": acc.cer for nm, acc in accs.items()
                          if nm != "greedy"}
            log.log("eval", step=step, cer=accs["greedy"].cer, loss=dev_loss,
                    num_utts=accs["greedy"].num_utts, **extra_cols)
        if crossed(cfg.train.checkpoint_every):
            path = save_checkpoint(cfg.train.checkpoint_dir, state, cfg,
                                   keep=cfg.train.keep_checkpoints,
                                   mesh=mesh)
            log.log("checkpoint", step=step, path=path)
        # every rank stops at the same dispatch, whichever got the signal
        if any_rank(mesh, stop_sig["num"] is not None):
            log.log("signal_stop", step=step,
                    signum=int(stop_sig["num"] or 0))
            return True
        return step >= cfg.train.total_steps

    def cached_utts(bucket_id) -> int:
        return sampler.shapes[bucket_id].batch_size * k_dispatch

    try:
        prior = 0           # dispatches of the epochs before the current one
        while not done:
            batches = epoch_batches(epoch)
            # exact resume: skip the dispatches already consumed this epoch
            consumed = state.step // k_dispatch - prior
            if consumed >= len(batches):
                prior += len(batches)
                epoch += 1
                continue
            todo = batches[max(consumed, 0):]
            if data_mode == "rotating":
                pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="csr-window")
                try:
                    # window w+1 fills the idle buffer set while w trains
                    for bucket_id, slots in rotating_dispatches(
                            corpus_cache, epoch, todo, pool):
                        m = timed_step(bucket_id, bucket_id, _slots_to(
                            dispatch_rows(mesh, slots), device))
                        if bookkeep(m, bucket_id, cached_utts(bucket_id)):
                            done = True
                            break
                finally:
                    pool.shutdown(wait=True, cancel_futures=True)
            elif data_mode == "device_cache":
                # lookahead 1: dispatch k+1's slot ids cross while k runs
                # (this rank's segment of them)
                pending = _slots_to(dispatch_rows(mesh, todo[0][1]), device)
                for i, (bucket_id, _) in enumerate(todo):
                    slots = pending
                    m = timed_step(bucket_id, bucket_id, slots)
                    if i + 1 < len(todo):
                        pending = _slots_to(dispatch_rows(
                            mesh, todo[i + 1][1]), device)
                    if bookkeep(m, bucket_id, cached_utts(bucket_id)):
                        done = True
                        break
            else:
                # each rank loads its own rows of every global batch
                prefetch = Prefetcher(loader, _local_batches(mesh, todo),
                                      depth=cfg.train.prefetch_depth,
                                      num_workers=cfg.train.loader_workers)
                try:
                    for (_, _, n_real), batch in zip(todo, prefetch):
                        bucket_id = batch["bucket_id"]
                        m = timed_step(bucket_id, to_device(batch, device))
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
                    keep=cfg.train.keep_checkpoints, mesh=mesh)
    log.close()
    return state
