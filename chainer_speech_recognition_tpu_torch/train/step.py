"""The train and eval steps (port of ``train/step.py``): front-end →
SpecAugment (train step only, when enabled) → acoustic model → CTC →
weighted sum → backward → (all-reduce over the ranks) → weighted mean →
clip → update, on torch tensors already on the model's device.

With a data-parallel mesh (``parallel/mesh.py``) each rank runs the step
on its rows of the global batch. The loss is Σ(local weighted losses) /
max(Σ over ranks of the weights, 1), as the reference's psum'd
normaliser: a scalar all-reduce sums the weights between the forward and
the backward, each rank back-propagates its local sum over that global
normaliser, and one more all-reduce sums a flat fp32 buffer of every
gradient, the loss and the real-row count. So the result is exact
whatever valid or padded rows each rank holds, and one rank without a
group runs the one-device arithmetic, op for op, less the collectives.

Batches are dicts of padded tensors:
  signals        [B, N_max] float32 PCM   (or features [B,T,F,3] +
  num_samples    [B] int32                 frame_lengths [B] from a
  labels         [B, L_max] int32          cached-feature corpus)
  label_lengths  [B] int32
  sample_weight  [B] float32, optional (0 for padded remainder rows)

A packed corpus (``data/packed.PackedBatchLoader``) gives ``signals_i16``
[B, N_max] int16 PCM in place of ``signals``: it crosses to the device as
int16 and becomes float32 there (``_features``).

``make_cached_train_step`` runs the same step body on rows gathered from
a device-resident corpus (``data/device_cache.py``), K steps a dispatch:
on the card one CUDA-graph replay.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import _kernels
from ..config import Config
from ..frontend import select_frontend
from ..ops.ctc import LOG_ZERO, ctc_loss_scan
from ..ops.ctc_cuda import ctc_loss
from ..ops.specaugment import (apply_specaugment, specaugment_draws,
                               step_generator)
from ..parallel.mesh import all_gather_rows, all_reduce_, shard_batch
from .state import Optimizer, TrainState, global_norm


def _ctc(cfg: Config):
    """train.ctc_impl: "auto" and "pallas" take the kernels' Function (the
    kernels on the card, their plain versions on the CPU); "jnp" takes
    autograd through the plain α recursion."""
    impl = cfg.train.ctc_impl
    table = {"auto": ctc_loss, "pallas": ctc_loss, "jnp": ctc_loss_scan}
    if impl not in table:
        raise ValueError(f"train.ctc_impl={impl!r}: expected one of "
                         f"{tuple(table)}")
    return table[impl]


def _signals(batch: dict) -> torch.Tensor:
    """float32 PCM on the batch's device: int16 batches (the packed
    corpus's wire format, half the host→device bytes) are converted on
    the device, as the reference's ``train/step._signals`` does."""
    if "signals" in batch:
        return batch["signals"]
    return batch["signals_i16"].to(torch.float32) / 32768.0


def _features(cfg: Config, batch: dict):
    if "features" in batch:
        return batch["features"], batch["frame_lengths"]
    return select_frontend(cfg.features)(
        _signals(batch), batch["num_samples"],
        apply_cmvn=cfg.features.cmvn_arg)


def loss_terms(model, cfg: Config, batch: dict, draws=None):
    """The weighted CTC loss SUM and its weights: ``sample_weight``
    (optional) and samples with no valid alignment weigh 0. ``draws``
    (``ops/specaugment.specaugment_draws`` on the batch's device) mask the
    features before the model; None leaves them as they are.
    → (Σ w·loss, Σ w, n_real, logits, out_lens)."""
    feats, flens = _features(cfg, batch)
    if draws is not None:
        feats = apply_specaugment(feats, flens, draws, cfg.specaugment)
    logits, olens = model(feats, flens)
    losses = _ctc(cfg)(logits, olens, batch["labels"], batch["label_lengths"])
    valid = losses < -LOG_ZERO / 2
    real = batch.get("sample_weight")
    real = (torch.ones_like(losses) if real is None
            else real.to(torch.float32))
    w = real * valid.to(torch.float32)
    total = (torch.where(valid, losses, 0.0) * w).sum()
    return total, w.sum(), real.sum(), logits, olens


def forward_loss(model, cfg: Config, batch: dict, draws=None):
    """Weighted-mean CTC loss of one device's batch: ``loss_terms``' sum
    over max(Σ weights, 1). → (loss, (n_valid_real, n_real), logits,
    out_lens)."""
    total, wsum, n_real, logits, olens = loss_terms(model, cfg, batch, draws)
    loss = total / torch.clamp(wsum, min=1.0)
    return loss, (wsum, n_real), logits, olens


def step_draws(cfg: Config, state: TrainState, batch: dict, rank: int = 0):
    """The SpecAugment draws of this step (None when disabled): drawn on the
    CPU from ``step_generator(state.rng, state.step, rank)`` for the
    batch's rows (a rank's own draws differ from the others', as the
    reference folds in ``axis_index``), then copied to the batch's device
    without waiting for it."""
    if not cfg.specaugment.enabled:
        return None
    labels = batch["labels"]
    draws = specaugment_draws(step_generator(state.rng, state.step, rank),
                              labels.shape[0], cfg.specaugment)
    if labels.is_cuda:
        draws = draws.pin_memory().to(labels.device, non_blocking=True)
    return draws


def backward_finite(loss: torch.Tensor, params: dict, step: int) -> None:
    """``loss.backward()`` for ``--debug-nans`` (the reference's
    ``jax_debug_nans``): raise ``FloatingPointError`` naming the step and
    the first non-finite tensor: the loss, a backward function's output
    (as anomaly detection, on in that mode, reports it) or a parameter's
    gradient. Each check reads the device, so the step waits for it."""
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError(f"step {step}: non-finite loss "
                                 f"({float(loss)})")
    try:
        loss.backward()
    except RuntimeError as e:
        if "nan values" not in str(e):
            raise
        raise FloatingPointError(f"step {step}: {e}") from e
    for name, p in params.items():
        if p.grad is not None and not bool(torch.isfinite(p.grad).all()):
            raise FloatingPointError(
                f"step {step}: non-finite gradient of {name}")


def _reduce(mesh, grads: list, scalars: list):
    """One all-reduce over the ranks of a flat fp32 buffer that holds every
    gradient and the scalars (loss, real rows) → the summed gradients
    (views of the buffer) and scalars."""
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack(scalars).to(torch.float32)])
    all_reduce_(mesh, flat)
    sizes = [g.numel() for g in grads]
    parts = torch.split(flat[:-len(scalars)], sizes)
    return ([p.view_as(g) for p, g in zip(parts, grads)],
            list(flat[-len(scalars):].unbind()))


def _step_body(tx, cfg: Config, state: TrainState, batch: dict, draws,
               debug_step: int | None = None, mesh=None) -> dict:
    """One optimizer step's device work on ``state`` (parameters and
    moments updated in place); ``step`` is not advanced. Reads nothing on
    the host unless ``debug_step`` (the step's number for ``--debug-nans``
    errors) asks for the checks, so the same call can be captured in a
    CUDA graph. With a ``mesh`` that has a group, ``batch`` is the rank's
    rows, the weights are summed over the ranks before the backward and
    the gradients and counts after it (module docstring)."""
    model = state.model
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    dp = mesh is not None and mesh.distributed
    total, n_valid, n_real, _, _ = loss_terms(model, cfg, batch, draws)
    if dp:
        all_reduce_(mesh, n_valid)
    loss = total / torch.clamp(n_valid, min=1.0)
    if debug_step is not None:
        backward_finite(loss, params, debug_step)
    else:
        loss.backward()
    names = list(params)
    grads = [params[k].grad for k in names]
    loss = loss.detach()
    if dp:
        grads, (loss, n_real) = _reduce(mesh, grads, [loss, n_real])
    grads = dict(zip(names, grads))
    gnorm = global_norm(grads.values())
    with torch.no_grad():
        updates, _ = tx.update(grads, state.opt_state,
                               {k: p.detach() for k, p in params.items()})
        for k, p in params.items():
            p.add_(updates[k])
            p.grad = None
    return {"loss": loss, "grad_norm": gnorm,
            "valid_frac": n_valid / torch.clamp(n_real, min=1.0)}


def make_train_step(cfg: Config, debug_nans: bool = False,
                    mesh=None) -> Callable:
    """→ ``train_step(state, batch) -> metrics``: one optimizer step on
    ``state`` (parameters and moments updated in place, step + 1);
    metrics ``loss``, ``grad_norm`` (before clipping) and ``valid_frac``
    are 0-d tensors on the device, read only when logged. ``debug_nans``
    checks the loss and every gradient (``backward_finite``). With a
    ``mesh``, ``batch`` is this rank's rows (``parallel.mesh.
    shard_batch``) and the metrics are the global batch's."""
    tx = Optimizer(cfg.optim)
    rank = 0 if mesh is None else mesh.rank

    def train_step(state: TrainState, batch: dict) -> dict:
        m = _step_body(tx, cfg, state, batch,
                       step_draws(cfg, state, batch, rank),
                       state.step + 1 if debug_nans else None, mesh)
        state.step += 1
        return m

    return train_step


def _gather(bucket: dict, idx: torch.Tensor) -> dict:
    """One batch's rows of a cached bucket (the reference's ``jnp.take``)."""
    return {k: v.index_select(0, idx) for k, v in bucket.items()}


def _mean_metrics(ms: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in ms]).mean(0) for k in ms[0]}


class _Replay:
    """One CUDA graph of K cached steps on one bucket's buffers, with the
    static inputs it reads (slot ids, SpecAugment draws), the metrics it
    writes and the kernel launches captured in it."""

    def __init__(self, K: int, B: int, n_draws: int, device):
        self.graph = torch.cuda.CUDAGraph()
        self.slots = torch.zeros((K, B), dtype=torch.int64, device=device)
        self.draws = self.draws_host = self.copied = None
        if n_draws:
            self.draws = torch.zeros((K, n_draws, 2, B), device=device)
            self.draws_host = torch.zeros((K, n_draws, 2, B),
                                          pin_memory=True)
        self.metrics: dict = {}
        self.launches: dict = {}


def make_cached_train_step(model, cfg: Config, corpus_cache,
                           steps_per_dispatch: int = 1,
                           debug_nans: bool = False, mesh=None, *,
                           _eager: bool = False) -> Callable:
    """Train step fed from a device-resident corpus
    (``data/device_cache.py``; reference ``make_cached_train_step``):
    ``call(state, bucket_id, slot_ids) -> metrics``, ``slot_ids`` [K, B]
    (or [B] for K = 1) on the model's device: with a ``mesh``, this
    rank's [K, B/n] segment (``parallel.mesh.dispatch_rows``) of local
    slot ids into its own shard of the corpus. Each of the K steps gathers
    its rows from ``corpus_cache.buckets[bucket_id]`` (read at call time:
    the rotating cache swaps it) and runs the body of ``make_train_step``
    with the SpecAugment draws of ``step_generator(state.rng, state.step
    + j, rank)``; the metrics are averaged over the K steps. Each step's
    all-reduce over the ranks (NCCL) is captured in the graph with it;
    the eager first dispatch is the collective that precedes the capture.

    On the CPU the K steps run eagerly. On the card one dispatch is one
    replay of a CUDA graph of the K steps, one graph a bucket's buffers:
    the first dispatch on them runs eagerly on a side stream (the warm-up
    capture asks for), then the graph is captured; before each replay the
    host copies only the slot ids and the draws (from one pinned buffer)
    into the graph's static inputs. Each replay adds the kernel launches
    captured in the graph to ``_kernels``' counts. A failed capture or
    replay raises. ``debug_nans`` (its checks read the host) and
    ``_eager`` (for holding the replay against eager steps) run every
    dispatch eagerly."""
    tx = Optimizer(cfg.optim)
    K = max(1, steps_per_dispatch)
    rank = 0 if mesh is None else mesh.rank
    device = next(model.parameters()).device
    graphs = device.type == "cuda" and not (debug_nans or _eager)
    replays: dict = {}

    def draws_of(state, B: int, K_: int):
        if not cfg.specaugment.enabled:
            return None
        return torch.stack([specaugment_draws(
            step_generator(state.rng, state.step + j, rank), B,
            cfg.specaugment) for j in range(K_)])

    def run_steps(state, bucket, slots, draws, first_step=None):
        ms = []
        for j in range(slots.shape[0]):
            ms.append(_step_body(
                tx, cfg, state, _gather(bucket, slots[j]),
                None if draws is None else draws[j],
                None if first_step is None else first_step + j, mesh))
        return _mean_metrics(ms)

    def eager(state, bucket, slots):
        draws = draws_of(state, slots.shape[1], slots.shape[0])
        if draws is not None and slots.is_cuda:
            draws = draws.pin_memory().to(slots.device, non_blocking=True)
        m = run_steps(state, bucket, slots, draws,
                      state.step + 1 if debug_nans else None)
        state.step += slots.shape[0]
        return m

    def first_dispatch(state, bucket, slots, key) -> dict:
        """Warm-up (this dispatch's K steps, eagerly on a side stream),
        then the capture of the graph that later dispatches replay."""
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            m = eager(state, bucket, slots)
        torch.cuda.current_stream(device).wait_stream(side)
        n_draws = (cfg.specaugment.num_time_masks
                   + cfg.specaugment.num_freq_masks
                   if cfg.specaugment.enabled else 0)
        r = _Replay(K, slots.shape[1], n_draws, device)
        for p in model.parameters():
            p.grad = None
        # thread_local: a rotating cache's fetch thread may allocate, pin
        # and launch on its own stream while this thread captures
        with _kernels.capturing() as r.launches, torch.cuda.graph(
                r.graph, capture_error_mode="thread_local"):
            r.metrics = run_steps(state, bucket, r.slots, r.draws)
        replays[key] = r
        return m

    def replay(state, r: _Replay, slots) -> dict:
        r.slots.copy_(slots, non_blocking=True)
        if r.draws is not None:
            if r.copied is not None:
                r.copied.synchronize()   # the last copy out of draws_host
            r.draws_host.copy_(draws_of(state, r.slots.shape[1], K))
            r.draws.copy_(r.draws_host, non_blocking=True)
            r.copied = torch.cuda.Event()
            r.copied.record()
        r.graph.replay()
        _kernels.add_launches(r.launches)
        state.step += K
        return {k: v.clone() for k, v in r.metrics.items()}

    def call(state: TrainState, bucket_id: int, slot_ids) -> dict:
        if state.model is not model:
            raise ValueError("cached train step: state.model is not the "
                             "model the step was built for")
        bucket = corpus_cache.buckets[bucket_id]
        slots = torch.as_tensor(slot_ids).to(torch.int64)
        if slots.dim() == 1:
            slots = slots[None]
        if slots.shape[0] != K:
            raise ValueError(f"cached train step: {slots.shape[0]} steps of "
                             f"slot ids, expected {K}")
        if not graphs:
            return eager(state, bucket, slots)
        key = (bucket_id,) + tuple(t.data_ptr() for t in bucket.values())
        r = replays.get(key)
        if r is None:
            return first_dispatch(state, bucket, slots, key)
        return replay(state, r, slots)

    call.graphs = graphs
    return call


def make_eval_step(model, cfg: Config) -> Callable:
    """``eval_step(batch) → (per-utterance CTC loss [B], logits, out_lens)``
    without autograd and without SpecAugment: the residual-free RNN
    kernel, the CTC forward kernel and no backward state."""

    @torch.no_grad()
    def eval_step(batch: dict):
        feats, flens = _features(cfg, batch)
        logits, olens = model(feats, flens)
        losses = ctc_loss(logits, olens, batch["labels"],
                          batch["label_lengths"])
        return losses, logits, olens

    return eval_step


def to_device(batch: dict, device: torch.device) -> dict:
    """Host batch (numpy) → tensors on ``device`` in their host dtypes (a
    packed batch's ``signals_i16`` crosses as int16 and becomes float32 on
    the device, ``_features``); on the card through pinned memory, so
    the copy does not wait for the steps in flight."""
    out = {}
    for k, v in batch.items():
        if k == "bucket_id":
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def make_auto_eval(model, cfg: Config, mesh=None) -> Callable:
    """Eval over HOST batches (reference ``make_auto_eval``, the train
    loop's and the evaluate CLI's): ``call(batch) → (losses, logits,
    olens)`` of the whole batch on the model's device. With a mesh of
    more than one rank (the reference's ``make_sharded_eval_step``) only
    this rank's rows cross to the device and run the forward, and the
    per-utterance losses, logits and lengths of every rank are gathered
    in the global row order, so the decoders see the whole batch on
    every rank; else the batch runs whole."""
    device = next(model.parameters()).device
    step = make_eval_step(model, cfg)
    if mesh is None or mesh.size == 1:
        return lambda batch: step(to_device(batch, device))

    def call(batch: dict):
        out = step(to_device(shard_batch(mesh, batch), device))
        return tuple(all_gather_rows(mesh, x) for x in out)

    return call
