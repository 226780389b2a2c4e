"""The train and eval steps (port of ``train/step.py``, one device):
front-end → SpecAugment (train step only, when enabled) → acoustic model →
CTC → weighted mean → backward → clip → update, on torch tensors already
on the model's device.

Batches are dicts of padded tensors:
  signals        [B, N_max] float32 PCM   (or features [B,T,F,3] +
  num_samples    [B] int32                 frame_lengths [B] from a
  labels         [B, L_max] int32          cached-feature corpus)
  label_lengths  [B] int32
  sample_weight  [B] float32, optional (0 for padded remainder rows)

A packed corpus (``data/packed.PackedBatchLoader``) gives ``signals_i16``
[B, N_max] int16 PCM in place of ``signals``: it crosses to the device as
int16 and becomes float32 there (``_features``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import Config
from ..frontend import select_frontend
from ..ops.ctc import LOG_ZERO, ctc_loss_scan
from ..ops.ctc_cuda import ctc_loss
from ..ops.specaugment import (apply_specaugment, specaugment_draws,
                               step_generator)
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


def forward_loss(model, cfg: Config, batch: dict, draws=None):
    """Weighted-mean CTC loss: ``sample_weight`` (optional) and samples with
    no valid alignment weigh 0; the normaliser is max(Σ weights, 1).
    ``draws`` (``ops/specaugment.specaugment_draws`` on the batch's device)
    mask the features before the model; None leaves them as they are.
    → (loss, (n_valid_real, n_real), logits, out_lens)."""
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
    total = w.sum()
    loss = (torch.where(valid, losses, 0.0) * w).sum() / torch.clamp(
        total, min=1.0)
    return loss, (total, real.sum()), logits, olens


def check_trainable(cfg: Config) -> None:
    """Raise for the training options the port does not run yet."""
    if cfg.parallel.num_devices > 1:
        raise NotImplementedError(
            f"parallel.num_devices={cfg.parallel.num_devices}: data "
            "parallelism is not ported yet (ROADMAP.md, module queue: data "
            "parallelism); the port trains on one device")


def step_draws(cfg: Config, state: TrainState, batch: dict):
    """The SpecAugment draws of this step (None when disabled): drawn on the
    CPU from ``step_generator(state.rng, state.step)``, then copied to the
    batch's device without waiting for it."""
    if not cfg.specaugment.enabled:
        return None
    labels = batch["labels"]
    draws = specaugment_draws(step_generator(state.rng, state.step),
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


def make_train_step(cfg: Config, debug_nans: bool = False) -> Callable:
    """→ ``train_step(state, batch) -> metrics``: one optimizer step on
    ``state`` (parameters and moments updated in place, step + 1);
    metrics ``loss``, ``grad_norm`` (before clipping) and ``valid_frac``
    are 0-d tensors on the device, read only when logged. ``debug_nans``
    checks the loss and every gradient (``backward_finite``)."""
    check_trainable(cfg)
    tx = Optimizer(cfg.optim)

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss, (n_valid, n_real), _, _ = forward_loss(
            model, cfg, batch, step_draws(cfg, state, batch))
        if debug_nans:
            backward_finite(loss, params, state.step + 1)
        else:
            loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        gnorm = global_norm(grads.values())
        with torch.no_grad():
            updates, state.opt_state = tx.update(
                grads, state.opt_state,
                {k: p.detach() for k, p in params.items()})
            for k, p in params.items():
                p.add_(updates[k])
                p.grad = None
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": gnorm,
                "valid_frac": n_valid / torch.clamp(n_real, min=1.0)}

    return train_step


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
