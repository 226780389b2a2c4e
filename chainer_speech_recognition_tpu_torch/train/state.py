"""Train state + the optimizer chain (port of ``train/state.py``).

``Optimizer`` writes out ``make_optimizer``'s optax chain on tensors:
``clip_by_global_norm`` → ``adam`` / ``adamw`` / ``sgd(momentum=0.9,
nesterov=True)`` → ``warmup_cosine_decay_schedule`` (linear warmup from 0,
then cosine decay to ``end_lr_scale``). It follows optax's formulas, not
``torch.optim``'s: eps is added outside the square root, the bias
corrections use the incremented count, and the learning rate is read from
the schedule at the count before the increment — so the first update is
exactly 0 (the schedule starts at 0).

The optimizer state has the layout of ``flax.serialization.to_state_dict``
of optax's state, with each moment a dict keyed by the model's state_dict
names (``bridge.opt_state_to_flax`` turns those into the flax tree):

  adam:  {"0": {}, "1": {"0": {count, mu, nu}, "1": {count}}}
  adamw: {"0": {}, "1": {"0": {count, mu, nu}, "1": {}, "2": {count}}}
  sgd:   {"0": {}, "1": {"0": {trace}, "1": {count}}}

Counts are int32 scalars and every number stays on the parameters' device,
so a step needs no host synchronisation. The state is updated in place:
its tensors keep their addresses from ``init`` on (a CUDA graph of cached
steps reads and writes them, ``train/step.make_cached_train_step``), and
so does the update of the parameters (``p += u``, the same value as
optax's ``p + u``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import OptimConfig


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    opt_state: dict
    step: int
    rng: np.ndarray     # uint32[2]: with ``step``, seeds the step's
                        # SpecAugment draws (ops/specaugment.step_generator)


def warmup_cosine(cfg: OptimConfig):
    """optax.warmup_cosine_decay_schedule(init_value=0, ...) as used by the
    reference, on an int32 count tensor → fp32 learning rate tensor."""
    peak = cfg.learning_rate
    end = cfg.learning_rate * cfg.end_lr_scale
    warm = cfg.warmup_steps
    decay = max(cfg.decay_steps, cfg.warmup_steps + 1) - warm
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = count.to(torch.float32)
        if warm <= 0:
            lin = torch.zeros_like(c)
        else:
            frac = 1 - torch.clamp(c, 0, warm) / warm
            lin = (0.0 - peak) * frac + peak
        cc = torch.clamp(c - warm, max=float(decay))
        cos = 0.5 * (1 + torch.cos(math.pi * cc / float(decay)))
        dec = peak * ((1 - alpha) * cos + alpha)
        return torch.where(c < warm, lin, dec)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2)
                          for t in tensors))


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


class Optimizer:
    """``init(params) → state``; ``update(grads, state, params) →
    (updates, state)``; params, grads and updates are dicts keyed by
    state_dict name."""

    def __init__(self, cfg: OptimConfig):
        if cfg.optimizer not in ("adam", "sgd"):
            raise KeyError(f"unknown optimizer {cfg.optimizer}")
        self.cfg = cfg
        self.schedule = warmup_cosine(cfg)

    def init(self, params: dict) -> dict:
        dev = next(iter(params.values())).device
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        sched = {"count": _count(dev)}
        if self.cfg.optimizer == "sgd":
            return {"0": {}, "1": {"0": {"trace": zeros()}, "1": sched}}
        adam = {"count": _count(dev), "mu": zeros(), "nu": zeros()}
        if self.cfg.weight_decay:
            return {"0": {}, "1": {"0": adam, "1": {}, "2": sched}}
        return {"0": {}, "1": {"0": adam, "1": sched}}

    def update(self, grads: dict, state: dict, params: dict):
        """→ (updates, ``state``): each new moment and count is computed
        as optax does, then copied into ``state``'s own tensor, so the
        state keeps its addresses (a captured CUDA graph reads and writes
        them) and the values are optax's bit for bit."""
        cfg = self.cfg
        # clip_by_global_norm
        g_norm = global_norm(grads.values())
        keep = g_norm < cfg.clip_norm
        u = {k: torch.where(keep, g, (g / g_norm) * cfg.clip_norm)
             for k, g in grads.items()}
        inner = state["1"]
        if cfg.optimizer == "sgd":        # trace(0.9, nesterov) → lr
            trace = {k: g + 0.9 * inner["0"]["trace"][k] for k, g in u.items()}
            u = {k: g + 0.9 * trace[k] for k, g in u.items()}
            copy_into(inner["0"]["trace"], trace)
            sched_key = "1"
        else:                             # scale_by_adam (→ decay) → lr
            b1, b2 = cfg.b1, cfg.b2
            st = inner["0"]
            mu = {k: (1 - b1) * g + b1 * st["mu"][k] for k, g in u.items()}
            nu = {k: (1 - b2) * g ** 2 + b2 * st["nu"][k]
                  for k, g in u.items()}
            count = st["count"] + 1
            cf = count.to(torch.float32)
            bc1 = 1 - torch.full((), b1, dtype=torch.float32,
                                 device=cf.device) ** cf
            bc2 = 1 - torch.full((), b2, dtype=torch.float32,
                                 device=cf.device) ** cf
            u = {k: (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + 1e-8)
                 for k in u}
            copy_into(st, {"count": count, "mu": mu, "nu": nu})
            sched_key = "1"
            if cfg.weight_decay:
                u = {k: v + cfg.weight_decay * params[k] for k, v in u.items()}
                sched_key = "2"
        sched_count = inner[sched_key]["count"]
        step_size = -self.schedule(sched_count)
        u = {k: step_size.to(v.dtype) * v for k, v in u.items()}
        sched_count.add_(1)
        return u, state


def copy_into(dst: dict, src: dict) -> None:
    """Copy a (nested) dict of tensors into ``dst``'s tensors in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            copy_into(dst[k], v)
        else:
            dst[k].copy_(v)


def init_state(model: torch.nn.Module, optim_cfg: OptimConfig,
               seed: int) -> TrainState:
    """A fresh state for ``model`` (already initialised and on its device):
    zero moments, step 0."""
    params = {k: p.detach() for k, p in model.named_parameters()}
    return TrainState(model=model,
                      opt_state=Optimizer(optim_cfg).init(params),
                      step=0,
                      rng=np.asarray([0, seed & 0xFFFFFFFF], np.uint32))
