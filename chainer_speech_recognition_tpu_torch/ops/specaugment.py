"""SpecAugment-style time and frequency masking of the features in the
train step (port of ``ops/specaugment.py``; config 3, ``bilstm_deep``).

The reference samples and masks in one function from a ``jax.random``
key. The port splits the two:

* ``specaugment_draws(gen, batch, cfg)``: the random numbers, drawn on the
  CPU from a ``torch.Generator`` in the reference's order (time masks
  first, then frequency masks; for each mask a [B] integer width in
  [0, max] before a [B] uniform in [0, 1) that places it);
* ``apply_specaugment(feats, lengths, draws, cfg)``: the masking for given
  draws, on the features' device, exactly as the reference computes it:
  a time mask starts at ``floor(u · max(len − width, 1))``, a frequency
  mask at ``floor(u · max(F − width, 1))``, and the masks multiply.

torch cannot reproduce JAX's threefry key folding (``train/step.py`` folds
the state's key with the step and the device index), so the port has its
own rule: ``step_generator(rng, step)`` seeds the CPU generator from the
train state's key and step. The card and the CPU therefore mask the same
frames, and a resumed run draws what an unbroken one would have.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SpecAugmentConfig


def step_generator(rng, step: int, rank: int = 0) -> torch.Generator:
    """A CPU generator determined by the train state's ``rng`` (uint32[2]),
    ``step`` and the data-parallel ``rank`` (folded in above 0, so rank 0
    draws what one device draws)."""
    words = [int(x) for x in np.asarray(rng, np.uint32).ravel()]
    words.append(int(step))
    if rank:
        words.append(int(rank))
    seed = np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2**63 - 1))


def specaugment_draws(gen: torch.Generator, batch: int,
                      cfg: SpecAugmentConfig) -> torch.Tensor:
    """→ [num_time_masks + num_freq_masks, 2, batch] float32 CPU tensor:
    per mask, the widths (integers, exact in float32) and the uniforms."""
    rows = []
    for n_masks, max_width in ((cfg.num_time_masks, cfg.time_mask_max),
                               (cfg.num_freq_masks, cfg.freq_mask_max)):
        for _ in range(n_masks):
            width = torch.randint(0, max_width + 1, (batch,), generator=gen)
            u = torch.rand((batch,), generator=gen)
            rows.append(torch.stack([width.to(torch.float32), u]))
    if not rows:
        return torch.zeros((0, 2, batch))
    return torch.stack(rows)


def _mask(idx, extent, draws, dtype):
    """Product over masks of (1 − hit) for positions ``idx`` [1, N] given
    each row's valid extent [B, 1] (int32) and the masks' draws."""
    mask = torch.ones((extent.shape[0], idx.shape[1]), dtype=dtype,
                      device=idx.device)
    for width_f, u in draws:
        width = width_f.to(torch.int32)[:, None]
        start = (u[:, None] * torch.clamp(extent - width, min=1).to(
            torch.float32)).to(torch.int32)
        hit = (idx >= start) & (idx < start + width)
        mask = mask * (1.0 - hit.to(dtype))
    return mask


def apply_specaugment(feats: torch.Tensor, lengths: torch.Tensor,
                      draws: torch.Tensor,
                      cfg: SpecAugmentConfig) -> torch.Tensor:
    """feats [B, T, F, C] → masked feats; ``lengths`` [B] valid frames;
    ``draws`` from ``specaugment_draws`` on the features' device."""
    if not cfg.enabled:
        return feats
    B, T, F, _ = feats.shape
    dev = feats.device
    nt = cfg.num_time_masks
    tmask = _mask(torch.arange(T, dtype=torch.int32, device=dev)[None],
                  lengths.to(device=dev, dtype=torch.int32)[:, None],
                  draws[:nt], feats.dtype)
    fmask = _mask(torch.arange(F, dtype=torch.int32, device=dev)[None],
                  torch.full((B, 1), F, dtype=torch.int32, device=dev),
                  draws[nt:], feats.dtype)
    return feats * tmask[:, :, None, None] * fmask[:, None, :, None]
