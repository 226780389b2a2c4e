"""Bucketed-by-length batching (the port's copy of the reference's
``data/buckets.py``): bucket boundaries are frame counts, and every batch
of bucket i is padded to that bucket's static shape.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from ..config import BucketConfig


@dataclass(frozen=True)
class BucketShape:
    """The static shapes of one bucket's batches."""
    max_frames: int
    batch_size: int
    max_label_len: int

    @property
    def max_samples(self) -> int:
        # inverse of num_frames: largest N with 1 + N // HOP <= max_frames.
        # N // HOP <= max_frames - 1 admits N up to max_frames·HOP - 1;
        # the previous (max_frames-1)·HOP silently clipped the final
        # ≤ HOP-1 samples (~10 ms) of exactly-boundary utterances
        return self.max_frames * C.HOP_LENGTH - 1


def bucket_shapes(cfg: BucketConfig) -> list[BucketShape]:
    assert len(cfg.boundaries) == len(cfg.batch_sizes)
    return [BucketShape(b, bs, cfg.max_label_len)
            for b, bs in zip(cfg.boundaries, cfg.batch_sizes)]


def assign_bucket(num_frames: np.ndarray, cfg: BucketConfig) -> np.ndarray:
    """Frame counts → bucket index; -1 for utterances exceeding the last
    boundary (dropped, logged by the sampler — no silent truncation)."""
    bounds = np.asarray(cfg.boundaries)
    idx = np.searchsorted(bounds, np.asarray(num_frames), side="left")
    return np.where(idx < len(bounds), idx, -1)


def padding_waste(num_frames: list[int], cfg: BucketConfig) -> float:
    """Fraction of padded frames if each utterance pads to its bucket max —
    the padding-waste metric logged by training (SURVEY.md §5.5)."""
    nf = np.asarray(num_frames)
    idx = assign_bucket(nf, cfg)
    ok = idx >= 0
    if not ok.any():
        return 0.0
    padded = np.asarray(cfg.boundaries)[idx[ok]]
    return float(1.0 - nf[ok].sum() / padded.sum())
