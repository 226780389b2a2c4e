"""Utterance index (the port's copy of the parts of the reference's
``data/corpus.py`` that training reads): the ``Utterance`` record, JSONL
index read/write, and segment-aware signal loading. Corpus scanning and
text normalisation stay with the reference's preprocessing CLI.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from dataclasses import dataclass

from .. import constants as C


@dataclass(frozen=True)
class Utterance:
    utt_id: str
    wav: str
    text: str
    num_samples: int
    feat: str | None = None     # optional cached-feature .npy (SURVEY §2.1)
    offset_samples: int = 0     # segment start within the recording (at the
                                # contract rate) — Kaldi ``segments`` support

    @property
    def num_frames(self) -> int:
        return C.num_frames(self.num_samples)


class RecordingCache:
    """Tiny decoded-recording memo for segment-style corpora, where many
    utterances slice one long wav: without it, loading N segments decodes
    the recording N times. Two slots cover the sequential access patterns
    of both pack_corpus and the (per-worker) batch loaders."""

    def __init__(self, read_fn, maxsize: int = 2):
        self.read_fn = read_fn
        self.maxsize = maxsize
        self._slots: collections.OrderedDict = collections.OrderedDict()

    def __call__(self, path: str):
        if path in self._slots:
            self._slots.move_to_end(path)
            return self._slots[path]
        sig = self.read_fn(path)
        self._slots[path] = sig
        if len(self._slots) > self.maxsize:
            self._slots.popitem(last=False)
        return sig


def load_signal(u: Utterance, read_fn):
    """Read an utterance's PCM, honoring its segment window. ``read_fn``
    maps wav path → float32 PCM at the contract rate (utils/wav.read_wav or
    a RecordingCache around it)."""
    sig = read_fn(u.wav)
    if u.offset_samples or len(sig) > u.num_samples:
        sig = sig[u.offset_samples: u.offset_samples + u.num_samples]
    return sig


def save_index(path: str, utts: list[Utterance]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for u in utts:
            f.write(json.dumps(dataclasses.asdict(u), ensure_ascii=False) + "\n")


def load_index(path: str) -> list[Utterance]:
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                utts.append(Utterance(**json.loads(line)))
    return utts
