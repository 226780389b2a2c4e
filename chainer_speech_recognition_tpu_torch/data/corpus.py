"""Corpus indexing (the port's copy of the reference's ``data/corpus.py``):
a CSJ-style corpus directory → utterance index, and the index read back.

Layouts accepted by ``cli/preprocess.py``: a root directory containing
``*.wav`` files (anywhere below root) with a sibling ``*.txt`` transcript
of the same stem (``scan_corpus``), or a Kaldi-style directory of
``wav.scp`` + ``text`` (+ optional ``segments``, ``scan_kaldi_style``).
The index is a JSONL file (one utterance per line: id, wav path,
transcript, num_samples) so training never re-walks the corpus.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import sys
import wave
from dataclasses import dataclass

from .. import constants as C
from ..vocab import Vocab


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


def scan_corpus(root: str) -> list[Utterance]:
    """Walk root, pair each wav with its transcript, read lengths."""
    utts = []
    for dirpath, _, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".wav"):
                continue
            wav_path = os.path.join(dirpath, fn)
            txt_path = wav_path[:-4] + ".txt"
            if not os.path.exists(txt_path):
                continue
            with open(txt_path, encoding="utf-8") as f:
                text = f.read().strip()
            try:
                with wave.open(wav_path, "rb") as w:
                    # length at the CONTRACT rate: read_wav resamples
                    # non-16 kHz input, so bucketing/num_frames must use
                    # the post-resample count (int(round(...)) matches
                    # resample_sinc's output length) — native counts would
                    # overstate a 48 kHz wav 3×
                    n = int(round(w.getnframes()
                                  * C.SAMPLE_RATE / w.getframerate()))
            except (wave.Error, OSError, EOFError) as e:
                # one corrupt file must not abort the whole corpus scan
                # (same policy as scan_kaldi_style)
                print(f"warning: skipping unreadable wav {wav_path}: {e}",
                      file=sys.stderr)
                continue
            utt_id = os.path.relpath(wav_path, root)[:-4].replace(os.sep, "/")
            utts.append(Utterance(utt_id, wav_path, text, n))
    return utts


def _read_two_col(path: str) -> dict[str, str]:
    out: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split(None, 1)
            if len(parts) == 2:
                out[parts[0]] = parts[1]
    return out


def scan_kaldi_style(root: str) -> list[Utterance]:
    """Read a Kaldi-style corpus dir: ``wav.scp`` (recording_id → wav path)
    + ``text`` (utt_id → transcript) + optional ``segments``
    (utt_id recording_id start_sec end_sec). The common interchange format
    for CSJ and other licensed corpora (whose own distribution formats
    vary). Without ``segments``, each recording is one utterance. With it,
    utterances are windows into long recordings (a CSJ lecture is one wav);
    loaders slice via Utterance.offset_samples (see load_signal). Order =
    sorted utt_id."""
    wavs = _read_two_col(os.path.join(root, "wav.scp"))
    texts = _read_two_col(os.path.join(root, "text"))

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(root, p)

    utts = []
    seg_path = os.path.join(root, "segments")
    if os.path.exists(seg_path):
        segs: dict[str, tuple[str, float, float]] = {}
        with open(seg_path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) == 4:
                    segs[parts[0]] = (parts[1], float(parts[2]),
                                      float(parts[3]))
        rec_len: dict[str, int] = {}    # recording → samples at contract rate

        def rec_samples(rec_id: str) -> int | None:
            """Recording length at the contract rate; None = unreadable.

            int(round(...)) matches resample_sinc's output-length rounding
            (utils/wav.py) — plain int() truncation could understate a
            non-16 kHz recording by one sample and shave the final sample
            off a segment ending exactly at EOF (ADVICE r2). A missing or
            corrupt wav listed in wav.scp skips its segments with a
            warning instead of aborting the whole corpus scan."""
            if rec_id not in rec_len:
                try:
                    with wave.open(resolve(wavs[rec_id]), "rb") as w:
                        rec_len[rec_id] = int(round(
                            w.getnframes() * C.SAMPLE_RATE
                            / w.getframerate()))
                except (wave.Error, OSError, EOFError) as e:
                    print(f"warning: skipping unreadable recording "
                          f"{rec_id} ({wavs[rec_id]}): {e}", file=sys.stderr)
                    rec_len[rec_id] = None
            return rec_len[rec_id]

        for utt_id in sorted(segs.keys() & texts.keys()):
            rec_id, start, end = segs[utt_id]
            if rec_id not in wavs or end <= start:
                continue
            # offsets/lengths at the CONTRACT rate: read paths resample
            # to SAMPLE_RATE before slicing (utils/wav.py, load_signal).
            # Clamp to the actual recording length — a bad segments line
            # must not overstate num_frames (mis-bucketing / padded-frame
            # waste, ADVICE r1); fully out-of-range segments are skipped.
            total = rec_samples(rec_id)
            if total is None:                       # unreadable recording
                continue
            off = int(round(start * C.SAMPLE_RATE))
            n = min(int(round(end * C.SAMPLE_RATE)), total) - off
            if off >= total or n <= 0:
                continue
            utts.append(Utterance(utt_id, resolve(wavs[rec_id]),
                                  texts[utt_id], n, offset_samples=off))
        return utts

    for utt_id in sorted(wavs.keys() & texts.keys()):
        wav_path = resolve(wavs[utt_id])
        with wave.open(wav_path, "rb") as w:
            # frame counts at the CONTRACT rate so bucketing is correct
            # even for to-be-resampled inputs (utils/wav.py)
            n = int(w.getnframes() * C.SAMPLE_RATE / w.getframerate())
        utts.append(Utterance(utt_id, wav_path, texts[utt_id], n))
    return utts


def normalize_texts(utts: list[Utterance], *, kana: str | None = None,
                    strip_tags: bool = True) -> list[Utterance]:
    """Apply CSJ-style Japanese transcript normalization (data/jptext.py)
    to every utterance; drops utterances whose transcript normalizes to
    empty (pure-filler segments)."""
    from .jptext import normalize

    out = []
    for u in utts:
        t = normalize(u.text, kana=kana, strip_tags=strip_tags)
        if t:
            out.append(dataclasses.replace(u, text=t))
    return out


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


def build_vocab(utts: list[Utterance], unit="char") -> Vocab:
    return Vocab.build([u.text for u in utts], unit=unit)
