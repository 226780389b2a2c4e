"""Packed binary corpus (the port's copy of the reference's
``data/packed.py``): one mmap-able PCM blob + one metadata sidecar, the
CSRPACK1 wire format that ``preprocess --pack`` writes and the train and
evaluate CLIs read.

* ``corpus.pack``     — ``MAGIC`` then all utterances' int16 PCM
  concatenated (little-endian), read back via ``np.memmap``: batch
  assembly is page-cache memcpy, no ``open()``/RIFF parse per utterance;
* ``corpus.meta.npz`` — offsets/lengths, label ids pre-encoded at pack
  time (no per-batch ``vocab.encode``), transcripts, utt ids;
* ``corpus.vocab.txt`` — the vocab the label ids were encoded with.

Batches leave the host as **int16** (``signals_i16``, half the bytes of
float32 over the host→device copy) and become float32 on the device
(``train/step._features``).
"""

from __future__ import annotations

import os

import numpy as np

from .. import constants as C
from ..vocab import Vocab
from ..utils.wav import read_wav
from .buckets import BucketShape, bucket_shapes
from .corpus import RecordingCache, Utterance, load_signal

MAGIC = b"CSRPACK1"


def pack_corpus(out_prefix: str, utts: list[Utterance], vocab: Vocab,
                read_fn=read_wav) -> tuple[str, str]:
    """Write ``{out_prefix}.pack`` + ``{out_prefix}.meta.npz``; returns paths."""
    pack_path = out_prefix + ".pack"
    meta_path = out_prefix + ".meta.npz"
    offsets = np.zeros(len(utts), np.int64)
    num_samples = np.zeros(len(utts), np.int64)
    label_offsets = np.zeros(len(utts) + 1, np.int64)
    labels_flat: list[np.ndarray] = []
    tmp = pack_path + ".tmp"
    cached_read = RecordingCache(read_fn)   # segment corpora slice long wavs
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        pos = 0
        for i, u in enumerate(utts):
            sig = load_signal(u, cached_read)
            pcm = np.clip(np.asarray(sig) * 32768.0, -32768, 32767).astype("<i2")
            f.write(pcm.tobytes())
            offsets[i] = pos
            num_samples[i] = len(pcm)
            pos += len(pcm)
            ids = np.asarray(vocab.encode(u.text), np.int32)
            labels_flat.append(ids)
            label_offsets[i + 1] = label_offsets[i] + len(ids)
    os.replace(tmp, pack_path)
    np.savez(
        meta_path,
        offsets=offsets, num_samples=num_samples,
        labels_flat=(np.concatenate(labels_flat) if labels_flat
                     else np.zeros(0, np.int32)),
        label_offsets=label_offsets,
        texts=np.asarray([u.text for u in utts]),
        utt_ids=np.asarray([u.utt_id for u in utts]),
        sample_rate=np.int64(C.SAMPLE_RATE))
    # the encoding vocab travels WITH the pack: labels_flat is meaningless
    # under any other id assignment, and the evaluate CLI's mismatch guard
    # can only fire when this sidecar exists
    vocab.save(out_prefix + ".vocab.txt")
    return pack_path, meta_path


class PackedCorpus:
    """mmap view over a packed corpus; drop-in utterance list provider."""

    def __init__(self, out_prefix: str):
        self.pack_path = out_prefix + ".pack"
        self.meta_path = out_prefix + ".meta.npz"
        with open(self.pack_path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{self.pack_path}: not a CSRPACK1 file")
        meta = np.load(self.meta_path, allow_pickle=False)
        if int(meta["sample_rate"]) != C.SAMPLE_RATE:
            raise ValueError(
                f"{self.pack_path}: packed at {int(meta['sample_rate'])} Hz, "
                f"framework constant is {C.SAMPLE_RATE} Hz")
        self.offsets = meta["offsets"]
        self.num_samples = meta["num_samples"]
        self.labels_flat = meta["labels_flat"]
        self.label_offsets = meta["label_offsets"]
        self.texts = [str(t) for t in meta["texts"]]
        self.utt_ids = [str(t) for t in meta["utt_ids"]]
        self.pcm = np.memmap(self.pack_path, dtype="<i2", mode="r",
                             offset=len(MAGIC))

    def __len__(self) -> int:
        return len(self.offsets)

    def utterances(self) -> list[Utterance]:
        """Sampler-compatible view (wav path points back at the pack)."""
        return [Utterance(self.utt_ids[i], self.pack_path, self.texts[i],
                          int(self.num_samples[i]))
                for i in range(len(self))]

    def signal_i16(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.pcm[o : o + int(self.num_samples[i])]

    def signal(self, i: int) -> np.ndarray:
        return self.signal_i16(i).astype(np.float32) / 32768.0

    def label_ids(self, i: int) -> np.ndarray:
        return self.labels_flat[int(self.label_offsets[i]):
                                int(self.label_offsets[i + 1])]


class PackedBatchLoader:
    """(bucket_id, utt indices) → padded int16 host batch (static shapes).

    Same contract as data.sampler.BatchLoader but sourced from a
    PackedCorpus: assembly is memmap slice-copies (no syscalls, no text
    encode) and the signal tensor stays int16 until it is on the device.
    """

    def __init__(self, corpus: PackedCorpus, bucket_cfg):
        self.corpus = corpus
        self.shapes = bucket_shapes(bucket_cfg)

    def load(self, bucket_id: int, idxs: np.ndarray,
             n_valid: int | None = None) -> dict:
        shape: BucketShape = self.shapes[bucket_id]
        B = len(idxs)
        extra = {}
        if n_valid is not None and n_valid < B:   # masked remainder padding
            extra["sample_weight"] = (
                np.arange(B) < n_valid).astype(np.float32)
        signals = np.zeros((B, shape.max_samples), np.int16)
        num_samples = np.zeros(B, np.int32)
        labels = np.full((B, shape.max_label_len), C.PAD_LABEL_ID, np.int32)
        label_lengths = np.zeros(B, np.int32)
        for i, u_idx in enumerate(idxs):
            j = int(u_idx)
            sig = self.corpus.signal_i16(j)
            n = min(len(sig), shape.max_samples)
            signals[i, :n] = sig[:n]
            num_samples[i] = n
            ids = self.corpus.label_ids(j)
            labels[i, : len(ids)] = ids
            label_lengths[i] = len(ids)
        return {"signals_i16": signals, "num_samples": num_samples,
                "labels": labels, "label_lengths": label_lengths,
                "bucket_id": bucket_id, **extra}
