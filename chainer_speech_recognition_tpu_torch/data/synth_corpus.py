"""Direct-to-pack synthetic corpus generation (the port's copy of the
reference's ``data/synth_corpus.py``): streams tones-style int16 PCM
(``data/synthetic.make_utterance``) straight into the CSRPACK1 container
(``data/packed.py``) plus its metadata sidecar and vocab file, at disk
speed, for corpora too large to write as one wav per utterance.
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import constants as C
from ..vocab import Vocab
from .packed import MAGIC
from .synthetic import make_utterance


def synthesize_packed(prefix: str, n_utts: int, vocab_size: int = 64,
                      max_samples: int = 1023 * C.HOP_LENGTH,
                      min_labels: int = 8, max_labels: int = 24,
                      seed: int = 7, log_every: int = 0) -> dict:
    """Write ``{prefix}.pack`` / ``.meta.npz`` / ``.vocab.txt``.

    Every utterance is near-full-length (tone_len = max_samples // n_lab),
    so corpus bytes ≈ n_utts × max_samples × 2. Idempotent: returns
    immediately when all three outputs already exist. Returns
    {"bytes": pack size, "seconds": build time, "built": bool}.
    """
    pack_path, meta_path = prefix + ".pack", prefix + ".meta.npz"
    vocab_path = prefix + ".vocab.txt"
    if all(os.path.exists(p) for p in (pack_path, meta_path, vocab_path)):
        # reuse only if the existing pack matches THIS request — a stale
        # pack from a smaller run would silently shrink the demonstration
        with np.load(meta_path) as meta:
            longest = int(meta["num_samples"].max(initial=0))
            # every synthesized utterance is near-full-length, so the
            # longest recorded one brackets the max_samples it was built with
            if (len(meta["offsets"]) == n_utts
                    and max_samples * 0.8 <= longest <= max_samples):
                return {"bytes": os.path.getsize(pack_path), "seconds": 0.0,
                        "built": False}
        print(f"[synth_corpus] existing {prefix}.pack does not match "
              f"(n_utts/max_samples) — rebuilding", flush=True)
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    offsets = np.zeros(n_utts, np.int64)
    num_samples = np.zeros(n_utts, np.int64)
    texts: list[str] = []
    tmp = pack_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        pos = 0
        for i in range(n_utts):
            n_lab = int(rng.integers(min_labels, max_labels + 1))
            ids: list[int] = []
            for _ in range(n_lab):          # no adjacent repeats: clean CTC
                k = int(rng.integers(1, vocab_size))
                while ids and k == ids[-1]:
                    k = int(rng.integers(1, vocab_size))
                ids.append(k)
            sig, _ = make_utterance(rng, ids, tone_len=max_samples // n_lab,
                                    vocab_size=vocab_size)
            sig = sig[:max_samples]
            pcm = np.clip(sig * 32768.0, -32768, 32767).astype("<i2")
            f.write(pcm.tobytes())
            offsets[i] = pos
            num_samples[i] = len(pcm)
            pos += len(pcm)
            texts.append("".join(chr(0x3042 + k) for k in ids))
            if log_every and (i + 1) % log_every == 0:
                print(f"[synth_corpus] {i + 1}/{n_utts} utts, "
                      f"{pos / 1e9:.2f} GB", flush=True)
    os.replace(tmp, pack_path)
    vocab = Vocab.build(texts)
    # label ids are encoded via the BUILT vocab so pack labels ==
    # vocab.encode(text) exactly
    labels_flat = [np.asarray(vocab.encode(t), np.int32) for t in texts]
    label_offsets = np.zeros(n_utts + 1, np.int64)
    for i, ids_arr in enumerate(labels_flat):
        label_offsets[i + 1] = label_offsets[i] + len(ids_arr)
    np.savez(meta_path, offsets=offsets, num_samples=num_samples,
             labels_flat=np.concatenate(labels_flat),
             label_offsets=label_offsets,
             texts=np.asarray(texts), utt_ids=np.asarray(
                 [f"u{i:06d}" for i in range(n_utts)]),
             sample_rate=np.int64(C.SAMPLE_RATE))
    vocab.save(vocab_path)
    return {"bytes": os.path.getsize(pack_path),
            "seconds": round(time.perf_counter() - t0, 1), "built": True}
