"""Synthetic tone utterances (the port's copy of ``make_utterance`` and
``tone_frequency`` from the reference's ``data/synthetic.py``): each vocab
symbol is a pure tone at a distinct frequency, a nearly linearly separable
audio→symbol map for smoke runs and tests that need no external corpus.
``write_tone_corpus`` writes such a corpus as a training data directory.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C
from ..frontend.golden_np import _hz_to_mel_slaney, _mel_to_hz_slaney


def tone_frequency(k: int, vocab_size: int | None = None) -> float:
    """Symbol id (1-based) → tone frequency in Hz.

    Small vocabularies keep the legacy linear map (200 + 150k Hz — all of
    it sits comfortably inside the mel range). Large vocabularies are
    spaced UNIFORMLY ON THE MEL SCALE within the filterbank's usable band:
    with the linear map, ids above (MEL_FMAX-200)/150 ≈ 52 would fall
    outside every mel triangle (zero feature energy → unlearnable symbol —
    this exact bug put a ~0.36 CER floor on the 82-symbol parity corpus),
    and high-frequency neighbours would share coarse mel bins.
    """
    if vocab_size is None or vocab_size <= 40:
        return 200.0 + 150.0 * k

    lo = _hz_to_mel_slaney(np.float64(300.0))
    hi = _hz_to_mel_slaney(np.float64(min(C.MEL_FMAX, C.SAMPLE_RATE / 2)
                                      * 0.92))
    # ids are 1-based; id 0 is the CTC blank and never synthesized
    frac = (k - 0.5) / max(vocab_size - 1, 1)
    return float(_mel_to_hz_slaney(lo + frac * (hi - lo)))


def make_utterance(rng: np.random.Generator, label_ids, tone_len=1600,
                   noise=0.05, sr=C.SAMPLE_RATE, vocab_size=None):
    """label ids (1-based) → (signal float32, labels int32)."""
    segs = []
    for k in label_ids:
        freq = tone_frequency(int(k), vocab_size)
        t = np.arange(tone_len) / sr
        phase = rng.uniform(0, 2 * np.pi)
        segs.append(np.sin(2 * np.pi * freq * t + phase))
    sig = np.concatenate(segs) if segs else np.zeros(tone_len)
    sig = sig + noise * rng.standard_normal(len(sig))
    return sig.astype(np.float32), np.asarray(label_ids, np.int32)


def write_tone_corpus(root: str, rng: np.random.Generator,
                      splits: dict[str, int], vocab_size: int,
                      seconds: tuple[float, float],
                      symbols_per_second: float = 10.0):
    """Write a tone corpus in the layout ``cli/train.py`` reads: wavs,
    ``{split}_index.jsonl`` for each split and ``vocab.txt`` (symbol k is
    the kana at codepoint 0x3041 + k, as the reference's
    ``cli/make_synthetic.py`` writes it; no adjacent repeats). Utterance
    lengths are uniform in ``seconds``. → the Vocab."""
    import os

    from ..utils.wav import write_wav
    from ..vocab import BLANK_SYMBOL, Vocab
    from .corpus import Utterance, save_index

    vocab = Vocab([BLANK_SYMBOL] + [chr(0x3041 + k)
                                    for k in range(1, vocab_size)])
    os.makedirs(root, exist_ok=True)
    vocab.save(os.path.join(root, "vocab.txt"))
    for split, n in splits.items():
        utts = []
        for i in range(n):
            secs = rng.uniform(*seconds)
            n_lab = max(int(round(secs * symbols_per_second)), 1)
            ids: list[int] = []
            for _ in range(n_lab):
                k = int(rng.integers(1, vocab_size))
                while ids and k == ids[-1]:
                    k = int(rng.integers(1, vocab_size))
                ids.append(k)
            sig, _ = make_utterance(
                rng, ids, tone_len=int(secs * C.SAMPLE_RATE / n_lab),
                vocab_size=vocab_size)
            path = os.path.join(root, f"{split}{i:05d}.wav")
            write_wav(path, sig)
            utts.append(Utterance(f"{split}{i:05d}", path,
                                  "".join(chr(0x3041 + k) for k in ids),
                                  len(sig)))
        save_index(os.path.join(root, f"{split}_index.jsonl"), utts)
    return vocab
