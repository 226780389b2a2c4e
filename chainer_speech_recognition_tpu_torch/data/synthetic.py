"""Synthetic corpora with a learnable audio→symbol map (the port's copy of
``tone_frequency``, ``make_utterance``, ``SymbolMarkov`` and
``ConfusableSynth`` from the reference's ``data/synthetic.py``), for smoke
runs, tests and the CER-parity protocol (PARITY.md §1), so no external
corpus is needed:

* **tones** (``make_utterance``): each vocab symbol is a pure tone at a
  distinct mel-spaced frequency, nearly linearly separable;
  ``write_tone_corpus`` writes such a corpus as a training data directory;
* **confusable** (``ConfusableSynth``): speech-like 2-formant harmonic
  timbres on an (F1, F2) grid with per-utterance speaker variation and
  speech-shaped noise, the corpus the quality gate trains on, with
  transcripts from the sparse Markov chain ``SymbolMarkov``.

``cli/make_synthetic.py`` draws from one generator in a fixed order, so
the same flags and seed write the same bytes as the reference's CLI.
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


# ---------------------------------------------------------------------------
# confusable speech-like synthesis (quality-gate corpus, PARITY.md v2)
# ---------------------------------------------------------------------------

class SymbolMarkov:
    """Deterministic sparse Markov chain over symbol ids 1..V-1.

    Each state (including 0 = BOS) allows only ``branching`` successors
    with Dirichlet-skewed weights (~2.2 bits/char vs log2(V-1) ≈ 6.3
    uniform at V=82), so an n-gram LM trained on sampled transcripts has
    real mutual information with the next symbol — the precondition for
    the config-4 LM-fusion win. Self-successors are excluded, so sampled
    text never has adjacent repeats (unambiguous CTC collapse).
    """

    def __init__(self, vocab_size: int, branching: int = 6,
                 seed: int = 0x5E9):
        V = vocab_size
        if V < 3:
            raise ValueError("SymbolMarkov needs vocab_size >= 3 "
                             "(>=1 non-self successor per symbol)")
        rng = np.random.default_rng([seed, V, branching])
        branching = min(branching, V - 2)   # small vocabs: fewer successors
        self.succ = np.zeros((V, branching), np.int32)
        self.probs = np.zeros((V, branching), np.float64)
        for k in range(V):
            cand = np.asarray([j for j in range(1, V) if j != k])
            self.succ[k] = rng.choice(cand, branching, replace=False)
            w = rng.dirichlet(np.full(branching, 0.6))
            self.probs[k] = w / w.sum()

    def sample(self, rng: np.random.Generator, n: int) -> list[int]:
        ids, k = [], 0
        for _ in range(n):
            k = int(rng.choice(self.succ[k], p=self.probs[k]))
            ids.append(k)
        return ids


class ConfusableSynth:
    """Speech-like confusable symbol synthesis.

    Symbol identity = a two-formant resonance pattern (F1, F2) on a grid:
    F2-neighbours (adjacent ids) sit ~6-7% apart — comparable to a mel bin
    in the 1-2.6 kHz band, so they are genuinely confusable under noise.
    Audio per token: harmonic source at a per-utterance pitch f0 (with
    drift), filtered by the symbol's formant envelope and the speaker's
    spectral tilt; raised-cosine attack/decay per token. Per-utterance
    "speaker": f0 ~ U(95, 260) Hz, vocal-tract length scale ±8%, tilt
    U(-9, -3) dB/octave. Per-token jitter: duration ×U(0.7, 1.35),
    amplitude ×U(0.6, 1.0), formants ±3%. Additive speech-shaped noise at
    SNR ~ U(8, 18) dB.
    """

    F1_LO, F1_HI = 320.0, 880.0
    F2_LO, F2_HI = 1050.0, 2600.0
    BW1, BW2 = 90.0, 140.0
    F_MAX = 3600.0                  # highest harmonic synthesized

    def __init__(self, vocab_size: int):
        self.V = vocab_size
        n = vocab_size - 1          # symbols 1..V-1 (0 = blank)
        # grid: n1 F1 rows × n2 F2 columns, n2 chosen so adjacent ids are
        # F2-neighbours within one F1 row (the confusable pairs)
        n2 = max(int(np.ceil(np.sqrt(n * 1.2))), 2)
        n1 = int(np.ceil(n / n2))
        f1s = np.geomspace(self.F1_LO, self.F1_HI, n1)
        f2s = np.geomspace(self.F2_LO, self.F2_HI, n2)
        k = np.arange(n)
        self.f1 = f1s[k // n2]
        self.f2 = f2s[k % n2]

    def _formant_env(self, freqs, f1, f2, tilt_db_oct):
        a = 1.0 / (1.0 + ((freqs - f1) / self.BW1) ** 2)
        b = 0.7 / (1.0 + ((freqs - f2) / self.BW2) ** 2)
        tilt = 10.0 ** (tilt_db_oct * np.log2(
            np.maximum(freqs, 1.0) / 300.0) / 20.0)
        return (a + b + 0.01) * np.minimum(tilt, 1.0)

    def utterance(self, rng: np.random.Generator, label_ids,
                  tone_len: int = 1600, snr_db: float | None = None,
                  sr: int = C.SAMPLE_RATE, coarticulation: bool = False):
        """label ids (1-based) → (signal float32, labels int32).

        ``coarticulation=True`` adds formant TRANSITIONS: each token's
        spectrum cross-fades from the PREVIOUS symbol's formant envelope
        over its first ~35% (≤60 ms) — token onsets become
        context-dependent, like real CV transitions, so a frame-wise
        model can no longer classify each frame from its own spectrum
        alone. (Off by default: the v2 parity corpus regenerates
        byte-identically.)"""
        f0 = rng.uniform(95.0, 260.0)
        vtl = rng.uniform(0.92, 1.08)       # vocal-tract length scale
        tilt = rng.uniform(-9.0, -3.0)      # dB/octave
        segs = []
        prev_f = None                       # previous token's (f1, f2)
        for kk in label_ids:
            k = int(kk) - 1
            d = max(int(tone_len * rng.uniform(0.7, 1.35)), 4 * C.HOP_LENGTH)
            amp = rng.uniform(0.6, 1.0)
            jf1 = self.f1[k] * vtl * rng.uniform(0.97, 1.03)
            jf2 = self.f2[k] * vtl * rng.uniform(0.97, 1.03)
            # harmonic stack under F_MAX at this token's (drifting) pitch
            tok_f0 = f0 * rng.uniform(0.96, 1.04)
            H = max(int(self.F_MAX / tok_f0), 2)
            h = np.arange(1, H + 1)
            t = np.arange(d) / sr
            # slow pitch drift within the token (±2%)
            drift = 1.0 + 0.02 * np.sin(
                2 * np.pi * rng.uniform(1.5, 4.0) * t
                + rng.uniform(0, 2 * np.pi))
            phase = 2 * np.pi * np.cumsum(tok_f0 * drift) / sr   # [d]
            amps = self._formant_env(h * tok_f0, jf1, jf2, tilt)  # [H]
            if coarticulation and prev_f is not None:
                # cross-fade from the previous symbol's spectrum: a
                # cheap-but-effective stand-in for a true formant glide
                amps_prev = self._formant_env(h * tok_f0, prev_f[0],
                                              prev_f[1], tilt)
                glide = min(int(0.35 * d), int(0.060 * sr))
                wfade = np.ones(d, np.float32)
                wfade[:glide] = np.linspace(0.0, 1.0, glide,
                                            dtype=np.float32)
            else:
                amps_prev, wfade = None, None
            prev_f = (jf1, jf2)
            # drop harmonics below 2% of the strongest — they are inaudible
            # under the noise floor and sin() dominates synthesis cost
            ref = amps if amps_prev is None else np.maximum(amps, amps_prev)
            keep = ref > 0.02 * ref.max()
            h, amps = h[keep], amps[keep]
            waves = np.sin(np.outer(h, phase).astype(np.float32)
                           + rng.uniform(0, 2 * np.pi,
                                         (len(h), 1)).astype(np.float32))
            seg = amps.astype(np.float32) @ waves
            if amps_prev is not None:
                seg_prev = amps_prev[keep].astype(np.float32) @ waves
                seg = wfade * seg + (1.0 - wfade) * seg_prev
            seg *= amp / max(np.sqrt(np.mean(seg ** 2)), 1e-6)
            # raised-cosine attack/decay (~6 ms) — no clicks, and an
            # amplitude dip at token boundaries like real articulation
            e = min(int(0.006 * sr), d // 4)
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(e) / e)
            seg[:e] *= ramp
            seg[-e:] *= ramp[::-1]
            segs.append(seg)
        sig = (np.concatenate(segs) if segs
               else np.zeros(tone_len, np.float64))
        # speech-shaped additive noise (broad 500 Hz peak, -12 dB/oct above)
        if snr_db is None:
            snr_db = rng.uniform(8.0, 18.0)
        spec = np.fft.rfft(rng.standard_normal(len(sig)))
        freqs = np.fft.rfftfreq(len(sig), 1.0 / sr)
        shape = 1.0 / (1.0 + (np.maximum(freqs, 1.0) / 500.0) ** 2)
        noise = np.fft.irfft(spec * shape, len(sig))
        sp = np.mean(sig ** 2)
        npow = np.mean(noise ** 2)
        noise *= np.sqrt(sp / max(npow, 1e-12)) * 10.0 ** (-snr_db / 20.0)
        sig = sig + noise
        sig *= 0.5 / max(np.max(np.abs(sig)), 1e-6)
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
