"""Generate a deterministic CSJ-style synthetic corpus (wav + txt pairs):
the port's copy of the reference's ``cli/make_synthetic.py``, which
writes the same files for the same flags and seed.

The parity protocol's corpus stand-in (PARITY.md §1). Two styles:

* ``tones`` — each vocab symbol is a distinct mel-spaced pure tone
  (fast, nearly separable; integration tests / benchmarks);
* ``confusable`` (quality-gate default) — speech-like two-formant timbres
  with per-utterance speaker variation and speech-shaped noise
  (data/synthetic.ConfusableSynth), with transcripts sampled from a
  sparse Markov chain (SymbolMarkov) so a char n-gram LM trained on the
  train split has real predictive power for the config-4 fusion gate.

    python -m chainer_speech_recognition_tpu_torch.cli.make_synthetic \\
        --out corpus --style confusable --utts 2000 --seed 20260816
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .. import constants as C
from ..data.synthetic import ConfusableSynth, SymbolMarkov, make_utterance
from ..utils.wav import write_wav


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--style", choices=["tones", "confusable"],
                   default="confusable")
    p.add_argument("--utts", type=int, default=2000)
    p.add_argument("--vocab", type=int, default=82,
                   help="number of distinct symbols")
    p.add_argument("--min-labels", type=int, default=50)
    p.add_argument("--max-labels", type=int, default=150)
    p.add_argument("--min-seconds", type=float, default=5.0)
    p.add_argument("--max-seconds", type=float, default=15.0)
    p.add_argument("--noise", type=float, default=None,
                   help="tones style only: additive white-noise amplitude "
                        "(default 0.05)")
    p.add_argument("--snr-db", type=float, default=None,
                   help="confusable style only: fixed SNR instead of "
                        "U(8,18) dB")
    p.add_argument("--coarticulation", action="store_true",
                   help="confusable style only: formant transitions from "
                        "the previous symbol over each token's onset "
                        "(context-dependent acoustics; off by default so "
                        "the v2 parity corpus regenerates byte-identically)")
    p.add_argument("--seed", type=int, default=20260816)
    args = p.parse_args(argv)

    # fail loudly on knobs that would be silently ignored by the style
    if args.style == "confusable" and args.noise is not None:
        raise SystemExit("--noise applies to --style tones; use --snr-db "
                         "for the confusable style")
    if args.style == "tones" and args.snr_db is not None:
        raise SystemExit("--snr-db applies to --style confusable; use "
                         "--noise for the tones style")

    rng = np.random.default_rng(args.seed)
    os.makedirs(args.out, exist_ok=True)
    synth = ConfusableSynth(args.vocab) if args.style == "confusable" else None
    markov = SymbolMarkov(args.vocab) if args.style == "confusable" else None
    for i in range(args.utts):
        n_lab = int(rng.integers(args.min_labels, args.max_labels + 1))
        secs = rng.uniform(args.min_seconds, args.max_seconds)
        tone_len = max(int(secs * C.SAMPLE_RATE / n_lab), 3 * C.HOP_LENGTH)
        if args.style == "confusable":
            ids = markov.sample(rng, n_lab)
            sig, _ = synth.utterance(rng, ids, tone_len=tone_len,
                                     snr_db=args.snr_db,
                                     coarticulation=args.coarticulation)
        else:
            ids = []
            for _ in range(n_lab):      # no adjacent repeats: unambiguous CTC
                k = int(rng.integers(1, args.vocab))
                while ids and k == ids[-1]:
                    k = int(rng.integers(1, args.vocab))
                ids.append(k)
            sig, _ = make_utterance(rng, ids, tone_len=tone_len,
                                    noise=(0.05 if args.noise is None
                                           else args.noise),
                                    vocab_size=args.vocab)
        write_wav(os.path.join(args.out, f"u{i:05d}.wav"), sig)
        # symbol k ↔ the kana at codepoint 0x3041+k (stable, readable)
        text = "".join(chr(0x3041 + k) for k in ids)
        with open(os.path.join(args.out, f"u{i:05d}.txt"), "w",
                  encoding="utf-8") as f:
            f.write(text)
    print(f"wrote {args.utts} {args.style} utterances -> {args.out}")


if __name__ == "__main__":
    main()
