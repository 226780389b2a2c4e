"""Preprocess CLI: corpus directory → utterance index + vocab (the port's
copy of the reference's ``cli/preprocess.py``, every flag included).
Features are computed on the device at train time, so only the index and
vocab are persisted (``--cache-features`` writes the golden NumPy
features instead, ``--pack`` also writes the packed int16 corpora that
the train and evaluate CLIs read); ``--stats`` checks bucket coverage.

    python -m chainer_speech_recognition_tpu_torch.cli.preprocess \\
        --corpus corpus --out prep --dev-fraction 0.1 --pack
"""

from __future__ import annotations

import argparse
import os

from ..config import BucketConfig
from ..data.buckets import padding_waste
from ..data.corpus import (build_vocab, normalize_texts, save_index,
                           scan_corpus, scan_kaldi_style)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--corpus", required=True, help="corpus root (wav+txt pairs)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--dev-fraction", type=float, default=0.0,
                   help="held-out fraction written to dev_index.jsonl")
    p.add_argument("--stats", action="store_true")
    p.add_argument("--cache-features", action="store_true",
                   help="precompute golden log-mel+Δ features to .npy "
                        "(reference-style cache; on-device front-end is the "
                        "default and needs no cache)")
    p.add_argument("--cmvn-mode", default="utterance",
                   choices=["utterance", "causal"],
                   help="CMVN mode for --cache-features; must match the "
                        "features.cmvn_mode the model will train with "
                        "(causal = the streamable mode, decode/streaming.py)")
    p.add_argument("--no-cmvn", action="store_true",
                   help="with --cache-features: skip utterance CMVN")
    p.add_argument("--unit", default="char", choices=["char", "mora", "bpe"],
                   help="label unit segmenter (vocab.py SEGMENTERS); "
                        "'bpe' LEARNS subword merges from this corpus's "
                        "transcripts (vocab.py::learn_bpe)")
    p.add_argument("--bpe-size", type=int, default=512,
                   help="with --unit bpe: target vocab size incl. "
                        "<blank>/<unk>")
    p.add_argument("--bpe-base", default="char", choices=["char", "mora"],
                   help="with --unit bpe: base inventory merges start from")
    p.add_argument("--vocab", default=None,
                   help="REUSE an existing vocab.txt instead of building "
                        "one from this corpus — required when preparing an "
                        "eval set for an already-trained model (a rebuilt "
                        "vocab may assign different ids or miss units, "
                        "silently corrupting CER)")
    p.add_argument("--format", default="pairs", choices=["pairs", "kaldi"],
                   help="corpus layout: wav+txt sibling pairs (default) or "
                        "Kaldi-style wav.scp + text (+ optional segments) "
                        "files — the CSJ interchange layout")
    p.add_argument("--normalize-text", action="store_true",
                   help="CSJ-style Japanese transcript cleanup: strip "
                        "filler/disfluency/event tags, NFKC, punctuation "
                        "(data/jptext.py); empty-after-cleanup utterances "
                        "are dropped")
    p.add_argument("--kana", default=None, choices=["katakana", "hiragana"],
                   help="with --normalize-text: fold kana into one script")
    p.add_argument("--pack", action="store_true",
                   help="also write packed binary corpora (train.pack / "
                        "dev.pack): mmap-able int16 PCM + pre-encoded "
                        "labels — the fast training input (data/packed.py)")
    args = p.parse_args(argv)

    scan = scan_kaldi_style if args.format == "kaldi" else scan_corpus
    utts = scan(args.corpus)
    if args.normalize_text:
        n0 = len(utts)
        utts = normalize_texts(utts, kana=args.kana)
        if len(utts) < n0:
            print(f"normalize-text: dropped {n0 - len(utts)} "
                  "empty-after-cleanup utterances")
    if not utts:
        raise SystemExit(f"no utterances found under {args.corpus} "
                         f"(format={args.format})")
    os.makedirs(args.out, exist_ok=True)

    if args.cache_features:
        import dataclasses

        import numpy as np

        from ..data.corpus import RecordingCache, load_signal
        from ..frontend.golden_np import features as golden_features
        from ..utils.wav import read_wav

        feat_dir = os.path.join(args.out, "features")
        os.makedirs(feat_dir, exist_ok=True)
        cached = []
        cached_read = RecordingCache(read_wav)
        for u in utts:
            path = os.path.join(feat_dir, u.utt_id.replace("/", "__") + ".npy")
            if not os.path.exists(path):
                f = golden_features(
                    load_signal(u, cached_read),
                    apply_cmvn=False if args.no_cmvn else args.cmvn_mode)
                np.save(path, f)
            cached.append(dataclasses.replace(u, feat=path))
        utts = cached
        print(f"cached features for {len(utts)} utterances -> {feat_dir}")

    n_dev = int(len(utts) * args.dev_fraction)
    dev, tr = utts[:n_dev], utts[n_dev:]
    save_index(os.path.join(args.out, "train_index.jsonl"), tr)
    if dev:
        save_index(os.path.join(args.out, "dev_index.jsonl"), dev)
    if args.vocab:
        from ..vocab import Vocab
        vocab = Vocab.load(args.vocab)
    elif args.unit == "bpe":
        from ..vocab import BLANK_SYMBOL, UNK_SYMBOL, Vocab, learn_bpe
        units = learn_bpe([u.text for u in utts], args.bpe_size,
                          unit=args.bpe_base)
        vocab = Vocab([BLANK_SYMBOL, UNK_SYMBOL] + units)
    else:
        vocab = build_vocab(utts, unit=args.unit)
    vocab.save(os.path.join(args.out, "vocab.txt"))
    print(f"indexed {len(tr)} train / {len(dev)} dev utterances, "
          f"vocab size {len(vocab)}")

    if args.pack:
        from ..data.packed import pack_corpus

        for name, subset in (("train", tr), ("dev", dev)):
            if subset:
                pack_path, _ = pack_corpus(
                    os.path.join(args.out, name), subset, vocab)
                print(f"packed {len(subset)} utterances -> {pack_path} "
                      f"({os.path.getsize(pack_path) / 1e6:.1f} MB)")

    if args.stats:
        frames = [u.num_frames for u in utts]
        waste = padding_waste(frames, BucketConfig())
        print(f"frames: min={min(frames)} max={max(frames)} "
              f"mean={sum(frames)/len(frames):.0f}; "
              f"default-bucket padding waste {waste:.1%}")


if __name__ == "__main__":
    main()
