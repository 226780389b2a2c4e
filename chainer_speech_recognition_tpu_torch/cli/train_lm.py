"""Train a character n-gram LM from corpus transcripts and write ARPA
(port of ``cli/train_lm.py``, config 4: the external-LM half of shallow
fusion). The same data dir and order give the same ARPA bytes as the
reference CLI.

    python -m chainer_speech_recognition_tpu_torch.cli.train_lm \\
        --data-dir prep --order 3
"""

from __future__ import annotations

import argparse
import os

from ..data.corpus import load_index
from ..decode.lm import NGramLM
from ..vocab import Vocab


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", required=True,
                   help="preprocess output dir (train_index.jsonl + vocab.txt)")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--out", default=None, help="ARPA output path")
    args = p.parse_args(argv)

    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.txt"))
    utts = load_index(os.path.join(args.data_dir, "train_index.jsonl"))
    lm = NGramLM.train([u.text for u in utts], vocab, order=args.order)
    out = args.out or os.path.join(args.data_dir, f"lm_{args.order}gram.arpa")
    lm.to_arpa(out, vocab)
    n = sum(len(v) for v in lm.logp[args.order - 1].values())
    print(f"trained {args.order}-gram LM on {len(utts)} transcripts "
          f"({n} top-order n-grams) -> {out}")


if __name__ == "__main__":
    main()
