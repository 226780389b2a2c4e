"""Train CLI (port of ``cli/train.py``): a preprocessed data directory
(``train_index.jsonl``, optional ``dev_index.jsonl``, ``vocab.txt``) →
checkpoints, on one card (default) or the CPU.

  python -m chainer_speech_recognition_tpu_torch.cli.train \\
      --data-dir prep_out --preset bigru \\
      --set train.data_mode=stream train.total_steps=20000

Only the stream data mode is ported (the default ``train.data_mode=auto``
picks the device-resident corpus cache for a corpus that fits, and raises);
a packed corpus (``train.pack``) is refused.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data.corpus import load_index
from ..train.loop import train
from ..vocab import Vocab
from .common import add_config_args, load_config, resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_config_args(p)
    p.add_argument("--data-dir", required=True,
                   help="preprocess output dir (indexes + vocab.txt)")
    p.add_argument("--ckpt-dir", default=None, help="override checkpoint dir")
    p.add_argument("--metrics", default=None, help="metrics JSONL path")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--debug-nans", action="store_true",
                   help="anomaly detection, and a check each step that the "
                   "loss and every gradient are finite (FloatingPointError "
                   "naming the step and the tensor)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler chrome trace of steps 10-14")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args)
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.txt"))
    cfg = cfg.override({"model.vocab_size": len(vocab)})
    if args.ckpt_dir:
        cfg = cfg.override({"train.checkpoint_dir": args.ckpt_dir})
    if os.path.exists(os.path.join(args.data_dir, "train.pack")):
        raise SystemExit(
            f"{args.data_dir}/train.pack: the packed corpus is not ported yet "
            "(ROADMAP.md, module queue); train from train_index.jsonl")
    train_utts = load_index(os.path.join(args.data_dir, "train_index.jsonl"))
    dev_path = os.path.join(args.data_dir, "dev_index.jsonl")
    dev_utts = load_index(dev_path) if os.path.exists(dev_path) else None

    with torch.autograd.set_detect_anomaly(args.debug_nans):
        train(cfg, train_utts, vocab, dev_utts=dev_utts,
              metrics_path=args.metrics, resume=not args.no_resume,
              profile_dir=args.profile_dir, device=device,
              debug_nans=args.debug_nans)


if __name__ == "__main__":
    main()
