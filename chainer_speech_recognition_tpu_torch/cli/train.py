"""Train CLI (port of ``cli/train.py``): a preprocessed data directory
(``train_index.jsonl`` or the packed ``train.pack``, optional
``dev_index.jsonl``, ``vocab.txt``) → checkpoints, on the cards (default)
or the CPU.

  python -m chainer_speech_recognition_tpu_torch.cli.train \\
      --data-dir prep_out --preset bigru \\
      --set train.total_steps=20000 parallel.num_devices=4

``parallel.num_devices`` N > 1 trains data-parallel on N ranks that the
CLI starts itself (``parallel/mesh.launch``): one card each in an NCCL
group, or, with ``--device cpu``, N CPU processes in a gloo group; 0 (the
default) takes every visible card, and one process on the CPU. Under
``torchrun`` the CLI is the rank that the environment names. Rank 0 writes
the metrics and checkpoints.

Where ``train.pack`` exists (``preprocess --pack``) the training batches
come from it (``PackedBatchLoader``: memmap reads, int16 PCM). The default
``train.data_mode=auto`` keeps a corpus within
``train.device_cache_budget_gb`` on the device (``device_cache``: bf16
features built once, ``train.steps_per_dispatch`` steps a dispatch, on the
card one CUDA-graph replay) and rotates windows of a larger one
(``rotating``); ``train.data_mode=stream`` feeds host batches each step.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data.corpus import load_index
from ..data.packed import PackedBatchLoader, PackedCorpus
from ..parallel.mesh import launch, visible_devices
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
                   "naming the step and the tensor); the cached data modes "
                   "then run their steps eagerly, without CUDA graphs")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler chrome trace of steps 10-14 "
                   "(of the whole dispatches that hold them)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args)
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.txt"))
    cfg = cfg.override({"model.vocab_size": len(vocab)})
    if args.ckpt_dir:
        cfg = cfg.override({"train.checkpoint_dir": args.ckpt_dir})
    launch(_rank_main, cfg.parallel.num_devices or visible_devices(device),
           device, cfg, vocab, args)


def _rank_main(device, cfg, vocab, args) -> None:
    """One rank's training run (the whole run without data parallelism)."""
    loader = None
    pack_prefix = os.path.join(args.data_dir, "train")
    if os.path.exists(pack_prefix + ".pack"):
        # packed binary corpus (preprocess --pack): memmap loader, int16 wire
        packed = PackedCorpus(pack_prefix)
        train_utts = packed.utterances()
        loader = PackedBatchLoader(packed, cfg.buckets)
    else:
        train_utts = load_index(
            os.path.join(args.data_dir, "train_index.jsonl"))
    dev_path = os.path.join(args.data_dir, "dev_index.jsonl")
    dev_utts = load_index(dev_path) if os.path.exists(dev_path) else None

    with torch.autograd.set_detect_anomaly(args.debug_nans):
        train(cfg, train_utts, vocab, dev_utts=dev_utts,
              metrics_path=args.metrics, resume=not args.no_resume,
              profile_dir=args.profile_dir, device=device, loader=loader,
              debug_nans=args.debug_nans)


if __name__ == "__main__":
    main()
