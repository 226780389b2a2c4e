"""Shared CLI plumbing: config file + dotted overrides, and the device flag
(port of ``cli/common.py``)."""

from __future__ import annotations

import argparse
import json

import torch

from ..config import Config, preset_config


def add_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="path to config JSON")
    p.add_argument("--preset", default=None,
                   help="preset config: tiny_conv | bigru | bilstm_deep")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. model.rnn_hidden=512")


def parse_overrides(pairs: list[str]) -> dict:
    """["a.b=1", "c=x"] → {"a.b": 1, "c": "x"} (JSON values where they
    parse, strings otherwise)."""
    overrides = {}
    for kv in pairs:
        key, _, val = kv.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    return overrides


def load_config(args) -> Config:
    if args.config:
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    elif args.preset:
        cfg = preset_config(args.preset)
    else:
        cfg = Config()
    overrides = parse_overrides(args.set)
    return cfg.override(overrides) if overrides else cfg


def resolve_device(name: str) -> torch.device:
    """``cuda`` (raises without a card: never a silent CPU fallback) or
    ``cpu``."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda or cpu")
    return dev
