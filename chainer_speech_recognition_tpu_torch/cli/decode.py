"""Decode CLI: checkpoint + wav file(s) → greedy transcripts (port of the
greedy path of ``cli/decode.py``).

Same flags, checks and output as the reference's greedy path: the vocab
size check, length-sorted chunks of ``--batch`` wavs with signal lengths
quantized to 1 s, results printed in input order as ``path<TAB>text``.
``--device`` picks the card (default) or the CPU; ``--device cuda`` on a
host without CUDA raises. Beam search (``--beam``, ``--lm``, ``--nbest``)
is not ported yet and is refused.

    python -m chainer_speech_recognition_tpu_torch.cli.decode \\
        --ckpt-dir CKPT --vocab vocab.txt a.wav b.wav
"""

from __future__ import annotations

import argparse
import json
import wave

import numpy as np
import torch

from chainer_speech_recognition_tpu import constants as C
from chainer_speech_recognition_tpu.utils.wav import read_wav
from chainer_speech_recognition_tpu.vocab import Vocab

from ..bridge import load_flax_params
from ..checkpoint import load_config, load_params
from ..decode.greedy import greedy_decode
from ..frontend import select_frontend
from ..models.presets import build_model

# execution-choice knobs: they pick a kernel or dtype and leave the
# parameter layout alone, so --set may override them (evaluate.py rules)
EXEC_KNOBS = {"model.attn_impl", "model.attn_residual_dtype",
              "model.rnn_impl"}


def load_model(ckpt_dir: str, average_last: int = 1,
               overrides: dict | None = None, device="cpu"):
    """→ (config, model on ``device`` in eval mode, checkpoint description).

    ``overrides`` are dotted config overrides on top of the frozen
    training config; ``model.*`` keys other than ``EXEC_KNOBS`` are
    rejected, since the topology must match the checkpoint."""
    cfg = load_config(ckpt_dir)
    if overrides:
        bad = [k for k in overrides
               if k.split(".", 1)[0] == "model" and k not in EXEC_KNOBS]
        if bad:
            raise SystemExit(
                f"--set cannot override model topology ({', '.join(bad)}): "
                "the checkpoint's parameters were shaped by the frozen "
                "model config (execution-choice knobs model.attn_impl / "
                "model.attn_residual_dtype / model.rnn_impl ARE allowed)")
        cfg = cfg.override(overrides)
    params, path = load_params(ckpt_dir, average_last)
    model = build_model(cfg.model)
    load_flax_params(model, params)
    return cfg, model.to(device).eval(), path


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to decode on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: expected cuda or cpu")
    return dev


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--average-last", type=int, default=1,
                   help="average the parameters of the last N kept "
                        "checkpoints (eval-time checkpoint averaging)")
    p.add_argument("--vocab", required=True, help="vocab.txt path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--beam", type=int, default=0,
                   help="beam width: only 0 (greedy) is ported")
    p.add_argument("--lm", default=None, help="not ported (needs --beam)")
    p.add_argument("--nbest", type=int, default=1,
                   help="not ported (needs --beam)")
    p.add_argument("--batch", type=int, default=32,
                   help="wavs per device batch: long wav lists are decoded "
                        "in length-sorted chunks and printed in input order")
    p.add_argument("--wav-list", default=None,
                   help="file with one wav path per line; combines with "
                        "positional wavs")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted eval-time config overrides (deployment "
                        "knobs + model.rnn_impl / model.attn_impl / "
                        "model.attn_residual_dtype)")
    p.add_argument("wavs", nargs="*")
    args = p.parse_args(argv)

    if args.beam > 0 or args.lm or args.nbest > 1:
        raise SystemExit("beam decoding (--beam/--lm/--nbest) is not yet "
                         "ported to the PyTorch package; decode greedily "
                         "or use chainer_speech_recognition_tpu.cli.decode")
    if args.wav_list:
        with open(args.wav_list, encoding="utf-8") as f:
            args.wavs += [l.strip() for l in f if l.strip()]
    if not args.wavs:
        raise SystemExit("no wavs given (positional or --wav-list)")
    if args.batch <= 0:
        raise SystemExit("--batch must be >= 1")
    device = resolve_device(args.device)

    overrides = {}
    for kv in args.set:
        key, _, val = kv.partition("=")
        try:
            overrides[key] = json.loads(val)
        except json.JSONDecodeError:
            overrides[key] = val
    cfg, model, _ = load_model(args.ckpt_dir, args.average_last, overrides,
                               device)
    vocab = Vocab.load(args.vocab)
    if len(vocab) != cfg.model.vocab_size:
        raise SystemExit(
            f"vocab has {len(vocab)} symbols but the checkpoint was trained "
            f"with model.vocab_size={cfg.model.vocab_size} — wrong vocab "
            "file for this checkpoint (decodes would be silently garbled)")

    def header_len(path):
        with wave.open(path, "rb") as w:
            return int(round(w.getnframes() * C.SAMPLE_RATE
                             / w.getframerate()))

    wav_lens = [header_len(w) for w in args.wavs]
    B = len(wav_lens)
    # long lists: length-sorted fixed-size chunks, lengths quantized to 1 s
    multi = B > args.batch
    bs = args.batch if multi else B
    order = sorted(range(B), key=lambda i: wav_lens[i]) if multi \
        else list(range(B))
    chunks = [order[start : start + bs] for start in range(0, B, bs)]
    frontend = select_frontend(cfg.features)
    results: list = [None] * B

    with torch.inference_mode():
        for chunk in chunks:
            rows = chunk + [chunk[0]] * (bs - len(chunk))  # static batch
            n_max = max(wav_lens[i] for i in chunk)
            if multi:
                n_max = -(-n_max // C.SAMPLE_RATE) * C.SAMPLE_RATE
            signals = np.zeros((bs, n_max), np.float32)
            lens = np.zeros(bs, np.int32)
            cache: dict = {}
            for r, i in enumerate(rows):
                sig = cache.get(i)
                if sig is None:
                    cache[i] = sig = read_wav(args.wavs[i])
                signals[r, : len(sig)] = sig
                lens[r] = len(sig)
            feats, flens = frontend(torch.from_numpy(signals).to(device),
                                    torch.from_numpy(lens).to(device),
                                    apply_cmvn=cfg.features.cmvn_arg)
            logits, olens = model(feats, flens)
            ids, out_lens = greedy_decode(logits, olens)
            ids, out_lens = ids.cpu().numpy(), out_lens.cpu().numpy()
            for r, i in enumerate(chunk):
                results[i] = vocab.decode(ids[r, : out_lens[r]])

    for w, res in zip(args.wavs, results):       # input order
        print(f"{w}\t{res}")


if __name__ == "__main__":
    main()
