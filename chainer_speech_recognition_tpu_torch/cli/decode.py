"""Decode CLI: checkpoint + wav file(s) → text (port of ``cli/decode.py``).

Greedy by default; ``--beam K`` switches to prefix beam search (one launch
of ``csrc/beam.cu`` a chunk on the card), and ``--lm``/``--lm-alpha``/
``--lm-beta`` add n-gram LM shallow fusion (config 4). Same flags, checks
and output as the reference: the vocab size check, length-sorted chunks of
``--batch`` wavs with signal lengths quantized to 1 s, results printed in
input order as ``path<TAB>text`` (``--nbest N``: ``path<TAB>rank<TAB>
log-score<TAB>text`` lines). ``--device`` picks the card (default) or the
CPU; ``--device cuda`` on a host without CUDA raises.

    python -m chainer_speech_recognition_tpu_torch.cli.decode \\
        --ckpt-dir CKPT --vocab vocab.txt a.wav b.wav
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np
import torch

from .. import constants as C
from ..bridge import load_flax_params
from ..checkpoint import load_config, load_params
from ..decode.beam import beam_decode, beam_decode_nbest
from ..decode.greedy import greedy_decode
from ..decode.lm import NGramLM, device_lm
from ..frontend import select_frontend
from ..models.presets import build_model
from ..utils.wav import read_wav
from ..vocab import Vocab
from .common import parse_overrides, resolve_device

# execution-choice knobs: they pick a kernel or dtype and leave the
# parameter layout alone, so --set may override them (evaluate.py rules)
EXEC_KNOBS = {"model.attn_impl", "model.attn_residual_dtype",
              "model.rnn_impl"}


def load_model(ckpt_dir: str, average_last: int = 1,
               overrides: dict | None = None, device="cuda"):
    """→ (config, model on ``device`` in eval mode, checkpoint description).

    ``device`` is the card unless the caller asks for the CPU; it goes
    through ``resolve_device``, so without a card the default refuses
    rather than falling back to the CPU. ``overrides`` are dotted config
    overrides on top of the frozen training config; ``model.*`` keys other
    than ``EXEC_KNOBS`` are rejected, since the topology must match the
    checkpoint."""
    device = resolve_device(str(device))
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
                   help="beam width (0 = greedy)")
    p.add_argument("--lm", default=None, help="ARPA n-gram LM for fusion")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.0)
    p.add_argument("--lm-repr", default="auto",
                   choices=("auto", "dense", "hashed"),
                   help="device LM representation: dense table, sparse "
                        "hashed (scales to order>=4 / large V), or auto "
                        "by table size")
    p.add_argument("--nbest", type=int, default=1,
                   help="with --beam: print the top-N hypotheses per wav "
                        "(tab-separated: path, rank, log-score, text)")
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

    if args.wav_list:
        with open(args.wav_list, encoding="utf-8") as f:
            args.wavs += [l.strip() for l in f if l.strip()]
    if not args.wavs:
        raise SystemExit("no wavs given (positional or --wav-list)")
    if args.batch <= 0:
        raise SystemExit("--batch must be >= 1")
    # --nbest only has meaning on the beam path: fail loudly instead of
    # silently printing greedy 1-best
    if args.nbest > 1 and args.beam <= 0:
        raise SystemExit("--nbest requires --beam K")
    if args.lm and args.beam <= 0:
        raise SystemExit("--lm requires --beam K (greedy decode cannot "
                         "apply LM fusion)")
    if args.beam > 0 and args.nbest > args.beam:
        print(f"warning: --nbest {args.nbest} clamped to beam width "
              f"{args.beam}", file=sys.stderr)   # stdout is the result TSV
    device = resolve_device(args.device)

    overrides = parse_overrides(args.set)
    cfg, model, _ = load_model(args.ckpt_dir, args.average_last, overrides,
                               device)
    vocab = Vocab.load(args.vocab)
    if len(vocab) != cfg.model.vocab_size:
        raise SystemExit(
            f"vocab has {len(vocab)} symbols but the checkpoint was trained "
            f"with model.vocab_size={cfg.model.vocab_size} — wrong vocab "
            "file for this checkpoint (decodes would be silently garbled)")
    lm = None
    if args.lm:
        lm = device_lm(NGramLM.from_arpa(args.lm, vocab), args.lm_repr)

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
            if args.beam > 0 and args.nbest > 1:
                n = min(args.nbest, args.beam)
                pfx, plen, scores = beam_decode_nbest(
                    logits, olens, beam=args.beam, lm=lm,
                    alpha=args.lm_alpha, beta=args.lm_beta)
                for r, i in enumerate(chunk):
                    results[i] = [(k + 1, float(scores[r, k]),
                                   vocab.decode(pfx[r, k, : plen[r, k]]))
                                  for k in range(n)]
                continue
            if args.beam > 0:
                hyps = beam_decode(logits, olens, beam=args.beam, lm=lm,
                                   alpha=args.lm_alpha, beta=args.lm_beta)
            else:
                ids, out_lens = greedy_decode(logits, olens)
                ids, out_lens = ids.cpu().numpy(), out_lens.cpu().numpy()
                hyps = [ids[r, : out_lens[r]] for r in range(len(ids))]
            for r, i in enumerate(chunk):
                results[i] = vocab.decode(hyps[r])

    for w, res in zip(args.wavs, results):       # input order
        if isinstance(res, list):
            for rank, score, text in res:
                print(f"{w}\t{rank}\t{score:.3f}\t{text}")
        else:
            print(f"{w}\t{res}")


if __name__ == "__main__":
    main()
