"""Streaming decode CLI: online recognition over wavs or live stdin PCM
(port of ``cli/stream.py``).

Serves the latency-controlled streaming recognizer (decode/streaming.py)
two ways, on the card unless ``--device cpu`` is asked for:

* **wav mode** — ``--batch`` wavs stream in lockstep and print one final
  transcript per wav (``path<TAB>text``, input order); audio buffers whole
  per batch. Under ``--partials`` each wav streams alone in ``--block-ms``
  pieces (simulated real time), printing incremental hypotheses with
  stream timestamps.
* **live mode** (``--raw``) — reads 16 kHz mono int16 PCM from stdin and
  prints tokens the moment their chunk finalizes.

Requires a checkpoint trained with ``features.cmvn_mode=causal`` (or CMVN
off); the recognizer refuses utterance CMVN with the retrain instruction.
``--beam K`` streams with the carried prefix beam (tokens print once every
live beam agrees on them, the 1-best tail at stream end), ``--lm`` adds
n-gram LM fusion. ``--right-frames`` defaults per model, as in the
reference: 0 for a chunk-causal attention checkpoint (``conformer_stream``:
its lookahead lives inside the chunk), 16 otherwise.

    python -m chainer_speech_recognition_tpu_torch.cli.stream \\
        --ckpt-dir CKPT --vocab vocab.txt --right-frames 0 a.wav b.wav
"""

from __future__ import annotations

import argparse
import sys
import wave

import numpy as np

from .. import constants as C
from ..decode.lm import NGramLM, device_lm
from ..decode.streaming import StreamingRecognizer, decode_lockstep
from ..utils.wav import read_wav
from ..vocab import Vocab
from .common import resolve_device
from .decode import load_model


def _print_partial(stream_name, t_samples, text):
    print(f"[{stream_name} @ {t_samples / C.SAMPLE_RATE:7.2f}s] {text}",
          flush=True)


def _print_new_segments(rec, vocab, seen: int, name: str) -> int:
    """Endpointing: print utterances finalized since `seen` as their own
    lines (frame index × 10 ms = end time); returns the new count."""
    segs = rec.segments[0]
    for ids, end_frame in segs[seen:]:
        print(f"[{name} utterance ended @ {end_frame / 100.0:7.2f}s] "
              f"{vocab.decode(ids)}", flush=True)
    return len(segs)


def _stream_wavs(args, rec, vocab):
    """Length-sorted lockstep batches over the wav list, driven by the
    shared ``decode_lockstep`` batch feeder."""
    order = sorted(range(len(args.wavs)),
                   key=lambda i: args.wav_lens[i])
    results: list = [None] * len(args.wavs)
    for grp, ids in decode_lockstep(rec, order,
                                    lambda i: read_wav(args.wavs[i])):
        for i, row in zip(grp, ids):
            results[i] = vocab.decode(row)
    for path, text in zip(args.wavs, results):
        print(f"{path}\t{text}", flush=True)


def _stream_wavs_partials(args, rec, vocab):
    """``--partials``: each wav streams alone (batch=1 — eager draining
    treats every fed sample as real, so unequal-length lockstep padding
    would corrupt shorter streams), printing hypotheses as chunks
    finalize, exactly as a live caller would see them."""
    blk = max(int(args.block_ms * C.SAMPLE_RATE / 1000), 1)
    for path in args.wavs:
        sig = read_wav(path)
        rec.reset()
        n_seg = 0
        for off in range(0, len(sig), blk):
            new = rec.accept(sig[None, off : off + blk])
            if new[0]:
                _print_partial(path, min(off + blk, len(sig)),
                               vocab.decode(new[0]))
            n_seg = _print_new_segments(rec, vocab, n_seg, path)
        new = rec.flush()
        if new[0]:
            _print_partial(path, len(sig), vocab.decode(new[0]))
        _print_new_segments(rec, vocab, n_seg, path)
        print(f"{path}\t{vocab.decode(rec.emitted[0])}", flush=True)


def _stream_stdin(args, rec, vocab):
    """Live mode: int16 PCM on stdin → tokens as chunks finalize."""
    blk_bytes = 2 * max(int(args.block_ms * C.SAMPLE_RATE / 1000), 1)
    src = sys.stdin.buffer
    total = 0
    n_seg = 0
    while True:
        raw = src.read(blk_bytes)
        if not raw:
            break
        if len(raw) % 2:                  # partial trailing sample
            raw = raw[:-1]
        pcm = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        total += len(pcm)
        new = rec.accept(pcm[None])
        if new[0]:
            _print_partial("stdin", total, vocab.decode(new[0]))
        n_seg = _print_new_segments(rec, vocab, n_seg, "stdin")
    new = rec.flush()
    if new[0]:
        _print_partial("stdin", total, vocab.decode(new[0]))
    _print_new_segments(rec, vocab, n_seg, "stdin")
    print(vocab.decode(rec.emitted[0]), flush=True)


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
                   help="streaming prefix-beam width (0 = greedy); tokens "
                        "print once every live beam agrees on them, the "
                        "1-best tail lands at stream end")
    p.add_argument("--lm", default=None,
                   help="ARPA n-gram LM for streaming shallow fusion "
                        "(requires --beam)")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.0)
    p.add_argument("--lm-repr", default="auto",
                   choices=("auto", "dense", "hashed"))
    p.add_argument("--chunk-frames", type=int, default=64,
                   help="emitted frames per streaming step (10 ms units)")
    p.add_argument("--right-frames", type=int, default=None,
                   help="future context per emitted frame (10 ms units); "
                        "latency = (chunk+right) x 10 ms + compute. "
                        "Default 16, or 0 for chunk-causal attention "
                        "models (their lookahead lives inside the chunk)")
    p.add_argument("--block-ms", type=float, default=100.0,
                   help="PCM feed granularity for --partials / --raw "
                        "(simulated real time; batch wav mode buffers "
                        "whole)")
    p.add_argument("--endpoint-ms", type=float, default=None,
                   help="CTC endpointing: close an utterance after this "
                        "much trailing argmax-blank; finished utterances "
                        "print as their own lines (live/partials modes)")
    p.add_argument("--batch", type=int, default=8,
                   help="wav mode: lockstep streams per step")
    p.add_argument("--partials", action="store_true",
                   help="print incremental hypotheses with stream time")
    p.add_argument("--timing", action="store_true",
                   help="print per-window latency percentiles at exit (the "
                        "serving SLO signal: window wall time = host "
                        "assembly + device step + result pull; the first "
                        "windows include the kernel build)")
    p.add_argument("--raw", action="store_true",
                   help="live mode: read 16 kHz mono int16 PCM from stdin")
    p.add_argument("--wav-list", default=None,
                   help="file with one wav path per line")
    p.add_argument("wavs", nargs="*")
    args = p.parse_args(argv)

    if args.wav_list:
        with open(args.wav_list, encoding="utf-8") as f:
            args.wavs += [l.strip() for l in f if l.strip()]
    if args.raw and args.wavs:
        raise SystemExit("--raw reads stdin; drop the wav arguments")
    if not args.raw and not args.wavs:
        raise SystemExit("no input: give wavs (or --wav-list), or --raw "
                         "for stdin PCM")
    if args.batch <= 0:
        raise SystemExit("--batch must be >= 1")
    if args.lm and args.beam <= 0:
        raise SystemExit("--lm requires --beam K (greedy streaming cannot "
                         "apply LM fusion)")
    device = resolve_device(args.device)

    cfg, model, _ = load_model(args.ckpt_dir, args.average_last,
                               device=device)
    vocab = Vocab.load(args.vocab)
    if len(vocab) != cfg.model.vocab_size:
        raise SystemExit(
            f"vocab has {len(vocab)} symbols but the checkpoint was trained "
            f"with model.vocab_size={cfg.model.vocab_size} — wrong vocab "
            "file for this checkpoint")
    lm = None
    if args.lm:
        lm = device_lm(NGramLM.from_arpa(args.lm, vocab), args.lm_repr)

    if args.right_frames is None:   # model-aware default (stream_geometry
        # rejects lookahead on chunk-causal attention models)
        args.right_frames = 0 if cfg.model.attn_chunk else 16

    batch = (1 if args.raw or args.partials
             else min(args.batch, len(args.wavs)))
    rec = StreamingRecognizer(
        model, cfg, batch=batch, chunk_frames=args.chunk_frames,
        right_frames=args.right_frames,
        decoder="beam" if args.beam > 0 else "greedy", beam=args.beam,
        lm=lm, lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        endpoint_ms=args.endpoint_ms)

    g = rec.geo
    if g["C"] != args.chunk_frames or g["R"] != args.right_frames:
        # geometry rounds to the conv subsample factor and enforces a
        # minimum chunk — say so, or the promised latency reads wrong
        print(f"note: effective geometry chunk {g['C']} + lookahead "
              f"{g['R']} frames (~{(g['C'] + g['R']) * 10} ms buffering); "
              f"requested {args.chunk_frames}+{args.right_frames}",
              file=sys.stderr)
    if not g["conv_exact"]:
        print(f"note: --right-frames {g['R']} is below the conv stack's "
              f"right receptive reach ({model.conv_right_margin()}): frames "
              "near each chunk boundary see zero-padded conv context — "
              "transcripts approximate the offline decode (raise "
              "--right-frames to restore conv exactness)", file=sys.stderr)

    def report_timing():
        if not args.timing or len(rec.window_times) < 2:
            return
        # the first TWO windows (first and steady-state shapes) carry the
        # one-off costs (kernel build and load, cuDNN algorithm choice) —
        # drop them when enough samples exist, or the p95 reports set-up
        # instead of steady-state window latency
        wt = rec.window_times[2:] if len(rec.window_times) > 6 \
            else rec.window_times
        wt = sorted(wt)
        q = lambda p: wt[min(int(p * len(wt)), len(wt) - 1)] * 1000
        print(f"window latency ms over {len(wt)} steady windows: "
              f"p50 {q(0.5):.1f} | p95 {q(0.95):.1f} | max "
              f"{max(rec.window_times) * 1000:.1f} (incl. the first windows)"
              f"; chunk {g['C']} + lookahead {g['R']} frames, conv_exact "
              f"{g['conv_exact']}", file=sys.stderr)

    if args.raw:
        _stream_stdin(args, rec, vocab)
    elif args.partials:
        _stream_wavs_partials(args, rec, vocab)
    else:
        def header_len(path):
            with wave.open(path, "rb") as w:
                return int(round(w.getnframes() * C.SAMPLE_RATE
                                 / w.getframerate()))

        args.wav_lens = [header_len(w) for w in args.wavs]
        _stream_wavs(args, rec, vocab)
    report_timing()


if __name__ == "__main__":
    main()
