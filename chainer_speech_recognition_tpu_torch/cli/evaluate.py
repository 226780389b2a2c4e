"""Evaluate CLI: checkpoint → dev/test CER (port of ``cli/evaluate.py``),
on every visible card (default) or the CPU.

Reconstructs the training config (front-end included) from the checkpoint
directory's frozen config.json, scores each ``--index`` set (a JSONL
index, or a packed ``.pack`` set) with one forward pass a batch, greedy
or (``--beam K``, ``--lm``) prefix beam search with LM fusion, and prints
the reference's result lines:

  CER 0.0123 | loss 12.3456 | 200 utts | 240 edits / 19310 ref chars

``--compare`` scores greedy, beam-K and beam-K+LM from one forward pass;
``--tune-lm`` grid-searches the fusion weights over logits kept on the
device (``--tune-chunk`` batches at a time); ``--streaming`` scores the
set through the online recognizer (``decode/streaming.py``, greedy or
beam) instead, and prints ``CER[streaming] …`` with its buffering. The
checkpoint load's time and each set's utt/s go to stderr, so stdout
compares line by line with the reference's.

With more than one visible card the CLI evaluates on all of them, one
rank a card (``parallel/mesh.launch``; under ``torchrun``, or inside a
process group the caller made, on that group's ranks), over a 1-D mesh
whatever mesh the checkpoint was trained on. When every bucket's batch
splits evenly over the ranks, each rank runs the forward of its rows and
the beam decodes its rows (``--beam``/``--lm``), and ``--streaming`` runs
each rank's segment of the lockstep streams when ``--stream-batch`` splits
too; else every rank evaluates the whole set, as one card would. Every
rank scores the gathered results; rank 0 alone prints and writes
``--hyp-out``.

    python -m chainer_speech_recognition_tpu_torch.cli.evaluate \\
        --ckpt-dir CKPT --data-dir prep --index dev_index.jsonl,dev.pack
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch

from ..checkpoint import load_config
from ..data.corpus import load_index, load_signal
from ..data.packed import PackedBatchLoader, PackedCorpus
from ..data.sampler import BatchLoader, BucketSampler
from ..decode.beam import beam_decode
from ..decode.lm import NGramLM, device_lm
from ..decode.metrics import CERAccumulator
from ..decode.streaming import StreamingRecognizer, decode_lockstep
from ..parallel.mesh import launch, make_mesh, visible_devices
from ..train.loop import evaluate_multi
from ..train.step import make_auto_eval
from ..utils.wav import read_wav
from ..vocab import Vocab
from .common import parse_overrides, resolve_device
from .decode import load_model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--average-last", type=int, default=1,
                   help="average the parameters of the last N kept "
                        "checkpoints (eval-time checkpoint averaging)")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--index", default="dev_index.jsonl",
                   help="index file(s) under --data-dir; comma-separated "
                        "for multi-set eval (a name ending in .pack, or "
                        "with a .pack beside it, reads the packed set) — "
                        "one model load, per-set CER rows")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--beam", type=int, default=0, help="beam width (0=greedy)")
    p.add_argument("--lm", default=None, help="ARPA LM for shallow fusion")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=1.0)
    p.add_argument("--lm-repr", default="auto",
                   choices=("auto", "dense", "hashed"),
                   help="device LM representation: dense table, sparse "
                        "hashed (scales to order>=4 / large V), or auto "
                        "by table size")
    p.add_argument("--compare", action="store_true",
                   help="score greedy, beam-K and beam-K+LM from ONE "
                        "forward pass and print the three-way CER table "
                        "(requires --beam, LM row needs --lm)")
    p.add_argument("--hyp-out", default=None,
                   help="write hypotheses (utt_id<TAB>text, index order) "
                        "from the strongest configured decoder; with "
                        "several sets, one file per set")
    p.add_argument("--tune-lm", action="store_true",
                   help="grid-search (alpha, beta) fusion weights over "
                        "this set from ONE acoustic forward pass (logits "
                        "kept on the device). Requires --beam and --lm.")
    p.add_argument("--tune-alphas", default="0.0,0.25,0.5,0.75,1.0")
    p.add_argument("--tune-betas", default="0.0,0.5,1.0,1.5,2.0")
    p.add_argument("--tune-chunk", type=int, default=64,
                   help="batches whose logits stay on the device at once "
                        "during --tune-lm (bounds device memory on large "
                        "dev sets; the acoustic pass still runs ONCE)")
    p.add_argument("--streaming", action="store_true",
                   help="score through the ONLINE recognizer "
                        "(decode/streaming.py) instead of the offline "
                        "forward; --beam/--lm select the streaming "
                        "decoder; needs a causal-CMVN checkpoint")
    p.add_argument("--stream-chunk", type=int, default=64,
                   help="streaming: emitted frames per step (10 ms units)")
    p.add_argument("--stream-right", type=int, default=None,
                   help="streaming: lookahead frames — buffering latency "
                        "= (chunk + right) x 10 ms. Default 16, or 0 for "
                        "chunk-causal attention checkpoints")
    p.add_argument("--stream-batch", type=int, default=16,
                   help="streaming: lockstep streams per step")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted eval-time config overrides on top of the "
                        "frozen training config (bucket shapes, ...); "
                        "model.* is rejected except the execution-choice "
                        "knobs attn_impl / attn_residual_dtype / rnn_impl")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    launch(_evaluate, visible_devices(device), device, args)


def _evaluate(device, args) -> None:
    """The evaluation on this rank: a 1-D mesh over the ranks whatever
    the training mesh was (the frozen num_devices and dcn_slices do not
    apply); rank 0 alone prints and writes."""
    mesh = make_mesh(dataclasses.replace(
        load_config(args.ckpt_dir).parallel, num_devices=0, dcn_slices=1),
        device)
    with contextlib.ExitStack() as stack:
        if not mesh.is_writer:
            quiet = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(quiet))
            stack.enter_context(contextlib.redirect_stderr(quiet))
        _score(device, args, mesh)


def _score(device, args, mesh) -> None:
    t0 = time.perf_counter()
    cfg, model, path = load_model(args.ckpt_dir, args.average_last,
                                  parse_overrides(args.set), device)
    writer = mesh.is_writer
    # the one place that decides whether the rows split over the ranks
    if not all(bs % mesh.size == 0 for bs in cfg.buckets.batch_sizes):
        mesh = None              # every rank evaluates the whole set
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    load_s = time.perf_counter() - t0
    vocab = Vocab.load(os.path.join(args.data_dir, "vocab.txt"))
    if len(vocab) != cfg.model.vocab_size:
        raise SystemExit(
            f"vocab has {len(vocab)} symbols but the checkpoint was trained "
            f"with model.vocab_size={cfg.model.vocab_size} — wrong vocab "
            "file for this checkpoint (decodes would be silently garbled)")
    set_names = [s for s in args.index.split(",") if s]
    if len(set_names) > 1 and args.tune_lm:
        raise SystemExit("--tune-lm tunes on ONE set; pass a single --index")
    if args.tune_lm and args.compare:
        raise SystemExit("--tune-lm and --compare are mutually exclusive "
                         "(tune first, then --compare at the best weights)")
    if args.lm and args.beam <= 0:
        raise SystemExit("--lm requires --beam K (greedy scoring cannot "
                         "apply LM fusion)")
    if args.streaming and (args.compare or args.tune_lm):
        raise SystemExit("--streaming scores one decoder; it combines with "
                         "--beam/--lm but not --compare/--tune-lm")
    if args.stream_right is None:   # model-aware default (stream_geometry
        # rejects lookahead on chunk-causal attention checkpoints)
        args.stream_right = 0 if cfg.model.attn_chunk else 16
    eval_fn = make_auto_eval(model, cfg, mesh)

    decode_fn = None                  # None: greedy on the device
    lm_dev = None
    if args.beam > 0:
        lm = NGramLM.from_arpa(args.lm, vocab) if args.lm else None
        lm_dev = device_lm(lm, args.lm_repr) if lm else None

        def decode_fn(logits, olens):
            return beam_decode(logits, olens, beam=args.beam, lm=lm_dev,
                               alpha=args.lm_alpha, beta=args.lm_beta,
                               mesh=mesh)

    print(f"checkpoint {path}")
    print(f"checkpoint load {load_s:.3f} s", file=sys.stderr)
    stream_rec = None                 # built once across --index sets
    for set_name in set_names:
        base = os.path.join(args.data_dir, set_name)
        if set_name.endswith(".pack") or os.path.exists(base + ".pack"):
            # packed binary eval set (preprocess --pack): the wire format
            # the train CLI reads, so a packed corpus round-trips
            prefix = base[: -len(".pack")] if set_name.endswith(".pack") \
                else base
            pv = prefix + ".vocab.txt"
            has_sidecar = os.path.exists(pv)   # checked ONCE for both guards
            if has_sidecar and Vocab.load(pv).symbols != vocab.symbols:
                raise SystemExit(
                    f"{pv} differs from the --data-dir vocab — the pack's "
                    "label ids would mis-score against this checkpoint; "
                    "re-pack the eval set with the training vocab")
            pc = PackedCorpus(prefix)
            if not has_sidecar:
                # a pack without a vocab sidecar: bound-check the label ids
                # so an out-of-range encoding fails loudly — a REORDERED
                # vocab of the same size is undetectable here, so say so
                lf = pc.labels_flat
                if lf.size and int(lf.max()) >= len(vocab):
                    raise SystemExit(
                        f"{prefix}.pack labels reach id {int(lf.max())} but "
                        f"the --data-dir vocab has {len(vocab)} symbols — "
                        "the pack was encoded with a different vocab")
                print(f"warning: {prefix}.pack has no .vocab.txt sidecar; "
                      "cannot verify its label ids were encoded with this "
                      "vocab (the loss column is wrong if not; CER is "
                      "unaffected — hypotheses score against stored texts)")
            utts = pc.utterances()
            loader = PackedBatchLoader(pc, cfg.buckets)
            read1 = pc.signal               # streaming reads from the mmap
        else:
            utts = load_index(base)
            loader = BatchLoader(utts, vocab, cfg.buckets)
            read1 = lambda i: load_signal(utts[i], read_wav)
        sampler = BucketSampler(utts, cfg.buckets, seed=0)
        stem = os.path.splitext(os.path.basename(set_name))[0]
        tag = f"[{stem}] " if len(set_names) > 1 else ""
        hyp_out = args.hyp_out
        if hyp_out and len(set_names) > 1:   # one file per set
            root_, ext_ = os.path.splitext(hyp_out)
            hyp_out = f"{root_}.{stem}{ext_}"

        if sampler.num_dropped and not args.streaming:
            # the streaming path below is bucket-free and scores every
            # utterance, so the drop warning would be wrong there
            print(f"{tag}warning: {sampler.num_dropped}/{len(utts)} utterances "
                  "exceed the bucket boundaries / max_label_len, NOT scored")

        def write_hyps(sink):
            if not writer:
                return
            with open(hyp_out, "w", encoding="utf-8") as f:
                for i, text in sorted(sink):
                    f.write(f"{utts[i].utt_id}\t{text}\n")
            print(f"wrote {len(sink)} hypotheses -> {hyp_out}")

        sink = [] if hyp_out else None
        t_set = time.perf_counter()
        if args.streaming:
            if stream_rec is None:     # ONE recognizer across the sets
                stream_rec = StreamingRecognizer(
                    model, cfg, batch=max(1, args.stream_batch),
                    chunk_frames=args.stream_chunk,
                    right_frames=args.stream_right,
                    decoder="beam" if args.beam > 0 else "greedy",
                    beam=args.beam, lm=lm_dev, lm_alpha=args.lm_alpha,
                    lm_beta=args.lm_beta, mesh=mesh)
            rec = stream_rec
            acc = CERAccumulator()
            # length-sorted lockstep batches through the feeder that
            # cli/stream.py shares (decode/streaming.decode_lockstep)
            order = sorted(range(len(utts)),
                           key=lambda i: utts[i].num_samples)
            for grp, ids in decode_lockstep(rec, order, read1):
                texts = [vocab.decode(row) for row in ids]
                acc.add_batch(texts, [utts[i].text for i in grp])
                if sink is not None:
                    sink.extend(zip(grp, texts))
            g = rec.geo
            print(f"{tag}CER[streaming] {acc.cer:.4f} | {acc.num_utts} utts "
                  f"| {acc.edits} edits / {acc.ref_len} ref chars | "
                  f"chunk {g['C']} + lookahead {g['R']} frames "
                  f"(~{(g['C'] + g['R']) * 10} ms buffering)"
                  + ("" if g["conv_exact"] else
                     " | note: lookahead < conv right reach "
                     f"({model.conv_right_margin()}) — boundary frames see "
                     "zero-padded conv context"))
        elif args.tune_lm:
            if args.beam <= 0 or lm_dev is None:
                raise SystemExit("--tune-lm requires --beam K and --lm")
            alphas = [float(x) for x in args.tune_alphas.split(",")]
            betas = [float(x) for x in args.tune_betas.split(",")]
            grid = [(a, b) for a in alphas for b in betas]
            # ONE acoustic forward pass, chunk-major: the logits of
            # --tune-chunk batches stay on the device while every grid
            # point decodes them, then the chunk is released
            accs = {ab: CERAccumulator() for ab in grid}
            sinks = {ab: [] for ab in grid} if hyp_out else None
            batches = sampler.eval_batches()
            Ch = max(1, args.tune_chunk)
            for c0 in range(0, len(batches), Ch):
                stored = []
                for bid, idxs, n_valid in batches[c0 : c0 + Ch]:
                    _, logits, olens = eval_fn(loader.load(bid, idxs))
                    refs = [utts[int(idxs[i])].text for i in range(n_valid)]
                    stored.append((logits, olens, refs, n_valid, idxs))
                for ab in grid:
                    for logits, olens, refs, n_valid, idxs in stored:
                        hyps = beam_decode(logits, olens, beam=args.beam,
                                           lm=lm_dev, alpha=ab[0],
                                           beta=ab[1], mesh=mesh)
                        texts = [vocab.decode(h) for h in hyps[:n_valid]]
                        accs[ab].add_batch(texts, refs)
                        if sinks is not None:
                            sinks[ab].extend((int(idxs[i]), t)
                                             for i, t in enumerate(texts))
            best = None
            for (a, b) in grid:
                acc = accs[(a, b)]
                print(f"alpha={a:<5g} beta={b:<5g} CER {acc.cer:.4f} "
                      f"({acc.edits} edits)")
                if best is None or acc.cer < best[0]:
                    best = (acc.cer, a, b)
            print(f"best: alpha={best[1]:g} beta={best[2]:g} CER "
                  f"{best[0]:.4f}")
            if sinks is not None:
                sink = sinks[(best[1], best[2])]   # best grid point
            acc = accs[(best[1], best[2])]
        elif args.compare:
            if args.beam <= 0:
                raise SystemExit("--compare requires --beam K")
            decoders = {
                "greedy": None,
                f"beam{args.beam}": (lambda lg, ol: beam_decode(
                    lg, ol, beam=args.beam, mesh=mesh)),
            }
            if lm_dev is not None:
                decoders[f"beam{args.beam}+lm"] = decode_fn
            accs, loss = evaluate_multi(eval_fn, loader,
                                        sampler.eval_batches(), vocab, utts,
                                        decoders, sink=sink,
                                        sink_decoder=list(decoders)[-1])
            for name, acc in accs.items():
                print(f"{tag}CER[{name}] {acc.cer:.4f} | {acc.num_utts} "
                      f"utts | {acc.edits} edits / {acc.ref_len} ref chars")
            print(f"{tag}loss {loss:.4f}")
        else:
            accs, loss = evaluate_multi(eval_fn, loader,
                                        sampler.eval_batches(), vocab, utts,
                                        {"_": decode_fn}, sink=sink,
                                        sink_decoder="_")
            acc = accs["_"]
            print(f"{tag}CER {acc.cer:.4f} | loss {loss:.4f} | "
                  f"{acc.num_utts} utts | {acc.edits} edits / "
                  f"{acc.ref_len} ref chars")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_set
        print(f"{tag}scored {acc.num_utts} utts in {wall:.3f} s: "
              f"{acc.num_utts / max(wall, 1e-9):.3f} utt/s", file=sys.stderr)
        if sink is not None:
            write_hyps(sink)


if __name__ == "__main__":
    main()
