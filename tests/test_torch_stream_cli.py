"""The port's stream CLI (--device cpu) against the reference stream CLI on
the same port-written checkpoint (a forward-only ``uni_gru`` at cut
widths, fp32, causal CMVN): identical output in wav mode, ``--partials``
and ``--raw``, greedy and with the streaming prefix beam and LM fusion;
its refusals, its ``--timing`` line, and a ``conformer_stream``
checkpoint under default flags (``--right-frames`` resolved per model)."""

import io
import sys

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu.cli import stream as jax_stream
from chainer_speech_recognition_tpu_torch.checkpoint import save_checkpoint
from chainer_speech_recognition_tpu_torch.cli import stream as torch_stream
from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.data.synthetic import make_utterance
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.train.state import init_state
from chainer_speech_recognition_tpu_torch.utils.wav import write_wav
from chainer_speech_recognition_tpu_torch.vocab import Vocab

V = 10
CUT = {"model.conv_channels": [8, 8], "model.rnn_hidden": 32,
       "model.rnn_layers": 2, "model.vocab_size": V,
       "model.compute_dtype": "float32"}


def _checkpoint(root, name, **over):
    cfg = preset_config("uni_gru").override({**CUT, **over})
    model = build_model(cfg.model)
    init_parameters(model, 5)
    ckpt = str(root / name)
    save_checkpoint(ckpt, init_state(model, cfg.optim, 0), cfg)
    return ckpt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("stream_cli")
    ckpt = _checkpoint(root, "ckpt")
    vocab = str(root / "vocab.txt")
    Vocab(["<blank>"] + [chr(ord("a") + i) for i in range(V - 1)]).save(vocab)
    rng = np.random.default_rng(0)
    wavs = []
    for i, n in enumerate((6, 2, 9)):           # different lengths
        sig, _ = make_utterance(rng, list(rng.integers(1, V, n)),
                                tone_len=1600, vocab_size=V)
        wavs.append(str(root / f"u{i}.wav"))
        write_wav(wavs[-1], sig)
    return root, ckpt, vocab, wavs


def _run(main, argv, capsys, stdin: bytes | None = None, monkeypatch=None):
    """→ (stdout lines, stderr) of one CLI run."""
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin",
                            io.TextIOWrapper(io.BytesIO(stdin)))
    main(argv)
    out = capsys.readouterr()
    return out.out.splitlines(), out.err


def test_wav_mode_matches_reference_cli(setup, capsys):
    """Three wavs in lockstep batches of 2 (a padded last batch), zero
    lookahead: the same ``path<TAB>text`` lines, in input order."""
    _, ckpt, vocab, wavs = setup
    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", "2",
            "--chunk-frames", "16", "--right-frames", "0", *wavs]
    ref, _ = _run(jax_stream.main, args, capsys)
    got, _ = _run(torch_stream.main, ["--device", "cpu", *args], capsys)
    assert got == ref
    assert [l.split("\t")[0] for l in got] == wavs
    assert any(l.split("\t")[1] for l in got)


def test_partials_and_raw_match_reference_cli(setup, capsys, monkeypatch):
    """--partials (each wav alone in 50 ms blocks, partial hypotheses with
    stream times) and --raw (int16 PCM on stdin): the same lines."""
    _, ckpt, vocab, wavs = setup
    # the reference binds its partial lines to the sys.stdout of its import
    # time; point them at the current one, which capsys reads
    monkeypatch.setattr(jax_stream._print_partial, "__defaults__", (None,))
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--chunk-frames", "16",
            "--right-frames", "0", "--block-ms", "50"]
    ref, _ = _run(jax_stream.main, base + ["--partials", *wavs[:2]], capsys)
    got, _ = _run(torch_stream.main,
                  ["--device", "cpu", "--partials"] + base + wavs[:2], capsys)
    assert got == ref and any(l.startswith("[") for l in got)
    from chainer_speech_recognition_tpu_torch.utils.wav import read_wav

    pcm = (np.clip(read_wav(wavs[2]), -1, 1) * 32767).astype("<i2").tobytes()
    ref, _ = _run(jax_stream.main, base + ["--raw"], capsys, pcm,
                  monkeypatch)
    got, _ = _run(torch_stream.main, ["--device", "cpu", "--raw"] + base,
                  capsys, pcm, monkeypatch)
    assert got == ref and got[-1]


def test_timing_line(setup, capsys):
    _, ckpt, vocab, wavs = setup
    _, err = _run(torch_stream.main,
                  ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cpu",
                   "--chunk-frames", "16", "--timing", wavs[2]], capsys)
    assert "window latency ms over" in err and "p95" in err


def test_refusals(setup, capsys, monkeypatch):
    root, ckpt, vocab, wavs = setup
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cpu"]
    # the reference's own error case of the LM flag
    with pytest.raises(SystemExit, match="--lm requires --beam"):
        torch_stream.main(base + ["--lm", "x.arpa"] + wavs[:1])
    with pytest.raises(SystemExit, match="--lm requires --beam"):
        jax_stream.main(base[:4] + ["--lm", "x.arpa"] + wavs[:1])
    with pytest.raises(SystemExit, match="--raw reads stdin"):
        torch_stream.main(base + ["--raw"] + wavs[:1])
    utt = _checkpoint(root, "utt_cmvn", **{"features.cmvn_mode": "utterance"})
    with pytest.raises(ValueError, match="retrain"):
        torch_stream.main(["--ckpt-dir", utt, "--vocab", vocab, "--device",
                           "cpu", *wavs[:1]])
    # a chunk-causal attention checkpoint streams with default flags:
    # --right-frames resolves to 0 (the lookahead lives inside the chunk)
    # as in the reference CLI, whose output it equals
    acfg = preset_config("conformer_stream").override({
        "model.conv_channels": [4, 4], "model.attn_blocks": 1,
        "model.attn_dim": 16, "model.attn_heads": 1, "model.vocab_size": V,
        "model.compute_dtype": "float32"})
    amodel = build_model(acfg.model)
    init_parameters(amodel, 5)
    attn = str(root / "attn")
    save_checkpoint(attn, init_state(amodel, acfg.optim, 0), acfg)
    aargs = ["--ckpt-dir", attn, "--vocab", vocab, "--batch", "2", *wavs]
    ref, _ = _run(jax_stream.main, aargs, capsys)
    got, _ = _run(torch_stream.main, ["--device", "cpu", *aargs], capsys)
    assert got == ref and len(got) == 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_stream.main(["--ckpt-dir", ckpt, "--vocab", vocab, *wavs[:1]])


def test_beam_lm_matches_reference_cli(setup, capsys, monkeypatch):
    """--beam 4 --lm (a 2-gram over the vocab): wav mode in lockstep
    batches of 2 and --partials in 50 ms blocks, tokens printed as every
    live beam agrees on them and the 1-best tail at the end."""
    from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM

    root, ckpt, vocab, wavs = setup
    tv = Vocab.load(vocab)
    rng = np.random.default_rng(4)
    texts = ["".join(rng.choice(tv.symbols[1:], size=int(rng.integers(3, 9))))
             for _ in range(30)]
    arpa = str(root / "lm2.arpa")
    NGramLM.train(texts, tv, order=2).to_arpa(arpa, tv)
    monkeypatch.setattr(jax_stream._print_partial, "__defaults__", (None,))
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--chunk-frames", "16",
            "--right-frames", "0", "--beam", "4", "--lm", arpa,
            "--lm-alpha", "0.6"]
    for mode in (["--batch", "2", *wavs],
                 ["--partials", "--block-ms", "50", *wavs[:2]]):
        ref, _ = _run(jax_stream.main, base + mode, capsys)
        got, _ = _run(torch_stream.main, ["--device", "cpu"] + base + mode,
                      capsys)
        assert got == ref and any(l.split("\t")[-1] for l in got)
