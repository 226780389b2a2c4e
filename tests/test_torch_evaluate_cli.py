"""The port's evaluate CLI (--device cpu) against the reference's on the
same data directory and port-written checkpoints (a cut bigru: conv
[8, 8], 2 BiGRU layers of H = 32, fp32 compute): the same result lines
(CER, edits, reference characters, utterance count; the loss within the
rtol 1e-5 that tests/test_torch_train_step.py holds the loss to), the
same --hyp-out files, with --average-last 2, a two-set --index with a
.pack set and the bucket-drop warning; --streaming on a causal-CMVN
checkpoint; config 4: --beam with --lm, --compare (greedy, beam and
beam+LM from one forward pass), a 2×2 --tune-lm grid and --streaming
--beam --lm; and the reference's error cases."""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu.cli import evaluate as jax_eval
from chainer_speech_recognition_tpu_torch.checkpoint import save_checkpoint
from chainer_speech_recognition_tpu_torch.cli import evaluate as torch_eval
from chainer_speech_recognition_tpu_torch.cli import (
    make_synthetic, preprocess, train_lm)
from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.data import packed
from chainer_speech_recognition_tpu_torch.data.corpus import load_index
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.train.state import init_state
from chainer_speech_recognition_tpu_torch.vocab import Vocab

LOSS_RTOL = 1e-5
# one bucket of 100 frames: the utterances past 1 s are dropped (warned)
BUCKETS = ["buckets.boundaries=[100]", "buckets.batch_sizes=[2]",
           "buckets.max_label_len=8"]
_CER = re.compile(r"CER(\[streaming\])? ([0-9.]+) \| (?:loss ([0-9.]+) \| )?"
                  r"(\d+) utts \| (\d+) edits / (\d+) ref chars")


def _checkpoints(root, name, V, steps, **over):
    cfg = preset_config("bigru").override({
        "model.conv_channels": [8, 8], "model.rnn_hidden": 32,
        "model.rnn_layers": 2, "model.vocab_size": V,
        "model.compute_dtype": "float32", **over})
    model = build_model(cfg.model)
    ckpt = str(root / name)
    for step in range(steps):
        init_parameters(model, 7 + step)
        state = init_state(model, cfg.optim, 0)
        state.step = step
        save_checkpoint(ckpt, state, cfg)
    return ckpt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("evaluate_cli")
    corpus, data = str(root / "corpus"), str(root / "data")
    make_synthetic.main(["--out", corpus, "--style", "tones", "--utts", "14",
                         "--vocab", "10", "--min-labels", "2",
                         "--max-labels", "5", "--min-seconds", "0.5",
                         "--max-seconds", "1.3", "--seed", "3"])
    preprocess.main(["--corpus", corpus, "--out", data, "--dev-fraction",
                     "0.5", "--pack"])
    V = len(Vocab.load(os.path.join(data, "vocab.txt")))
    ckpt = _checkpoints(root, "ckpt", V, 2)
    causal = _checkpoints(root, "causal", V, 1,
                          **{"features.cmvn_mode": "causal"})
    train_lm.main(["--data-dir", data, "--order", "3"])
    return root, data, ckpt, causal


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def _compare(ref, got, root, hyp_names):
    """Result lines equal but for the loss (LOSS_RTOL), other lines
    equal after the hypothesis file names."""
    assert len(got) == len(ref)
    n_results = 0
    for r, g in zip(ref, got):
        for a, b in hyp_names:
            r = r.replace(a, "HYP")
            g = g.replace(b, "HYP")
        mr, mg = _CER.search(r), _CER.search(g)
        if mr is None:
            assert g == r
            continue
        n_results += 1
        assert mg is not None, g
        assert r[: mr.start()] == g[: mg.start()]          # set tag
        assert [mg.group(i) for i in (1, 2, 4, 5, 6)] == \
            [mr.group(i) for i in (1, 2, 4, 5, 6)]
        assert r[mr.end():] == g[mg.end():]                # buffering note
        if mr.group(3) is not None:
            np.testing.assert_allclose(float(mg.group(3)),
                                       float(mr.group(3)), rtol=LOSS_RTOL)
    return n_results


def test_offline_two_sets_average_last_and_hyps_match(setup, capsys):
    root, data, ckpt, _ = setup
    args = ["--ckpt-dir", ckpt, "--data-dir", data, "--average-last", "2",
            "--index", "dev_index.jsonl,dev.pack", "--set", *BUCKETS]
    jhyp, thyp = str(root / "j_hyp.txt"), str(root / "t_hyp.txt")
    ref = _run(jax_eval.main, args + ["--hyp-out", jhyp], capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--hyp-out", thyp]
               + args, capsys)
    assert _compare(ref, got, root, [(str(root / "j_hyp"),
                                      str(root / "t_hyp"))]) == 2
    assert got[0].startswith("checkpoint avg[step_00000000.msgpack,")
    assert sum("NOT scored" in l for l in got) == 2      # drop warning
    for stem in ("dev_index", "dev"):
        a = open(str(root / f"j_hyp.{stem}.txt"), encoding="utf-8").read()
        b = open(str(root / f"t_hyp.{stem}.txt"), encoding="utf-8").read()
        assert b == a and b.count("\n") >= 2
    # the pack stores the wavs' int16 samples: both sets score the same
    a, b = [_CER.search(l) for l in got if _CER.search(l)]
    assert a.group(0) == b.group(0)


def test_streaming_matches_reference(setup, capsys):
    root, data, _, causal = setup
    args = ["--ckpt-dir", causal, "--data-dir", data, "--streaming",
            "--stream-chunk", "16", "--stream-batch", "2", "--index",
            "dev.pack"]
    jhyp, thyp = str(root / "js.txt"), str(root / "ts.txt")
    ref = _run(jax_eval.main, args + ["--hyp-out", jhyp], capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--hyp-out", thyp]
               + args, capsys)
    assert _compare(ref, got, root, [(jhyp, thyp)]) == 1
    assert "CER[streaming]" in got[1] and "lookahead 16 frames" in got[1]
    n = len(load_index(os.path.join(data, "dev_index.jsonl")))
    assert f"| {n} utts |" in got[1]          # every utterance, no buckets
    assert open(thyp).read() == open(jhyp).read()


def test_refusals(setup, tmp_path, monkeypatch):
    root, data, ckpt, _ = setup
    base = ["--ckpt-dir", ckpt, "--device", "cpu"]
    # a vocab of another size than the checkpoint's
    other = str(tmp_path / "other")
    shutil.copytree(data, other)
    v = Vocab.load(os.path.join(data, "vocab.txt"))
    Vocab(v.symbols + ["ん"]).save(os.path.join(other, "vocab.txt"))
    with pytest.raises(SystemExit, match="wrong vocab file"):
        torch_eval.main(base + ["--data-dir", other])
    # a pack sidecar that differs from the data-dir vocab
    Vocab(v.symbols).save(os.path.join(other, "vocab.txt"))
    swapped = v.symbols[:1] + v.symbols[2:3] + v.symbols[1:2] + v.symbols[3:]
    Vocab(swapped).save(os.path.join(other, "dev.vocab.txt"))
    with pytest.raises(SystemExit, match="differs from the --data-dir vocab"):
        torch_eval.main(base + ["--data-dir", other, "--index", "dev.pack"])
    # a pack without a sidecar whose ids run past the vocab
    utts = load_index(os.path.join(data, "dev_index.jsonl"))
    packed.pack_corpus(os.path.join(other, "big"), utts,
                       Vocab(["<blank>"] + [f"x{i}" for i in range(20)]
                             + v.symbols[1:]))
    os.remove(os.path.join(other, "big.vocab.txt"))
    with pytest.raises(SystemExit, match="encoded with a different vocab"):
        torch_eval.main(base + ["--data-dir", other, "--index", "big.pack"])
    with pytest.raises(SystemExit, match="cannot override model topology"):
        torch_eval.main(base + ["--data-dir", data, "--set",
                                "model.vocab_size=5"])
    # the reference's own error cases of the beam and LM flags
    for extra, match in (
            (["--lm", "x.arpa"], "--lm requires --beam"),
            (["--compare"], "--compare requires --beam"),
            (["--tune-lm", "--beam", "4"], "requires --beam K and --lm"),
            (["--tune-lm", "--compare", "--beam", "4"], "mutually exclusive"),
            (["--streaming", "--compare", "--beam", "4"], "one decoder"),
            (["--tune-lm", "--index", "a.jsonl,b.jsonl"], "ONE set")):
        with pytest.raises(SystemExit, match=match):
            torch_eval.main(base + ["--data-dir", data, *extra])
        with pytest.raises(SystemExit, match=match):
            jax_eval.main(["--ckpt-dir", ckpt, "--data-dir", data, *extra])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_eval.main(["--ckpt-dir", ckpt, "--data-dir", data])


def _lm(data):
    return ["--lm", os.path.join(data, "lm_3gram.arpa")]


def _same_lines(ref, got, hyp_names=()):
    """Line by line equal after the hypothesis file names, but a
    ``loss X`` line within LOSS_RTOL."""
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        for a, b in hyp_names:
            r, g = r.replace(a, "HYP"), g.replace(b, "HYP")
        if r.startswith("loss ") and g.startswith("loss "):
            np.testing.assert_allclose(float(g[5:]), float(r[5:]),
                                       rtol=LOSS_RTOL)
        else:
            assert g == r


def test_compare_and_beam_lm_match_reference(setup, capsys):
    """--compare prints CER[greedy], CER[beam4] and CER[beam4+lm] from one
    forward pass, and --hyp-out takes the beam+LM hypotheses; a plain
    --beam --lm run prints the reference's CER line."""
    root, data, ckpt, _ = setup
    jhyp, thyp = str(root / "jc.txt"), str(root / "tc.txt")
    args = ["--ckpt-dir", ckpt, "--data-dir", data, "--beam", "4",
            *_lm(data), "--lm-alpha", "0.7", "--lm-beta", "0.4"]
    ref = _run(jax_eval.main, args + ["--compare", "--hyp-out", jhyp],
               capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--compare",
                                 "--hyp-out", thyp] + args, capsys)
    _same_lines(ref, got, [(jhyp, thyp)])
    assert [l.split(" ")[0] for l in got[1:4]] == [
        "CER[greedy]", "CER[beam4]", "CER[beam4+lm]"]
    assert open(thyp).read() == open(jhyp).read()
    ref = _run(jax_eval.main, args + ["--lm-repr", "hashed"], capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--lm-repr", "hashed"]
               + args, capsys)
    assert _compare(ref, got, root, []) == 1


def test_tune_lm_grid_matches_reference(setup, capsys):
    """A 2×2 (alpha, beta) grid over logits kept from one forward pass
    (--tune-chunk 1: one batch's logits at a time): every grid line, the
    best point and its hypotheses."""
    root, data, ckpt, _ = setup
    jhyp, thyp = str(root / "jt.txt"), str(root / "tt.txt")
    args = ["--ckpt-dir", ckpt, "--data-dir", data, "--beam", "4",
            *_lm(data), "--tune-lm", "--tune-alphas", "0.0,0.8",
            "--tune-betas", "0.0,1.5", "--tune-chunk", "1"]
    ref = _run(jax_eval.main, args + ["--hyp-out", jhyp], capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--hyp-out", thyp]
               + args, capsys)
    _same_lines(ref, got, [(jhyp, thyp)])
    assert sum(l.startswith("alpha=") for l in got) == 4
    assert any(l.startswith("best: alpha=") for l in got)
    assert open(thyp).read() == open(jhyp).read()


def test_streaming_beam_lm_matches_reference(setup, capsys):
    root, data, _, causal = setup
    args = ["--ckpt-dir", causal, "--data-dir", data, "--streaming",
            "--stream-chunk", "16", "--stream-batch", "2", "--beam", "4",
            *_lm(data)]
    jhyp, thyp = str(root / "jsb.txt"), str(root / "tsb.txt")
    ref = _run(jax_eval.main, args + ["--hyp-out", jhyp], capsys)
    got = _run(torch_eval.main, ["--device", "cpu", "--hyp-out", thyp]
               + args, capsys)
    assert _compare(ref, got, root, [(jhyp, thyp)]) == 1
    assert "CER[streaming]" in got[1]
    assert open(thyp).read() == open(jhyp).read()


def test_conformer_stream_streaming_matches_reference(setup, capsys):
    """``evaluate --streaming`` scores a chunk-causal attention checkpoint
    (conformer_stream cut to 1 block of d = 16, chunk 4, left 2, causal
    CMVN) greedy and with ``--beam 4 --lm``: the lookahead resolves to 0
    and the lines and hypotheses equal the reference CLI's."""
    root, data, _, _ = setup
    V = len(Vocab.load(os.path.join(data, "vocab.txt")))
    cfg = preset_config("conformer_stream").override({
        "model.conv_channels": [8, 8], "model.attn_blocks": 1,
        "model.attn_dim": 16, "model.attn_heads": 2, "model.attn_chunk": 4,
        "model.attn_left_chunks": 2, "model.attn_conv_kernel": 7,
        "model.vocab_size": V, "model.compute_dtype": "float32",
        "features.cmvn_mode": "causal"})
    model = build_model(cfg.model)
    init_parameters(model, 11)
    ckpt = str(root / "cstream")
    save_checkpoint(ckpt, init_state(model, cfg.optim, 0), cfg)
    for extra in ([], ["--beam", "4", *_lm(data)]):
        args = ["--ckpt-dir", ckpt, "--data-dir", data, "--streaming",
                "--stream-batch", "2", "--index", "dev.pack", *extra]
        jhyp, thyp = str(root / "jc.txt"), str(root / "tc.txt")
        ref = _run(jax_eval.main, args + ["--hyp-out", jhyp], capsys)
        got = _run(torch_eval.main, ["--device", "cpu", "--hyp-out", thyp]
                   + args, capsys)
        assert _compare(ref, got, root, [(jhyp, thyp)]) == 1
        assert "CER[streaming]" in got[1] and "lookahead 0 frames" in got[1]
        assert open(thyp).read() == open(jhyp).read()
