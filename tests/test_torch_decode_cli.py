"""The port's decode CLI (--device cpu) vs the reference decode CLI on the
same tiny checkpoint and wavs: identical transcripts at fp32 compute,
greedy and with prefix beam search and LM fusion (--beam, --lm, --lm-repr,
--nbest), and the reference's error cases."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.cli import decode as jax_decode
from chainer_speech_recognition_tpu.config import preset_config
from chainer_speech_recognition_tpu.data.synthetic import make_utterance
from chainer_speech_recognition_tpu.models.presets import build_model
from chainer_speech_recognition_tpu.train.checkpoint import save_checkpoint
from chainer_speech_recognition_tpu.train.state import init_state
from chainer_speech_recognition_tpu.utils.wav import write_wav
from chainer_speech_recognition_tpu.vocab import Vocab
from chainer_speech_recognition_tpu_torch.cli import decode as torch_decode
from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM
from chainer_speech_recognition_tpu_torch.vocab import Vocab as TVocab

V = 10


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode_cli")
    cfg = preset_config("bigru").override({
        "model.conv_channels": [8, 8], "model.rnn_hidden": 32,
        "model.rnn_layers": 2, "model.vocab_size": V,
        "model.compute_dtype": "float32"})
    model = build_model(cfg.model)
    state = init_state(model, cfg.optim, jax.random.key(3),
                       jnp.zeros((1, 32, 40, 3)), jnp.asarray([32]))
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, state, cfg)
    vocab = str(root / "vocab.txt")
    Vocab(["<blank>"] + [chr(ord("a") + i) for i in range(V - 1)]).save(vocab)
    rng = np.random.default_rng(0)
    wavs = []
    for i, n in enumerate((3, 1, 5, 2, 4)):     # different lengths
        sig, _ = make_utterance(rng, list(rng.integers(1, V, n)),
                                tone_len=1200)
        wavs.append(str(root / f"u{i}.wav"))
        write_wav(wavs[-1], sig)
    tv = TVocab.load(vocab)
    texts = ["".join(rng.choice(tv.symbols[1:], size=int(rng.integers(3, 9))))
             for _ in range(30)]
    for order in (2, 3):
        NGramLM.train(texts, tv, order=order).to_arpa(
            str(root / f"lm{order}.arpa"), tv)
    return ckpt, vocab, wavs


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_transcripts_match_reference_cli(setup, capsys):
    """Chunked decode (--batch 2 < 5 wavs: length-sorted, 1 s-quantized
    chunks, a padded last chunk). fp32 logits agree to ~1e-6, far inside
    any top-2 gap these random weights leave, so greedy output is
    identical."""
    ckpt, vocab, wavs = setup
    jax_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", "2",
                     *wavs])
    ref = _lines(capsys)
    torch_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab, "--device",
                       "cpu", "--batch", "2", *wavs])
    got = _lines(capsys)
    assert got == ref
    assert [l.split("\t")[0] for l in got] == wavs          # input order
    assert any(l.split("\t")[1] for l in got)               # not all empty
    # one chunk (no length quantization) decodes the same transcripts
    torch_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab, "--device",
                       "cpu", "--batch", "8", *wavs])
    assert _lines(capsys) == ref


def test_wav_list_and_average_last(setup, capsys, tmp_path):
    ckpt, vocab, wavs = setup
    lst = tmp_path / "wavs.txt"
    lst.write_text("\n".join(wavs[2:]) + "\n")
    torch_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab, "--device",
                       "cpu", "--wav-list", str(lst), wavs[0]])
    got = _lines(capsys)
    assert [l.split("\t")[0] for l in got] == [wavs[0]] + wavs[2:]
    with pytest.raises(SystemExit, match="only 1"):
        torch_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab, "--device",
                           "cpu", "--average-last", "2", wavs[0]])


def test_refusals(setup, tmp_path, monkeypatch):
    ckpt, vocab, wavs = setup
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cpu"]
    # the reference's own error cases of the beam flags
    for extra, match in ((["--lm", "x.arpa"], "--lm requires --beam"),
                         (["--nbest", "2"], "--nbest requires --beam")):
        with pytest.raises(SystemExit, match=match):
            torch_decode.main(base + extra + wavs[:1])
        with pytest.raises(SystemExit, match=match):
            jax_decode.main(base[:4] + extra + wavs[:1])
    with pytest.raises(SystemExit, match="model topology"):
        torch_decode.main(["--set", "model.rnn_hidden=64"] + base + wavs[:1])
    bad_vocab = str(tmp_path / "v.txt")
    Vocab(["<blank>", "a"]).save(bad_vocab)
    with pytest.raises(SystemExit, match="vocab has 2 symbols"):
        torch_decode.main(["--ckpt-dir", ckpt, "--vocab", bad_vocab,
                           "--device", "cpu", *wavs[:1]])
    # --device cuda never falls back to the CPU
    monkeypatch.setattr(torch_decode.torch.cuda, "is_available",
                        lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_decode.main(["--ckpt-dir", ckpt, "--vocab", vocab,
                           "--device", "cuda", *wavs[:1]])


def test_exec_knob_override_keeps_transcripts(setup, capsys):
    ckpt, vocab, wavs = setup
    base = ["--ckpt-dir", ckpt, "--vocab", vocab, "--device", "cpu", *wavs]
    torch_decode.main(base)
    a = _lines(capsys)
    torch_decode.main(["--set", "model.rnn_impl=scan",
                       "features.frontend_impl=jnp"] + base)
    assert _lines(capsys) == a


@pytest.mark.parametrize("extra", [
    ["--beam", "4"],
    ["--beam", "4", "--lm", "lm3.arpa", "--lm-alpha", "0.8"],
    ["--beam", "4", "--lm", "lm3.arpa", "--lm-repr", "hashed", "--nbest",
     "3"],
    ["--beam", "2", "--lm", "lm2.arpa", "--nbest", "5"],   # clamped to 2
])
def test_beam_transcripts_match_reference_cli(setup, capsys, extra):
    """Prefix beam decoding, with and without LM fusion (dense and hashed
    tables), 1-best and n-best (rank and log-score columns): the same
    stdout as the reference CLI; --nbest above the beam is clamped with a
    warning on stderr."""
    ckpt, vocab, wavs = setup
    root = os.path.dirname(vocab)
    extra = [os.path.join(root, x) if x.endswith(".arpa") else x
             for x in extra]
    args = ["--ckpt-dir", ckpt, "--vocab", vocab, "--batch", "2", *extra,
            *wavs]
    jax_decode.main(args)
    ref = capsys.readouterr()
    torch_decode.main(["--device", "cpu", *args])
    got = capsys.readouterr()
    assert got.out.splitlines() == ref.out.splitlines()
    assert ("clamped" in got.err) == ("5" in extra)
    lines = got.out.splitlines()
    assert len(lines) == len(wavs) * min(
        int(extra[extra.index("--nbest") + 1]) if "--nbest" in extra else 1,
        int(extra[1]))
