"""The port's data tools against the reference's on the CPU: make_synthetic
writes byte-identical wav and txt files for the same flags and seed (both
styles, ``--snr-db``, ``--coarticulation``); preprocess writes identical
indexes, vocabs, packs (``.pack`` bytes, ``.meta.npz`` arrays, the
``.vocab.txt`` sidecar) and cached features for pairs and Kaldi corpora,
every unit and the CSJ text cleanup; the packed loader and the
direct-to-pack synthesizer give the same arrays."""

import os

import numpy as np
import pytest

from chainer_speech_recognition_tpu.cli import make_synthetic as jsynth_cli
from chainer_speech_recognition_tpu.cli import preprocess as jprep_cli
from chainer_speech_recognition_tpu.config import Config as JConfig
from chainer_speech_recognition_tpu.data import packed as jpacked
from chainer_speech_recognition_tpu.data import synth_corpus as jsc
from chainer_speech_recognition_tpu.data.sampler import \
    BucketSampler as JSampler
from chainer_speech_recognition_tpu_torch.cli import make_synthetic as tsynth_cli
from chainer_speech_recognition_tpu_torch.cli import preprocess as tprep_cli
from chainer_speech_recognition_tpu_torch.config import Config as TConfig
from chainer_speech_recognition_tpu_torch.data import packed as tpacked
from chainer_speech_recognition_tpu_torch.data import synth_corpus as tsc
from chainer_speech_recognition_tpu_torch.data.synthetic import make_utterance
from chainer_speech_recognition_tpu_torch.utils.wav import write_wav

SHORT = ["--utts", "4", "--min-labels", "6", "--max-labels", "12",
         "--min-seconds", "1", "--max-seconds", "2", "--seed", "11"]
# CSJ-style transcripts: tags, events, fullwidth forms, small kana, a
# pure-filler line that --normalize-text drops
TEXTS = ["(F えー)きょうは<笑>いい(A てんき;天気)ですね。",
         "きゃりーぱみゅぱみゅ、(D ち)ちょっと",
         "（Ｆ あの）ぎゅうにゅうをのむ",
         "(F えっと)",
         "カタカナとひらがなのきょうかい",
         "じゅぎょうしゅうりょう(笑)です"]


def _files(root: str) -> dict:
    """relative path → bytes of every file below ``root``."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


@pytest.mark.parametrize("flags", [
    ["--style", "tones"],
    ["--style", "confusable"],
    ["--style", "confusable", "--snr-db", "6"],
    ["--style", "confusable", "--coarticulation"],
], ids=["tones", "confusable", "snr_db", "coarticulation"])
def test_make_synthetic_writes_the_same_bytes(flags, tmp_path, capsys):
    jsynth_cli.main(["--out", str(tmp_path / "j"), *flags, *SHORT])
    ref = capsys.readouterr().out
    tsynth_cli.main(["--out", str(tmp_path / "t"), *flags, *SHORT])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / "t"), "D") == \
        ref.replace(str(tmp_path / "j"), "D")
    j, t = _files(str(tmp_path / "j")), _files(str(tmp_path / "t"))
    assert len(j) == 8 and sorted(t) == sorted(j)
    for name in j:
        assert t[name] == j[name], name


def test_make_synthetic_refuses_the_other_styles_knob(tmp_path):
    with pytest.raises(SystemExit, match="--snr-db applies"):
        tsynth_cli.main(["--out", str(tmp_path), "--style", "tones",
                         "--snr-db", "3"])
    with pytest.raises(SystemExit, match="--noise applies"):
        tsynth_cli.main(["--out", str(tmp_path), "--noise", "0.1"])


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A tones corpus of wav+txt pairs, a pairs corpus of CSJ-style kana
    transcripts, and a Kaldi-style directory (wav.scp, text, segments)
    slicing two recordings."""
    root = tmp_path_factory.mktemp("corpora")
    tones = str(root / "tones")
    tsynth_cli.main(["--out", tones, "--style", "tones", "--utts", "8",
                     "--vocab", "12", "--min-labels", "3", "--max-labels",
                     "6", "--min-seconds", "0.5", "--max-seconds", "1.2",
                     "--seed", "2"])
    rng = np.random.default_rng(4)
    kana = root / "kana"
    (kana / "sub").mkdir(parents=True)
    for i, text in enumerate(TEXTS):
        d = kana / "sub" if i % 2 else kana
        sig, _ = make_utterance(rng, [1 + i % 5, 2 + i % 3], tone_len=3200)
        write_wav(str(d / f"k{i}.wav"), sig)
        (d / f"k{i}.txt").write_text(text, encoding="utf-8")
    kaldi = root / "kaldi"
    kaldi.mkdir()
    for r in range(2):
        sig, _ = make_utterance(rng, [1, 2, 3, 4, 5], tone_len=6400)
        write_wav(str(kaldi / f"rec{r}.wav"), sig)
    (kaldi / "wav.scp").write_text(
        "rec0 rec0.wav\nrec1 " + str(kaldi / "rec1.wav") + "\n")
    (kaldi / "text").write_text(
        "a0 あいう\na1 えお\nb0 かきく\nb1 けこ\nb2 さし\nb3 すせ\n",
        encoding="utf-8")
    (kaldi / "segments").write_text(
        "a0 rec0 0.0 0.7\na1 rec0 0.7 2.1\n"      # a1 runs past the end
        "b0 rec1 0.25 1.5\nb1 rec1 1.5 1.5\n"      # b1 is empty
        "b2 rec1 5.0 6.0\nb3 rec9 0.0 1.0\n")      # out of range, no wav
    return {"tones": tones, "kana": str(kana), "kaldi": str(kaldi)}


PREP_CASES = {
    "pack": ("tones", ["--dev-fraction", "0.25", "--pack", "--stats"]),
    "mora": ("kana", ["--unit", "mora", "--dev-fraction", "0.2"]),
    "bpe": ("kana", ["--unit", "bpe", "--bpe-size", "70", "--bpe-base",
                     "mora", "--pack"]),
    "kaldi_segments": ("kaldi", ["--format", "kaldi", "--pack"]),
    "normalize_katakana": ("kana", ["--normalize-text", "--kana",
                                    "katakana", "--pack"]),
    "cache_features": ("tones", ["--cache-features", "--cmvn-mode",
                                 "causal", "--dev-fraction", "0.25"]),
}


@pytest.mark.parametrize("case", list(PREP_CASES))
def test_preprocess_writes_the_same_outputs(case, corpora, tmp_path, capsys):
    corpus, flags = PREP_CASES[case]
    outs = {}
    for name, main in (("j", jprep_cli.main), ("t", tprep_cli.main)):
        out = str(tmp_path / name)
        main(["--corpus", corpora[corpus], "--out", out, *flags])
        outs[name] = (out, capsys.readouterr().out.replace(out, "OUT"))
    (jo, jtext), (to, ttext) = outs["j"], outs["t"]
    assert ttext == jtext
    j, t = _files(jo), _files(to)
    assert sorted(t) == sorted(j) and "vocab.txt" in j
    for name in j:
        if name.endswith(".jsonl"):       # feature paths name the out dir
            assert t[name].decode().replace(to, "OUT") == \
                j[name].decode().replace(jo, "OUT"), name
        elif name.endswith(".npz"):       # zip entries carry a timestamp
            a, b = np.load(os.path.join(jo, name)), np.load(
                os.path.join(to, name))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=name)
        else:
            assert t[name] == j[name], name
    if "--pack" in flags:
        assert any(n.endswith(".pack") for n in j)
    if case == "cache_features":
        assert sum(n.endswith(".npy") for n in j) == 8
    vocab = j["vocab.txt"].decode().splitlines()
    if case == "bpe":                 # merges past the 55 base units
        assert 57 < len(vocab) <= 70
    if case == "kaldi_segments":      # a0, a1 (clamped), b0
        assert j["train_index.jsonl"].decode().count("\n") == 3


def test_packed_loader_and_synthesizer_match(corpora, tmp_path):
    """``PackedBatchLoader.load`` on one pack, every key equal for eval
    batches (padded remainders) and training batches (n_valid masks); and
    ``synthesize_packed``'s three files."""
    out = str(tmp_path / "prep")
    tprep_cli.main(["--corpus", corpora["tones"], "--out", out, "--pack"])
    prefix = os.path.join(out, "train")
    jc, tc = jpacked.PackedCorpus(prefix), tpacked.PackedCorpus(prefix)
    assert len(tc) == len(jc) == 8
    assert [u.__dict__ for u in tc.utterances()] == \
        [u.__dict__ for u in jc.utterances()]
    over = {"buckets.boundaries": [64, 128], "buckets.batch_sizes": [3, 2],
            "buckets.max_label_len": 8}
    jb, tb = JConfig().override(over).buckets, TConfig().override(over).buckets
    jl, tl = jpacked.PackedBatchLoader(jc, jb), tpacked.PackedBatchLoader(
        tc, tb)
    sampler = JSampler(jc.utterances(), jb, seed=1)
    batches = sampler.eval_batches() + sampler.epoch_batches(0)
    assert batches
    for bid, idxs, n_valid in batches:
        a, b = jl.load(bid, idxs, n_valid), tl.load(bid, idxs, n_valid)
        assert sorted(a) == sorted(b)
        assert b["signals_i16"].dtype == np.int16
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    np.testing.assert_array_equal(tc.signal(3), jc.signal(3))

    kw = dict(n_utts=3, vocab_size=10, max_samples=40 * 160, min_labels=2,
              max_labels=4, seed=5)
    rj = jsc.synthesize_packed(str(tmp_path / "j"), **kw)
    rt = tsc.synthesize_packed(str(tmp_path / "t"), **kw)
    assert rj["built"] and rt["built"] and rt["bytes"] == rj["bytes"]
    for ext in (".pack", ".vocab.txt"):
        assert open(str(tmp_path / "t") + ext, "rb").read() == \
            open(str(tmp_path / "j") + ext, "rb").read()
    a = np.load(str(tmp_path / "j") + ".meta.npz")
    b = np.load(str(tmp_path / "t") + ".meta.npz")
    for k in a.files:
        np.testing.assert_array_equal(b[k], a[k])
    # idempotent: a matching pack is reused, not rebuilt
    assert tsc.synthesize_packed(str(tmp_path / "t"), **kw)["built"] is False


def test_packed_corpus_refuses_a_foreign_file(tmp_path):
    (tmp_path / "x.pack").write_bytes(b"RIFF....")
    with pytest.raises(ValueError, match="not a CSRPACK1 file"):
        tpacked.PackedCorpus(str(tmp_path / "x"))
