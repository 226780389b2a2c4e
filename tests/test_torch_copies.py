"""The port keeps its own copies of the reference's JAX-free host modules
(config, constants, vocab and its BPE learner, wav I/O, the golden NumPy
front-end, synthetic audio and the confusable corpus, the corpus scanners
and CSJ text cleanup, the bucketed sampler and loader, CER scoring, the
n-gram LM) and of the host code
of the streaming recognizer (window assembly, buffer trimming, the
lockstep feeder); each copy is held to the original here, and no module of
the port or ``chip_smoke.py`` imports the JAX package."""

import contextlib
import dataclasses
import os
import re
import shutil
import types

import numpy as np
import pytest

from chainer_speech_recognition_tpu import config as jconfig
from chainer_speech_recognition_tpu import constants as jconst
from chainer_speech_recognition_tpu.data import buckets as jbuckets
from chainer_speech_recognition_tpu.data import corpus as jcorpus
from chainer_speech_recognition_tpu.data import jptext as jjp
from chainer_speech_recognition_tpu.data import sampler as jsampler
from chainer_speech_recognition_tpu.data import synthetic as jsynth
from chainer_speech_recognition_tpu.decode import lm as jlm
from chainer_speech_recognition_tpu.decode import metrics as jmetrics
from chainer_speech_recognition_tpu.decode import streaming as jstream
from chainer_speech_recognition_tpu.frontend import golden_np as jgold
from chainer_speech_recognition_tpu.utils import wav as jwav
from chainer_speech_recognition_tpu.vocab import Vocab as JVocab
from chainer_speech_recognition_tpu.vocab import learn_bpe as jlearn_bpe
from chainer_speech_recognition_tpu_torch import config as tconfig
from chainer_speech_recognition_tpu_torch import constants as tconst
from chainer_speech_recognition_tpu_torch.data import buckets as tbuckets
from chainer_speech_recognition_tpu_torch.data import corpus as tcorpus
from chainer_speech_recognition_tpu_torch.data import jptext as tjp
from chainer_speech_recognition_tpu_torch.data import sampler as tsampler
from chainer_speech_recognition_tpu_torch.data import synthetic as tsynth
from chainer_speech_recognition_tpu_torch.decode import lm as tlm
from chainer_speech_recognition_tpu_torch.decode import metrics as tmetrics
from chainer_speech_recognition_tpu_torch.decode import streaming as tstream
from chainer_speech_recognition_tpu_torch.frontend import golden_np as tgold
from chainer_speech_recognition_tpu_torch.utils import wav as twav
from chainer_speech_recognition_tpu_torch.vocab import Vocab as TVocab
from chainer_speech_recognition_tpu_torch.vocab import learn_bpe as tlearn_bpe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ["tiny_conv", "glu_conv", "conformer", "conformer_stream",
           "bigru", "uni_gru", "bilstm_deep"]


@pytest.mark.parametrize("preset", PRESETS + [None])
def test_config_json_matches(preset):
    j = jconfig.preset_config(preset) if preset else jconfig.Config()
    t = tconfig.preset_config(preset) if preset else tconfig.Config()
    assert t.to_json() == j.to_json()
    # a config.json frozen by either package reads back in the other
    assert tconfig.Config.from_json(j.to_json()).to_json() == j.to_json()
    over = {"model.rnn_hidden": 64, "buckets.boundaries": [32, 64]}
    assert t.override(over).to_json() == j.override(over).to_json()


def test_constants_match():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names and all(getattr(tconst, n) == getattr(jconst, n)
                         for n in names)
    assert all(tconst.num_frames(n) == jconst.num_frames(n)
               for n in (0, 1, 159, 160, 16000))


@pytest.mark.parametrize("unit", ["char", "mora"])
def test_vocab_matches(unit, tmp_path):
    texts = ["きゃりー", "ぱみゅぱみゅ", "abcab", "きょう"]
    j, t = JVocab.build(texts, unit=unit), TVocab.build(texts, unit=unit)
    assert t.symbols == j.symbols
    for s in texts + ["zz"]:
        assert t.encode(s) == j.encode(s)
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    t.save(tmp_path / "v.txt")
    assert JVocab.load(tmp_path / "v.txt").symbols == t.symbols
    with pytest.raises(ValueError, match="<blank>"):
        TVocab(["a"])


@pytest.mark.parametrize("rate,channels", [(16000, 1), (48000, 2)])
def test_wav_io_matches(rate, channels, tmp_path):
    rng = np.random.default_rng(rate)
    sig = (0.3 * rng.standard_normal(rate // 10 * channels)).astype(
        np.float32)
    twav.write_wav(tmp_path / "t.wav", sig, rate, channels)
    jwav.write_wav(tmp_path / "j.wav", sig, rate, channels)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got = twav.read_wav(str(tmp_path / "t.wav"))
    np.testing.assert_array_equal(got, jwav.read_wav_py(str(tmp_path / "t.wav")))
    assert got.dtype == np.float32
    if rate != 16000:
        with pytest.raises(ValueError, match="expected 16000"):
            twav.read_wav(str(tmp_path / "t.wav"), resample=False)


def test_mel_and_window_match():
    np.testing.assert_array_equal(tgold.mel_filterbank(),
                                  jgold.mel_filterbank())
    np.testing.assert_array_equal(tgold.hann_periodic(400),
                                  jgold.hann_periodic(400))


@pytest.mark.parametrize("vocab_size", [None, 8, 64])
def test_synthetic_matches(vocab_size):
    ids = [1, 5, 3, 7] if vocab_size != 8 else [1, 5, 3]
    a = jsynth.make_utterance(np.random.default_rng(4), ids, tone_len=320,
                              vocab_size=vocab_size)
    b = tsynth.make_utterance(np.random.default_rng(4), ids, tone_len=320,
                              vocab_size=vocab_size)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert all(tsynth.tone_frequency(k, vocab_size)
               == jsynth.tone_frequency(k, vocab_size) for k in range(1, 8))


def _corpus(tmp_path, n=23):
    rng = np.random.default_rng(1)
    utts = []
    for i in range(n):
        ids = [int(k) for k in rng.integers(1, 5, rng.integers(1, 6))]
        sig, _ = tsynth.make_utterance(rng, ids, tone_len=int(
            rng.integers(400, 1200)))
        p = str(tmp_path / f"u{i}.wav")
        twav.write_wav(p, sig)
        utts.append(tcorpus.Utterance(f"u{i}", p, "".join(
            "abcd"[k - 1] for k in ids), len(sig)))
    tcorpus.save_index(str(tmp_path / "index.jsonl"), utts)
    return utts


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_and_loader_match(seed, tmp_path):
    tutts = _corpus(tmp_path)
    jutts = jcorpus.load_index(str(tmp_path / "index.jsonl"))
    assert [dataclasses.asdict(u) for u in jutts] == \
        [dataclasses.asdict(u) for u in tcorpus.load_index(
            str(tmp_path / "index.jsonl"))]
    bcfg = {"buckets.boundaries": [40, 70, 100],
            "buckets.batch_sizes": [4, 3, 2], "buckets.max_label_len": 6}
    jb = jconfig.Config().override(bcfg).buckets
    tb = tconfig.Config().override(bcfg).buckets
    js, ts = (jsampler.BucketSampler(jutts, jb, seed=seed),
              tsampler.BucketSampler(tutts, tb, seed=seed))
    assert ts.num_dropped == js.num_dropped
    for epoch in (0, 1, 5):
        a, b = js.epoch_batches(epoch), ts.epoch_batches(epoch)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x[0] == y[0] and x[2] == y[2]
            np.testing.assert_array_equal(x[1], y[1])
    a, b = js.eval_batches(), ts.eval_batches()
    assert [(x[0], list(x[1]), x[2]) for x in a] == \
        [(y[0], list(y[1]), y[2]) for y in b]
    nf = [u.num_frames for u in tutts]
    assert tbuckets.padding_waste(nf, tb) == jbuckets.padding_waste(nf, jb)
    vocab = TVocab(["<blank>", "a", "b", "c", "d"])
    jl = jsampler.BatchLoader(jutts, JVocab(vocab.symbols), jb)
    tl = tsampler.BatchLoader(tutts, vocab, tb)
    for bid, idxs, n_valid in ts.epoch_batches(0)[:4]:
        x, y = jl.load(bid, idxs, n_valid), tl.load(bid, idxs, n_valid)
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]))


def test_cer_matches():
    hyps = ["abcd", "", "xbyd", "aaaa"]
    refs = ["abd", "ab", "abcd", "a"]
    j, t = jmetrics.CERAccumulator(), tmetrics.CERAccumulator()
    j.add_batch(hyps, refs)
    t.add_batch(hyps, refs)
    j.add("abc", "abd")
    t.add("abc", "abd")
    assert (t.edits, t.ref_len, t.num_utts) == (j.edits, j.ref_len,
                                                 j.num_utts)
    assert t.cer == j.cer


@pytest.mark.parametrize("g0,W_lm,lengths,base", [
    (0, 24, None, 0),              # first window: start reflection
    (20, 44, None, 0),             # steady window inside the buffer
    (40, 44, (9000, 6500), 0),     # flush: both streams end inside it
    (52, 44, (9000, 1), 0),        # a one-sample stream
    (60, 44, None, 3200),          # after a trim: absolute offsets
    (60, 44, (12000, 9000), 3200),
])
def test_stream_window_assembly_matches(g0, W_lm, lengths, base):
    """``StreamingRecognizer._assemble``: the same PCM window, reflections
    included, from the same buffer state."""
    rng = np.random.default_rng(g0)
    n = 12000
    buf = rng.uniform(-1, 1, (2, n - base)).astype(np.float32)
    lens = None if lengths is None else np.asarray(lengths)
    state = dict(batch=2, _buf=buf, _n=n, _base=base)
    a = tstream.StreamingRecognizer._assemble(
        types.SimpleNamespace(**state), g0, W_lm, lens)
    b = jstream.StreamingRecognizer._assemble(
        types.SimpleNamespace(**state), g0, W_lm, lens)
    assert a.shape == b.shape == (2, (W_lm + 4) * 160)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t0,n", [(64, 20000), (2048, 400_000),
                                  (4096, 700_000)])
def test_stream_buffer_trim_matches(t0, n):
    """``_trim`` drops the same PCM from the same buffer."""
    geo = {"La": 8, "C": 64}
    fakes = []
    for cls in (tstream.StreamingRecognizer, jstream.StreamingRecognizer):
        f = types.SimpleNamespace(geo=geo, _t0=t0, _n=n, _base=0,
                                  _buf=np.arange(2 * n, dtype=np.float32)
                                  .reshape(2, n))
        cls._trim(f)
        fakes.append(f)
    assert fakes[0]._base == fakes[1]._base
    np.testing.assert_array_equal(fakes[0]._buf, fakes[1]._buf)


def test_decode_lockstep_matches():
    """The lockstep feeder: the same batches, padding rows, buffered PCM
    and flush lengths, and the same reads."""
    sigs = [np.full(n, i + 1, np.float32) for i, n in
            enumerate((700, 300, 900, 500, 100))]

    class Rec:
        batch = 2

        def __init__(self):
            self.log = []

        def reset(self):
            self.log.append("reset")

        def accept(self, pcm, drain):
            self.log.append(("accept", pcm.tolist(), drain))

        def flush(self, num_samples):
            self.log.append(("flush", list(num_samples)))

        @property
        def emitted(self):
            return [[len(self.log)], [0]]

    runs = []
    for mod in (tstream, jstream):
        rec, reads = Rec(), []
        out = list(mod.decode_lockstep(rec, [4, 1, 3, 0, 2],
                                       lambda i: reads.append(i) or sigs[i]))
        runs.append((out, rec.log, reads))
    assert runs[0] == runs[1]


JP_TEXTS = ["(F えー)きょうは<笑>いい(A てんき;天気)ですね。",
            "（Ｆ あの）(D2それ)ぎゅうにゅう(? のむ,のん)",
            "(笑)", "カタカナ・ひらがな「ヴ」ー…", "(M (F え)まえ)x (Dで始まる)",
            "(A 読み;表記)(X ばつ)", "abc(def", "ゃゅょャュョ"]


@pytest.mark.parametrize("kana", [None, "katakana", "hiragana"])
@pytest.mark.parametrize("strip_tags", [True, False])
def test_jptext_matches(kana, strip_tags):
    for t in JP_TEXTS:
        assert tjp.normalize(t, kana=kana, strip_tags=strip_tags) == \
            jjp.normalize(t, kana=kana, strip_tags=strip_tags)
    assert tjp.hira_to_kata("きゃあ") == jjp.hira_to_kata("きゃあ") == "キャア"
    assert tjp.kata_to_hira("キャア") == jjp.kata_to_hira("キャア")


@pytest.mark.parametrize("unit,size", [("char", 30), ("mora", 40),
                                       ("char", 3)])
def test_learn_bpe_matches(unit, size):
    texts = ["きゃりーぱみゅぱみゅ", "ぱみゅぱみゅきゃりー", "きょうきょう",
             "abababcabc", "", "きゃきゃきゃ"] * 2
    with pytest.warns(UserWarning) if size < 10 else contextlib.nullcontext():
        t = tlearn_bpe(texts, size, unit=unit)
    with pytest.warns(UserWarning) if size < 10 else contextlib.nullcontext():
        j = jlearn_bpe(texts, size, unit=unit)
    assert t == j and len(t) > 0


@pytest.mark.parametrize("V", [3, 12, 82])
def test_confusable_synthesis_matches(V):
    tm, jm = tsynth.SymbolMarkov(V), jsynth.SymbolMarkov(V)
    np.testing.assert_array_equal(tm.succ, jm.succ)
    np.testing.assert_array_equal(tm.probs, jm.probs)
    assert tm.sample(np.random.default_rng(1), 30) == \
        jm.sample(np.random.default_rng(1), 30)
    ts, js = tsynth.ConfusableSynth(V), jsynth.ConfusableSynth(V)
    np.testing.assert_array_equal(ts.f1, js.f1)
    np.testing.assert_array_equal(ts.f2, js.f2)
    ids = tm.sample(np.random.default_rng(2), 6)
    for kw in ({}, {"snr_db": 4.0}, {"coarticulation": True}, {"tone_len": 500}):
        a = ts.utterance(np.random.default_rng(3), ids, **kw)
        b = js.utterance(np.random.default_rng(3), ids, **kw)
        assert a[0].dtype == b[0].dtype == np.float32
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    with pytest.raises(ValueError, match="vocab_size >= 3"):
        tsynth.SymbolMarkov(2)


def test_corpus_scanners_match(tmp_path):
    """``scan_corpus`` on wav+txt pairs (a corrupt wav, a wav without a
    transcript), ``scan_kaldi_style`` with and without ``segments``,
    ``normalize_texts`` and ``build_vocab``."""
    rng = np.random.default_rng(0)
    pairs = tmp_path / "pairs"
    (pairs / "a").mkdir(parents=True)
    for i, text in enumerate(JP_TEXTS[:5]):
        sig, _ = tsynth.make_utterance(rng, [1, 2], tone_len=400 + 80 * i)
        twav.write_wav(pairs / ("a" if i % 2 else "") / f"u{i}.wav", sig,
                       16000 if i != 3 else 8000)
        (pairs / ("a" if i % 2 else "") / f"u{i}.txt").write_text(
            text + "\n", encoding="utf-8")
    twav.write_wav(pairs / "lone.wav", sig)
    (pairs / "bad.wav").write_bytes(b"not a wav")
    (pairs / "bad.txt").write_text("x")
    kaldi = tmp_path / "kaldi"
    kaldi.mkdir()
    twav.write_wav(kaldi / "r0.wav", np.zeros(16000, np.float32))
    twav.write_wav(kaldi / "r1.wav", np.zeros(8000, np.float32), 8000)
    (kaldi / "wav.scp").write_text("r0 r0.wav\nr1 r1.wav\n")
    (kaldi / "text").write_text("s0 あい\ns1 う\ns2 え\nr0 お\nr1 か\n",
                                encoding="utf-8")
    plain = tmp_path / "plain"
    shutil.copytree(kaldi, plain)
    (kaldi / "segments").write_text(
        "s0 r0 0.1 0.5\ns1 r1 0.2 3.0\ns2 r1 2.0 3.0\n")
    for root, scan in ((pairs, "scan_corpus"), (kaldi, "scan_kaldi_style"),
                       (plain, "scan_kaldi_style")):
        t = getattr(tcorpus, scan)(str(root))
        j = getattr(jcorpus, scan)(str(root))
        assert [dataclasses.asdict(u) for u in t] == \
            [dataclasses.asdict(u) for u in j] and t
        tn = tcorpus.normalize_texts(t, kana="katakana")
        jn = jcorpus.normalize_texts(j, kana="katakana")
        assert [dataclasses.asdict(u) for u in tn] == \
            [dataclasses.asdict(u) for u in jn]
        for unit in ("char", "mora"):
            assert tcorpus.build_vocab(t, unit).symbols == \
                jcorpus.build_vocab(j, unit).symbols


@pytest.mark.parametrize("cmvn", [False, True, "causal"])
def test_golden_features_match(cmvn):
    sig = np.random.default_rng(5).standard_normal(4321).astype(np.float32)
    a, b = tgold.features(sig, cmvn), jgold.features(sig, cmvn)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


_JAX_IMPORT = re.compile(
    r"^\s*(from|import)\s+chainer_speech_recognition_tpu(\.|\s|$)", re.M)


def test_port_never_imports_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    pkg = os.path.join(REPO, "chainer_speech_recognition_tpu_torch")
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    bad = [f for f in files if _JAX_IMPORT.search(open(f).read())
           or re.search(r"^\s*(from|import)\s+(jax|flax|optax)\b",
                        open(f).read(), re.M)]
    assert not bad, bad


@pytest.mark.parametrize("order", [1, 3, 4])
def test_ngram_lm_copy_matches(order, tmp_path):
    """decode/lm.py's copy: the same public names and hash constants, and
    an LM trained on the same texts gives the same ARPA bytes, dense table
    and hashed table (tests/test_torch_lm.py holds the rest)."""
    public = lambda m: sorted(n for n in vars(m) if not n.startswith("__")
                              and n not in ("np", "math", "defaultdict",
                                            "annotations", "Vocab"))
    assert public(tlm) == public(jlm)
    assert (tlm._CTX_MULT2, tlm._CTX_MOD2) == (jlm._CTX_MULT2, jlm._CTX_MOD2)
    texts = ["あいうあい", "いうえおあ", "おあい", "えおえおう"]
    jv, tv = JVocab.build(texts, add_unk=False), TVocab.build(texts,
                                                               add_unk=False)
    j = jlm.NGramLM.train(texts, jv, order=order)
    t = tlm.NGramLM.train(texts, tv, order=order)
    j.to_arpa(str(tmp_path / "j.arpa"), jv)
    t.to_arpa(str(tmp_path / "t.arpa"), tv)
    assert (tmp_path / "t.arpa").read_bytes() == \
        (tmp_path / "j.arpa").read_bytes()
    assert np.array_equal(t.to_dense()[0], j.to_dense()[0])
    if order > 1:
        assert np.array_equal(t.to_hashed().table, j.to_hashed().table)
