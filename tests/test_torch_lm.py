"""The port's n-gram LM (decode/lm.py) and ``cli.train_lm`` against the
reference's, bit for bit: the trained LM's ARPA bytes, ``from_arpa``
(out-of-vocab symbols dropped) and its scores, the dense table, the hashed
table and rows, and ``device_lm``'s choice under each representation and
budget (order 1 included)."""

import numpy as np
import pytest

from chainer_speech_recognition_tpu.cli import train_lm as jax_train_lm
from chainer_speech_recognition_tpu.decode import lm as jlm
from chainer_speech_recognition_tpu.vocab import Vocab as JVocab
from chainer_speech_recognition_tpu_torch.cli import make_synthetic
from chainer_speech_recognition_tpu_torch.cli import preprocess
from chainer_speech_recognition_tpu_torch.cli import train_lm as torch_train_lm
from chainer_speech_recognition_tpu_torch.decode import lm as tlm
from chainer_speech_recognition_tpu_torch.vocab import Vocab as TVocab

SYMS = [chr(0x3042 + i) for i in range(9)]
TEXTS = ["".join(np.random.default_rng(s).choice(SYMS, size=n))
         for s, n in enumerate([3, 7, 5, 9, 4, 6, 8, 2, 5, 7, 6, 3])]


def _pair(order):
    jv, tv = JVocab.build(TEXTS, add_unk=False), TVocab.build(TEXTS,
                                                               add_unk=False)
    return (jlm.NGramLM.train(TEXTS, jv, order=order), jv,
            tlm.NGramLM.train(TEXTS, tv, order=order), tv)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_train_arpa_and_scores_match(order, tmp_path):
    j, jv, t, tv = _pair(order)
    assert t.logp == j.logp and t.backoff == j.backoff
    j.to_arpa(tmp_path / "j.arpa", jv)
    t.to_arpa(tmp_path / "t.arpa", tv)
    assert (tmp_path / "t.arpa").read_bytes() == \
        (tmp_path / "j.arpa").read_bytes()
    jr = jlm.NGramLM.from_arpa(str(tmp_path / "j.arpa"), jv)
    tr = tlm.NGramLM.from_arpa(str(tmp_path / "j.arpa"), tv)
    assert tr.order == jr.order and tr.logp == jr.logp
    assert [dict(b) for b in tr.backoff] == [dict(b) for b in jr.backoff]
    rng = np.random.default_rng(order)
    for _ in range(50):
        ctx = tuple(int(c) for c in rng.integers(0, len(tv), 3))
        c = int(rng.integers(1, len(tv)))
        assert tr.score(ctx, c) == jr.score(ctx, c)
        assert t.score(ctx, c) == j.score(ctx, c)
    ids = [int(c) for c in rng.integers(1, len(tv), 12)]
    assert t.sequence_logp(ids) == j.sequence_logp(ids)


def test_from_arpa_drops_oov_symbols(tmp_path):
    j, jv, t, tv = _pair(2)
    arpa = tmp_path / "lm.arpa"
    j.to_arpa(str(arpa), jv)
    small = SYMS[:5]
    jr = jlm.NGramLM.from_arpa(str(arpa), JVocab(["<blank>"] + small))
    tr = tlm.NGramLM.from_arpa(str(arpa), TVocab(["<blank>"] + small))
    assert tr.logp == jr.logp and tr.V == jr.V == 6
    with pytest.raises(ValueError, match="every n-gram was dropped"):
        tlm.NGramLM.from_arpa(str(arpa), TVocab(["<blank>", "x"]))


@pytest.mark.parametrize("order", [1, 2, 3])
def test_dense_tables_match(order):
    j, _, t, _ = _pair(order)
    (jt, jn), (tt, tn) = j.to_dense(), t.to_dense()
    assert tn == jn and tt.dtype == jt.dtype and np.array_equal(tt, jt)
    V = t.V
    cid = 7 % (V ** max(order - 1, 1))
    assert tlm.NGramLM.next_context_id(cid, 3, V, order) == \
        jlm.NGramLM.next_context_id(cid, 3, V, order)


@pytest.mark.parametrize("order,probes,dtype", [(2, 8, np.float32),
                                                (3, 8, np.float32),
                                                (4, 2, np.float16)])
def test_hashed_tables_match(order, probes, dtype):
    j, _, t, _ = _pair(order)
    jh = j.to_hashed(max_probes=probes, rows_dtype=dtype)
    th = t.to_hashed(max_probes=probes, rows_dtype=dtype)
    assert th.order == jh.order and th.max_probes == jh.max_probes
    assert np.array_equal(th.table, jh.table)
    assert th.rows.dtype == jh.rows.dtype
    assert np.array_equal(th.rows, jh.rows)
    assert th.bytes == jh.bytes and th.vocab_size == jh.vocab_size
    with pytest.raises(ValueError, match="order >= 2"):
        tlm.NGramLM(1, 5).to_hashed()


def test_ctx_keys_match_wrapping():
    """key1 past int32 (V^k > 2^31) wraps exactly like the reference."""
    for V in (7, 3000, 32767):
        for ctx in [(), (1,), (0, 0, 5), (V - 1,) * 4, (3, V - 2, 1, 9, 4)]:
            assert tlm.ctx_keys(ctx, V) == jlm.ctx_keys(ctx, V)


@pytest.mark.parametrize("order", [1, 3, 4])
@pytest.mark.parametrize("repr_", ["auto", "dense", "hashed"])
@pytest.mark.parametrize("dense_budget,rows_budget", [(256 << 20, 512 << 20),
                                                      (1000, 1000)])
def test_device_lm_choice_matches(order, repr_, dense_budget, rows_budget):
    j, _, t, _ = _pair(order)
    jd = jlm.device_lm(j, repr_, dense_budget, rows_budget)
    td = tlm.device_lm(t, repr_, dense_budget, rows_budget)
    if isinstance(jd, tuple):
        assert isinstance(td, tuple) and td[1] == jd[1]
        assert np.array_equal(td[0], jd[0])
    else:
        assert isinstance(td, tlm.HashedLM)
        assert np.array_equal(td.table, jd.table)
        assert td.rows.dtype == jd.rows.dtype
        assert np.array_equal(td.rows, jd.rows)
    with pytest.raises(ValueError, match="unknown LM repr"):
        tlm.device_lm(t, "sparse")


@pytest.mark.parametrize("order", [2, 3])
def test_train_lm_cli_writes_the_same_file(order, tmp_path, capsys):
    corpus, data = str(tmp_path / "corpus"), str(tmp_path / "data")
    make_synthetic.main(["--out", corpus, "--style", "tones", "--utts", "12",
                         "--vocab", "8", "--min-labels", "2",
                         "--max-labels", "6", "--min-seconds", "0.5",
                         "--max-seconds", "1.0"])
    preprocess.main(["--corpus", corpus, "--out", data])
    capsys.readouterr()
    jout, tout = str(tmp_path / "j.arpa"), str(tmp_path / "t.arpa")
    jax_train_lm.main(["--data-dir", data, "--order", str(order),
                       "--out", jout])
    ref = capsys.readouterr().out.replace(jout, "OUT")
    torch_train_lm.main(["--data-dir", data, "--order", str(order),
                         "--out", tout])
    got = capsys.readouterr().out.replace(tout, "OUT")
    assert got == ref and "-gram LM on" in got
    assert open(tout, "rb").read() == open(jout, "rb").read()
