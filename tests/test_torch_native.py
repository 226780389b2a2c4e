"""The port's C++ batch edit distance (``native/edit_distance.cpp``, built
by ``utils/native.py``) against the reference's native batch and the
plain ``edit_distance_py``, on random id sequences with empty sides; two
processes that build the library at once both succeed."""

import os
import subprocess
import sys

import numpy as np
import pytest

from chainer_speech_recognition_tpu.decode import metrics as jmetrics
from chainer_speech_recognition_tpu_torch.decode import metrics as tmetrics
from chainer_speech_recognition_tpu_torch.utils import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_edit_distance_matches_reference_and_plain(seed):
    rng = np.random.default_rng(seed)
    V = [3, 30, 3000][seed]
    hyps, refs = [], []
    for _ in range(40):
        hyps.append(list(rng.integers(0, V, rng.integers(0, 25))))
        refs.append(list(rng.integers(0, V, rng.integers(0, 25))))
    hyps += [[], [], [5, 6]]
    refs += [[], [1, 2, 3], []]
    got = tmetrics.edit_distance_batch(hyps, refs)
    assert got.dtype == np.int64 and got.shape == (len(hyps),)
    np.testing.assert_array_equal(got, jmetrics.edit_distance_batch(hyps,
                                                                   refs))
    np.testing.assert_array_equal(
        got, [tmetrics.edit_distance_py(h, r) for h, r in zip(hyps, refs)])
    # strings score by code point, as the reference does
    assert list(tmetrics.edit_distance_batch(["かきく", ""], ["かく", "あ"])) \
        == [1, 1]
    assert tmetrics.edit_distance_batch([], []).shape == (0,)


def test_native_refuses_bad_shapes():
    h = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="exceeds its row"):
        native.edit_distance_batch_native(h, [1, 4], h, [0, 0])
    with pytest.raises(ValueError, match="shapes"):
        native.edit_distance_batch_native(h, [1, 1], h[:1], [0])
    with pytest.raises(ValueError, match="hypotheses for"):
        tmetrics.edit_distance_batch(["a"], [])


BUILD = r"""
import sys
from chainer_speech_recognition_tpu_torch.utils import native
native._BUILD = sys.argv[1]
d = native.edit_distance_batch_native([[1, 2, 3]], [3], [[1, 3, 0]], [2])
print("OK", int(d[0]), native.build())
"""


def test_two_processes_build_at_once(tmp_path):
    """Both compile into an empty build directory at the same time: each
    to its own pid-named temporary file, moved into place; both load a
    working library, and no temporary file is left."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("OK 1 ")
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 1 and names[0].endswith(".so"), names
    assert outs[0][0] == outs[1][0]


def test_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f( { }\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        native.build()
    assert os.listdir(tmp_path / "build") == []
