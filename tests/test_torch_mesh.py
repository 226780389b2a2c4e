"""The port's data-parallel mesh (``parallel/mesh.py``) on four CPU ranks
in a gloo group (spawned once for the module, ``torch_ranks.run_ranks``),
against the same work in this process without a group: the mesh's shape,
axes and validation (mirroring the reference's ``tests/test_dcn.py``),
the sharding helpers, a ``parallel.dcn_slices = 2`` train step and
cached dispatch equal to the 1-D mesh's and to one device's, and the
decoders over the mesh: the sharded dev eval, ``beam_decode(mesh=)`` with
and without an LM, and ``StreamingRecognizer(mesh=)`` greedy, beam and
with endpointing, each equal to one device (mirroring the reference's
``tests/test_multichip.py``). fp32, one BiGRU layer of 16, V = 12 (8 for
streaming), SpecAugment off. Then two ranks streaming ``conformer_stream``
(each holding its own streams' attention carries) against one device."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.data.synthetic import make_utterance
from chainer_speech_recognition_tpu_torch.decode.beam import beam_decode
from chainer_speech_recognition_tpu_torch.decode.lm import NGramLM
from chainer_speech_recognition_tpu_torch.decode.streaming import (
    StreamingRecognizer)
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.parallel.mesh import (
    Mesh, all_gather_rows, dispatch_rows, launch, make_mesh, shard_batch)
from chainer_speech_recognition_tpu_torch.train.state import init_state
from chainer_speech_recognition_tpu_torch.train.step import (
    make_auto_eval, make_train_step)
from chainer_speech_recognition_tpu_torch.vocab import Vocab
from torch_ranks import run_ranks

WORLD = 4
CPU = torch.device("cpu")


def _cfg(**over):
    base = {"parallel.dcn_slices": 2, "model.vocab_size": 12,
            "model.compute_dtype": "float32", "model.rnn_layers": 1,
            "model.rnn_hidden": 16, "model.conv_channels": [4, 4],
            "specaugment.enabled": False, "optim.learning_rate": 1e-3,
            "optim.warmup_steps": 1}
    base.update(over)
    return preset_config("bigru").override(base)


def _batch(seed: int, B: int = 16) -> dict:
    """B utterances of 2-4 labels; row 1 weighs 0 (a padded row) and row
    6's labels outrun its frames (no alignment)."""
    rng = np.random.default_rng(seed)
    n_max = 8000
    sig = np.zeros((B, n_max), np.float32)
    labels = np.full((B, 40), -1, np.int32)
    lens, nls = [], []
    for i in range(B):
        nl = 40 if i == 6 else int(rng.integers(2, 5))
        ids = [int(k) for k in rng.integers(1, 12, nl)]
        s, _ = make_utterance(rng, ids[:4], tone_len=1600)
        n = min(len(s), n_max)
        sig[i, :n] = s[:n]
        labels[i, :nl] = ids
        lens.append(n)
        nls.append(nl)
    w = np.ones(B, np.float32)
    w[1] = 0.0
    return {"signals": sig, "num_samples": np.asarray(lens, np.int32),
            "labels": labels, "label_lengths": np.asarray(nls, np.int32),
            "sample_weight": w}


def _model(cfg, seed: int = 0):
    model = build_model(cfg.model)
    init_parameters(model, seed)
    return model


def _train(cfg, mesh, steps: int = 2):
    """``steps`` train steps on _batch(0), _batch(1), ... (this rank's rows
    over ``mesh``) → (the metrics of each step, parameters)."""
    model = _model(cfg)
    state = init_state(model, cfg.optim, 0)
    step = make_train_step(cfg, mesh=mesh)
    ms = []
    for i in range(steps):
        b = {k: torch.from_numpy(v) for k, v in
             shard_batch(mesh, _batch(i)).items()}
        ms.append({k: float(v) for k, v in step(state, b).items()})
    return ms, {k: v.detach().numpy().copy()
                for k, v in model.state_dict().items()}


def _stream_setup():
    cfg = _cfg(**{"features.cmvn_mode": "causal", "model.vocab_size": 8,
                  "model.rnn_layers": 2})
    rng = np.random.default_rng(0)
    S = 8
    ns = [int(rng.integers(6000, 12000)) for _ in range(S)]
    pcm = np.asarray(rng.uniform(-0.5, 0.5, (S, max(ns))), np.float32)
    for b, nb in enumerate(ns):
        pcm[b, nb:] = 0.0
    return cfg, _model(cfg), pcm, ns


def _stream(mesh, **kw):
    cfg, model, pcm, ns = _stream_setup()
    rec = StreamingRecognizer(model, cfg, batch=len(ns), chunk_frames=16,
                              right_frames=8, mesh=mesh, **kw)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    return rec.emitted, rec.segments


def _beam_inputs():
    vocab = Vocab(["<blank>", "あ", "い", "う"])
    lm = NGramLM.train(["あいう"] * 30 + ["あいあ"] * 7, vocab, order=2)
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((16, 20, len(vocab))).astype(np.float32) * 2
    return logits, rng.integers(8, 21, 16), lm


def _decode(mesh):
    """The decoders over ``mesh``: eval of _batch(2), beam with and
    without an LM, streaming greedy, beam and endpointed."""
    cfg = _cfg()
    ev = make_auto_eval(_model(cfg), cfg, mesh)(_batch(2))
    logits, lens, lm = _beam_inputs()
    out = {"eval": [x.numpy() for x in ev],
           "beam": beam_decode(logits, lens, beam=8, mesh=mesh),
           "beam_lm": beam_decode(logits, lens, beam=8, lm=lm, alpha=0.6,
                                  beta=0.8, mesh=mesh),
           "stream": _stream(mesh)[0],
           "stream_beam": _stream(mesh, decoder="beam", beam=4)[0],
           "stream_endpoint": _stream(mesh, endpoint_ms=100.0)}
    return out


def _on_ranks(rank: int) -> dict:
    out = {}
    cfg1, cfg2 = _cfg(**{"parallel.dcn_slices": 1}), _cfg()
    m1, m2 = make_mesh(cfg1.parallel, CPU), make_mesh(cfg2.parallel, CPU)
    out["meshes"] = [(m.rank, m.size, m.shape, m.axis_names,
                      len(m.axis_groups)) for m in (m1, m2)]
    errors = {}
    for name, over in (("dcn3", {"parallel.dcn_slices": 3}),
                       ("too_many", {"parallel.num_devices": 8}),
                       ("too_few", {"parallel.num_devices": 2})):
        try:
            make_mesh(_cfg(**over).parallel, CPU)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    out["shard"] = shard_batch(m2, {"x": np.arange(64).reshape(16, 4),
                                    "bucket_id": 3})
    out["dispatch"] = [dispatch_rows(m2, np.arange(48).reshape(3, 16)),
                       dispatch_rows(m2, np.arange(16))]
    out["gather"] = all_gather_rows(m2, torch.full((2, 3), rank)).numpy()
    out["train_1d"], out["train_dcn"] = _train(cfg1, m1), _train(cfg2, m2)
    out["decode"] = _decode(m2)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    torch.set_num_threads(1)
    return run_ranks(_on_ranks, WORLD, tmp_path_factory.mktemp("mesh"))


def test_mesh_shape_axes_and_validation(ranks):
    for r, out in enumerate(ranks):
        assert out["meshes"] == [(r, 4, (4,), ("data",), 1),
                                 (r, 4, (2, 2), ("dcn", "data"), 2)]
        e = out["errors"]
        assert "do not split into 3 dcn slices" in e["dcn3"]
        assert e["too_many"] == "requested 8 devices, have 4"
        assert "process group has 4 ranks" in e["too_few"]
    # the config carries the 2-D axes, as the reference's
    assert _cfg().parallel.batch_axes == ("dcn", "data")
    assert _cfg(**{"parallel.dcn_slices": 1}).parallel.batch_axes == "data"


def test_mesh_without_a_group():
    """One process: a mesh of one; more devices, or dcn slices that do
    not divide them, raise; on the CPU there is no card to start ranks
    on."""
    m = make_mesh(_cfg(**{"parallel.dcn_slices": 1}).parallel, CPU)
    assert (m.rank, m.size, m.distributed, m.is_writer) == (0, 1, False,
                                                           True)
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        make_mesh(_cfg(**{"parallel.num_devices": 2}).parallel, CPU)
    with pytest.raises(ValueError, match="do not split into 2 dcn slices"):
        make_mesh(_cfg().parallel, CPU)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="requested 2 devices, have 0"):
            launch(print, 2, "cuda")


def test_helpers_shard_over_both_axes(ranks):
    for r, out in enumerate(ranks):
        assert out["shard"]["bucket_id"] == 3
        np.testing.assert_array_equal(
            out["shard"]["x"], np.arange(64).reshape(16, 4)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(
            out["dispatch"][0], np.arange(48).reshape(3, 16)[:, 4 * r:
                                                             4 * r + 4])
        np.testing.assert_array_equal(out["dispatch"][1],
                                      np.arange(16)[4 * r:4 * r + 4])
        np.testing.assert_array_equal(
            out["gather"], np.repeat(np.arange(4), 2)[:, None].repeat(3, 1))
    fake = Mesh(rank=1, size=4, device=CPU, shape=(4,), axis_names=("data",))
    with pytest.raises(ValueError, match="does not split over 4"):
        shard_batch(fake, {"x": np.zeros((6, 2))})


def test_dcn_train_step_matches_1d_mesh_and_one_device(ranks):
    """Two steps (a padded row on rank 0, an impossible one on rank 1):
    the (2, 2) mesh equals the 1-D mesh to summation order, as the
    reference's test_dcn holds it, and both equal one device at the
    bars of test_torch_train_step.py."""
    (m1, p1), (m2, p2) = ranks[0]["train_1d"], ranks[0]["train_dcn"]
    m0, p0 = _train(_cfg(**{"parallel.dcn_slices": 1}), None)
    for out in ranks[1:]:      # every rank holds the same state
        for k, v in out["train_dcn"][1].items():
            np.testing.assert_array_equal(v, p2[k])
    for a, b, c in zip(m1, m2, m0):
        assert abs(a["loss"] - b["loss"]) < 1e-5
        assert a["valid_frac"] == b["valid_frac"] == c["valid_frac"] < 1
        np.testing.assert_allclose(a["loss"], c["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], c["grad_norm"], rtol=1e-4)
    for k in p1:
        np.testing.assert_allclose(p2[k], p1[k], atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(p1[k], p0[k], atol=2e-5, rtol=1e-3)


def test_sharded_eval_beam_and_streaming_match_one_device(ranks):
    """Every rank returns the whole batch's results, equal to one
    device's: eval losses, logits and lengths; beam hypotheses with and
    without the LM; the streamed ids greedy and beam, and the endpointed
    segments."""
    want = _decode(None)
    for out in ranks:
        got = out["decode"]
        for a, b in zip(got["eval"], want["eval"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got["eval"][2], want["eval"][2])
        for key in ("beam", "beam_lm", "stream", "stream_beam",
                    "stream_endpoint"):
            assert got[key] == want[key], key


def _cstream(mesh, **kw):
    """conformer_stream (2 blocks, d = 16, 2 heads, chunk 4, left 2, conv
    kernel 7, causal CMVN, fp32) streaming 4 utterances of different
    lengths in one lockstep batch over ``mesh`` → (emitted, segments)."""
    cfg = preset_config("conformer_stream").override({
        "model.conv_channels": [8, 8], "model.attn_blocks": 2,
        "model.attn_dim": 16, "model.attn_heads": 2, "model.attn_chunk": 4,
        "model.attn_left_chunks": 2, "model.attn_conv_kernel": 7,
        "model.vocab_size": 8, "model.compute_dtype": "float32",
        "features.cmvn_mode": "causal"})
    rng = np.random.default_rng(5)
    ns = [9600, 7040, 12000, 3300]
    pcm = np.asarray(rng.uniform(-0.5, 0.5, (4, max(ns))), np.float32)
    for b, nb in enumerate(ns):
        pcm[b, nb:] = 0.0
    rec = StreamingRecognizer(_model(cfg, 3), cfg, batch=4, chunk_frames=16,
                              right_frames=0, mesh=mesh, **kw)
    rec.accept(pcm, drain=False)
    rec.flush(num_samples=ns)
    return rec.emitted, rec.segments


def _cstream_all(mesh) -> dict:
    return {"greedy": _cstream(mesh)[0],
            "beam": _cstream(mesh, decoder="beam", beam=4)[0],
            "endpoint": _cstream(mesh, endpoint_ms=100.0)}


def _cstream_on_ranks(rank: int) -> dict:
    mesh = make_mesh(_cfg(**{"parallel.dcn_slices": 1,
                             "parallel.num_devices": 2}).parallel, CPU)
    assert mesh.size == 2
    return _cstream_all(mesh)


def test_sharded_conformer_stream_matches_one_device(tmp_path):
    """Two gloo ranks streaming conformer_stream, each holding the KV-cache,
    conv-tail and position carries of its own two streams only: greedy,
    beam and endpointed results equal to one device's on every rank."""
    torch.set_num_threads(1)
    want = _cstream_all(None)
    assert any(want["greedy"])
    for got in run_ranks(_cstream_on_ranks, 2, tmp_path):
        assert got == want
