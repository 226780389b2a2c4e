"""The port's train CLI on the CPU, on a tiny synthetic corpus: the JSONL
events of the reference's loop, checkpoints and resume, the profiler
window, a cut ``bilstm_deep`` with SpecAugment on, training from the
packed corpus (``train.pack``: the same losses as from the wavs), the
dev eval's beam and beam+LM columns, the default data mode (the device
cache, and rotating windows under a small budget), the forward-only
``uni_gru`` in both data modes with resume, ``glu_conv``, and the
refusals (a file that is not a pack, no card for ``--device cuda``, dcn
slices that do not divide the devices)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.checkpoint import (
    list_checkpoints, load_config)
from chainer_speech_recognition_tpu_torch.cli import train as cli
from chainer_speech_recognition_tpu_torch.data.synthetic import (
    write_tone_corpus)

SMALL = ["model.conv_channels=[4,4]", "model.rnn_hidden=32",
         "model.rnn_layers=1", "buckets.boundaries=[64]",
         "buckets.batch_sizes=[2]", "buckets.max_label_len=8",
         "train.loader_workers=1", "optim.warmup_steps=2"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    write_tone_corpus(root, np.random.default_rng(3),
                      {"train": 5, "dev": 3}, 6, (0.3, 0.5))
    return root


def _run(data_dir, tmp_path, *sets, extra=(), preset="bigru"):
    metrics = str(tmp_path / "m.jsonl")
    cli.main(["--data-dir", data_dir, "--preset", preset, "--device", "cpu",
              "--ckpt-dir", str(tmp_path / "ckpt"), "--metrics", metrics,
              *extra, "--set", *SMALL, *sets])
    with open(metrics) as f:
        return [json.loads(l) for l in f]


def test_cli_trains_evaluates_checkpoints_and_resumes(data_dir, tmp_path):
    ev = _run(data_dir, tmp_path, "train.data_mode=stream",
              "train.total_steps=4", "train.log_every=1",
              "train.eval_every=2", "train.checkpoint_every=2")
    kinds = [e["kind"] for e in ev]
    for k in ("data", "data_mode", "train", "eval", "checkpoint"):
        assert k in kinds, k
    train = [e for e in ev if e["kind"] == "train"]
    assert [e["step"] for e in train] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0
               and e["valid_frac"] == 1.0 for e in train)
    assert [e["epoch"] for e in train] == [0, 0, 0, 1]   # 3 batches / epoch
    evals = [e for e in ev if e["kind"] == "eval"]
    assert [e["step"] for e in evals] == [2, 4]
    assert all(e["num_utts"] == 3 and 0 <= e["cer"] for e in evals)
    assert list_checkpoints(str(tmp_path / "ckpt")) == [
        "step_00000002.msgpack", "step_00000004.msgpack"]
    ev = _run(data_dir, tmp_path, "train.data_mode=stream",
              "train.total_steps=6", "train.log_every=1")
    resume = [e for e in ev if e["kind"] == "resume"]
    assert resume[-1]["step"] == 4
    assert [e["step"] for e in ev if e["kind"] == "train"][-2:] == [5, 6]
    assert "step_00000006.msgpack" in list_checkpoints(
        str(tmp_path / "ckpt"))


def test_cli_profiles_steps_10_to_14(data_dir, tmp_path):
    ev = _run(data_dir, tmp_path, "train.data_mode=stream",
              "train.total_steps=15",
              extra=["--profile-dir", str(tmp_path / "prof")])
    prof = [e for e in ev if e["kind"] == "profile"]
    assert len(prof) == 1 and prof[0]["steps"] == "10-14"
    with open(prof[0]["trace"]) as f:
        assert json.load(f)["traceEvents"]


def test_cli_trains_bilstm_deep_with_specaugment(data_dir, tmp_path):
    """The bilstm_deep preset (cut to 2 layers of H=32 by SMALL's
    overrides) trains with SpecAugment on, as the preset has it, evaluates
    and checkpoints; its checkpoint records the LSTM and SpecAugment."""
    ev = _run(data_dir, tmp_path, "train.data_mode=stream",
              "model.rnn_layers=2", "train.total_steps=3",
              "train.log_every=1", "train.eval_every=3",
              "train.checkpoint_every=3", preset="bilstm_deep")
    train = [e for e in ev if e["kind"] == "train"]
    assert [e["step"] for e in train] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in train)
    assert [e["step"] for e in ev if e["kind"] == "eval"] == [3]
    cfg = load_config(str(tmp_path / "ckpt"))
    assert cfg.model.rnn_type == "lstm" and cfg.specaugment.enabled
    assert list_checkpoints(str(tmp_path / "ckpt")) == [
        "step_00000003.msgpack"]


@pytest.mark.parametrize("sets,match,exc", [
    # GLU blocks, once refused here, are ported: the case now trains them
    # (glu_conv at two blocks of 16 channels, the port's own preset name
    # and module names: tests/test_torch_glu.py holds it to JAX)
    (["train.data_mode=stream", "model.glu_blocks=2",
      "model.glu_channels=16", "train.total_steps=2",
      "train.log_every=1"], "GLU", None),
    # data parallelism is ported (tests/test_torch_dp.py); a 2-D mesh
    # whose dcn slices do not divide the one device is refused
    (["train.data_mode=stream", "parallel.dcn_slices=2"], "parallelism",
     ValueError),
], ids=["sets0-GLU", "sets1-parallelism"])
def test_cli_refuses_what_is_not_ported(data_dir, tmp_path, sets, match,
                                        exc):
    """What the port does not take is refused; what it once refused and
    now takes (``exc`` None) trains."""
    if exc is None:
        ev = _run(data_dir, tmp_path, *sets, preset="glu_conv")
        train = [e for e in ev if e["kind"] == "train"]
        assert [e["step"] for e in train] == [1, 2] and all(
            np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in train)
        assert load_config(str(tmp_path / "ckpt")).model.glu_blocks == 2
        return
    with pytest.raises(exc, match=match):
        _run(data_dir, tmp_path, *sets)


@pytest.mark.parametrize("sets,mode", [
    ([], "device_cache"),                       # auto: the corpus fits
    (["train.device_cache_budget_gb=1e-5"], "rotating"),
])
def test_cli_trains_in_the_default_data_mode(data_dir, tmp_path, sets,
                                             mode):
    """With no ``train.data_mode`` the CLI trains from the device-resident
    corpus (the bf16 feature cache, K = 8 steps a dispatch; eager on the
    CPU) or, under a budget too small for it, from rotating windows; the
    step advances by K a dispatch, and logging, dev eval and checkpoints
    land where a dispatch crosses their cadence."""
    ev = _run(data_dir, tmp_path, *sets, "train.total_steps=12",
              "train.log_every=4", "train.eval_every=10",
              "train.checkpoint_every=10")
    dm = [e for e in ev if e["kind"] == "data_mode"][0]
    assert dm["mode"] == mode and dm["steps_per_dispatch"] == 8
    assert dm["cache_features"] and not dm["graphs"]
    train = [e for e in ev if e["kind"] == "train"]
    assert [e["step"] for e in train] == [8, 16]
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in train)
    assert [e["step"] for e in ev if e["kind"] == "eval"] == [16]
    assert list_checkpoints(str(tmp_path / "ckpt")) == [
        "step_00000016.msgpack"]


@pytest.mark.parametrize("mode", ["stream", "device_cache"])
def test_cli_trains_uni_gru_and_resumes(data_dir, tmp_path, mode):
    """The forward-only preset (rec [1, H, 3H]) trains through the CLI in
    the stream data mode and the default one (the device cache, K = 8),
    with dev eval and checkpoints, and resumes from its checkpoint."""
    sets = [f"train.data_mode={mode}", "train.log_every=1",
            "train.eval_every=8", "train.checkpoint_every=8"]
    ev = _run(data_dir, tmp_path, *sets, "train.total_steps=8",
              preset="uni_gru")
    assert [e for e in ev if e["kind"] == "data_mode"][0]["mode"] == mode
    train = [e for e in ev if e["kind"] == "train"]
    assert train[-1]["step"] == 8
    assert all(np.isfinite(e["loss"]) and e["grad_norm"] > 0 for e in train)
    assert [e["step"] for e in ev if e["kind"] == "eval"] == [8]
    cfg = load_config(str(tmp_path / "ckpt"))
    assert cfg.model.rnn_bidirectional is False
    ev = _run(data_dir, tmp_path, *sets, "train.total_steps=16",
              preset="uni_gru")
    assert [e for e in ev if e["kind"] == "resume"][-1]["step"] == 8
    assert [e["step"] for e in ev if e["kind"] == "train"][-1] == 16
    assert list_checkpoints(str(tmp_path / "ckpt"))[-1] == \
        "step_00000016.msgpack"


def test_cli_refuses_packed_corpus_and_missing_card(data_dir, tmp_path,
                                                    monkeypatch):
    """A ``train.pack`` that is not a CSRPACK1 file is refused (the packed
    corpus itself trains: ``test_cli_trains_from_the_pack_as_from_wavs``),
    and so is ``--device cuda`` without a card."""
    packed = tmp_path / "packed"
    packed.mkdir()
    for name in ("vocab.txt", "train_index.jsonl"):
        (packed / name).write_bytes(
            open(os.path.join(data_dir, name), "rb").read())
    (packed / "train.pack").write_bytes(b"")
    with pytest.raises(ValueError, match="not a CSRPACK1 file"):
        _run(str(packed), tmp_path, "train.data_mode=stream")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--data-dir", data_dir, "--device", "cuda"])


def test_cli_trains_from_the_pack_as_from_wavs(tmp_path):
    """``preprocess --pack`` output trains through ``train.pack`` (int16
    PCM, labels encoded at pack time) with bitwise the losses and gradient
    norms of training from ``train_index.jsonl`` (the wavs hold the same
    int16 samples), dev eval included."""
    from chainer_speech_recognition_tpu_torch.cli import (make_synthetic,
                                                          preprocess)

    corpus, data = str(tmp_path / "corpus"), str(tmp_path / "data")
    make_synthetic.main(["--out", corpus, "--style", "confusable",
                         "--utts", "10", "--vocab", "6", "--min-labels", "2",
                         "--max-labels", "5", "--min-seconds", "0.3",
                         "--max-seconds", "0.6", "--seed", "9"])
    preprocess.main(["--corpus", corpus, "--out", data, "--dev-fraction",
                     "0.3", "--pack"])
    wavs = str(tmp_path / "wavs")
    shutil.copytree(data, wavs)
    os.remove(os.path.join(wavs, "train.pack"))
    runs = []
    for d, name in ((data, "pack"), (wavs, "wav")):
        (tmp_path / name).mkdir()
        ev = _run(d, tmp_path / name, "train.data_mode=stream",
                  "train.total_steps=4", "train.log_every=1",
                  "train.eval_every=4")
        runs.append([(e["step"], e["loss"], e["grad_norm"]) if
                     e["kind"] == "train" else (e["cer"], e["loss"])
                     for e in ev if e["kind"] in ("train", "eval")])
    assert len(runs[0]) == 5 and runs[0] == runs[1]


@pytest.mark.parametrize("with_lm", [False, True])
def test_cli_eval_beam_columns_match_evaluate_compare(data_dir, tmp_path,
                                                      capsys, with_lm):
    """``train.eval_beam`` (and ``train.eval_lm``) add the reference's
    ``cer_beam`` (and ``cer_beam_lm``) columns to the periodic dev eval,
    from the same forward pass as ``cer``; at the last step they equal
    what ``evaluate --compare`` prints for the checkpoint of that step."""
    from chainer_speech_recognition_tpu_torch.cli import evaluate, train_lm

    sets = ["train.eval_beam=4"]
    extra = []
    if with_lm:
        arpa = str(tmp_path / "lm.arpa")
        train_lm.main(["--data-dir", data_dir, "--order", "2", "--out",
                       arpa])
        sets += [f"train.eval_lm={arpa}", "train.eval_lm_alpha=0.7",
                 "train.eval_lm_beta=0.3"]
        extra = ["--lm", arpa, "--lm-alpha", "0.7", "--lm-beta", "0.3"]
    ev = _run(data_dir, tmp_path, "train.data_mode=stream", *sets,
              "train.total_steps=3", "train.eval_every=3",
              "train.checkpoint_every=3")
    last = [e for e in ev if e["kind"] == "eval"][-1]
    assert {"cer", "cer_beam"} <= set(last)
    assert ("cer_beam_lm" in last) == with_lm
    capsys.readouterr()
    evaluate.main(["--ckpt-dir", str(tmp_path / "ckpt"), "--data-dir",
                   data_dir, "--device", "cpu", "--compare", "--beam", "4",
                   *extra])
    out = capsys.readouterr().out
    for name, col in (("greedy", "cer"), ("beam4", "cer_beam"),
                      ("beam4+lm", "cer_beam_lm")):
        if col in last:
            assert f"CER[{name}] {last[col]:.4f} |" in out, (col, out)


def test_cli_debug_nans_trains_and_scopes_anomaly_mode(data_dir, tmp_path):
    """``--debug-nans`` (the reference's flag) checks each step and turns
    anomaly detection on for the run only."""
    ev = _run(data_dir, tmp_path, "train.data_mode=stream",
              "train.total_steps=2", "train.log_every=1",
              extra=["--debug-nans"])
    train = [e for e in ev if e["kind"] == "train"]
    assert [e["step"] for e in train] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in train)
    assert not torch.is_anomaly_enabled()


def test_debug_nans_step_raises_on_a_nan_feature():
    """One NaN input feature: the debug step raises FloatingPointError
    naming the step; without the check the step runs on."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.frontend import select_frontend
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model, init_parameters)
    from chainer_speech_recognition_tpu_torch.train.state import init_state
    from chainer_speech_recognition_tpu_torch.train.step import (
        make_train_step)

    cfg = preset_config("bigru").override(
        {"model.rnn_hidden": 32, "model.rnn_layers": 1,
         "model.conv_channels": [4, 4]})
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(0.3 * rng.standard_normal((2, 8000)).astype(
        np.float32))
    feats, flens = select_frontend(cfg.features)(
        sig, torch.tensor([8000, 6000], dtype=torch.int32),
        apply_cmvn=cfg.features.cmvn_arg)
    feats[0, 10, 5, 0] = float("nan")
    batch = {"features": feats, "frame_lengths": flens,
             "labels": torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32),
             "label_lengths": torch.tensor([3, 2], dtype=torch.int32)}

    def step(debug_nans: bool):
        model = build_model(cfg.model)
        init_parameters(model, 0)
        state = init_state(model, cfg.optim, 0)
        with torch.autograd.set_detect_anomaly(debug_nans):
            return make_train_step(cfg, debug_nans)(state, batch)

    with pytest.raises(FloatingPointError, match="step 1: "):
        step(True)
    step(False)
