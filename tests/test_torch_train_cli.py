"""The port's train CLI on the CPU, on a tiny synthetic corpus: the JSONL
events of the reference's loop, checkpoints and resume, the profiler
window, a cut ``bilstm_deep`` with SpecAugment on, and the refusals (data
modes, model blocks and corpus formats that are not ported, no card for
``--device cuda``, data parallelism)."""

import json
import os

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


@pytest.mark.parametrize("sets,match", [
    ([], "ROADMAP.md §1 item 8"),                   # auto → device_cache
    (["train.data_mode=rotating"], "train.data_mode=stream"),
    (["train.data_mode=stream", "model.glu_blocks=2"], "GLU"),
    (["train.data_mode=stream", "parallel.num_devices=2"], "parallelism"),
])
def test_cli_refuses_what_is_not_ported(data_dir, tmp_path, sets, match):
    with pytest.raises(NotImplementedError, match=match):
        _run(data_dir, tmp_path, *sets)


def test_cli_refuses_packed_corpus_and_missing_card(data_dir, tmp_path,
                                                    monkeypatch):
    packed = tmp_path / "packed"
    packed.mkdir()
    for name in ("vocab.txt", "train_index.jsonl"):
        (packed / name).write_bytes(
            open(os.path.join(data_dir, name), "rb").read())
    (packed / "train.pack").write_bytes(b"")
    with pytest.raises(SystemExit, match="packed corpus"):
        _run(str(packed), tmp_path, "train.data_mode=stream")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--data-dir", data_dir, "--device", "cuda"])


@pytest.mark.parametrize("sets", [["train.eval_beam=4"],
                                  ["train.eval_lm=lm.arpa"]])
def test_cli_refuses_beam_eval_columns_before_a_step(data_dir, tmp_path,
                                                     sets):
    """The reference's periodic eval adds beam and beam+LM columns; the
    port has no beam search yet, so it refuses them rather than ignore
    them, before any step."""
    with pytest.raises(NotImplementedError, match="config 4"):
        _run(data_dir, tmp_path, "train.data_mode=stream", *sets)
    assert not os.path.exists(tmp_path / "ckpt") or not list_checkpoints(
        str(tmp_path / "ckpt"))


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
