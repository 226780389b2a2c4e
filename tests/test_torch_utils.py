"""The port's ``utils/flops.py``, ``utils/roofline.py`` and
``utils/runtime.py`` against the reference's modules.

The FLOP counts equal the reference's exactly (the same float arithmetic)
for every preset at three frame counts; the Conformer block's components
(names, FLOPs, bytes) equal the reference's; the peaks come from the card
table, never from a TPU: an unknown card gives no MFU, and a component's
bound follows the peaks it is given (the reference's v5e peaks, planted,
flip the FFN pair of a d = 320 block from bytes to operations, as the
reference's own label says). ``profile_trace`` writes the Chrome trace
the train loop's ``--profile-dir`` reads."""

import contextlib
import io
import json

import pytest
import torch

from chainer_speech_recognition_tpu import config as jconfig
from chainer_speech_recognition_tpu.utils import flops as jflops
from chainer_speech_recognition_tpu.utils import roofline as jroof
from chainer_speech_recognition_tpu_torch import config as tconfig
from chainer_speech_recognition_tpu_torch.utils import flops as tflops
from chainer_speech_recognition_tpu_torch.utils import roofline as troof
from chainer_speech_recognition_tpu_torch.utils import runtime as truntime

PRESETS = ["tiny_conv", "glu_conv", "conformer", "conformer_stream",
           "bigru", "uni_gru", "bilstm_deep"]
V5E = (197.0, 819.0)              # reference roofline.py's TPU peaks


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("frames", [1, 701, 1024])
def test_flops_equal_the_reference(preset, frames):
    j = jconfig.preset_config(preset).model
    t = tconfig.preset_config(preset).model
    assert tflops.forward_flops_per_utt(t, frames) == \
        jflops.forward_flops_per_utt(j, frames)
    assert tflops.train_flops_per_utt(t, frames) == \
        jflops.train_flops_per_utt(j, frames)
    assert tflops.forward_flops_per_utt(t, frames) > 0


def test_peaks_come_from_the_card_table():
    h100 = tflops.card_peaks("NVIDIA H100 80GB HBM3")
    assert (h100.bf16_tflops, h100.fp32_tflops, h100.hbm_tbs) == \
        (989.0, 67.0, 3.35)
    assert tflops.peak_tflops(tflops.H100_SXM) == 989.0
    assert tflops.mfu(98.9e12, tflops.H100_SXM) == pytest.approx(0.1)
    for name in ("NVIDIA H100", "nvidia h100 80gb hbm3", "TPU v5 lite",
                 "TPU v5e", "v4", "cpu"):
        assert tflops.peak_tflops(name) is None
        assert tflops.mfu(1e12, name) is None
    assert tflops.mfu(float("nan"), tflops.H100_SXM) is None
    # the reference's table is the TPU's; none of its keys carries over
    assert not set(jflops.PEAK_TFLOPS) & set(tflops.CARDS)


@pytest.mark.parametrize("B,T,d,flash,rb", [
    (64, 256, 256, False, 4), (64, 256, 256, True, 2), (8, 701, 256, False, 2),
    (24, 256, 320, True, 4)])
def test_roofline_components_equal_the_reference(B, T, d, flash, rb):
    j = jroof.conformer_block_components(B, T, d, residual_bytes=rb,
                                         flash=flash)
    t = troof.conformer_block_components(B, T, d, residual_bytes=rb,
                                         flash=flash)
    assert [(c.name, c.flops, c.bytes_) for c in t] == \
        [(c.name, c.flops, c.bytes_) for c in j]
    # at the reference's own peaks, the same labels (BW = bytes, MXU =
    # operations) and times
    label = {"BW": "bytes", "MXU": "operations"}
    assert [c.bound(*V5E) for c in t] == [label[c.bound] for c in j]
    assert [c.time_us(*V5E) for c in t] == [c.time_us(*V5E) for c in j]


def test_bound_follows_the_peaks_it_is_given():
    """d = 320: the FFN pair does 0.8·d = 256 FLOPs a byte, above the
    v5e's 240 and below the H100's 295."""
    ffn = [c for c in troof.conformer_block_components(64, 256, 320)
           if c.name.startswith("2 x FFN")][0]
    assert ffn.bound(*V5E) == "operations"
    assert ffn.bound(989.0, 3350.0) == "bytes"
    assert ffn.bound() == "bytes"           # this box has no card: the H100
    with pytest.raises(ValueError, match="no datasheet peaks"):
        troof.resolve_peaks(card="NVIDIA Imaginary 1")


def test_report_names_the_card_and_equals_the_reference_at_its_peaks():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = troof.report(B=32, T=701, d=256, flash=True)
        at_v5e = troof.report(B=32, T=701, d=256, flash=True,
                              peak_tflops=V5E[0], bw_gbs=V5E[1])
    text = out.getvalue()
    assert "NVIDIA H100 80GB HBM3: 989.0 TF bf16, 3350.0 GB/s" in text
    assert "v5e" not in text
    with contextlib.redirect_stdout(io.StringIO()):
        ref = jroof.report(B=32, T=701, d=256, flash=True,
                           peak_tflops=V5E[0], bw_gbs=V5E[1])
        ref_h100 = jroof.report(B=32, T=701, d=256, flash=True,
                                peak_tflops=989.0, bw_gbs=3350.0)
    assert at_v5e == ref and got == ref_h100


def test_profile_trace_writes_the_chrome_trace(tmp_path):
    """The host-side trace on the CPU (the card's activity is added on a
    CUDA device); the JAX-only helpers have no counterpart."""
    x = torch.randn(64, 64)
    with truntime.profile_trace(str(tmp_path / "prof"), "cpu") as prof:
        for _ in range(3):
            x = x @ x.T / 64
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "prof" / truntime.TRACE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert not hasattr(truntime, "respect_jax_platforms")
    assert not hasattr(truntime, "enable_compilation_cache")
