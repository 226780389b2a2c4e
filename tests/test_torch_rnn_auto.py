"""``model.rnn_impl=auto`` routes a recurrence layer to the kernels'
wrappers where the kernels take its hidden size and to the plain scan
elsewhere, as the reference's ``auto`` takes its scan wherever its kernel
does not fit; ``rnn_cuda.ROUTED`` shows the path each layer call took."""

import numpy as np
import pytest
import torch

from chainer_speech_recognition_tpu_torch.config import preset_config
from chainer_speech_recognition_tpu_torch.decode.greedy import greedy_decode
from chainer_speech_recognition_tpu_torch.frontend import select_frontend
from chainer_speech_recognition_tpu_torch.models.presets import (
    build_model, init_parameters)
from chainer_speech_recognition_tpu_torch.ops import rnn_cuda


@pytest.mark.parametrize("H,takes", [(32, True), (256, True), (512, True),
                                     (520, False), (768, True),
                                     (100, False), (2048, True),
                                     (2080, False)])
def test_kernel_takes(H, takes):
    assert rnn_cuda.kernel_takes(H) is takes


def _logits(H: int, impl: str):
    cfg = preset_config("bigru").override(
        {"model.rnn_hidden": H, "model.rnn_layers": 2,
         "model.conv_channels": [4, 4], "model.rnn_impl": impl})
    model = build_model(cfg.model)
    init_parameters(model, 0)
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(0.3 * rng.standard_normal((2, 8000)).astype(
        np.float32))
    n = torch.tensor([8000, 5000], dtype=torch.int32)
    feats, flens = select_frontend(cfg.features)(
        sig, n, apply_cmvn=cfg.features.cmvn_arg)
    with torch.no_grad():
        return model(feats, flens)


@pytest.mark.parametrize("H,path", [(2080, "scan"), (768, "kernel"),
                                    (256, "kernel")])
def test_bigru_builds_and_decodes_through_auto(H, path):
    """A bigru at H = 2080, past the sizes the kernels take, decodes
    through ``auto`` on the plain scan (the same logits as ``scan``); at
    H = 768 (W streamed on the card) and 256 (W resident) ``auto`` takes
    the kernels' wrappers. Each layer call counts once."""
    before = dict(rnn_cuda.ROUTED)
    logits, olens = _logits(H, "auto")
    assert rnn_cuda.ROUTED[path] == before[path] + 2
    other = "kernel" if path == "scan" else "scan"
    assert rnn_cuda.ROUTED[other] == before[other]
    assert torch.isfinite(logits).all()
    ids, lens = greedy_decode(logits, olens)
    assert ids.shape[0] == 2 and (lens >= 0).all()
    if path == "scan":
        want, _ = _logits(H, "scan")
        assert torch.equal(logits, want)
