"""PyTorch front-end (chainer_speech_recognition_tpu_torch.frontend) vs the
JAX front-ends and the golden NumPy oracle, on the CPU. The fused kernel's
wrapper takes its plain rfft version for CPU tensors, so both selections
are covered here; the kernel itself is checked on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chainer_speech_recognition_tpu.config import FeatureConfig
from chainer_speech_recognition_tpu.frontend import golden_np as g
from chainer_speech_recognition_tpu.frontend.jnp_frontend import (
    batch_features as jax_batch_features)
from chainer_speech_recognition_tpu.frontend.pallas_frontend import (
    batch_features_pallas)
from chainer_speech_recognition_tpu_torch.frontend import select_frontend
from chainer_speech_recognition_tpu_torch.frontend.cuda_frontend import (
    batch_features_cuda, dft_tables, fused_logmel_rows)
from chainer_speech_recognition_tpu_torch.frontend.torch_frontend import (
    _K, batch_features, extend_signal, logmel_from_extended)

# ragged, including one utterance below one reflection pad (257 samples)
LENS = (9000, 4001, 200, 2560)


def _signals(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    sigs = np.zeros((len(lens), max(lens)), np.float32)
    for i, L in enumerate(lens):
        sigs[i, :L] = 0.3 * rng.standard_normal(L).astype(np.float32)
    return sigs, np.asarray(lens, np.int32)


def _torch(sigs, lens, cmvn, fn=batch_features):
    f, fl = fn(torch.from_numpy(sigs), torch.from_numpy(lens),
               apply_cmvn=cmvn)
    return f.numpy(), fl.numpy()


@pytest.mark.parametrize("cmvn", [True, "causal", False])
def test_plain_matches_jnp_frontend(cmvn):
    """fp32 rfft path on both sides: atol 1e-4 (summation order only)."""
    sigs, lens = _signals()
    ft, lt = _torch(sigs, lens, cmvn)
    fj, lj = jax_batch_features(jnp.asarray(sigs), jnp.asarray(lens),
                                apply_cmvn=cmvn)
    assert np.array_equal(lt, np.asarray(lj))
    np.testing.assert_allclose(ft, np.asarray(fj), atol=1e-4, rtol=0)


def test_plain_matches_pallas_frontend_interpret():
    """The Pallas kernel's bf16x3 DFT vs fp32 rfft: the reference suite's
    own bar for that pair (atol 2e-3, rtol 1e-3)."""
    sigs, lens = _signals()
    ft, lt = _torch(sigs, lens, True)
    fp, lp = batch_features_pallas(jnp.asarray(sigs), jnp.asarray(lens),
                                   apply_cmvn=True)
    assert np.array_equal(lt, np.asarray(lp))
    np.testing.assert_allclose(ft, np.asarray(fp), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("cmvn", [True, "causal", False])
def test_plain_matches_golden_per_utterance(cmvn):
    """Per utterance against golden_np (atol 2e-3, the reference's bar);
    the sub-257-sample utterance is the documented limitation and is held
    only to finite, masked output."""
    sigs, lens = _signals()
    ft, lt = _torch(sigs, lens, cmvn)
    for i, L in enumerate(lens):
        T = int(lt[i])
        assert np.all(ft[i, T:] == 0)
        if L < 257:
            assert np.all(np.isfinite(ft[i, :T]))
            continue
        golden = {True: True, "causal": "causal", False: False}[cmvn]
        ref = g.features(sigs[i, :L], apply_cmvn=golden)
        assert ref.shape[0] == T
        np.testing.assert_allclose(ft[i, :T], ref, atol=2e-3, rtol=1e-3)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    sigs, lens = _signals()
    for cmvn in (True, "causal"):
        a, _ = _torch(sigs, lens, cmvn)
        b, _ = _torch(sigs, lens, cmvn, fn=batch_features_cuda)
        assert np.array_equal(a, b)
    T = 40
    ext = extend_signal(torch.from_numpy(sigs), torch.from_numpy(lens),
                        T + _K + 1)
    assert torch.equal(fused_logmel_rows(ext, T),
                       logmel_from_extended(ext, T))


def test_select_frontend():
    assert select_frontend(FeatureConfig(frontend_impl="auto")) \
        is batch_features_cuda
    assert select_frontend(FeatureConfig(frontend_impl="pallas")) \
        is batch_features_cuda
    assert select_frontend(FeatureConfig(frontend_impl="jnp")) \
        is batch_features


def test_dft_table_is_the_windowed_rfft():
    """The kernel's table (window folded in) reproduces the plain path's
    power spectrum in fp64 — what the kernel computes in fp32 FMA."""
    rng = np.random.default_rng(1)
    frames = rng.standard_normal((5, 512))
    dft, mel = dft_tables()
    reim = frames @ dft.astype(np.float64)
    power = reim[:, :257] ** 2 + reim[:, 257:] ** 2
    win = np.zeros(512)
    win[56:456] = g.hann_periodic(400)
    ref = np.abs(np.fft.rfft(frames * win, n=512)) ** 2
    np.testing.assert_allclose(power, ref, rtol=1e-5, atol=1e-5)
    assert mel.shape == (257, 40)
