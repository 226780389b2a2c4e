"""The port's Conformer modules (``models/attention.py``) against the flax
ones, from the same weights (bridged) and inputs made with numpy, on the
CPU, at a cut width (d = 128, h = 2, dh = 64): RoPE, the chunk-causal
mask, the feed-forward and conv modules, MHSA and the whole block under
``impl`` einsum and flash (the Pallas kernel in interpret mode on the JAX
side, the kernels' plain versions on the port's), chunk 0 and 16/2,
residual stream fp32 and bf16, and one head of 128 (dh = 128). Bars: fp32 1e-5 (modules) and 3e-5 (the
block's eight sums), bf16 3e-2. Also the streaming call: refused for
global attention, run for ``conformer_stream`` (through the model, the
recognizer and the stream CLI; tests/test_torch_attention_stream.py holds
the stream against JAX)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chainer_speech_recognition_tpu.models import attention as jatt
from chainer_speech_recognition_tpu.models.rnn import time_mask as jtime_mask
from chainer_speech_recognition_tpu_torch.bridge import flax_to_state_dict
from chainer_speech_recognition_tpu_torch.models import attention as tatt
from chainer_speech_recognition_tpu_torch.ops import attention_cuda

D, H = 128, 2
DT = {"float32": (jnp.float32, torch.float32, 1e-5),
      "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _x(B, T, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, T, d)).astype(np.float32)


def _load(module, params):
    sd = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                   params["params"]))
    module.load_state_dict(sd, strict=True)
    return module


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("T,pos0", [(40, None), (33, [0, 7, 1000])])
def test_rope_matches(T, pos0):
    x = np.random.default_rng(T).standard_normal((3, T, 2, 64)).astype(
        np.float32)
    p0 = None if pos0 is None else np.asarray(pos0, np.int32)
    want = jatt.rope(jnp.asarray(x), pos0=None if p0 is None
                     else jnp.asarray(p0))
    got = tatt.rope(torch.from_numpy(x), pos0=None if p0 is None
                    else torch.from_numpy(p0))
    _close(got, want, 1e-5)
    # bf16 in, bf16 out, fp32 math in between
    xb = jnp.asarray(x, jnp.bfloat16)
    gb = tatt.rope(torch.from_numpy(np.array(xb.astype(jnp.float32)))
                   .to(torch.bfloat16))
    assert gb.dtype == torch.bfloat16
    _close(gb.float(), jatt.rope(xb).astype(jnp.float32), 1e-2)


@pytest.mark.parametrize("T,chunk,left", [(50, 16, 2), (64, 16, 4),
                                          (7, 3, 1), (33, 8, 0)])
def test_chunk_causal_mask_matches(T, chunk, left):
    want = jatt.chunk_causal_mask(T, chunk, left)
    got = tatt.chunk_causal_mask(T, chunk, left).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_matches(dtype):
    jdt, tdt, tol = DT[dtype]
    x = _x(2, 20, D, 0)
    jm = jatt._FFN(mult=4, dtype=jdt)
    params = jm.init(jax.random.key(0), jnp.asarray(x, jdt))
    want = jm.apply(params, jnp.asarray(x, jdt))
    tm = _load(tatt.FFN(D, 4, tdt), params)
    got = tm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    _close(got.float(), want.astype(jnp.float32), tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_module_matches(causal, dtype):
    """Symmetric ((k−1)//2, k//2) and causal (k−1, 0) padding; padded
    frames are zeroed before the depthwise conv, so they cannot leak."""
    jdt, tdt, tol = DT[dtype]
    x = _x(3, 30, D, 1)
    lens = np.asarray([30, 17, 1], np.int32)
    jm = jatt._ConvModule(kernel=15, dtype=jdt, causal=causal)
    mask = jtime_mask(30, jnp.asarray(lens))
    params = jm.init(jax.random.key(1), jnp.asarray(x, jdt), mask)
    want = jm.apply(params, jnp.asarray(x, jdt), mask)
    tm = _load(tatt.ConvModule(D, 15, tdt, causal=causal), params)
    assert tuple(tm.dw.weight.shape) == (D, 1, 15)
    got = tm(torch.from_numpy(x).to(tdt),
             torch.from_numpy(np.array(mask)))
    _close(got.float(), want.astype(jnp.float32), tol)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("chunk,left", [(0, 0), (16, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mhsa_matches(impl, chunk, left, dtype):
    _mhsa_case(impl, chunk, left, dtype, H)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mhsa_one_head_of_128_matches(impl, dtype):
    """h = 1 at d = 128: a head of 128, which the kernels take split over
    two 64-column slices (the plain versions here)."""
    _mhsa_case(impl, 0, 0, dtype, 1)


def _mhsa_case(impl, chunk, left, dtype, heads):
    jdt, tdt, tol = DT[dtype]
    T = 64
    x = _x(3, T, D, 2)
    lens = np.asarray([64, 40, 1], np.int32)
    jm = jatt._MHSA(heads=heads, dtype=jdt, chunk=chunk, left_chunks=left,
                    impl=impl)
    mask = jtime_mask(T, jnp.asarray(lens))
    args = (jnp.asarray(x, jdt), mask)
    params = jm.init(jax.random.key(2), *args, lengths=jnp.asarray(lens))
    want = jm.apply(params, *args, lengths=jnp.asarray(lens))
    tm = _load(tatt.MHSA(D, heads, tdt, chunk, left, impl), params)
    before = dict(attention_cuda.ROUTED)
    got = tm(torch.from_numpy(x).to(tdt), torch.from_numpy(np.array(mask)),
             torch.from_numpy(lens))
    assert attention_cuda.ROUTED[impl] == before[impl] + 1
    # valid query rows only: a padded query row with no allowed key is
    # garbage in the reference and 0 in the kernel's semantics; the block
    # zeroes both
    m = np.asarray(mask)[:, :, None]
    _close(got.detach().float().numpy() * m,
           np.asarray(want.astype(jnp.float32)) * m, tol)


@pytest.mark.parametrize("impl,chunk,left,rdt,dtype", [
    ("einsum", 0, 0, "float32", "float32"),
    ("flash", 0, 0, "float32", "float32"),
    ("einsum", 16, 2, "float32", "float32"),
    ("flash", 16, 2, "float32", "float32"),
    ("einsum", 0, 0, "bfloat16", "float32"),
    ("flash", 16, 2, "bfloat16", "bfloat16"),
    ("einsum", 0, 0, "float32", "bfloat16"),
])
def test_conformer_block_matches(impl, chunk, left, rdt, dtype):
    _block_case(impl, chunk, left, rdt, dtype, H)


@pytest.mark.parametrize("impl", ["einsum", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conformer_block_one_head_of_128_matches(impl, dtype):
    """The block at h = 1, d = 128 (dh = 128), fp32 residual stream."""
    _block_case(impl, 0, 0, "float32", dtype, 1)


def _block_case(impl, chunk, left, rdt, dtype, heads):
    jdt, tdt, tol = DT[dtype]
    if rdt == "bfloat16":
        tol = 3e-2
    elif dtype == "float32":
        tol = 3e-5
    T = 48
    x = _x(3, T, D, 3)
    lens = np.asarray([48, 29, 1], np.int32)
    jm = jatt.ConformerBlock(heads=heads, dtype=jdt, chunk=chunk,
                             left_chunks=left, impl=impl,
                             residual_dtype=jnp.dtype(rdt))
    params = jm.init(jax.random.key(3), jnp.asarray(x), jnp.asarray(lens))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(lens))
    tm = _load(tatt.ConformerBlock(D, heads=heads, dtype=tdt, chunk=chunk,
                                   left_chunks=left, impl=impl,
                                   residual_dtype=DT[rdt][1]), params)
    got = tm(torch.from_numpy(x), torch.from_numpy(lens))
    assert got.dtype == DT[rdt][1]
    _close(got.float(), want.astype(jnp.float32), tol)
    assert torch.all(got[1, 29:] == 0) and torch.all(got[2, 1:] == 0)


@pytest.mark.parametrize("loc,spread", [(0.0, 3e-3), (0.5, 1.0),
                                         (5.0, 2.0)])
def test_layer_norm_matches_flax(loc, spread):
    """flax's LayerNorm: epsilon 1e-6 (torch's default is 1e-5; rows of
    variance ~1e-5 tell them apart), its fast variance E[x²] − E[x]² on
    rows off 0, and the learned scale and bias."""
    import flax.linen as fnn
    rng = np.random.default_rng(5)
    x = (loc + spread * rng.standard_normal((4, D))).astype(np.float32)
    jm = fnn.LayerNorm(dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    ln = torch.nn.LayerNorm(D)
    ln.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, params["params"])))
    got = tatt.layer_norm(torch.from_numpy(x), ln).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    if loc == 0.0:
        default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (D,), ln.weight, ln.bias).detach().numpy()
        assert np.abs(default - want).max() > 1e-2


def test_streaming_refuses_attention_models():
    """A global-attention model (``conformer``, attn_chunk 0) refuses to
    stream, in the model and in the recognizer's geometry, as the
    reference does; ``conformer_stream`` streams: its stream carries lay
    out as [pos0, total_valid, seg_start] + 3 a block, and one streaming
    call advances pos0 by the chunk and total_valid by the frames fed
    (tests/test_torch_attention_stream.py holds it against JAX)."""
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.decode.streaming import (
        StreamingRecognizer)
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)

    small = {"model.attn_blocks": 1, "model.attn_dim": 64,
             "model.attn_heads": 1, "model.conv_channels": [4, 4],
             "model.vocab_size": 6}
    feats = torch.zeros(1, 64, 40, 3)
    glob = build_model(preset_config("conformer").override(small).model)
    with pytest.raises(ValueError, match="global-attention presets"):
        glob(feats, torch.tensor([64]), rnn_carries=[], carry_at=16)
    with pytest.raises(ValueError, match="global-attention presets"):
        StreamingRecognizer(glob, preset_config("conformer").override(
            {**small, "features.cmvn_mode": "causal"}), batch=1)
    cfg = preset_config("conformer_stream").override(small)
    model = build_model(cfg.model)
    with torch.inference_mode():
        logits, lens = model(feats, torch.tensor([64]))
        assert logits.shape == (1, 16, 6)
        carries = model.init_stream_carries(1)
        assert len(carries) == 3 + 3 and carries[3].shape == (1, 64, 1, 64)
        out, slens, new = model(feats, torch.tensor([64]),
                                rnn_carries=carries, carry_at=16)
    assert out.shape == (1, 16, 6) and int(slens[0]) == 16
    assert [int(c[0]) for c in new[:3]] == [16, 16, 0]
    with pytest.raises(ValueError, match="right_frames must be 0"):
        StreamingRecognizer(model, cfg, batch=1, chunk_frames=64,
                            right_frames=16)
    rec = StreamingRecognizer(model, cfg, batch=1, chunk_frames=64,
                              right_frames=0)
    assert rec.geo["C"] == 64 and rec.geo["R"] == 0


def test_stream_cli_refuses_conformer_stream(tmp_path, capsys):
    """The stream CLI streams a conformer_stream checkpoint with default
    flags (``--right-frames`` resolves to 0: the lookahead lives inside
    the chunk) and refuses it only with an explicit lookahead, which would
    shift the attention grid off its training-time alignment."""
    from chainer_speech_recognition_tpu_torch.bridge import state_dict_to_flax
    from chainer_speech_recognition_tpu_torch.checkpoint import save_params
    from chainer_speech_recognition_tpu_torch.cli import stream
    from chainer_speech_recognition_tpu_torch.config import preset_config
    from chainer_speech_recognition_tpu_torch.models.presets import (
        build_model)
    from chainer_speech_recognition_tpu_torch.utils.wav import write_wav
    from chainer_speech_recognition_tpu_torch.vocab import Vocab

    cfg = preset_config("conformer_stream").override({
        "model.attn_blocks": 1, "model.attn_dim": 64, "model.attn_heads": 1,
        "model.conv_channels": [4, 4], "model.vocab_size": 6})
    save_params(str(tmp_path / "ckpt"),
                state_dict_to_flax(build_model(cfg.model).state_dict()), cfg)
    Vocab(["<blank>", "a", "b", "c", "d", "e"]).save(tmp_path / "v.txt")
    wav = str(tmp_path / "a.wav")
    write_wav(wav, np.random.default_rng(0).uniform(-0.3, 0.3, 8000)
              .astype(np.float32))
    base = ["--ckpt-dir", str(tmp_path / "ckpt"), "--vocab",
            str(tmp_path / "v.txt"), "--device", "cpu"]
    with pytest.raises(ValueError, match="right_frames must be 0"):
        stream.main(base + ["--right-frames", "16", wav])
    capsys.readouterr()
    stream.main(base + [wav])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith(wav + "\t")
