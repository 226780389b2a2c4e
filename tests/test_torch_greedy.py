"""PyTorch greedy decode (decode/greedy.py: on the CPU the plain version,
compact_kept(*best_keep_plain(...))) vs the JAX Pallas greedy kernel
(interpret mode) and the host oracle. The CUDA kernel, which does all of
it in one launch, is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import torch

import jax.numpy as jnp

from chainer_speech_recognition_tpu.constants import PAD_LABEL_ID
from chainer_speech_recognition_tpu.decode.greedy import greedy_decode_np
from chainer_speech_recognition_tpu.decode.greedy_pallas import (
    greedy_decode_pallas)
from chainer_speech_recognition_tpu_torch.decode.greedy import (
    best_keep_plain, compact_kept, greedy_decode)


def _decode(logits, lens, max_len=None):
    ids, ol = greedy_decode(torch.from_numpy(logits), torch.from_numpy(lens),
                            max_len=max_len)
    return ids.numpy(), ol.numpy()


def _pallas(logits, lens, max_len=None):
    ids, ol = greedy_decode_pallas(jnp.asarray(logits), jnp.asarray(lens),
                                   max_len=max_len)
    return np.asarray(ids), np.asarray(ol)


def _planted(seed=0, B=6, T=40, V=13):
    """Random logits with planted ties, repeats, lengths 0, 1 and T."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    logits[0, 3, [2, 7]] = 9.0            # tie: first index wins
    logits[0, 4, [7, 2]] = 9.0            # same tie again: a repeat
    logits[1, :10, 5] = 8.0               # long repeat run
    logits[2, 5, :] = 1.0                 # all-equal frame → index 0 (blank)
    lens = np.asarray([T, T, 17, 0, 1, 23], np.int32)
    return logits, lens


def test_matches_pallas_and_oracle():
    logits, lens = _planted()
    ids, ol = _decode(logits, lens)
    pids, pol = _pallas(logits, lens)
    assert np.array_equal(ids, pids) and np.array_equal(ol, pol)
    for b in range(len(lens)):
        assert list(ids[b, : ol[b]]) == greedy_decode_np(logits[b], lens[b])
        assert np.all(ids[b, ol[b]:] == PAD_LABEL_ID)
    assert ol[3] == 0


def test_nan_frames_follow_the_pallas_kernel():
    """[3 | NaN@2 with 9@4 | 5 | all-NaN] → [3, 5]: a frame holding any
    NaN maps to blank (greedy_pallas.py), unlike XLA argmax."""
    logits = np.full((1, 4, 6), -5.0, np.float32)
    logits[0, 0, 3] = 5.0
    logits[0, 1, 2] = np.nan
    logits[0, 1, 4] = 9.0
    logits[0, 2, 5] = 5.0
    logits[0, 3, :] = np.nan
    lens = np.asarray([4], np.int32)
    ids, ol = _decode(logits, lens)
    assert list(ids[0, : ol[0]]) == [3, 5]
    pids, pol = _pallas(logits, lens)
    assert list(pids[0, : pol[0]]) == [3, 5]


def test_max_len_smaller_than_kept_count():
    logits, lens = _planted(seed=3)
    full, full_len = _decode(logits, lens)
    ids, ol = _decode(logits, lens, max_len=4)
    pids, pol = _pallas(logits, lens, max_len=4)
    assert ids.shape == (len(lens), 4)
    assert np.array_equal(ids, pids) and np.array_equal(ol, pol)
    assert np.array_equal(ol, np.minimum(full_len, 4))
    assert np.array_equal(ids, full[:, :4])


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors greedy_decode is compact_kept(*best_keep_plain(...)),
    the version the card's one-launch kernel is held to."""
    logits, lens = _planted(seed=4)
    lg, ln = torch.from_numpy(logits), torch.from_numpy(lens)
    for max_len in (None, 3):
        a = greedy_decode(lg, ln, max_len=max_len)
        b = compact_kept(*best_keep_plain(lg, ln), max_len or lg.shape[1])
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert a[0].dtype == torch.int32 and a[1].dtype == torch.int32


def test_one_symbol_vocab_single_slot_and_nan_batch():
    """Edges the kernel takes too: V = 1 (every frame is blank), max_len =
    1 (at most one symbol kept), and a batch whose frames are all NaN (all
    blank): the CPU route against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    cases = [(rng.standard_normal((3, 9, 1)).astype(np.float32), None),
             (_planted(seed=6)[0], 1),
             (np.full((2, 7, 5), np.nan, np.float32), None)]
    for logits, max_len in cases:
        B, T, _ = logits.shape
        lens = np.asarray([T, 0, 4, 1, T, 2][:B], np.int32)
        ids, ol = _decode(logits, lens, max_len)
        pids, pol = _pallas(logits, lens, max_len)
        assert np.array_equal(ids, pids) and np.array_equal(ol, pol)
        assert ids.shape == (B, max_len or T)
    assert np.all(_decode(*cases[0][:1], np.asarray([9, 0, 4], np.int32))[1]
                  == 0)
