"""The wide flash kernels' launch plans (``attention_cuda.flash_bwd_plan``
and ``flash_fwd_plan``, the geometry ``csrc/attention_bwd.cu`` and
``csrc/attention_fwd.cu`` launch; the card tests hold the library's to
them): for every head width the wide kernels take, whole tiles or halves
of them a block, every n-tile of a tile (8 keys or queries in the scores,
8 head columns of a slice in the products) owned by exactly one warp
group, within a block's threads and shared memory."""

import pytest

from chainer_speech_recognition_tpu_torch.ops.attention_cuda import (
    KERNEL_DHS, TILE, flash_bwd_plan, flash_fwd_plan)

SMEM_BLOCK = 232448       # the most dynamic shared memory a block (H100)
SMEM_SM = 233472          # an SM's shared memory, 1 KB of it reserved a block
# the forward's two shapes on the main path, (B, T'): a decode chunk of
# long-form wavs and a training batch of the 1024-frame bucket
SHAPES = {"decode": (32, 701), "train": (24, 256)}


def check_owners(ntiles):
    owners = [0] * 8
    for lo, hi in ntiles:
        assert 0 <= lo < hi <= 8             # no warp group without work
        for j in range(lo, hi):
            owners[j] += 1
    assert owners == [1] * 8


@pytest.mark.parametrize("form", ["dq", "dkv"])
@pytest.mark.parametrize("dh", KERNEL_DHS[1:])
def test_flash_bwd_plan_gives_everything_one_owner(dh, form):
    plan = flash_bwd_plan(dh, form)
    assert plan.rows in (TILE, TILE // 2)     # whole tiles or two halves
    assert plan.rows % 16 == 0                # whole m16 row groups
    groups = len(plan.ntiles)
    assert 1 <= groups <= 4
    assert plan.threads == 32 * (plan.rows // 16) * groups <= 512
    check_owners(plan.ntiles)
    assert plan.smem <= SMEM_BLOCK
    if plan.threads == 256 and plan.rows == TILE:   # (256, 2) bounds
        assert 2 * (plan.smem + 1024) <= SMEM_SM


@pytest.mark.parametrize("dh,form", [(64, "dq"), (96, "dkv"), (576, "dq"),
                                     (128, "fwd")])
def test_flash_bwd_plan_refuses_what_has_no_wide_kernel(dh, form):
    with pytest.raises(ValueError, match="no wide"):
        flash_bwd_plan(dh, form)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dh", KERNEL_DHS[1:])
def test_flash_fwd_plan_gives_everything_one_owner(dh, shape):
    B, T = SHAPES[shape]
    h = 256 // dh if 256 % dh == 0 else 1     # chip_smoke.width_heads
    plan = flash_fwd_plan(dh, -(-T // TILE) * B * h)
    assert plan.rows in (TILE, TILE // 2)     # whole tiles or two halves
    assert plan.rows % 16 == 0                # whole m16 row groups
    groups = len(plan.ntiles)
    assert 1 <= groups <= 4
    assert plan.threads == 32 * (plan.rows // 16) * groups <= 512
    check_owners(plan.ntiles)
    assert 2 <= plan.stages <= 4              # a ring: a stage in flight
    assert plan.smem <= SMEM_BLOCK
    # the launch bounds ask for two blocks an SM below 512 threads (128
    # registers a thread): their shared memory fits
    if plan.threads < 512:
        assert 2 * (plan.smem + 1024) <= SMEM_SM


@pytest.mark.parametrize("dh,tiles", [(64, 352), (96, 352), (576, 96),
                                      (128, 0)])
def test_flash_fwd_plan_refuses_what_has_no_wide_kernel(dh, tiles):
    with pytest.raises(ValueError, match="no wide"):
        flash_fwd_plan(dh, tiles)
