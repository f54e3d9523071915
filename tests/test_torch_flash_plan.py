"""The bf16 flash kernel's launch plan (``ops/flash_attention.py::
flash_plan``), on the CPU.

The CUDA kernel refuses a plan that disagrees with its own arithmetic, so
these tests hold the plan to what the kernel can take: a route, a head
group that divides H, no more warps than the kernel's launch bounds, every
row tile of every head owned by some warp, shared memory within half of a
Hopper SM's 227 KB and a grid within ``blockIdx.x``'s INT_MAX.  The shapes
are ``chip_smoke.py``'s, where the kernel runs on the card.
"""

import pytest
import torch

import chip_smoke
from har_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

H100_SMS = 132
SMEM_PER_BLOCK = 232_448  # Hopper's dynamic shared memory a block may take
INT_MAX = 2**31 - 1

RESIDENT_SHAPES = {
    name: s for name, s in chip_smoke.FLASH_CHECK_SHAPES.items()
    if s is not chip_smoke.FLASH_STREAMED
}


def _plan(s, sms=H100_SMS):
    return fa.flash_plan(s["b"], s["t"], s["h"], s["d"], sms)


def _assert_launchable(s, plan):
    b, t, h, d = s["b"], s["t"], s["h"], s["d"]
    tiles = -(-t // 16)
    assert plan.route in ("resident", "streamed")
    assert h % plan.heads_per_block == 0
    assert 1 <= plan.warps <= min(32, fa.max_warps(d))
    assert plan.key_chunk == 32
    assert 0 < plan.smem_bytes <= SMEM_PER_BLOCK // 2
    assert 0 < plan.grid <= INT_MAX
    if plan.route == "resident":
        # one block per (batch row, head group); its warps walk every row
        # tile of its heads, and none of them idles
        assert plan.grid * plan.heads_per_block == b * h
        assert plan.warps <= plan.heads_per_block * tiles
    else:
        # one head a block, 16 rows a warp, the blocks of a head cover T
        assert plan.heads_per_block == 1
        q_blocks = plan.grid // (b * h)
        assert plan.grid == b * h * q_blocks
        assert (q_blocks - 1) * 16 * plan.warps < t <= q_blocks * 16 * plan.warps


def test_the_main_path_shapes_are_check_shapes():
    for shape in (chip_smoke.FLASH_TRAIN, chip_smoke.FLASH_PREDICT,
                  chip_smoke.FLASH_PACKED, chip_smoke.FLASH_PACKED_PREDICT):
        assert shape in RESIDENT_SHAPES.values()


@pytest.mark.parametrize("name", sorted(RESIDENT_SHAPES))
def test_check_shapes_take_the_resident_route(name):
    s = RESIDENT_SHAPES[name]
    plan = _plan(s)
    assert plan.route == "resident"
    _assert_launchable(s, plan)


@pytest.mark.parametrize(
    "shape",
    [chip_smoke.FLASH_STREAMED, dict(b=2, t=4096, h=2, d=128),
     dict(b=1, t=4096, h=1, d=128), dict(b=8, t=801, h=4, d=16)],
    ids=["check_2x4096x2x64", "4096_d128", "one_head_4096_d128", "801_d16"],
)
def test_long_sequences_take_the_streamed_route(shape):
    plan = _plan(shape)
    assert plan.route == "streamed"
    _assert_launchable(shape, plan)


def test_the_cli_and_packed_plans():
    """T = 200: one head per block, its 13 row tiles in two rounds of 7
    warps; T = 25 with 8 heads: 4 heads on 4 warps, two tiles a warp."""
    cli = _plan(chip_smoke.FLASH_TRAIN)
    assert (cli.heads_per_block, cli.warps, cli.grid) == (1, 7, 512 * 4)
    packed = _plan(chip_smoke.FLASH_PACKED)
    assert (packed.heads_per_block, packed.warps, packed.grid) == (4, 4, 4096 * 2)


def test_a_small_batch_splits_its_heads_across_blocks():
    """Fewer batch rows than two blocks per SM: one head a block, so the
    grid spreads over more SMs; a smaller card takes whole groups."""
    s = dict(b=64, t=25, h=8, d=32)
    assert _plan(s).heads_per_block == 1
    assert _plan(s, sms=16).heads_per_block == 4
    for sms in (16, H100_SMS):
        _assert_launchable(s, _plan(s, sms))


@pytest.mark.parametrize("d", [8, 16, 24, 32, 40, 64, 72, 128])
def test_every_head_dim_has_a_launchable_plan(d):
    for t in (1, 15, 16, 17, 200, 1000):
        s = dict(b=3, t=t, h=4, d=d)
        _assert_launchable(s, _plan(s))


def test_a_grid_past_int_max_raises():
    with pytest.raises(ValueError, match="past the grid"):
        fa.flash_plan(2**31, 16, 1, 16)


def test_plans_are_cached_and_frozen():
    s = chip_smoke.FLASH_TRAIN
    plan = _plan(s)
    assert _plan(s) is plan
    with pytest.raises(AttributeError):
        plan.warps = 1
