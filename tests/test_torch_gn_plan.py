"""``ops/group_norm.py:launch_plan``, the plan of ``group_norm_relu``'s
one-launch backward, on the CPU with an H100's limits (132 SMs, 227 KB of
shared memory a block, 50 MB of L2; the occupancy as the shared memory
allows, at most two blocks of 256 threads an SM as the kernel's launch
bounds ask).

- At FPN's seven site shapes at batch 16 and 512 tiles, and at the same
  decoder at 256 and 1024 tiles: every pixel of every sample falls in one
  item of one block, the grid is one the card holds at once (the blocks of
  a sample wait for each other), the shared memory fits a block, the
  upsampling sites keep dz and x on chip (g read from HBM once), and the
  re-read route's samples in flight fit in its L2 share where one sample
  does; the 128² site at 512 tiles takes the re-read route.
- The plan never raises for a shape the forward accepts (C a multiple of 8
  dividing 2048, groups dividing C, any map, any batch).
- The plan's constants against ``csrc/group_norm.cu``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from flairtpu_torch.ops import group_norm as gn

BATCH, C, G = 16, 128, 32
SMEM_SM = 233472  # an H100 SM's shared memory; a block reserves 1 KB of it
H100 = gn.Limits(132, 232448, 50 * 2 ** 20,
                 lambda up, on_chip, smem: min(2, SMEM_SM // (smem + 1024)))
# FPN's Conv3x3GNReLU sites as (side at 512 tiles, upsample): p5, p4, p3 and
# p2's first convs and the upsampling chains
FPN = ((16, True), (32, True), (64, True), (32, True), (64, True), (64, True), (128, False))
SRC = Path(gn.__file__).resolve().parent.parent / "csrc" / "group_norm.cu"


def coverage(plan: gn.BackwardPlan, batch: int, hw: int) -> np.ndarray:
    """How many items of the launch cover each (sample, pixel): block b
    takes part b % parts of samples b // parts, + slots, ..."""
    seen = np.zeros((batch, hw + 1), np.int64)
    for b in range(plan.grid):
        part = b % plan.parts
        for s in range(b // plan.parts, batch, plan.slots):
            lo, hi = part * plan.part, min(hw, (part + 1) * plan.part)
            seen[s, lo] += 1
            seen[s, hi] -= 1
    return np.cumsum(seen, axis=1)[:, :hw]


def check_plan(plan: gn.BackwardPlan, batch: int, h: int, w: int, channels: int, groups: int,
               up: bool) -> None:
    hw = h * w
    assert (coverage(plan, batch, hw) == 1).all()
    assert plan.parts == -(-hw // plan.part) and plan.grid == plan.slots * plan.parts
    assert 1 <= plan.slots <= batch
    assert plan.smem == gn.backward_smem(channels, groups, plan.part, plan.on_chip, up)
    assert plan.smem <= H100.smem_block
    assert plan.blocks_per_sm == H100.blocks_per_sm(up, plan.on_chip, plan.smem) >= 1
    assert plan.grid <= H100.sms * plan.blocks_per_sm  # resident at once: the waits end
    assert plan.part % gn.pass_pixels(channels) == 0 or plan.part >= hw
    sample = hw * channels * (2 + 4 * (4 if up else 1))
    assert plan.sample_bytes == sample and plan.in_flight_bytes == plan.slots * sample
    io = batch * hw * channels * (2 + 4 * (4 if up else 1) + 2)
    if plan.on_chip or plan.in_flight_bytes <= H100.l2_bytes * gn.L2_SHARE:
        assert plan.hbm_bytes == io  # x and g read from HBM once, dy written once
    else:  # not even one sample fits in the L2 share: the second read from HBM
        assert plan.slots == 1 and plan.hbm_bytes == io + batch * sample


@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_plan_at_fpn_sites(tile):
    """FPN's seven sites at 256, 512 and 1024 tiles (the maps scale with
    the tile): one item a pixel, resident grids, the upsampling sites on
    chip, the re-read route's samples in flight in L2 where one fits."""
    for side, up in FPN:
        side = side * tile // 512
        plan = gn.launch_plan(BATCH, side, side, C, G, up, H100)
        check_plan(plan, BATCH, side, side, C, G, up)
        assert plan.on_chip == up
        if not up and plan.sample_bytes <= H100.l2_bytes * gn.L2_SHARE:
            assert plan.in_flight_bytes <= H100.l2_bytes * gn.L2_SHARE


def test_the_128_site_rereads_from_l2():
    """seg3_c0 (p2) at 512 tiles: 128² and no upsample takes the re-read
    route, two samples (x 4 MB, g 8 MB each) in flight, within half the L2;
    a 256² unupsampled map (1024 tiles) re-reads from HBM, one sample in
    flight; the 64² upsampling sites keep 8 samples on chip in two rounds."""
    p2 = gn.launch_plan(BATCH, 128, 128, C, G, False, H100)
    assert not p2.on_chip and p2.slots == 2
    assert p2.in_flight_bytes == 2 * 128 * 128 * C * 6 <= H100.l2_bytes * gn.L2_SHARE
    assert p2.hbm_bytes == BATCH * 128 * 128 * C * 8
    big = gn.launch_plan(BATCH, 256, 256, C, G, False, H100)
    assert not big.on_chip and big.slots == 1
    assert big.sample_bytes > H100.l2_bytes * gn.L2_SHARE and big.hbm_bytes > 256 * 256 * C * 8
    p3 = gn.launch_plan(BATCH, 64, 64, C, G, True, H100)
    assert p3.on_chip and p3.slots == 8 and p3.grid <= 264


def test_forced_routes():
    """The phases tool's variants: the re-read route anywhere, the on-chip
    route where a sample fits (the 128² site too); forcing it where no item
    size fits raises."""
    for side, up in FPN:
        check_plan(gn.launch_plan(BATCH, side, side, C, G, up, H100, route="reread"), BATCH,
                   side, side, C, G, up)
    on = gn.launch_plan(BATCH, 128, 128, C, G, False, H100, route="on_chip")
    assert on.on_chip
    check_plan(on, BATCH, 128, 128, C, G, False)
    with pytest.raises(ValueError, match="does not fit on chip"):
        gn.launch_plan(BATCH, 512, 512, C, G, True, H100, route="on_chip")
    with pytest.raises(ValueError, match="route"):
        gn.launch_plan(BATCH, 16, 16, C, G, True, H100, route="cluster")


def test_plan_never_raises_for_a_shape_the_forward_takes():
    """Every channel count the forward accepts, with its smallest and
    largest group counts, small and ragged maps, batch 1 to 16, both
    upsample settings: a plan whose items cover every pixel once, on a grid
    the card holds at once."""
    for channels in (8, 16, 32, 64, 128, 256, 512, 1024, 2048):
        for groups in (1, 32 if channels >= 32 else channels, channels):
            gn.check_channels(channels, groups)
            for h, w in ((1, 1), (3, 17), (64, 64), (45, 45), (300, 7)):
                for batch in (1, 3, 16):
                    for up in (False, True):
                        plan = gn.launch_plan(batch, h, w, channels, groups, up, H100)
                        check_plan(plan, batch, h, w, channels, groups, up)


def test_plan_constants_match_the_kernel_source():
    """THREADS, FOLD_FAN_IN, the ring's size and the shared memory
    formula's terms against csrc/group_norm.cu."""
    src = SRC.read_text()
    assert f"constexpr int kThreads = {gn.THREADS};" in src
    assert f"constexpr int kFoldFanIn = {gn.FOLD_FAN_IN};" in src
    assert (f"constexpr int ring_slots(bool up) {{ return up ? {gn.RING_SLOTS[True]} : "
            f"{gn.RING_SLOTS[False]}; }}") in src
    assert (f"constexpr int pixel_words(bool up) {{ return up ? {gn.PIXEL_WORDS[True]} : "
            f"{gn.PIXEL_WORDS[False]}; }}") in src
    smem = src[src.index("inline long long backward_smem"):]
    smem = smem[:smem.index("\n}\n")]
    assert re.search(r"fold_rows\(C\) \* 2 \* C \+ 4LL \* C \+ \(\(2LL \* G \+ 3\) / 4\) \* 4 "
                     r"\+\s+kThreads \+ 4", smem)
    staged = src[src.index("inline long long stage_bytes"):]
    assert "* 3 * kThreads * 16" in staged and "pixel_words(up) * kThreads * 16" in staged
