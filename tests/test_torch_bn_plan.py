"""bn_train's launch plan (``ops/bn_train.py:launch_plan``) at every
BatchNorm site geometry of resnet34-unet, at the train batch (16 x 512²)
and at the CPU tests' size (4 x 64²), what the wrappers tell the C entry
points, and the phases tool's source variants. Pure Python: the kernels run only on a card, where ``chip_smoke.py``
holds them against their plain versions.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops import bn_train_phases

SOURCE = Path(bt.__file__).resolve().parent.parent / "csrc" / "bn_train.cu"
# (C, H, W at a 512² input, residual, branch, keep_f32) of each distinct
# site of resnet34-unet's train forward (43 sites, 46 BatchNorms)
SITES = (
    (64, 256, 256, False, False, True), (64, 128, 128, False, False, False),
    (64, 128, 128, True, False, True), (64, 128, 128, True, False, False),
    (128, 64, 64, False, False, False), (128, 64, 64, False, True, True),
    (128, 64, 64, True, False, True), (128, 64, 64, True, False, False),
    (256, 32, 32, False, False, False), (256, 32, 32, False, True, True),
    (256, 32, 32, True, False, True), (256, 32, 32, True, False, False),
    (512, 16, 16, False, False, False), (512, 16, 16, False, True, True),
    (512, 16, 16, True, False, True), (512, 16, 16, True, False, False),
    (32, 256, 256, False, False, False), (16, 512, 512, False, False, False),
)
SIZES = {"train": (16, 512), "cpu": (4, 64)}  # (batch, input side)
# co-resident grids: 132 SMs x 1, 2, 4 and 8 blocks
CO_RESIDENT = (132, 264, 528, 1056)


def site_pixels(site, size) -> tuple[int, int]:
    """(pixels, channels) of a site at a SIZES entry."""
    c, h, w = site[:3]
    batch, side = size
    return batch * (h * side // 512) * (w * side // 512), c


def block_pixels(m: int, plan: bt.Plan) -> np.ndarray:
    """Each block's pixels: tiles b, b + grid, ... of plan.tile pixels, the
    last tile cut at m."""
    starts = np.arange(0, m, plan.tile)
    sizes = np.minimum(plan.tile, m - starts)
    return np.bincount(np.arange(len(starts)) % plan.grid, weights=sizes,
                       minlength=plan.grid).astype(np.int64)


def test_sites_are_resnet34_unets():
    """SITES are the distinct sites of the port's resnet34-unet train
    forward, as bn_train_phases records them (at 64², scaled to 512²)."""
    sites = bn_train_phases.record_sites()
    assert len(sites) == 43 and sum(s["branch"] for s in sites) == 3
    assert all(s["shape"][0] == bn_train_phases.BATCH for s in sites)
    assert sorted({(*s["shape"][1:], s["residual"], s["branch"], s["keep_f32"])
                   for s in sites}) == sorted(SITES)


def test_plan_constants_match_the_kernel_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == bt.THREADS
    assert const("kStatsUnroll") == bt.UNROLL["stats"]
    assert const("kBackUnroll") == bt.UNROLL["backward"]
    assert const("kCombineLoads") == bt.COMBINE_LOADS
    assert const("kCounters") == bt.COUNTERS


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("site", SITES, ids=lambda s: "x".join(map(str, s[:3])) + "".join(
    tag for tag, on in zip(("-res", "-branch", "-f32"), s[3:]) if on))
def test_launch_plan(site, size):
    """The grid never exceeds the co-resident blocks; each block gets whole
    tiles of at least MIN_BLOCK_BYTES of the bf16 map; a site smaller than
    one block's share takes one block; the scratch holds each block's
    sums."""
    m, c = site_pixels(site, SIZES[size])
    for mode in ("stats", "backward"):
        for co in CO_RESIDENT:
            plan = bt.launch_plan(m, c, mode, co, branch=site[4])
            assert 1 <= plan.grid <= co
            assert plan.tile == bt.THREADS // (c // 8) * bt.UNROLL[mode]
            assert plan.sums == 2 + (mode == "backward" and site[4])
            assert plan.partials == plan.sums * c * plan.grid
            assert plan.combiners == bt.combiners(plan.grid, c) <= plan.grid
            assert plan.counters == bt.COUNTERS
            share = block_pixels(m, plan)
            assert share.sum() == m
            if 2 * m * c < bt.MIN_BLOCK_BYTES:
                assert plan.grid == 1
            if plan.grid > 1:
                assert 2 * c * share.min() >= bt.MIN_BLOCK_BYTES
            if plan.grid < co:  # not capped: one block more would cut a share short
                assert 2 * c * (m // plan.tile // (plan.grid + 1)) * plan.tile \
                    < bt.MIN_BLOCK_BYTES


def test_small_site_takes_one_block():
    assert bt.launch_plan(1, 8, "stats", 1056).grid == 1
    assert bt.launch_plan(2 * 32, 256, "backward", 264, branch=True).grid == 1


@pytest.mark.parametrize("grid,channels,want", [
    (1, 512, 1), (64, 512, 64), (128, 512, 64), (256, 256, 32), (257, 256, 64),
    (660, 64, 32), (660, 16, 8), (1056, 2048, 1056), (264, 8, 2)])
def test_combiners_give_each_team_one_channel(grid, channels, want):
    """A team of 1-8 warps takes a channel, each lane loading at most 8 of
    a sum's partials; the combiners are enough for one channel a team,
    never more than the grid."""
    assert bt.combiners(grid, channels) == want


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card path on CPU tensors, its C entry points recorded:
    (symbol, args) a call."""
    calls = []

    def entry(name, argtypes, symbol=None):
        assert name == "bn_train" and len(argtypes) == {
            "bn_train_stats": len(bt.STATS_ARGTYPES),
            "bn_train_backward": len(bt.BACKWARD_ARGTYPES)}[symbol]
        return lambda *args: calls.append((symbol, args)) or 0

    monkeypatch.setattr(bt, "_on_card", lambda x, what: True)
    monkeypatch.setattr(bt, "_co_resident", lambda device, mode, c, branch=False: 528)
    monkeypatch.setattr(bt, "_COUNTERS", {})
    monkeypatch.setattr(bt, "launches", 0)
    monkeypatch.setattr(bt, "backward_launches", 0)
    monkeypatch.setattr(bt._build, "entry", entry)
    monkeypatch.setattr(bt._build, "stream_handle", lambda t: 7)
    return calls


def cl(shape, dtype):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("site", [SITES[0], SITES[5], SITES[10], SITES[17]], ids=str)
def test_wrappers_tell_the_entry_points_the_plan(fake_card, site):
    """Each call launches once with the plan's grid, its partials sized
    sums x C x grid and the stream's two counters (one pair for both entry
    points and every call on the stream)."""
    m, c = site_pixels(site, SIZES["cpu"])
    shape = (SIZES["cpu"][0], c, m // SIZES["cpu"][0], 1)
    y = cl(shape, torch.bfloat16)
    vec = [torch.ones(c) for _ in range(4)]
    bt.bn_stats(y, *vec)
    branch = (cl(shape, torch.bfloat16), *vec[:3]) if site[4] else None
    bt.bn_backward(cl(shape, torch.bfloat16), cl(shape, torch.float32) if site[5] else None,
                   cl(shape, torch.bfloat16), y, *vec[:3], branch=branch, residual=site[3])
    assert bt.launches == 1 and bt.backward_launches == 1
    (s_sym, s), (b_sym, b) = fake_card
    assert (s_sym, b_sym) == ("bn_train_stats", "bn_train_backward")
    stats, back = (bt.launch_plan(m, c, "stats", 528),
                   bt.launch_plan(m, c, "backward", 528, branch=site[4]))
    # stats: ..., partials, partial_floats, counters, n_counters, blocks, ...
    assert (s[6], s[8], s[9]) == (stats.partials, bt.COUNTERS, stats.grid)
    assert (s[14], s[15]) == (m, c)
    # backward: ..., partials, partial_floats, counters, n_counters, blocks, ...
    assert (b[12], b[14], b[15]) == (back.partials, bt.COUNTERS, back.grid)
    assert (b[20], b[21]) == (m, c)
    assert s[7] == b[13] and list(bt._COUNTERS) == [(None, 7)]
    assert (b[7] is not None) == site[4] and (b[1] is not None) == site[5]
    assert (b[18] is not None) == site[3]  # dres


@pytest.mark.parametrize("name", [n for n, (edits, _) in bn_train_phases.VARIANTS.items()
                                  if edits])
def test_phases_variants_find_their_anchors(name):
    """Each source variant of ops/bn_train_phases.py edits text that the
    kernel source holds exactly once."""
    src = SOURCE.read_text()
    for old, _ in bn_train_phases.VARIANTS[name][0]:
        assert src.count(old) == 1, old
