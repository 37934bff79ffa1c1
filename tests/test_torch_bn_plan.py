"""bn_train's launch plan (``ops/bn_train.py:launch_plan``) at every
BatchNorm site geometry of resnet34-unet, at the train batch (16 x 512²)
and at the CPU tests' size (4 x 64²), and at efficientnet-b4-unet's SiLU
and affine sites (the lean backward's U); the sample index constant
(``sample_divisor``); what the wrappers tell the C entry points; and the
phases tool's source variants. Pure Python: the kernels run only on a card,
where ``chip_smoke.py`` holds them against their plain versions.
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
# (mode, C, H, W at a 512² input, keep_f32) of each distinct site of
# efficientnet-b4-unet's train forward that takes the SiLU or the affine
# (31 SiLU, 32 depthwise, 25 drop-connect sites)
EFFNET_SITES = (
    ("depthwise", 24, 256, 256, False), ("depthwise", 48, 256, 256, False),
    ("depthwise", 144, 128, 128, False), ("depthwise", 192, 64, 64, False),
    ("depthwise", 192, 128, 128, False), ("depthwise", 336, 32, 32, False),
    ("depthwise", 336, 64, 64, False), ("depthwise", 672, 32, 32, False),
    ("depthwise", 960, 16, 16, False), ("depthwise", 960, 32, 32, False),
    ("depthwise", 1632, 16, 16, False), ("depthwise", 2688, 16, 16, False),
    ("drop", 24, 256, 256, False), ("drop", 32, 128, 128, False), ("drop", 32, 128, 128, True),
    ("drop", 56, 64, 64, False), ("drop", 56, 64, 64, True), ("drop", 112, 32, 32, False),
    ("drop", 112, 32, 32, True), ("drop", 160, 32, 32, False), ("drop", 160, 32, 32, True),
    ("drop", 272, 16, 16, False), ("drop", 272, 16, 16, True), ("drop", 448, 16, 16, False),
    ("silu", 48, 256, 256, False), ("silu", 144, 256, 256, False),
    ("silu", 192, 128, 128, False), ("silu", 336, 64, 64, False), ("silu", 672, 32, 32, False),
    ("silu", 960, 32, 32, False), ("silu", 1632, 16, 16, False), ("silu", 2688, 16, 16, False),
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
    assert const("kLeanUnroll") == bt.UNROLL["lean"]
    assert re.search(r"kMaxBackPixels = 1LL << (\d+);", src).group(1) == "31"
    assert bt.MAX_BACKWARD_PIXELS == 2 ** 31
    kinds = re.findall(r"k(\w+)Kind = (\d+),", src)
    assert [int(v) for _, v in kinds] == list(range(len(bt.KINDS)))
    assert [re.sub(r"(?<=.)([A-Z])", r"_\1", k).lower() for k, _ in kinds] == list(bt.KINDS)
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
    monkeypatch.setattr(bt, "_sms", lambda device: 132)
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


def test_effnet_sites_are_b4_unets():
    """EFFNET_SITES are the distinct SiLU and affine sites of the port's
    efficientnet-b4-unet train forward, as ``bn_train_phases --effnet``
    records them (at 64², a drop-connect mask at every block with an
    identity, scaled to 512²): 31 SiLU, 32 depthwise, 25 drop-connect."""
    sites = bn_train_phases.record_effnet_sites()
    counts = {m: sum(s["mode"] == m for s in sites) for m in ("silu", "depthwise", "drop")}
    assert counts == {"silu": 31, "depthwise": 32, "drop": 25} and len(sites) == 88
    assert all(s["shape"][0] == bn_train_phases.BATCH and s["hw"] == s["shape"][2] * s["shape"][3]
               for s in sites)
    assert all(s["residual"] == (s["mode"] == "drop") for s in sites)
    assert all((s["keep"] is not None) == (s["mode"] == "drop") for s in sites)
    assert sorted({(s["mode"], *s["shape"][1:], s["keep_f32"]) for s in sites}) == \
        sorted(EFFNET_SITES)


# the sample boundaries and pixels the divisor is held at: b4's maps, odd
# sides, and pixels up to a batch of 128 x 512²
HW = (512 * 512, 256 * 256, 128 * 128, 64 * 64, 32 * 32, 16 * 16, 1, 3, 7, 1000, 65535)
BATCH_128_PIXELS = 128 * 512 * 512


@pytest.mark.parametrize("hw", HW)
def test_sample_divisor_gives_the_floor_division(hw):
    """(p * magic) >> shift == p // hw at every sample boundary (b hw - 1,
    b hw, b hw + 1) up to batch 128 x 512² (a seeded 10^4 of them where
    there are more), at 10^4 seeded pixels below 2^31 and at 2^31 - 1; the
    constant fits 32 bits, the product 63."""
    magic, shift = bt.sample_divisor(hw)
    assert 0 < magic < 2 ** 32 and shift == 31 + (hw - 1).bit_length()
    rng = np.random.default_rng(hw)
    samples = BATCH_128_PIXELS // hw
    b = (np.arange(1, samples + 1, dtype=np.uint64) if samples <= 10 ** 4
         else rng.integers(1, samples + 1, 10 ** 4, dtype=np.uint64))
    b = np.concatenate([b, np.array([1, samples], dtype=np.uint64)])
    p = np.concatenate([b * hw - 1, b * hw, b * hw + 1,
                        rng.integers(0, 2 ** 31, 10 ** 4, dtype=np.uint64),
                        np.array([0, 2 ** 31 - 1], dtype=np.uint64)])
    assert int(p.max()) * magic < 2 ** 63
    got = (p * np.uint64(magic)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, p // np.uint64(hw))


def test_backward_refuses_2_31_pixels():
    """The backward's pixel index is 31 bits: the plan refuses 2^31 pixels
    or more (the statistics take them), and a sample of 0 or more than
    2^31 pixels."""
    assert bt.launch_plan(2 ** 31 - 1, 64, "backward", 528).grid == 528
    with pytest.raises(ValueError, match="2\\^31"):
        bt.launch_plan(2 ** 31, 64, "backward", 528)
    with pytest.raises(ValueError, match="2\\^31"):
        bt.launch_plan(2 ** 31, 64, "backward", 528, lean=True, hw=2 ** 20)
    assert bt.launch_plan(2 ** 31, 64, "stats", 528).grid == 528
    for hw in (0, 2 ** 31 + 1):
        with pytest.raises(ValueError):
            bt.sample_divisor(hw)


@pytest.mark.parametrize("site", EFFNET_SITES, ids=lambda s: "-".join(map(str, s)))
def test_launch_plan_at_b4_sites(site):
    """At b4's SiLU and affine sites (batch 16) the lean backward walks
    tiles of rows x kLeanUnroll pixels where a pixel loads only g and y, and
    of rows x kBackUnroll where it also loads g32 (the drop-connect sites
    before an identity), each block at least MIN_LEAN_BLOCK_BYTES of its
    channel tile's map, the grid of whole channel tiles within the
    co-resident blocks, the sample constant of the site's H W; given the
    card's SMs, a one-tile grid above them rounded down to a multiple of
    them; a ReLU site of the same geometry keeps U = kBackUnroll,
    MIN_BLOCK_BYTES and its grid."""
    mode, c, h, w, keep_f32 = site
    m, hw = 16 * h * w, h * w
    ct = bt.channel_tiles(c)
    rows = bt.THREADS // (c // ct // 8)
    for co in CO_RESIDENT:
        plan = bt.launch_plan(m, c, "backward", co, lean=True, hw=hw, g32=keep_f32)
        u = bt.UNROLL["backward"] if keep_f32 else bt.UNROLL["lean"]
        assert u == (2 if keep_f32 else 4) and plan.unroll == u and plan.tile == rows * u
        assert (plan.sample_magic, plan.sample_shift) == bt.sample_divisor(hw)
        assert plan.grid % ct == 0 and ct <= plan.grid <= max(co, ct)
        assert plan.partials == 2 * c * (plan.grid // ct) and plan.channel_tiles == ct
        nb = plan.grid // ct
        least = bt.MIN_LEAN_BLOCK_BYTES
        if nb > 1:
            assert 2 * (c // ct) * (m // plan.tile // nb) * plan.tile >= least
        if nb < co // ct:
            assert 2 * (c // ct) * (m // plan.tile // (nb + 1)) * plan.tile < least
        balanced = bt.launch_plan(m, c, "backward", co, lean=True, hw=hw, g32=keep_f32, sms=132)
        if ct == 1 and plan.grid > 132:
            assert balanced.grid == plan.grid - plan.grid % 132 and balanced.grid % 132 == 0
        else:
            assert balanced.grid == plan.grid
        assert balanced.partials == 2 * c * (balanced.grid // ct)
        assert balanced.combiners == bt.combiners(balanced.grid // ct, c)
        relu = bt.launch_plan(m, c, "backward", co, hw=hw)
        assert relu == bt.launch_plan(m, c, "backward", co, hw=hw, sms=132)
        assert relu.unroll == bt.UNROLL["backward"] == 2 and relu.tile == rows * 2
        nb = relu.grid // ct
        if nb < co // ct:
            assert 2 * (c // ct) * (m // relu.tile // (nb + 1)) * relu.tile < bt.MIN_BLOCK_BYTES
        assert bt.launch_plan(m, c, "backward", co, branch=True, lean=True, hw=hw).unroll == 2


@pytest.mark.parametrize("relu,branch,silu,affine,want", [
    (True, False, False, False, "relu"), (False, True, False, False, "branch"),
    (True, True, False, False, "branch"), (False, False, False, False, "lean"),
    (False, False, True, False, "silu"), (False, False, False, True, "affine"),
    (False, False, True, True, "silu_affine")])
def test_backward_kind(relu, branch, silu, affine, want):
    """The instance of a call's operands; the lean ones with g32 apart, the
    ReLU and branch ones test for it at run time."""
    assert bt.backward_kind(relu, branch, silu, affine) == want
    assert bt.backward_kind(relu, branch, silu, affine, g32=True) == (
        want if want in ("relu", "branch") else want + "_g32")
    assert want in bt.KINDS and bt.KINDS.index(want) < 6


@pytest.mark.parametrize("site", [s for s in EFFNET_SITES if s[3] == 64 or s[1] == 2688],
                         ids=lambda s: "-".join(map(str, s)))
def test_wrapper_tells_the_backward_its_instance(fake_card, site):
    """A SiLU, depthwise or drop-connect call launches once with its plan:
    the grid, U (4 with g and y alone, 2 with g32) and the sample constant
    of the map's H W, after the hw; the card path refuses the SiLU or the
    affine with a ReLU."""
    mode, c, h, w, keep_f32 = site
    shape = (2, c, h // 8, w // 8)
    y = cl(shape, torch.bfloat16)
    vec = [torch.ones(c) for _ in range(3)]
    kw = {"shift": torch.zeros(c)} if mode != "drop" else {}
    if mode != "silu":
        kw["gmul"] = torch.ones(2, c)
    if mode == "depthwise":
        kw["gadd"] = torch.zeros(2, c)
    bt.bn_backward(cl(shape, torch.bfloat16), cl(shape, torch.float32) if keep_f32 else None,
                   None, y, *vec, relu=False, residual=mode == "drop", **kw)
    (sym, b), = fake_card
    m = y.numel() // c
    plan = bt.launch_plan(m, c, "backward", 528, lean=True, hw=shape[2] * shape[3], g32=keep_f32,
                          sms=132)
    assert sym == "bn_train_backward" and bt.backward_launches == 1
    assert (b[12], b[15], b[20], b[21]) == (plan.partials, plan.grid, m, c)
    assert b[26:30] == (shape[2] * shape[3], 2 if keep_f32 else 4, plan.sample_magic,
                        plan.sample_shift)
    assert (b[23] is not None, b[24] is not None, b[25] is not None) == (
        "shift" in kw, "gmul" in kw, "gadd" in kw)
    with pytest.raises(ValueError, match="no ReLU"):
        bt.bn_backward(cl(shape, torch.bfloat16), None, y, y, *vec, relu=True, **kw)
