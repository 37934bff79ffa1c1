"""The grouped int8 kernel's weight layout and launch plan, on the CPU.

``ops/int8_conv.py:pack_grouped`` (the kernel's block-diagonal bundles in
the MMA's fragment order) and ``grouped_plan`` (instance, slab, band, copy
depth) at resnext50_32x4d's grouped sites and at chip_smoke's edge
geometries, against the kernel source's constants; the kernel itself runs
only on the card (chip_smoke phase 2).
"""

import re

import numpy as np
import pytest
import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import int8_conv as ic

# resnext50_32x4d's grouped 3x3 at 512 tiles, batch 128: (sites, ho, co,
# stride), the first site of layers 2-4 at stride 2
WALK = ((3, 128, 128, 1), (1, 64, 256, 2), (3, 64, 256, 1), (1, 32, 512, 2), (5, 32, 512, 1),
        (1, 16, 1024, 2), (2, 16, 1024, 1))


@pytest.mark.parametrize("cg,groups", [(4, 8), (8, 4), (16, 3), (32, 2), (48, 2), (12, 4)])
def test_packed_zeros_sit_off_the_diagonal_and_past_the_tap_row(cg, groups):
    """Each packed byte is the weight the design names (output channel 8 j
    + g of the bundle, word p = tig + 4 half of step s: unit t = 4 s + tig,
    channel 8 (t % u) + 4 half + e at tap t // u), and zero exactly where
    that channel's group is not the output channel's or t is past the tap
    row; a bundle is the fewest whole groups in a multiple of 8 channels."""
    co = groups * cg
    rng = np.random.default_rng(cg)
    w = torch.from_numpy(rng.integers(1, 128, (co, cg, 3, 3)).astype(np.int8))  # no zero weight
    packed = ic.pack_grouped(w, groups).numpy()
    cb, units, steps = ic.grouped_bundle(cg)
    assert cb == np.lcm(cg, 8) and cb % cg == 0 and steps == -(-3 * cb // 8 // 4)
    assert packed.shape == (co // cb, 3, steps, cb // 8, 32, 8)
    u = cb // 8
    for bi, ky, s, j, lane, byte in np.ndindex(packed.shape):
        g, tig, half, e = lane // 4, lane % 4, byte // 4, byte % 4
        t, n = 4 * s + tig, bi * cb + 8 * j + g
        c = 8 * (t % u) + 4 * half + e
        same = t < units and (c // cg) == (n - bi * cb) // cg
        want = int(w[n, c % cg, ky, t // u]) if same else 0
        assert packed[bi, ky, s, j, lane, byte] == want
    # the block-diagonal zeros: a bundle of k groups keeps 1 / k of its bytes
    # in the taps' units
    real = np.count_nonzero(packed)
    assert real == co * cg * 9


def test_plan_at_the_walk_sites():
    """Every grouped site of resnext50_32x4d takes a fast instance (cg 4,
    8, 16, 32 at its stride), fits its blocks an SM in an H100's shared
    memory, and has at least one block a SM; the bands cover each image."""
    for _, ho, co, stride in WALK:
        plan = ic.grouped_plan(128, ho, ho, co, 32, stride)
        cg = co // 32
        assert plan.instance == 1 + 2 * ic.GROUPED_FAST_CG.index(cg) + stride - 1
        assert plan.slab == ic.GROUPED_SLAB and 1 <= plan.depth <= ic.GROUPED_MAX_DEPTH
        assert plan.blocks_per_sm * plan.smem <= ic.SMEM_BYTES
        assert plan.ring == (plan.depth + plan.rows_step - 1) * stride + 3
        assert plan.rows_step == {(4, 1): 1, (8, 2): 1, (8, 1): 2, (16, 2): 2, (16, 1): 4,
                                  (32, 2): 1, (32, 1): 4}[cg, stride]
        assert plan.grid == co // plan.slab * -(-ho // plan.band) * 128 >= 132
        assert plan.threads == (128 if cg == 32 else 256)


@pytest.mark.parametrize("B,ho,wo,groups,cg,stride,pad,dil,instance", [
    (2, 32, 32, 32, 32, 1, 2, 2, 0),   # dilation 2: the general instance
    (2, 64, 64, 32, 16, 1, 2, 2, 0),
    (2, 64, 64, 32, 32, 1, 4, 4, 0),
    (1, 13, 13, 32, 4, 1, 1, 1, 1),    # Wo 13: one 16-pixel tile, part empty
    (3, 17, 16, 32, 8, 2, 1, 1, 4),    # stride 2 from odd sides
    (1, 32, 32, 32, 48, 1, 1, 1, 0),   # 48 a group
    (1, 7, 9, 20, 4, 2, 1, 1, 2),      # 80 channels: the slab part empty
    (2, 40, 24, 6, 16, 1, 1, 1, 5),    # 96 channels, a band that ends short
])
def test_plan_at_edges(B, ho, wo, groups, cg, stride, pad, dil, instance):
    """The instance the wrapper picks; shared memory within an H100's; the
    ring holds the rows a band's output row reads and the copies ahead."""
    co = groups * cg
    plan = ic.grouped_plan(B, ho, wo, co, groups, stride, pad, dil)
    assert plan.instance == instance
    cb = np.lcm(cg, 8)
    assert plan.slab % np.lcm(cb, 16) == 0 and plan.slab >= cb
    assert plan.smem <= ic.SMEM_BYTES
    assert plan.ring == (plan.depth + plan.rows_step - 1) * stride + 2 * dil + 1
    assert plan.rows_step == 1 or instance > 0
    mt = ic.grouped_segment(wo, stride) // 16
    assert plan.seg == 16 * mt and plan.cols >= (16 * mt - 1) * stride + 2 * dil + 1
    if plan.instance:  # a TMA box of whole swizzle periods, within 256 columns
        assert plan.slot_bytes % 1024 == 0 and plan.cols <= plan.slot_bytes // 128 <= 256
    else:  # chunk-major, an odd chunk stride
        assert plan.slot_bytes % plan.slab == 0 and (plan.slot_bytes // plan.slab) % 2 == 1


def test_plan_constants_match_the_source():
    """The plan's slab, depth limit, tiles an item, threads and blocks an
    SM are the kernel's compiled constants (Grouped<CG>, kGroupedSlab,
    kGroupedMaxDepth), and the entry point takes the plan's ten arguments
    (GroupedPlan.entry_args: its launch and its shared-memory layout) after
    the stream, in their order."""
    src = (_build.CSRC / "int8_conv.cu").read_text()
    assert f"constexpr int kGroupedSlab = {ic.GROUPED_SLAB};" in src
    assert f"constexpr int kGroupedMaxDepth = {ic.GROUPED_MAX_DEPTH};" in src
    assert "static constexpr int kWarps = CG == 32 ? 4 : 8;" in src
    assert "static constexpr int kMinBlocks = CG == 32 ? 3 : 2;" in src
    assert [ic.grouped_segment(w, s) for w, s in ((13, 1), (128, 1), (300, 1), (64, 2),
                                                  (100, 2), (50, 3))] == [16, 128, 128, 64, 64, 32]
    sig = re.search(r'extern "C" int int8_conv_grouped\(([^)]*)\)', src).group(1)
    assert len(sig.split(",")) == len(ic.GROUPED_ARGTYPES)
    after = [a.split()[-1] for a in sig.split("void* stream,")[1].split(",")]
    plan = ic.grouped_plan(4, 32, 32, 1024, 32)
    assert after == ["instance", "slab", "band", "depth", "rows_step", "seg", "cols", "ring",
                     "slot_bytes", "smem"]
    assert plan.entry_args() == tuple(getattr(plan, a) for a in after)
    assert "static constexpr int kMT = CG == 32 ? 1 : 2;" in src
    assert ic.GROUPED_ITEM_TILES == {4: 2, 8: 2, 16: 2}
    for cg in ic.GROUPED_FAST_CG:
        plan = ic.grouped_plan(4, 32, 32, 32 * cg, 32)
        assert plan.threads == 32 * (4 if cg == 32 else 8)
        assert plan.blocks_per_sm == (3 if cg == 32 else 2)


def test_plan_fills_the_card_at_layer4():
    """layer4's 16² sites (the smallest) keep at least two waves of blocks
    in flight on 132 SMs."""
    plan = ic.grouped_plan(128, 16, 16, 1024, 32, 1)
    assert plan.grid >= 2 * 132 * plan.blocks_per_sm


def test_wrapper_on_cpu_takes_the_plain_version_for_a_plan():
    """A plan passed to the wrapper changes nothing on the CPU (the plain
    version), and counts no launch."""
    g = torch.Generator().manual_seed(3)
    p = ic.Int8ConvParams(torch.randint(-127, 128, (64, 8, 3, 3), generator=g,
                                        dtype=torch.int8), 0.1, torch.full((64,), 1e-3),
                          torch.zeros(64), 8)
    x = torch.randint(-127, 128, (1, 64, 9, 9), generator=g, dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    ic.grouped_launches = 0
    got = ic.int8_conv_grouped(x, p, 2, 1, out_sx=0.05,
                               plan=ic.grouped_plan(1, 5, 5, 64, 8, 2))
    want = ic.int8_conv_plain(x, p, 2, 1, out_sx=0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ic.grouped_launches == 0


def test_epilogue_conversions_are_the_conversion_units():
    """The grouped epilogue's conversions on the FMA pipes, transcribed in
    numpy float32 (each operation rounded to nearest even, as __fadd_rn,
    __fmul_rn): float(acc) from the bits of 1.5 * 2^23 + acc equals
    float32(acc) over |acc| <= 2^22; quantize_bits's low byte, the
    clamp before the rounding, equals quantize_values (round half to even,
    then clip to [-127, 127]) over values around every rounding midpoint,
    the bounds, and far outside them."""
    acc = np.concatenate([np.arange(-2 ** 22, -2 ** 22 + 4096), np.arange(-70000, 70000),
                          np.arange(2 ** 22 - 4096, 2 ** 22 + 1), np.array([144 * 127 ** 2])])
    acc = acc.astype(np.int32)
    magic = ((acc + np.int32(0x4B400000)).view(np.float32)
             - np.float32(12582912.0)).astype(np.float32)
    np.testing.assert_array_equal(magic, acc.astype(np.float32))

    rng = np.random.default_rng(0)
    halves = np.arange(-300, 301, dtype=np.float32) / np.float32(2)
    near = np.concatenate([np.nextafter(halves, np.float32(-1e9)), halves,
                           np.nextafter(halves, np.float32(1e9))])
    v = np.concatenate([near, rng.normal(0, 60, 20000).astype(np.float32),
                        np.float32([1e9, -1e9, 3.4e38, -3.4e38, np.inf, -np.inf, 0.0, -0.0])])
    for inv in (np.float32(1.0), np.float32(1 / 0.04), np.float32(0.37)):
        with np.errstate(over="ignore"):  # 3.4e38 * 25 is inf, as on the card
            t = (v * inv).astype(np.float32)
        c = np.minimum(np.maximum(t, np.float32(-127)), np.float32(127))
        bits = (c + np.float32(12582912.0)).astype(np.float32).view(np.uint32)
        got = (bits & 0xFF).astype(np.uint8).view(np.int8)
        # quantize_values's operations after its multiply
        want = torch.round(torch.from_numpy(t)).clamp_(-127, 127).to(torch.int8).numpy()
        np.testing.assert_array_equal(got, want)


def test_plan_takes_any_width():
    """Rows wider than a segment (2048-pixel tiles: 512 columns at layer1)
    split into segments whose staged rows fit a TMA box and shared memory."""
    for wo, stride in ((256, 1), (512, 1), (256, 2), (1000, 2)):
        plan = ic.grouped_plan(4, 64, wo, 128, 32, stride)
        assert plan.cols <= 256 and plan.smem * plan.blocks_per_sm <= ic.SMEM_BYTES
        assert plan.grid == -(-wo // ic.grouped_segment(wo, stride)) * -(-64 // plan.band) * 4


def test_phases_tool_anchors():
    """Every guard of ``ops/int8_grouped_phases.py`` still finds its anchor
    in the kernel source (the tool itself needs the card)."""
    from flairtpu_torch.ops import int8_grouped_phases as gp

    src = gp.guarded_source()
    for name, uses in (("GROUPED_NO_COPIES", 2), ("GROUPED_NO_MMA", 1),
                       ("GROUPED_NO_EPILOGUE", 4), ("GROUPED_CVT_UNIT", 2),
                       ("GROUPED_TIMING", 10)):
        assert src.count(name) == 2 + uses, name  # its default and its uses
    assert set(gp.VARIANTS) == {"full", "no_copies", "no_mma", "no_epilogue", "convert_unit",
                                "timing"}
