"""The host side of the int8_conv kernel (``flairtpu_torch/ops/int8_conv.py``)
on the CPU: the instance a site takes (output columns a tile, how A is
loaded) and the operand checks the kernel's loads, TMA weight map and
16-byte epilogue need, which the wrapper makes on either device.

The int8 walks of resnet18, resnet34 and resnet50 U-Nets (random weights,
one 64 x 64 tile, int8_decoder 2) run through a recording conv: every site
must map to an instance the kernel has: the stem's 8-byte gathers, im2col
TMA in 128- or 64-byte rows where Cp is a multiple of either. Exact
kernel-vs-plain equality is checked on the card (chip_smoke.py phase 2)."""

import numpy as np
import pytest
import torch

from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops import int8_conv_phases as ph

TILE, MARGIN = 64, 16


@pytest.mark.parametrize("cp,co,geometry,want", [
    (8, 64, (7, 2, 3, 1), (64, 8)),         # the stem: 5 channels padded to 8
    (24, 72, (3, 1, 1, 1), (128, 8)),       # 8-byte groups, 128 columns past 64
    (40, 64, (3, 1, 1, 1), (64, 8)),
    (16, 8, (3, 1, 1, 1), (64, 16)),
    (32, 64, (3, 1, 1, 1), (64, 16)),
    (48, 128, (3, 1, 1, 1), (128, 16)),
    (64, 64, (3, 1, 1, 1), (64, 64)),       # layer 1: 64-byte im2col rows
    (64, 128, (1, 2, 0, 1), (128, 64)),
    (192, 128, (3, 1, 1, 1), (128, 64)),
    (128, 128, (3, 1, 1, 1), (128, 128)),   # a stage of K in one tap: im2col TMA
    (768, 256, (3, 1, 1, 1), (128, 128)),   # decoder block 0's concat
    (256, 64, (3, 1, 2, 2), (64, 128)),
    (128, 128, (3, 1, 130, 1), (128, 16)),  # corners past the map's 8 bits: gathers
    (64, 128, (3, 9, 1, 1), (128, 16)),     # a traversal stride past 8
])
def test_kernel_instance(cp, co, geometry, want):
    assert ic.kernel_instance(cp, co, *geometry) == want


def test_instance_codes_are_distinct():
    codes = {ic.instance_code(bn, g) for bn in (64, 128) for g in (8, 16, *ic.TMA_ROWS)}
    assert codes == set(range(8))
    assert ic.instance_code(128, 16) == 3 and ic.instance_code(64, 8) == 0
    assert ic.instance_code(128, 128) == 6 and ic.instance_code(64, 64) == 5


def quantized_model(arch: str, int8_decoder: int) -> pq.QuantizedZoneModel:
    torch.manual_seed(0)
    model = FlairSegmentationModel(arch, 4, 5).eval()
    batch = np.random.default_rng(1).integers(0, 256, (1, TILE, TILE, 5), dtype=np.uint8)
    cfg = {"int8_decoder": int8_decoder, "norma_task": [{"norm_type": "scaling"}]}
    return pq.quantize_model(cfg, model, [batch])


@pytest.mark.parametrize("arch,int8_decoder", [("resnet18", 2), ("resnet34", 2), ("resnet50", 2),
                                               ("resnet34", 4)])
def test_walk_sites_map_to_instances(arch, int8_decoder):
    """Every int8 site of the walk: a supported instance (8-byte gathers at
    the stem, im2col TMA rows where Cp allows, 16-byte gathers at decoder
    block 3's 32 channels), operands the wrapper accepts, no launch
    counted."""
    qmodel = quantized_model(arch, int8_decoder)
    names = {id(p): n for qp in (qmodel.qparams, qmodel.dec_qparams) for n, p in qp.items()}
    seen = []

    def conv(x, p, stride, padding, dilation=1, **kw):
        cp, (co, _, kh, _) = p.in_channels, p.wq.shape
        bn, load = ic.kernel_instance(cp, co, kh, stride, padding, dilation)
        assert cp % load == 0 and p.packed.shape[1] % ic.K_CHUNK == 0
        assert bn == (64 if co <= 64 else 128)
        want = (8 if names[id(p)] == "stem" else 128 if cp % 128 == 0 else
                64 if cp % 64 == 0 else 16)
        assert load == want, (names[id(p)], cp)
        if load in ic.TMA_ROWS:  # the kernel's im2col instances need K whole stages
            assert p.packed.shape[1] == kh * kh * cp
        assert 0 <= ic.instance_code(bn, load) <= 7
        seen.append(names[id(p)])
        return ic.int8_conv(x, p, stride, padding, dilation, **kw)

    ic.launches = 0
    x = torch.rand((1, TILE, TILE, 5), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        out = qmodel.tail_input(x, MARGIN, conv=conv)
    assert torch.isfinite(out).all()
    assert sorted(seen) == sorted(names.values())
    assert ic.launches == 0
    if int8_decoder == 4:  # decoder block 3's second conv takes 32 channels
        assert 16 in {ic.kernel_instance(p.in_channels, p.wq.shape[0], p.wq.shape[2])[1]
                      for p in qmodel.dec_qparams.values()}


def site(cp: int = 64, co: int = 64, offset: int = 0, gen_seed: int = 3):
    """x (2, cp, 9, 10) int8 channels_last starting ``offset`` bytes into an
    aligned buffer, and a 3x3 site's params."""
    g = torch.Generator().manual_seed(gen_seed)
    n = 2 * cp * 9 * 10
    buf = torch.randint(-127, 128, (n + 64,), generator=g, dtype=torch.int8)
    x = torch.as_strided(buf, (2, cp, 9, 10), (9 * 10 * cp, 1, 10 * cp, cp), offset)
    p = ic.Int8ConvParams(torch.randint(-127, 128, (co, cp, 3, 3), generator=g,
                                        dtype=torch.int8), 0.05, torch.full((co,), 1e-3),
                          torch.zeros(co))
    return x, p


def test_wrapper_accepts_aligned_operands():
    x, p = site()
    assert x.data_ptr() % 16 == 0
    out32, outq = ic.int8_conv(x, p, 1, 1, out_sx=0.1)
    assert out32.shape == (2, 64, 9, 10) and outq.dtype == torch.int8


@pytest.mark.parametrize("cp,offset,raises", [
    (64, 8, True),   # 16-byte gathers need a 16-byte base
    (64, 16, False),
    (128, 8, True),  # so does the im2col TMA map
    (8, 8, False),   # 8-byte gathers need 8
    (8, 4, True),
])
def test_wrapper_checks_x_alignment(cp, offset, raises):
    x, p = site(cp=cp, offset=offset)
    assert x.is_contiguous(memory_format=torch.channels_last)
    if raises:
        with pytest.raises(ValueError, match="aligned"):
            ic.int8_conv(x, p, 1, 1)
    else:
        ic.int8_conv(x, p, 1, 1)


def test_wrapper_rejects_nchw_x():
    x, p = site()
    with pytest.raises(ValueError, match="channels_last"):
        ic.int8_conv(x.contiguous(), p, 1, 1)


def test_wrapper_rejects_misaligned_residual():
    x, p = site()
    buf = torch.zeros(2 * 64 * 9 * 10 + 4)
    r = torch.as_strided(buf, (2, 64, 9, 10), (9 * 10 * 64, 1, 10 * 64, 64), 1)
    assert r.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ic.int8_conv(x, p, 1, 1, residual=r)
    ic.int8_conv(x, p, 1, 1, residual=r.clone(memory_format=torch.channels_last))


def test_wrapper_rejects_misaligned_weights():
    x, p = site()
    buf = torch.zeros(p.packed.numel() + 16, dtype=torch.int8)
    packed = buf[4:4 + p.packed.numel()].view(p.packed.shape)
    packed.copy_(p.packed)
    p.packed = packed
    with pytest.raises(ValueError, match="TMA"):
        ic.int8_conv(x, p, 1, 1)


def test_phases_tool_anchors():
    """Every guard of ``ops/int8_conv_phases.py`` still finds its anchor in
    the kernel source (the tool itself needs the card)."""
    src = ph.guarded_source()
    for name in ("SKIP_EPILOGUE", "SKIP_MMA", "SKIP_LOADS", "SKIP_GATHER", "SKIP_TMA",
                 "SKIP_FENCE", "PRODUCER_REGS", "DRAIN_REGS", "CONSUMER_REGS_TMA",
                 "ONE_TILE_A_BLOCK"):
        assert src.count(name) == 3, name  # its default and its one use
    assert src.count("COLUMN_TILES_OUTER") == 2 + 2 * 3  # the producers' and the epilogue's
    assert set(ph.VARIANTS) >= {"full", "no_epilogue", "no_mma", "no_gather_loads"}
