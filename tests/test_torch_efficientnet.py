"""flairtpu_torch's EfficientNet encoders against flairtpu (CPU, float32):
the plan, logits under three archs, the U-Net's interior decode, the smp
manifests, the weights both ways, the squeeze-excite and SiLU plain
versions, the squeeze kernel's reduction order, and the refusals.

One seeded smp-keyed state dict a case feeds both packages: the port loads
it strictly, ``flairtpu`` takes it through its own ``torch_to_flax`` (never
``model.init``). Tolerances: logits within 2e-5 of the largest |logit|
(``tests/test_torch_manet_unetpp.py``'s bound: the frameworks sum the
convolutions and the means in other orders); the plain versions within
float32 rounding of ``flairtpu``'s expressions (``flairtpu/models/
efficientnet.py:182, 191-199``) on the same numpy inputs.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.efficientnet import efficientnet_plan as flax_plan
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.train import checkpoints as fck
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models import efficientnet as en
from flairtpu_torch.models.convert import from_flax, load_weights, to_flax, write_native
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import fold_model
from flairtpu_torch.models.quantize import check_quantizable, quantize_model
from flairtpu_torch.ops import se_gate as sg
from flairtpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
from tests.test_torch_models import random_state_dict
from tests.test_torch_msgpack import assert_flax_trees_equal

N_CLASSES, TILE = 5, 64
REL_TOL = 2e-5
PLAIN_TOL = 1e-6
MANIFESTS = Path(__file__).parent / "smp_manifests"
# (encoder, arch): the three arch shapes (full stride, output stride 16,
# depth 3) and b3's symmetric pads at its odd 75² stage
CASES = (("efficientnet-b0", "unet"), ("efficientnet-b0", "deeplabv3plus"),
         ("efficientnet-b0", "pspnet"), ("efficientnet-b3", "unet"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs() -> np.ndarray:
    return np.random.default_rng(7).uniform(0, 1, (2, TILE, TILE, 5)).astype(np.float32)


def flax_model(encoder: str, arch: str):
    return flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_{arch}"}},
        "n_classes": N_CLASSES, "channels": [1, 2, 3, 4, 5]})


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}_{c[1]}")
def case(request, tmp_path_factory):
    """(encoder, arch, port model loaded from a .pth, state dict, flairtpu's
    logits of ``inputs()``)."""
    encoder, arch = request.param
    port = FlairSegmentationModel(encoder, N_CLASSES, 5, arch=arch).eval()
    sd = random_state_dict(port, np.random.default_rng(CASES.index(request.param) + 90))
    path = tmp_path_factory.mktemp("effnet") / f"{encoder}_{arch}.pth"
    torch.save(sd, path)
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel = flax_model(encoder, arch)
    x = jnp.asarray(inputs())
    want = np.asarray(jax.jit(lambda v: fmodel.apply(v, x, train=False))(variables))
    return encoder, arch, port, sd, want


def assert_close(got: np.ndarray, want: np.ndarray, rel: float = REL_TOL) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(en.EFFICIENTNET_SPECS))
@pytest.mark.parametrize("output_stride", (32, 16, 8))
def test_plan_equals_flairtpu(name, output_stride):
    """Every block's kernel, stride, dilation, widths, squeeze width, skip
    and pads, the stem, the taps and the feature widths."""
    assert en.efficientnet_plan(name, output_stride) == flax_plan(name, output_stride)


def test_pads_are_the_default_image_walk():
    """Asymmetric (0, 1) / (1, 2) pads at even sizes, symmetric at b3's odd
    75² stage; a dilated first block keeps skip False."""
    b0 = en.efficientnet_plan("efficientnet-b0")
    assert b0["stem_pad"] == (0, 1)
    assert {b["pad"][0] for b in b0["blocks"] if b["stride"] == 2} == {(0, 1), (1, 2)}
    b3 = en.efficientnet_plan("efficientnet-b3")
    assert (2, 2) in {b["pad"][0] for b in b3["blocks"] if b["stride"] == 2}
    os16 = en.efficientnet_plan("efficientnet-b0", 16)["blocks"]
    first = next(b for b in os16 if b["dilation"] == 2)
    assert first["stride"] == 1 and not first["skip"] and first["pad"][0] == (4, 4)


def test_logits_match_flairtpu(case):
    _, _, port, _, want = case
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs())).numpy()
    assert_close(got, want)


def test_interior_decode_is_the_crop(case):
    """``inner_margin``: the U-Net's interior plan gives the crop bit for
    bit; the strided-head archs' windowed upsample within 1e-6 of the
    largest |logit|."""
    _, arch, port, _, _ = case
    x = torch.from_numpy(inputs())
    with torch.inference_mode():
        got, full = port(x, inner_margin=16), port(x)[:, 16:TILE - 16, 16:TILE - 16]
    if arch == "unet":
        assert torch.equal(got, full)
    else:
        assert_close(got.numpy(), full.numpy(), 1e-6)


def test_asymmetric_pads_are_padded_copies():
    """A (p, p + 1) pad at stride 2 (b0's k3 and k5 sites) equals the conv
    of the zero-padded map; the view that drops the first row and column
    and pads p + 1 on both sides would not: its first output row and
    column read zeros where the pad reads row and column 0."""
    gen = torch.Generator().manual_seed(3)
    for k, pad in ((3, (0, 1)), (5, (1, 2))):
        m = torch.nn.Conv2d(8, 8, k, 2, en.own_padding(pad), groups=8, bias=False)
        x = torch.randn((2, 8, 16, 16), generator=gen).contiguous(
            memory_format=torch.channels_last)
        want = F.conv2d(F.pad(x, pad + pad), m.weight, None, 2, 0, 1, 8)
        got = en.same_conv(x, m, pad, torch.float32)
        assert got.shape == want.shape == (2, 8, 8, 8)
        assert torch.equal(got, want)
        view = F.conv2d(x[:, :, 1:, 1:], m.weight, None, 2, pad[1], 1, 8)
        assert torch.equal(view[:, :, 1:, 1:], want[:, :, 1:, 1:])
        assert not torch.equal(view[:, :, 0], want[:, :, 0])


@pytest.mark.parametrize("encoder", ("efficientnet-b0", "efficientnet-b4"))
def test_state_dict_matches_smp_manifest(encoder):
    """The production shape (5 channels, 13 classes): the keys and shapes of
    the committed smp manifest, no more, no fewer."""
    model = FlairSegmentationModel(encoder, 13, 5)
    got = {k: list(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == json.loads((MANIFESTS / f"{encoder}_unet.json").read_text())
    assert all(m.eps == 1e-3 for m in model.encoder.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_weights_both_ways(case, tmp_path):
    """``to_flax`` equals flairtpu's converter leaf by leaf, ``from_flax``
    brings it back bit for bit, and a ``.msgpack`` the port writes is read
    by flairtpu as that tree and loads back into the port strictly."""
    encoder, arch, _, sd, _ = case
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    got = to_flax(sd, arch)
    assert_flax_trees_equal(got, want)
    back = from_flax(got["params"], got["batch_stats"], arch)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    path = tmp_path / "w.msgpack"
    write_native(path, sd, arch)
    assert_flax_trees_equal(fck.load_weights_msgpack(path), want)
    model = FlairSegmentationModel(encoder, N_CLASSES, 5, arch=arch)
    load_weights(model, path)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def bn_site(rng, shape):
    """A bf16-representable map (B, H, W, C), its BatchNorm (scale, shift)
    and a (B, C) gate, in float32."""
    B, H, W, C = shape
    y = rng.standard_normal(shape).astype(np.float32) * 3
    return (y, rng.uniform(0.5, 1.5, C).astype(np.float32),
            rng.normal(0, 0.5, C).astype(np.float32),
            1 / (1 + np.exp(-rng.standard_normal((B, C))).astype(np.float32)))


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def test_plain_versions_equal_flairtpu_expressions():
    """The SiLU epilogue (:182), the squeeze (:191-193) and the gate multiply
    (:199) on the same numpy inputs as flairtpu's jnp expressions."""
    y, scale, shift, gate = bn_site(np.random.default_rng(5), (2, 9, 7, 24))
    silu = jax.nn.silu(jnp.asarray(y) * scale + shift)
    want_mean = np.asarray(jnp.mean(silu, axis=(1, 2)))
    want_gated = np.asarray(jnp.asarray(gate)[:, None, None, :] * silu)
    s, t = torch.from_numpy(scale), torch.from_numpy(shift)
    x = nchw(y).contiguous(memory_format=torch.channels_last)
    out, out32 = conv_epilogue(x, s, t, act="silu", keep_f32=True)
    np.testing.assert_allclose(out32.permute(0, 2, 3, 1).numpy(), np.asarray(silu),
                               rtol=PLAIN_TOL, atol=PLAIN_TOL)
    assert torch.equal(out, out32)
    np.testing.assert_allclose(sg.se_squeeze(x, s, t).numpy(), want_mean, rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    gated = sg.se_excite(x, s, t, torch.from_numpy(gate))
    assert gated.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(gated.permute(0, 2, 3, 1).numpy(), want_gated, rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)


def test_silu_epilogue_keeps_relu_results():
    """ReLU sites are unchanged; an activation that is neither raises."""
    y, scale, shift, _ = bn_site(np.random.default_rng(6), (1, 4, 4, 8))
    x = nchw(y).contiguous(memory_format=torch.channels_last)
    s, t = torch.from_numpy(scale), torch.from_numpy(shift)
    want = torch.relu(x * s[:, None, None] + t[:, None, None])
    assert torch.equal(conv_epilogue(x, s, t)[0], want)
    assert torch.equal(conv_epilogue_plain(x, s, t)[0], want)
    with pytest.raises(ValueError, match="ReLU or SiLU"):
        conv_epilogue(x, s, t, act="relu+silu")


def test_wrappers_take_cpu_or_raise():
    """Neither CPU nor CUDA: no fallback, an error; a malformed operand
    raises on the CPU too."""
    y = torch.empty((2, 16, 4, 4), device="meta").contiguous(memory_format=torch.channels_last)
    s = torch.empty(16, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        sg.se_squeeze(y, s, s)
    with pytest.raises(RuntimeError, match="unsupported device"):
        sg.se_excite(y, s, s, torch.empty((2, 16), device="meta"))
    x = torch.zeros((2, 16, 4, 4)).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="gate must be"):
        sg.se_excite(x, torch.ones(16), torch.zeros(16), torch.ones((2, 8)))
    with pytest.raises(ValueError, match="scale must be"):
        sg.se_squeeze(x, torch.ones(8), torch.zeros(16))


def squeeze_transcription(y: np.ndarray, scale, shift, plan: sg.SqueezePlan) -> np.ndarray:
    """csrc/se_gate.cu's squeeze in numpy float32, block by block in its
    order: each block's share of the batch x tiles x HW units, cut at the
    columns it meets; in each, each row's pixels, the block's rows, its
    partial at row block + column; each column's partials in block order
    (its SiLU: the FMAs in float64 rounded once, 2^x and the reciprocal in
    float32). Checks that each (pixel, channel) is counted once and that no
    two partials share a row of the plan's scratch."""
    B, H, W, C = y.shape
    hw, gt, width = H * W, plan.group_tile, plan.group_tile * 8
    rows = sg.THREADS // gt
    f32, f64 = np.float32, np.float64
    v = (y.reshape(B, hw, C).astype(f64) * scale + shift).astype(f32)
    silu_r = (f32(1) / (f32(1) + np.exp2(v * f32(-1.4426950408889634)))).astype(f32)
    seen = np.zeros((B, hw, C), int)
    units = B * plan.tiles * hw
    partial = {}
    for i in range(plan.blocks):
        u, u1 = units * i // plan.blocks, units * (i + 1) // plan.blocks
        while u < u1:
            col = u // hw
            end = min(u1, (col + 1) * hw)
            b, tile = divmod(col, plan.tiles)
            cols = slice(tile * width, (tile + 1) * width)
            acc = np.zeros((rows, width), f32)
            for p in range(u - col * hw, end - col * hw, rows):
                n = min(rows, end - col * hw - p)
                term = v[b, p:p + n, cols].astype(f64) * silu_r[b, p:p + n, cols]
                acc[:n] = (term + acc[:n]).astype(f32)
                seen[b, p:p + n, cols] += 1
            total = np.zeros(width, f32)
            for row in acc:
                total += row
            assert i + col not in partial
            partial[i + col] = (col, total)
            u = end
    assert (seen == 1).all()
    assert max(partial) < plan.partials // width
    mean = np.zeros((B, C), f32)
    for col in range(B * plan.tiles):
        b, tile = divmod(col, plan.tiles)
        total = np.zeros(width, f32)
        for row in sorted(k for k, (c, _) in partial.items() if c == col):
            total += partial[row][1]
        mean[b, tile * width:(tile + 1) * width] = total / f32(hw)
    return mean


@pytest.mark.parametrize("shape,co_resident", [((2, 5, 7, 48), 4), ((2, 20, 20, 48), 3),
                                               ((1, 12, 12, 8), 132), ((2, 3, 3, 264), 2),
                                               ((3, 16, 16, 1632), 20), ((2, 4, 4, 3840), 7)])
def test_squeeze_reduction_order_covers_the_map(shape, co_resident):
    """The kernel's blocks, columns and rows (a numpy transcription) sum
    every pixel of every channel once, blocks that share a column and
    blocks that span several included, and give the plain mean within
    1e-6."""
    y, scale, shift, _ = bn_site(np.random.default_rng(8), shape)
    B, H, W, C = shape
    plan = sg.squeeze_plan(B, H * W, C, co_resident)
    got = squeeze_transcription(y, scale, shift, plan)
    want = sg.se_squeeze_plain(nchw(y), torch.from_numpy(scale), torch.from_numpy(shift))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


def test_newton_reciprocal_within_float32_rounding():
    """csrc/se_gate.cu:rcp_newton in numpy float32 (the bit-trick seed, three
    Newton steps as FMAs, each rounded once): within 2^-23 of 1 / x over
    the [1, 2^126] that the clamped 1 + 2^a spans, the seed within 12%."""
    f32, f64 = np.float32, np.float64
    x = np.concatenate([np.geomspace(1, 2.0 ** 126, 20001), 1 + np.random.default_rng(
        3).uniform(0, 1, 10000), [1, 2, 2.0 ** 126]]).astype(f32)

    def fma(a, b, c):
        return (a.astype(f64) * b.astype(f64) + c).astype(f32)

    r = (np.int32(0x7ef311c3) - x.view(np.int32)).view(f32)
    assert np.abs(r.astype(f64) * x - 1).max() < 0.12
    for _ in range(3):
        r = fma(r, fma(-x, r, f32(1)), r)
    assert np.abs(r.astype(f64) * x - 1).max() < 2.0 ** -23


def site_shapes(name: str, output_stride: int = 32, size: int = 512) -> list[tuple]:
    """(hw, channels) of every squeeze-excite site of an encoder on size²
    tiles: the depthwise output of each block."""
    plan = en.efficientnet_plan(name, output_stride)
    side, out = size // 2, []
    for b in plan["blocks"]:
        side //= b["stride"]
        out.append((side * side, b["cin"] * b["expand"]))
    return out


@pytest.mark.parametrize("per_sm", [4, 5, 8])
@pytest.mark.parametrize("name", sorted(en.EFFICIENTNET_SPECS))
def test_squeeze_plan_at_every_site(name, per_sm):
    """At batch 128 on an H100's 132 SMs holding ``per_sm`` blocks each:
    tiles that divide C / 8 (3840 channels at b7), the widest that keep
    BUSY of a block's threads busy (a whole pixel where one does); a grid
    of exactly the co-resident blocks wherever the map gives every thread
    MIN_PIXELS pixels, never more, and the scratch the kernel indexes."""
    co = 132 * per_sm
    for hw, c in site_shapes(name):
        plan = sg.squeeze_plan(128, hw, c, co)
        c8 = c // 8
        assert c % 8 == 0 and c8 % plan.group_tile == 0
        assert plan.group_tile <= sg.MAX_GROUP_TILE and plan.tiles * plan.group_tile == c8
        rows = sg.THREADS // plan.group_tile
        busy = [d for d in range(1, sg.MAX_GROUP_TILE + 1)
                if c8 % d == 0 and sg.THREADS // d * d >= sg.BUSY * sg.THREADS]
        assert rows * plan.group_tile >= sg.BUSY * sg.THREADS or not busy
        assert plan.group_tile == max(busy, default=plan.group_tile)
        if c8 <= sg.MAX_GROUP_TILE and sg.THREADS // c8 * c8 >= sg.BUSY * sg.THREADS:
            assert plan.tiles == 1
        units = 128 * plan.tiles * hw
        assert 1 <= plan.blocks <= co and plan.blocks <= units
        if units >= co * rows * sg.MIN_PIXELS:
            assert plan.blocks == co
        if plan.blocks > 1:
            assert units // plan.blocks >= rows * sg.MIN_PIXELS
        assert plan.partials == (plan.blocks + 128 * plan.tiles - 1) * plan.group_tile * 8
    assert max(c for _, c in site_shapes("efficientnet-b7")) == 3840


def test_phases_tool_anchors_are_in_the_source():
    """``ops/se_gate_phases.py``'s variants edit text that is in
    ``csrc/se_gate.cu``, and its sites are the encoder's."""
    from flairtpu_torch.ops import se_gate_phases as ph

    src = (ph._build.CSRC / "se_gate.cu").read_text()
    for name, edits in ph.EDITS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (name, old)
    got = [(c, h * w) for _, c, h, w in ph.sites("efficientnet-b4", 128)]
    assert got == [(c, hw) for hw, c in site_shapes("efficientnet-b4")]


def test_metadata_fuses_into_the_deepest_map():
    """use_metadata: the MLP's embedding of ``mtd`` is added to the 16²
    deepest map of a 512² tile, row by row, as with the resnet encoders."""
    model = FlairSegmentationModel("efficientnet-b0", 3, 5, use_metadata=True).eval()
    gen = torch.Generator().manual_seed(4)
    x, mtd = torch.rand((1, 512, 512, 5), generator=gen), torch.rand((1, 45), generator=gen)
    with torch.inference_mode():
        fused = model.features(x, mtd=mtd)
        emb = model.enc(mtd)
        model.use_metadata = False
        plain = model.features(x)
    assert tuple(fused[-1].shape) == (1, 320, 16, 16)
    torch.testing.assert_close(fused[-1] - plain[-1],
                               emb[:, None, :, None].expand_as(plain[-1]), rtol=0, atol=1e-6)


def test_prepare_inference_casts_the_gate_biases():
    model = FlairSegmentationModel("efficientnet-b0", 3, 5, dtype=torch.bfloat16)
    model.prepare_inference()
    for block in model.encoder._blocks:
        for m in (block._se_reduce, block._se_expand):
            assert m.weight.dtype == m.bias.dtype == torch.bfloat16
    assert model.segmentation_head[0].bias.dtype == torch.float32


def test_refusals(tmp_path):
    """bn_fold and int8 raise flairtpu's ValueError (the detect engine asks
    before it reads a calibration tile); flair with train validates, and
    with remat raises NotImplementedError when its config is read, as for
    every family; predict validates; every arch takes the encoder."""
    model = FlairSegmentationModel("efficientnet-b0", 3, 5)
    with pytest.raises(ValueError, match="bn_fold: supports the ResNet"):
        fold_model(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        check_quantizable(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        quantize_model({}, model, [])
    for arch in cfgmod.SMP_ARCHS:
        assert cfgmod.check_smp(f"efficientnet-b7_{arch}") == ("efficientnet-b7", arch)

    def train_config(train: bool, **over) -> dict:
        return {"paths": {"out_folder": str(tmp_path)}, "tasks": {"train": train,
                                                                  "predict": True},
                "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                    "SegmentationModelsPytorch": {"encoder_decoder":
                                                                  "efficientnet-b4_unet"}},
                "channels": [1, 2, 3, 4, 5], "classes": {1: [1, "a"], 2: [1, "b"]},
                "accelerator": "cpu", **over}

    assert cfgmod.validate_train_config(train_config(True))["tasks"]["train"]
    with pytest.raises(NotImplementedError, match="remat"):
        cfgmod.validate_train_config(train_config(True, remat=True))
    assert cfgmod.validate_train_config(train_config(False))["tasks"]["predict"]
