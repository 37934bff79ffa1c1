"""flairtpu_torch's MobileOne blocks and zone runs against flairtpu (CPU,
float32): one block, with its kernels' plain versions (``ops/branch_sum.py``,
``ops/se_gate.py``'s MobileOne squeeze and excite), against ``flairtpu``'s
MobileOneBlock and expressions; the sum squeeze's plain version against a
transcription of its kernel; the kernels' constants against their sources;
``init_encoder_weights``, ``use_metadata`` and the refusals; a
``flair-detect`` run of mobileone_s4-unet against ``flairtpu``'s, and the
port's ``flair`` predict and metrics of mobileone_s0-unet from a
``.msgpack``.

Weights are ``tests/test_torch_mobileone.py``'s (``mobileone_state_dict``:
each block's BatchNorm gammas scaled to keep its sum's scale). Tolerances:
a block within 2e-5 of the largest |value|, the kernels' plain versions
within float32 rounding (1e-6) of ``flairtpu``'s expressions; the zone as
``tests/test_torch_mobilenet.py``'s: classes equal but at near-ties (the
owning tile's top-2 logit gap below 1e-4), probabilities within 1.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import flairtpu.models.mobileone as fmo
from flairtpu.models import pretrained as fpre
from flairtpu.models.convert import torch_to_flax
from flairtpu_torch import cli
from flairtpu_torch import config as cfgmod
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models import mobileone as mo
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models.convert import write_native
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import fold_model
from flairtpu_torch.models.quantize import check_quantizable, quantize_model
from flairtpu_torch.ops import branch_sum as bs
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops import se_gate as sg
from tests.test_torch_mobileone import VARIANTS, assert_close, mobileone_state_dict
from tests.test_torch_zone_archs import N_CLASSES as ZONE_CLASSES
from tests.test_torch_zone_archs import (HEIGHT, MARGIN, WIDTH, assert_argmax_close, exact_ties,
                                         raster, read, run_port)

TILE = 64
PLAIN_TOL = 1e-6
CSRC = Path(__file__).resolve().parent.parent / "flairtpu_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- one block and the kernels' plain versions ---------------------------------

# (cin, cout, kernel, stride, dilation, depthwise, branches, se, skip): s0's
# depthwise block (4 branches, the scale branch, the skip), s4's pointwise
# squeeze-excite block with a skip, a dilated first depthwise block with
# squeeze-excite and no skip
BLOCKS = ((48, 48, 3, 1, 1, True, 4, False, True), (64, 64, 1, 1, 1, False, 1, True, True),
          (32, 32, 3, 1, 2, True, 1, True, False))


@pytest.mark.parametrize("spec", BLOCKS, ids=lambda s: f"{s[0]}x{s[2]}x{s[6]}{'se' * s[7]}")
def test_block_matches_flairtpus(spec):
    """One block (its convs, :func:`ops.branch_sum.block_epilogue_plain`)
    against ``flairtpu``'s MobileOneBlock on the same weights, on a float32
    input that bf16 cannot hold with a NaN at one pixel: within 2e-5 of the
    largest |value|, NaN where flairtpu's is NaN; the float32 copy is the
    output."""
    cin, cout, k, stride, dil, dw, n, se, skip = spec
    plan = dict(name="b", cin=cin, cout=cout, kernel=k, stride=stride, dilation=dil,
                depthwise=dw, branches=n, se=se, skip=skip)
    block = mo.MobileOneBlock(plan).eval()
    sd = mobileone_state_dict(block, np.random.default_rng(cin + n))
    block.load_state_dict(sd)
    tree = torch_to_flax({f"encoder.stage1.1.{k_}": v.numpy() for k_, v in sd.items()})
    variables = {c: tree[c]["encoder"]["stage1_1"] for c in ("params", "batch_stats")}
    x = np.random.default_rng(3).normal(0, 2, (2, 9, 9, cin)).astype(np.float32)
    x[0, 4, 4, 0] = np.nan
    want = np.asarray(fmo.MobileOneBlock(cout, k, stride, dilation=dil, depthwise=dw,
                                         n_branches=n, use_se=se, skip=skip).apply(
        variables, jnp.asarray(x), train=False))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        out, out32 = block(xt, xt if skip else None, keep_f32=True,
                           epilogue=bs.block_epilogue_plain)
    got = out.permute(0, 2, 3, 1).numpy()
    torch.testing.assert_close(out, out32, rtol=0, atol=0, equal_nan=True)
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(want).any()
    finite = ~np.isnan(want)
    assert_close(np.where(finite, got, 0), np.where(finite, want, 0))


def test_branch_sum_plain_equals_flairtpus_expression():
    """``0.0 + b_0 + ... + b_{n-1} [+ skip]`` then ReLU (flairtpu/models/
    mobileone.py:97-112) with each b a BatchNorm (scale, shift) in float32:
    five branches and a float32 skip bf16 cannot hold, within float32
    rounding; a NaN branch value passes the ReLU, a -0 first term becomes
    +0; the modes' outputs; the wrapper on the CPU counts nothing."""
    rng = np.random.default_rng(12)
    B, C, H, W = 2, 24, 5, 6
    ys = [rng.normal(0, 2, (B, H, W, C)).astype(np.float32) for _ in range(5)]
    skip = rng.normal(0, 2, (B, H, W, C)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (6, C)).astype(np.float32)
    shift = rng.normal(0, 1, (6, C)).astype(np.float32)
    ys[2][0, 1, 1, 3] = np.nan
    ys[0][1, 0, 0, 5], shift[0, 5] = 0.0, -0.0
    v = 0.0
    for j, y in enumerate([*ys, skip]):
        v = v + (jnp.asarray(y) * scale[j] + shift[j])
    want_sum = np.asarray(v)
    want = np.asarray(jax.nn.relu(v))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    args = ([nchw(y) for y in ys], torch.from_numpy(scale), torch.from_numpy(shift), nchw(skip))
    before = bs.launches
    out, out32 = bs.branch_sum(*args, out="relu_f32")
    assert bs.launches == before
    torch.testing.assert_close(out, out32, rtol=0, atol=0, equal_nan=True)
    got = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=PLAIN_TOL, atol=PLAIN_TOL)
    assert np.isnan(got[0, 1, 1, 3]) and np.isnan(got).sum() == 1
    _, s = bs.branch_sum(*args, out="sum")
    np.testing.assert_allclose(s.permute(0, 2, 3, 1).numpy(), want_sum, rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    assert bs.branch_sum(*args)[1] is None and bs.branch_sum(*args, out="sum")[0] is None
    one = bs.branch_sum_plain([nchw(ys[0])], torch.from_numpy(scale[:1]),
                              torch.from_numpy(shift[:1]), out="sum")[1]
    assert not torch.signbit(one[1, 5, 0, 0]) and one[1, 5, 0, 0] == 0


def test_branch_sum_refuses():
    """Six branches, a skip in another dtype, terms that do not match the
    constants, an unknown mode; on another device, no fallback."""
    y = torch.zeros((1, 8, 2, 2)).contiguous(memory_format=torch.channels_last)
    s = torch.ones((1, 8))
    with pytest.raises(ValueError, match="1 to 5 branches"):
        bs.branch_sum([y] * 6, torch.ones((6, 8)), torch.ones((6, 8)))
    with pytest.raises(ValueError, match="skip"):
        bs.branch_sum([y], torch.ones((2, 8)), torch.ones((2, 8)), skip=y.double())
    with pytest.raises(ValueError, match="scale"):
        bs.branch_sum([y, y], s, s)
    with pytest.raises(ValueError, match="out is one of"):
        bs.branch_sum([y], s, s, out="relu6")
    with pytest.raises(RuntimeError, match="unsupported device"):
        bs.branch_sum([torch.empty((1, 8, 2, 2), device="meta")], s, s)


def test_se_plain_versions_equal_flairtpus_expressions():
    """MobileOneSE (flairtpu/models/mobileone.py:60-74) and the block's
    ReLU: the float32 mean, the gate (reduce conv, ReLU, expand conv, the
    sigmoid in float32) and relu(v * gate), within float32 rounding; a NaN
    passes the excite; the wrappers' CPU path is the plain version and
    counts nothing."""
    rng = np.random.default_rng(13)
    B, C, H, W, R = 2, 32, 5, 7, 2
    v = rng.normal(0, 3, (B, H, W, C)).astype(np.float32)
    v[1, 2, 3, 4] = np.nan
    w_r, b_r = rng.normal(0, 0.3, (R, C, 1, 1)).astype(np.float32), rng.normal(0, 0.1, R)
    w_e, b_e = rng.normal(0, 0.3, (C, R, 1, 1)).astype(np.float32), rng.normal(0, 0.1, C)
    b_r, b_e = b_r.astype(np.float32), b_e.astype(np.float32)
    g = jnp.mean(jnp.asarray(v), axis=(1, 2))
    g = jax.nn.relu(g @ w_r[:, :, 0, 0].T + b_r) @ w_e[:, :, 0, 0].T + b_e
    gate_want = np.asarray(jax.nn.sigmoid(g))
    out_want = np.asarray(jax.nn.relu(jnp.asarray(v) * gate_want[:, None, None, :]))
    vt = torch.from_numpy(v).permute(0, 3, 1, 2)
    before = (sg.squeeze_sum_launches, sg.excite_relu_launches)
    mean = sg.se_squeeze_sum(vt)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jnp.mean(jnp.asarray(v), axis=(1, 2))),
                               rtol=PLAIN_TOL, atol=PLAIN_TOL)
    gate = sg.gate_from(mean, *map(torch.from_numpy, (w_r, b_r, w_e, b_e)), torch.float32,
                        act="relu")
    np.testing.assert_allclose(gate[0].numpy(), gate_want[0], rtol=PLAIN_TOL, atol=PLAIN_TOL)
    assert torch.isnan(gate[1]).all()  # the NaN's sample: its mean, then every gate
    out, out32 = sg.se_excite_relu(vt, gate, torch.float32, keep_f32=True)
    torch.testing.assert_close(out, out32, rtol=0, atol=0, equal_nan=True)
    assert sg.se_excite_relu(vt, gate, torch.float32)[1] is None
    got = out.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got[0], out_want[0], rtol=PLAIN_TOL, atol=PLAIN_TOL)
    assert np.isnan(got[1]).all() and np.isnan(out_want[1]).all()
    assert (sg.squeeze_sum_launches, sg.excite_relu_launches) == before
    with pytest.raises(ValueError, match="act is 'silu' or 'relu'"):
        sg.gate_from(mean, *map(torch.from_numpy, (w_r, b_r, w_e, b_e)), torch.float32,
                     act="relu6")
    with pytest.raises(ValueError, match="float32"):
        sg.se_squeeze_sum(vt.to(torch.bfloat16))


def squeeze_transcription(v: torch.Tensor, plan: sg.SqueezePlan) -> np.ndarray:
    """csrc/se_gate.cu's squeeze (kSumMode) a thread at a time in numpy:
    each block's run of each column, each thread's row of pixels added to 0,
    the rows added in order, a column held by one block divided at once,
    else its partials added in block order by its last block."""
    B, C, H, W = v.shape
    hw, gt = H * W, plan.group_tile
    rows, width, units = sg.THREADS // gt, gt * 8, B * plan.tiles * hw
    a = v.permute(0, 2, 3, 1).reshape(B, hw, C).numpy()
    mean = np.zeros((B, C), np.float32)
    partial = {}

    def block_of(u):
        return ((u + 1) * plan.blocks - 1) // units

    for i in range(plan.blocks):
        u, u1 = units * i // plan.blocks, units * (i + 1) // plan.blocks
        while u < u1:
            col = u // hw
            end = min(u1, (col + 1) * hw)
            b, tile = divmod(col, plan.tiles)
            sl = slice(tile * width, (tile + 1) * width)
            total = np.zeros(width, np.float32)
            for r in range(rows):
                acc = np.zeros(width, np.float32)
                for p in range(u - col * hw + r, end - col * hw, rows):
                    acc = acc + a[b, p, sl]
                total = total + acc
            first = block_of(col * hw)
            n = block_of((col + 1) * hw - 1) - first + 1
            if n == 1:
                mean[b, sl] = total / np.float32(hw)
            else:
                partial[i, col] = total
                if i == first + n - 1:
                    t = np.zeros(width, np.float32)
                    for k in range(first, first + n):
                        t = t + partial[k, col]
                    mean[b, sl] = t / np.float32(hw)
            u = end
    return mean


@pytest.mark.parametrize("shape,co_resident", [
    ((2, 48, 9, 7), 5), ((3, 896, 4, 4), 7), ((2, 2048, 3, 3), 11), ((4, 224, 6, 6), 9),
    ((1, 8, 1, 1), 3)])
def test_squeeze_sum_plain_follows_the_kernel(shape, co_resident):
    """Given the kernel's plan (columns split between blocks, several tiles
    a map, one block, one pixel), the sum squeeze's plain version has the
    bits of a transcription of the kernel's loops, and is within float32
    rounding of torch.mean."""
    v = torch.from_numpy(np.random.default_rng(sum(shape)).normal(0, 50, shape).astype(
        np.float32)).contiguous(memory_format=torch.channels_last)
    plan = sg.squeeze_plan(shape[0], shape[2] * shape[3], shape[1], co_resident)
    got = sg.se_squeeze_sum_plain(v, plan).numpy()
    assert np.array_equal(got.view(np.int32), squeeze_transcription(v, plan).view(np.int32))
    np.testing.assert_allclose(got, v.mean((2, 3)).numpy(), rtol=1e-5, atol=1e-4)


def test_kernel_constants_match_their_sources():
    """ops/branch_sum.py's branch limit, activation codes and output bits
    against csrc/branch_sum.cu; ops/se_gate.py's squeeze instances, the sum
    squeeze's pixels in flight and the ReLU excite's output bits against
    csrc/se_gate.cu."""
    src = (CSRC / "branch_sum.cu").read_text()
    assert int(re.search(r"constexpr int kMaxBranches = (\d+);", src).group(1)) == \
        bs.MAX_BRANCHES == 5
    acts = dict(re.findall(r"k(Identity|Relu) = (\d+)", src))
    assert {None: int(acts["Identity"]), "relu": int(acts["Relu"])} == bs.ACT_CODES
    outs = dict(re.findall(r"kOut(Bf16|F32|Both) = (\d+)", src))
    assert (int(outs["Bf16"]), int(outs["F32"]), int(outs["Both"])) == \
        (bs.OUT_BF16, bs.OUT_F32, bs.OUT_BF16 | bs.OUT_F32)
    assert {m: (a, o) for m, (a, o) in bs.MODES.items()} == {
        "relu": ("relu", bs.OUT_BF16), "relu_f32": ("relu", bs.OUT_BF16 | bs.OUT_F32),
        "sum": (None, bs.OUT_F32)}
    se = (CSRC / "se_gate.cu").read_text()
    modes = re.search(r"enum SqueezeMode \{([^}]*)\}", se).group(1)
    assert [(m.lower(), int(c)) for m, c in re.findall(r"k(\w+)Mode = (\d+)", modes)] == \
        [(m, i) for i, m in enumerate(sg.SQUEEZE_MODES)]
    assert int(re.search(r"constexpr int kSumUnroll = (\d+);", se).group(1)) == sg.SUM_UNROLL
    outs = dict(re.findall(r"kOut(Bf16|F32) = (\d+)", re.search(
        r"enum ExciteOutputs \{([^}]*)\}", se).group(1)))
    assert {"bf16": int(outs["Bf16"]), "f32": int(outs["F32"])} == sg.EXCITE_OUTPUTS
    assert (bs.OUT_BF16, bs.OUT_F32) == (sg.EXCITE_OUTPUTS["bf16"], sg.EXCITE_OUTPUTS["f32"])


# -- init_encoder_weights, metadata, refusals ------------------------------------


def test_init_encoder_weights_patches_every_stage0_conv(tmp_path):
    """An Apple-keyed MobileOne classifier (the encoder's 3-channel keys,
    ``linear.*``) at 5 channels: the port's conversion equals flairtpu's
    key for key, both stage0 convs (the 3x3 branch and the 1x1 scale
    branch) carry smp's channel rule, and it loads into the model."""
    rng = np.random.default_rng(21)
    enc3 = mo.MobileOneEncoder("mobileone_s1", 3)
    sd = {k: rng.normal(0, 0.1, v.shape).astype(np.float32)
          for k, v in enc3.state_dict().items() if not k.endswith("num_batches_tracked")}
    sd["linear.weight"] = rng.normal(0, 0.1, (1000, 1280)).astype(np.float32)
    sd["linear.bias"] = np.zeros(1000, np.float32)
    got = ppre.classifier_to_encoder_state_dict(sd, "mobileone_s1", 5)
    want = fpre.classifier_to_encoder_state_dict(sd, "mobileone_s1", 5)
    assert set(got) == set(want) and not any(k.startswith("encoder.linear") for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for key in ("stage0.rbr_conv.0.conv.weight", "stage0.rbr_scale.conv.weight"):
        w = sd[key]
        rule = np.stack([w[:, i % 3] for i in range(5)], axis=1) * (3 / 5)
        np.testing.assert_allclose(got[f"encoder.{key}"], rule, rtol=1e-6)
    pth = tmp_path / "apple.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    model = FlairSegmentationModel("mobileone_s1", 3, 5)
    assert ppre.stem_in_channels(model.encoder) == 5
    ppre.init_encoder_from_classifier(pth, model)
    np.testing.assert_array_equal(model.encoder.stage0.rbr_scale.conv.weight.detach().numpy(),
                                  got["encoder.stage0.rbr_scale.conv.weight"])


def test_metadata_fuses_into_the_deepest_map():
    """use_metadata: the MLP's embedding of ``mtd`` is added to the 16²
    deepest map of a 512² tile (1280 channels in s1), as with the other
    encoders."""
    model = FlairSegmentationModel("mobileone_s1", 3, 5, use_metadata=True).eval()
    gen = torch.Generator().manual_seed(4)
    x, mtd = torch.rand((1, 512, 512, 5), generator=gen), torch.rand((1, 45), generator=gen)
    with torch.inference_mode():
        fused = model.features(x, mtd=mtd)
        emb = model.enc(mtd)
        model.use_metadata = False
        plain = model.features(x)
    assert tuple(fused[-1].shape) == (1, 1280, 16, 16)
    torch.testing.assert_close(fused[-1] - plain[-1],
                               emb[:, None, :, None].expand_as(plain[-1]), rtol=0, atol=1e-5)


def test_refusals(tmp_path):
    """Every arch takes every variant; bn_fold and int8 raise flairtpu's
    ValueError; flair with train raises the not-ported message when its
    config is read (predict alone validates), with remat the remat one; a
    train-mode forward raises it too."""
    model = FlairSegmentationModel("mobileone_s0", 3, 5)
    with pytest.raises(ValueError, match="bn_fold: supports the ResNet"):
        fold_model(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        check_quantizable(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        quantize_model({}, model, [])
    for variant in VARIANTS:
        for arch in cfgmod.SMP_ARCHS:
            assert cfgmod.check_smp(f"{variant}_{arch}") == (variant, arch)

    def train_config(train: bool, **over) -> dict:
        return {"paths": {"out_folder": str(tmp_path)}, "tasks": {"train": train,
                                                                  "predict": True},
                "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                    "SegmentationModelsPytorch": {"encoder_decoder":
                                                                  "mobileone_s4_fpn"}},
                "channels": [1, 2, 3, 4, 5], "classes": {1: [1, "a"], 2: [1, "b"]},
                "accelerator": "cpu", **over}

    with pytest.raises(NotImplementedError, match="slice 6: MobileOne training"):
        cfgmod.validate_train_config(train_config(True))
    assert not cfgmod.validate_train_config(train_config(False))["tasks"]["train"]
    with pytest.raises(NotImplementedError, match="remat"):
        cfgmod.validate_train_config(train_config(True, remat=True))
    with pytest.raises(NotImplementedError, match="slice 6: MobileOne training"):
        model(torch.zeros((1, 64, 64, 5)), epilogue=TrainSites())


# -- flair-detect and flair, use_gpu: false / accelerator: cpu -------------------


@pytest.fixture(scope="module")
def zone(tmp_path_factory):
    """``tests/test_torch_zone_archs.py``'s zone (100 x 90 pixels, 64-pixel
    tiles, a 16-pixel margin, 4 classes) and a mobileone_s4-unet ``.pth``;
    a config maker."""
    tmp = tmp_path_factory.mktemp("torch_zone_mobileone")
    img = np.random.default_rng(37).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
    path = tmp / "zone.tif"
    write_array(path, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)
    model = FlairSegmentationModel("mobileone_s4", ZONE_CLASSES, 5).eval()
    model.load_state_dict(mobileone_state_dict(model, np.random.default_rng(98)))
    weights = tmp / "mobileone_s4_unet.pth"
    torch.save(model.state_dict(), weights)

    def make_config(out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone", "input_img_path": str(path),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": TILE, "margin": MARGIN,
            "output_type": "argmax", "n_classes": ZONE_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder":
                                                              "mobileone_s4_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    return dict(tmp=tmp, img=img, model=model, make_config=make_config)


def test_flair_detect_matches_flairtpu(zone):
    """The port's argmax raster against ``flairtpu``'s ``run_pipeline`` (its
    streaming route, one compile; its engine given the ``.pth``'s variables
    through ``torch_to_flax``, as ``prepare_model`` would load them, without
    its initializing compile) on the same weights: classes equal but at
    near-ties, probabilities within 1."""
    from flairtpu import config as flax_cfg
    from flairtpu.models.factory import create_model
    from flairtpu.zone.engine import ZoneEngine, run_pipeline

    cfg = flax_cfg.validate_detect_config(zone["make_config"]("ref_argmax"))
    variables = torch_to_flax({k: v.numpy() for k, v in zone["model"].state_dict().items()})
    engine = ZoneEngine(cfg, create_model(cfg, dtype=jnp.float32), variables["params"],
                        variables["batch_stats"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        run_pipeline(cfg, engine)
    want = read(raster(cfg))
    have = read(run_port(zone["tmp"], zone["make_config"]("port_argmax"))[0])
    assert_argmax_close(have, want, exact_ties(zone["model"], zone["img"], TILE))


def test_knobs_raise_before_the_zone_is_read(zone, tmp_path):
    """bn_fold and int8 raise flairtpu's ValueError on the loaded model,
    before a tile is read: the zone here is not a TIFF."""
    bogus = tmp_path / "zone.tif"
    bogus.write_bytes(b"not a tiff")
    for knobs, match in (({"bn_fold": True}, "bn_fold: supports the ResNet"),
                         ({"quantize": "int8"}, "int8 supports the ResNet")):
        cfg = zone["make_config"](f"knob_{next(iter(knobs))}", input_img_path=str(bogus),
                                  **knobs)
        with pytest.raises(ValueError, match=match):
            run_port(tmp_path, cfg)


def test_flair_predict_and_metrics_from_msgpack(tmp_path):
    """The port's ``flair`` predict and metrics of mobileone_s0-unet from a
    native ``.msgpack``: a PRED raster a test patch, metrics.json, and each
    PRED's classes the argmax of the model's own logits but at near-ties."""
    from flairtpu_torch.data.manifest import gather_paths
    from flairtpu_torch.data.patches import PatchDataset, PatchLoader
    from flairtpu_torch.train import checkpoints as ckpt_lib
    from flairtpu_torch.train.loop import SegmentationTrainer
    from tests.test_torch_train import N_CLASSES, train_config, write_split

    test_csv = write_split(tmp_path / "test", 4, 3)
    model = FlairSegmentationModel("mobileone_s0", N_CLASSES, 5)
    weights = tmp_path / "mobileone_s0_unet.msgpack"
    write_native(weights, mobileone_state_dict(model, np.random.default_rng(8)))
    cfg = train_config(tmp_path, model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": "mobileone_s0_unet"}})
    cfg["paths"].update(test_csv=str(test_csv), ckpt_model_path=str(weights))
    cfg["tasks"]["train"] = False
    conf = tmp_path / "flair.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    result = cli.flair_main([f"--conf={conf}"])
    assert result["predict"]["patches"] == 4 and "metrics" in result
    out = tmp_path / "out" / "toy"
    assert (out / "metrics" / "metrics.json").exists()
    tr = SegmentationTrainer(cfgmod.validate_train_config(cfg))
    ckpt_lib.init_weights_with_surgery(weights, tr.model, verbose=False)
    ds = PatchDataset(gather_paths(cfg, "test"), cfg["channels"], with_masks=False)
    with torch.inference_mode():
        for batch in PatchLoader(ds, 4):
            x, _ = tr.prepare(batch)
            top2, cls = tr.model(x).topk(2, dim=-1)
            for src, gap, want in zip(batch["id"], (top2[..., 0] - top2[..., 1]).numpy(),
                                      cls[..., 0].numpy()):
                with TiffReader(out / "predictions_toy" / f"PRED_{Path(src).name}") as r:
                    got = r.read(1)
                assert not ((got != want) & (gap >= 1e-4)).any(), src
