"""flairtpu_torch's MobileNetV2 encoder against flairtpu (CPU, float32):
the plan, the encoder's features and the logits under four archs (output
stride 32, 16 and 8, and depth 3), the U-Net's interior decode, the smp
manifest and the torchvision mirror's keys, the weights both ways, the
ReLU6 epilogue's plain version, one ``flair-detect`` run, and the
refusals.

One seeded smp-keyed state dict a case feeds both packages: the port loads
it strictly, ``flairtpu`` takes it through its own ``torch_to_flax`` (never
``model.init``), and one jitted ``flairtpu`` apply an arch gives both its
logits and its encoder's features (captured). Tolerances are
``tests/test_torch_efficientnet.py``'s: logits and features within 2e-5 of
the largest |value|, the plain ReLU6 epilogue within float32 rounding of
``flairtpu``'s ``jnp.clip`` expression.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.models.tv_encoders import MobileNetV2SmpEncoder
from flairtpu.models.tv_encoders import mobilenet_v2_plan as flax_plan
from flairtpu.train import checkpoints as fck
from flairtpu_torch import config as cfgmod
from flairtpu_torch import tools
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models import mobilenet as mn
from flairtpu_torch.models.convert import from_flax, load_weights, to_flax, write_native
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import fold_model
from flairtpu_torch.models.quantize import check_quantizable, quantize_model
from flairtpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
from tests.test_torch_models import random_state_dict
from tests.test_torch_msgpack import assert_flax_trees_equal
from tests.test_torch_zone_archs import N_CLASSES as ZONE_CLASSES
from tests.test_torch_zone_archs import (HEIGHT, MARGIN, WIDTH, assert_argmax_close, exact_ties,
                                         raster, read, run_port)
from tests.torch_ref_tv import MobileNetV2EncoderTorch, MobileNetV2Unet

N_CLASSES, TILE = 5, 64
REL_TOL = 2e-5
PLAIN_TOL = 1e-6
MANIFESTS = Path(__file__).parent / "smp_manifests"
# the four encoder shapes: output stride 32 (unet), 16 (deeplabv3plus), 8
# (deeplabv3), and depth 3 (pspnet)
ARCHS = ("unet", "deeplabv3plus", "deeplabv3", "pspnet")


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


def flax_model(arch: str, n_classes: int = N_CLASSES):
    return flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder":
                                                          f"mobilenet_v2_{arch}"}},
        "n_classes": n_classes, "channels": [1, 2, 3, 4, 5]})


@pytest.fixture(scope="module", params=ARCHS)
def case(request, tmp_path_factory):
    """(arch, port model loaded from a .pth, state dict, flairtpu's logits
    of ``inputs()``, flairtpu's encoder features of them)."""
    arch = request.param
    port = FlairSegmentationModel("mobilenet_v2", N_CLASSES, 5, arch=arch).eval()
    sd = random_state_dict(port, np.random.default_rng(ARCHS.index(arch) + 60))
    path = tmp_path_factory.mktemp("mobilenet") / f"mobilenet_v2_{arch}.pth"
    torch.save(sd, path)
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel = flax_model(arch)
    x = jnp.asarray(inputs())

    def apply(v):
        return fmodel.apply(v, x, train=False, mutable=["intermediates"],
                            capture_intermediates=lambda m, _: isinstance(
                                m, MobileNetV2SmpEncoder))

    logits, inter = jax.jit(apply)(variables)
    (feats,), = [v for k, v in flatten_dict(inter["intermediates"]).items()
                 if k[-1] == "__call__"]
    return arch, port, sd, np.asarray(logits), [np.asarray(f) for f in feats]


def assert_close(got: np.ndarray, want: np.ndarray, rel: float = REL_TOL) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("output_stride", (32, 16, 8))
def test_plan_equals_flairtpu(output_stride):
    """Every block's widths, expand ratio, stride, dilation and skip."""
    assert mn.mobilenet_v2_plan(output_stride) == flax_plan(output_stride)
    with pytest.raises(ValueError, match="output_stride"):
        mn.mobilenet_v2_plan(4)


def test_dilated_plan_keeps_the_original_skip():
    """At output stride 8 the first blocks of stages 4 and 5 (features.7,
    features.14) lose their stride but keep skip False; the depthwise
    dilation is 2 in stage 4 and 4 in stage 5."""
    plan = {b["index"]: b for b in mn.mobilenet_v2_plan(8)}
    for i in (7, 14):
        assert plan[i]["stride"] == 1 and not plan[i]["skip"]
    assert {plan[i]["dilation"] for i in range(7, 14)} == {2}
    assert {plan[i]["dilation"] for i in range(14, 18)} == {4}
    assert sum(b["skip"] for b in mn.mobilenet_v2_plan(32)) == 10


def test_features_match_flairtpu(case):
    """The pyramid [x, f1..f_depth] at the arch's output stride and depth:
    its widths (16, 24, 32, 96, 1280), each map within 2e-5 of its
    largest |value|."""
    arch, port, _, _, want = case
    with torch.inference_mode():
        got = port.features(torch.from_numpy(inputs()))
    assert len(got) == len(want) == port.encoder.depth + 1 == (4 if arch == "pspnet" else 6)
    assert tuple(f.shape[1] for f in got[1:]) == port.encoder.out_channels[1:]
    for g, w in zip(got[1:], want[1:]):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_logits_match_flairtpu(case):
    _, port, _, want, _ = case
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs())).numpy()
    assert_close(got, want)


def test_interior_decode_is_the_crop(case):
    """``inner_margin``: the U-Net's interior plan gives the crop bit for
    bit; the strided-head archs' windowed upsample within 1e-6 of the
    largest |logit|."""
    _, port, _, _, _ = case
    x = torch.from_numpy(inputs())
    with torch.inference_mode():
        got, full = port(x, inner_margin=16), port(x)[:, 16:TILE - 16, 16:TILE - 16]
    if port.arch == "unet":
        assert torch.equal(got, full)
    else:
        assert_close(got.numpy(), full.numpy(), 1e-6)


@pytest.mark.parametrize("output_stride,depth", [(32, 5), (16, 5), (8, 5), (32, 3)])
def test_keys_and_values_match_the_torchvision_mirror(output_stride, depth):
    """The encoder's keys and shapes are those of ``tests/torch_ref_tv.py``'s
    torchvision mirror (smp's dilation applied verbatim), which loads the
    port's state dict strictly and gives its features within 2e-5."""
    port = mn.MobileNetV2Encoder(5, output_stride=output_stride, depth=depth).eval()
    sd = random_state_dict(port, np.random.default_rng(output_stride + depth))
    port.load_state_dict(sd)
    mirror = MobileNetV2EncoderTorch(5, depth=depth, output_stride=output_stride).eval()
    assert {k: tuple(v.shape) for k, v in mirror.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    mirror.load_state_dict(sd, strict=True)
    x = torch.from_numpy(inputs()).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got, want = port(x), mirror(x)
    for g, w in zip(got[1:], want[1:]):
        assert_close(g.numpy(), w.numpy())


def test_state_dict_matches_smp_manifest():
    """The production shape (5 channels, 13 classes): the 312 keys and
    shapes of the committed smp manifest, no more, no fewer; the mirror of
    smp's model has them too; torchvision's BatchNorm constants."""
    model = FlairSegmentationModel("mobilenet_v2", 13, 5)
    got = {k: list(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = json.loads((MANIFESTS / "mobilenet_v2_unet.json").read_text())
    assert got == want and len(want) == 312
    mirror = {k: list(v.shape) for k, v in MobileNetV2Unet(5, 13).state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert mirror == want
    assert all(m.eps == 1e-5 and m.momentum == 0.1 for m in model.encoder.modules()
               if isinstance(m, torch.nn.BatchNorm2d))


def test_weights_both_ways(case, tmp_path):
    """``to_flax`` equals flairtpu's converter leaf by leaf, ``from_flax``
    brings it back bit for bit, a ``.msgpack`` the port writes is read by
    flairtpu as that tree and loads back into the port strictly, and
    ``tools.py convert-weights`` of the ``.pth`` (its arch found from the
    keys) writes the same bytes."""
    arch, _, sd, _, _ = case
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    got = to_flax(sd, arch)
    assert_flax_trees_equal(got, want)
    assert set(got["params"]["encoder"]["f1"]) == {"dw", "dw_bn", "project", "project_bn"}
    back = from_flax(got["params"], got["batch_stats"], arch)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    path = tmp_path / "w.msgpack"
    write_native(path, sd, arch)
    assert_flax_trees_equal(fck.load_weights_msgpack(path), want)
    pth = tmp_path / "w.pth"
    torch.save(sd, pth)
    tools.main(["convert-weights", str(pth), str(tmp_path / "c.msgpack")])
    assert (tmp_path / "c.msgpack").read_bytes() == path.read_bytes()
    model = FlairSegmentationModel("mobilenet_v2", N_CLASSES, 5, arch=arch)
    load_weights(model, path)
    for k, v in sd.items():
        assert torch.equal(model.state_dict()[k], v), k


def bn_map(rng, shape):
    """A map (B, H, W, C) and a BatchNorm (scale, shift) whose outputs
    cross 0 and 6, in float32."""
    C = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32) * 4,
            rng.uniform(0.5, 1.5, C).astype(np.float32), rng.normal(2, 1, C).astype(np.float32))


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def test_relu6_epilogue_equals_flairtpus_expression():
    """The ReLU6 mode (``flairtpu/models/tv_encoders.py:111``: ``jnp.clip(v,
    0, 6)`` of the BatchNorm) on the same numpy inputs; the float32 copy
    is the output; a NaN passes, as jnp.clip and torch.clamp pass it."""
    y, scale, shift = bn_map(np.random.default_rng(5), (2, 9, 7, 24))
    want = np.asarray(jnp.clip(jnp.asarray(y) * scale + shift, 0.0, 6.0))
    s, t = torch.from_numpy(scale), torch.from_numpy(shift)
    out, out32 = conv_epilogue(nchw(y), s, t, act="relu6", keep_f32=True)
    np.testing.assert_allclose(out32.permute(0, 2, 3, 1).numpy(), want, rtol=PLAIN_TOL,
                               atol=PLAIN_TOL)
    assert torch.equal(out, out32)
    assert 0 < (want == 6).mean() < 0.5 and 0 < (want == 0).mean() < 0.5
    y[0, 0, 0, :2] = np.nan
    got = conv_epilogue_plain(nchw(y), s, t, act="relu6")[0]
    assert torch.isnan(got[0, :2, 0, 0]).all() and not torch.isnan(got[0, 2:]).any()


def test_relu6_epilogue_keeps_the_other_modes():
    """ReLU, SiLU and no-activation results are unchanged; an activation
    that is none of them raises; the drop-connect takes no ReLU6."""
    y, scale, shift = bn_map(np.random.default_rng(6), (1, 4, 4, 8))
    x = nchw(y)
    s, t = torch.from_numpy(scale), torch.from_numpy(shift)
    v = x * s[:, None, None] + t[:, None, None]
    assert torch.equal(conv_epilogue(x, s, t)[0], torch.relu(v))
    assert torch.equal(conv_epilogue(x, s, t, act=None)[0], v)
    assert torch.equal(conv_epilogue(x, s, t, act=False)[0], v)
    assert torch.equal(conv_epilogue(x, s, t, act=True)[0], torch.relu(v))
    assert torch.equal(conv_epilogue(x, s, t, act="silu")[0], v * torch.sigmoid(v))
    assert torch.equal(conv_epilogue(x, s, t, act="relu6")[0], torch.clamp(v, 0, 6))
    for act in ("hardtanh", "ReLU6", 2):
        with pytest.raises(ValueError, match="ReLU or SiLU or ReLU6"):
            conv_epilogue(x, s, t, act=act)
    with pytest.raises(ValueError, match="drop-connect"):
        conv_epilogue(x, s, t, residual=x.float(), act="relu6", drop=(torch.ones(1), 0.5))


def test_metadata_fuses_into_the_deepest_map():
    """use_metadata: the MLP's embedding of ``mtd`` is added to the 16²
    1280-channel deepest map of a 512² tile, as with the other encoders."""
    model = FlairSegmentationModel("mobilenet_v2", 3, 5, use_metadata=True).eval()
    gen = torch.Generator().manual_seed(4)
    x, mtd = torch.rand((1, 512, 512, 5), generator=gen), torch.rand((1, 45), generator=gen)
    with torch.inference_mode():
        fused = model.features(x, mtd=mtd)
        emb = model.enc(mtd)
        model.use_metadata = False
        plain = model.features(x)
    assert tuple(fused[-1].shape) == (1, 1280, 16, 16)
    torch.testing.assert_close(fused[-1] - plain[-1],
                               emb[:, None, :, None].expand_as(plain[-1]), rtol=0, atol=1e-6)


def test_refusals(tmp_path):
    """bn_fold and int8 raise flairtpu's ValueError; every arch takes the
    encoder; flair with train validates, and with remat raises
    NotImplementedError when its config is read, as for every family."""
    model = FlairSegmentationModel("mobilenet_v2", 3, 5)
    with pytest.raises(ValueError, match="bn_fold: supports the ResNet"):
        fold_model(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        check_quantizable(model)
    with pytest.raises(ValueError, match="int8 supports the ResNet"):
        quantize_model({}, model, [])
    for arch in cfgmod.SMP_ARCHS:
        assert cfgmod.check_smp(f"mobilenet_v2_{arch}") == ("mobilenet_v2", arch)

    def train_config(train: bool, **over) -> dict:
        return {"paths": {"out_folder": str(tmp_path)}, "tasks": {"train": train,
                                                                  "predict": True},
                "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                    "SegmentationModelsPytorch": {"encoder_decoder":
                                                                  "mobilenet_v2_unet"}},
                "channels": [1, 2, 3, 4, 5], "classes": {1: [1, "a"], 2: [1, "b"]},
                "accelerator": "cpu", **over}

    assert cfgmod.validate_train_config(train_config(True))["tasks"]["train"]
    with pytest.raises(NotImplementedError, match="remat"):
        cfgmod.validate_train_config(train_config(True, remat=True))


# -- flair-detect, use_gpu: false ---------------------------------------------


@pytest.fixture(scope="module")
def zone(tmp_path_factory):
    """``tests/test_torch_efficientnet_zone.py``'s zone (100 x 90 pixels,
    64-pixel tiles, a 16-pixel margin, 4 classes) and a mobilenet_v2-unet
    ``.pth``; a config maker."""
    tmp = tmp_path_factory.mktemp("torch_zone_mobilenet")
    img = np.random.default_rng(31).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
    path = tmp / "zone.tif"
    write_array(path, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)
    model = FlairSegmentationModel("mobilenet_v2", ZONE_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(99)))
    weights = tmp / "mobilenet_v2_unet.pth"
    torch.save(model.state_dict(), weights)

    def make_config(out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone", "input_img_path": str(path),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": TILE, "margin": MARGIN,
            "output_type": "argmax", "n_classes": ZONE_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder":
                                                              "mobilenet_v2_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    return dict(tmp=tmp, img=img, model=model, make_config=make_config)


def test_flair_detect_matches_flairtpu(zone):
    """The port's argmax raster against ``flairtpu``'s ``run_pipeline`` (its
    streaming route, one compile) on the same ``.pth``: classes equal but
    at near-ties (the owning tile's top-2 logit gap below 1e-4),
    probabilities within 1."""
    from flairtpu import config as flax_cfg
    from flairtpu.zone.engine import run_pipeline

    cfg = flax_cfg.validate_detect_config(zone["make_config"]("ref_argmax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        run_pipeline(cfg)
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
