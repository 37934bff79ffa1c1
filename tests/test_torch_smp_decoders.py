"""flairtpu_torch's slice-5 smp models (deeplabv3plus, deeplabv3, fpn,
pspnet, linknet, pan) against flairtpu: weights both ways and logits (CPU,
float32).

One seeded smp-keyed state dict per architecture, built from the torch
mirrors of ``tests/torch_ref.py`` with their encoder cut to resnet18
(each stage's first two blocks), feeds both packages: the port loads it
strictly (``load_weights``), flairtpu through its own torch->flax
converter. Tolerance: float32 logits within 2e-5 of the largest |logit|
(measured: at most 1.8e-6; the frameworks sum convolutions, means and the
upsample's dot products in other orders, and torch's GroupNorm in the
mirror takes the two-pass variance where Flax and the port take
E[x^2] - E[x]^2).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu_torch.config import ConfigError, validate_detect_config
from flairtpu_torch.models.convert import from_flax, load_weights
from flairtpu_torch.models.factory import HEAD_UPSAMPLE, FlairSegmentationModel
from flairtpu_torch.ops import group_norm as gn
from tests import torch_ref as tr

N_CLASSES = 5
ARCHS = ("deeplabv3plus", "deeplabv3", "fpn", "pspnet", "linknet", "pan")
MIRRORS = {"deeplabv3plus": tr.ResNet34DeepLabV3Plus, "deeplabv3": tr.ResNet34DeepLabV3,
           "fpn": tr.ResNet34FPN, "pspnet": tr.ResNet34PSPNet, "linknet": tr.ResNet34Linknet,
           "pan": tr.ResNet34PAN}
REL_TOL = 2e-5
MARGINS = (8, 16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile(arch: str) -> int:
    return 128 if arch == "pan" else 64  # PAN's pyramid pools the stride-16 map 3 times


def mirror_state_dict(arch: str, rng: np.random.Generator) -> tuple[nn.Module, dict]:
    """The torch mirror with a resnet18 encoder, and its state dict with
    seeded weights: He-scaled convs, random BatchNorm statistics and affine
    GroupNorms."""
    mirror = MIRRORS[arch](in_channels=5, classes=N_CLASSES)
    for i, n in enumerate((2, 2, 2, 2), start=1):
        stage = getattr(mirror.encoder, f"layer{i}", None)
        if stage is not None:
            setattr(mirror.encoder, f"layer{i}", nn.Sequential(*list(stage)[:n]))
    sd = {}
    for key, v in mirror.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = v.clone()
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key.endswith(("running_mean", ".bias")):
            a = rng.normal(0.0, 0.1, shape)
        elif v.dim() == 1:  # BatchNorm / GroupNorm gamma
            a = rng.uniform(0.5, 1.0, shape)
        else:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / v[0].numel())
        sd[key] = torch.from_numpy(a.astype(np.float32))
    mirror.load_state_dict(sd, strict=True)
    return mirror.eval(), sd


def flax_model(arch: str):
    return flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": f"resnet18_{arch}"}},
        "n_classes": N_CLASSES, "channels": [1, 2, 3, 4, 5]})


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, tmp_path_factory):
    """(arch, port model loaded from a .pth, mirror, flairtpu's whole-tile
    logits of ``inputs(arch)``, variables, state dict)."""
    arch = request.param
    mirror, sd = mirror_state_dict(arch, np.random.default_rng(ARCHS.index(arch) + 40))
    path = tmp_path_factory.mktemp(arch) / f"resnet18_{arch}.pth"
    torch.save(sd, path)
    port = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch).eval()
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel, x = flax_model(arch), jax.numpy.asarray(inputs(arch))
    # jitted: one compile costs less than the decoders' eager dispatch
    want = np.asarray(jax.jit(lambda v: fmodel.apply(v, x, train=False))(variables))
    return arch, port, mirror, want, variables, sd


def inputs(arch: str) -> np.ndarray:
    S = tile(arch)
    return np.random.default_rng(7).uniform(0, 1, (2, S, S, 5)).astype(np.float32)


def assert_close(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * float(np.abs(want).max()), (err, float(np.abs(want).max()))


def test_from_flax_round_trip_is_exact(pair):
    """flairtpu's variables back to smp keys: the same tensors bit for bit,
    linknet's flipped and transposed transposed-conv kernel included."""
    arch, port, _, _, variables, sd = pair
    back = from_flax(variables["params"], variables["batch_stats"], arch)
    assert set(back) == set(sd) == set(port.state_dict())
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k
    port.load_state_dict(back, strict=True)


def test_logits_match_flairtpu(pair):
    """The whole tile's logits, the strided archs' head upsampled."""
    arch, port, _, want, _, _ = pair
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs(arch))).numpy()
    assert_close(got, want)


def test_logits_match_torch_mirror(pair):
    """The same weights through the torch mirror of smp (NCHW, torch's own
    BatchNorm, GroupNorm and bilinear upsample)."""
    arch, port, mirror, _, _, _ = pair
    x = torch.from_numpy(inputs(arch))
    with torch.inference_mode():
        want = mirror(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        got = port(x).numpy()
    assert_close(got, want)


@pytest.mark.parametrize("margin", MARGINS)
def test_inner_margin_decode(pair, margin):
    """``decode(..., inner_margin)``: the strided archs' windowed upsample
    against flairtpu's and the port's full decode, cropped (the window's
    rows of the same matrices: within rounding; flairtpu's own windowed
    upsample is held to it in tests/test_torch_strided_tail.py); linknet's
    crop of the full decode, exactly (flairtpu's zone route crops it too)."""
    arch, port, _, want, _, _ = pair
    x = inputs(arch)
    S = x.shape[1]
    with torch.inference_mode():
        got = port(torch.from_numpy(x), inner_margin=margin).numpy()
        full = port(torch.from_numpy(x)).numpy()
    crop = full[:, margin:S - margin, margin:S - margin]
    if arch in HEAD_UPSAMPLE:
        assert_close(got, want[:, margin:S - margin, margin:S - margin])
        assert_close(got, crop)
    else:
        np.testing.assert_array_equal(got, crop)


def test_head_logits_stride(pair):
    """The zone tail's input: the head's float32 logits at stride ``up``."""
    arch, port, _, _, _, _ = pair
    x = torch.from_numpy(inputs(arch))
    S, up = x.shape[1], port.up
    with torch.inference_mode():
        t = port.tail_input(x, 16)
    assert t.dtype == torch.float32 and t.is_contiguous()
    assert tuple(t.shape) == (2, S // up, S // up, N_CLASSES)


def test_encoder_geometry():
    """smp's output_stride and depth: dilated stages keep stride 8 or 16,
    strides 1 in them, padding equal to the dilation; depth 3 stops after
    layer2 (no layer3, layer4 parameters)."""
    x = torch.rand(1, 64, 64, 5)
    shapes = {}
    for arch in ("deeplabv3plus", "deeplabv3", "pspnet", "fpn"):
        m = FlairSegmentationModel("resnet50", 3, 5, arch=arch).eval()
        with torch.inference_mode():
            shapes[arch] = [tuple(f.shape[1:]) for f in m.features(x)]
    assert shapes["fpn"][-1] == (2048, 2, 2)
    assert shapes["deeplabv3plus"][-2:] == [(1024, 4, 4), (2048, 4, 4)]
    assert shapes["deeplabv3"][-3:] == [(512, 8, 8), (1024, 8, 8), (2048, 8, 8)]
    assert shapes["pspnet"] == [(5, 64, 64), (64, 32, 32), (256, 16, 16), (512, 8, 8)]
    m = FlairSegmentationModel("resnet34", 3, 5, arch="deeplabv3")
    first = m.encoder.layer4[0]
    assert first.conv1.stride == (1, 1) and first.conv1.dilation == (4, 4)
    assert first.conv1.padding == (4, 4) and first.downsample[0].stride == (1, 1)
    assert not any(k.startswith(("encoder.layer3", "encoder.layer4")) for k in
                   FlairSegmentationModel("resnet18", 3, 5, arch="pspnet").state_dict())


def test_group_norm_counts_no_cpu_launch(pair):
    """FPN's seven GroupNorm sites run the plain version on the CPU, which
    counts no launch."""
    arch, port, _, _, _, _ = pair
    gn.launches = 0
    with torch.inference_mode():
        port(torch.from_numpy(inputs(arch)))
    assert gn.launches == 0



def test_pan_small_tiles_refused_as_flairtpu_fails():
    """flairtpu's resnet18_pan fails below a 128-pixel tile (FPA's third max
    pool leaves an empty map: an IndexError while it traces) and traces at
    128 to whole-tile logits; the port's config check refuses the same
    sizes (test_pan_config_check_tile_sizes)."""
    fmodel, key = flax_model("pan"), jax.random.PRNGKey(0)

    def logits_shape(size: int):
        x = jax.numpy.zeros((1, size, size, 5))
        variables = jax.eval_shape(lambda: fmodel.init(key, x, train=False))
        return jax.eval_shape(lambda v: fmodel.apply(v, x, train=False), variables).shape

    with pytest.raises(IndexError):
        logits_shape(112)
    assert logits_shape(128) == (1, 128, 128, N_CLASSES)


@pytest.mark.parametrize("size,refused", [(112, True), (128, False)])
def test_pan_config_check_tile_sizes(tmp_path, size, refused):
    """The port refuses PAN tiles under 128 pixels when it reads the config,
    with a ConfigError naming the limit, and takes 128."""
    (tmp_path / "zone.tif").touch()
    (tmp_path / "w.pth").touch()
    cfg = {"input_img_path": str(tmp_path / "zone.tif"), "output_path": str(tmp_path / "out"),
           "channels": [1, 2, 3, 4, 5], "img_pixels_detection": size, "margin": 16,
           "output_type": "argmax", "n_classes": N_CLASSES,
           "norma_task": [{"norm_type": "scaling"}], "model_weights": str(tmp_path / "w.pth"),
           "model_framework": {"model_provider": "SegmentationModelsPytorch",
                               "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_pan"}}}
    if refused:
        with pytest.raises(ConfigError, match="pan needs tiles of at least 128"):
            validate_detect_config(cfg)
    else:
        assert validate_detect_config(cfg)["img_pixels_detection"] == 128
