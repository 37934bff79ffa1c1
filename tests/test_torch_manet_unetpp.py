"""flairtpu_torch's MAnet and UNet++ against flairtpu and the torch mirrors
(CPU, float32): keys, weights both ways, logits, and the zone tail's input.

One seeded smp-keyed state dict per architecture, built from the torch
mirrors of ``tests/torch_ref.py`` with their encoder cut to resnet18
(``tests/test_torch_smp_decoders.py``'s cut), feeds both packages: the
port loads it strictly, flairtpu through its own torch->flax converter.
Tolerances: logits within 2e-5 of the largest |logit| (the frameworks sum
convolutions, the attention's products and softmax in other orders); the
zone tail on ``tail_input`` (``fused_tail``'s plain versions: the last
block and the head on the crop of block 3's output) against the crop of
the full decode within 1e-6 of the largest |logit| (measured: about 3e-7
relative), classes equal where the top-2 gap is above that, probabilities
within one step of 255.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu_torch.models.convert import from_flax, load_weights
from flairtpu_torch.models.factory import FUSED_TAIL_ARCHS, FlairSegmentationModel
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops.fused import prob_to_u8, softmax
from tests import torch_ref as tr
from tests.test_torch_models import random_state_dict

N_CLASSES, TILE = 5, 64
ARCHS = ("manet", "unetplusplus")
MIRRORS = {"manet": tr.ResNet34MAnet, "unetplusplus": tr.ResNet34UnetPlusPlus}
MANIFESTS = Path(__file__).parent / "smp_manifests"
REL_TOL = 2e-5
TAIL_TOL = 1e-6
MARGINS = (16, 0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mirror_state_dict(arch: str, rng: np.random.Generator) -> tuple[nn.Module, dict]:
    """The torch mirror with a resnet18 encoder, and its seeded state dict
    (He-scaled convs, random BatchNorm statistics)."""
    mirror = MIRRORS[arch](in_channels=5, classes=N_CLASSES)
    for i in range(1, 5):
        stage = getattr(mirror.encoder, f"layer{i}")
        setattr(mirror.encoder, f"layer{i}", nn.Sequential(*list(stage)[:2]))
    sd = random_state_dict(mirror, rng)
    mirror.load_state_dict(sd, strict=True)
    return mirror.eval(), sd


def inputs() -> np.ndarray:
    return np.random.default_rng(7).uniform(0, 1, (2, TILE, TILE, 5)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request, tmp_path_factory):
    """(arch, port model loaded from a .pth, mirror, flairtpu's whole-tile
    logits of ``inputs()``, variables, state dict)."""
    arch = request.param
    mirror, sd = mirror_state_dict(arch, np.random.default_rng(ARCHS.index(arch) + 70))
    path = tmp_path_factory.mktemp(arch) / f"resnet18_{arch}.pth"
    torch.save(sd, path)
    port = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch).eval()
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel = flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": f"resnet18_{arch}"}},
        "n_classes": N_CLASSES, "channels": [1, 2, 3, 4, 5]})
    x = jax.numpy.asarray(inputs())
    want = np.asarray(jax.jit(lambda v: fmodel.apply(v, x, train=False))(variables))
    return arch, port, mirror, want, variables, sd


def assert_close(got: np.ndarray, want: np.ndarray, rel: float = REL_TOL) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_dict_matches_smp_manifest(arch):
    """resnet34 at the production shape (5 channels, 13 classes): the keys
    and shapes of the committed smp manifest, no more, no fewer."""
    model = FlairSegmentationModel("resnet34", 13, 5, arch=arch)
    got = {k: list(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert got == json.loads((MANIFESTS / f"resnet34_{arch}.json").read_text())
    assert arch in FUSED_TAIL_ARCHS and model.up == 1


def test_pth_loads_strictly(pair):
    """The .pth of the mirror's state dict loads strictly, every tensor as
    it was saved."""
    _, port, _, _, _, sd = pair
    have = port.state_dict()
    assert set(have) == set(sd)
    for k, v in sd.items():
        assert torch.equal(have[k], v), k


def test_from_flax_round_trip_is_exact(pair):
    """flairtpu's variables back to smp keys: the same tensors bit for bit
    (MAnet's center, hl convs and SE gates, UNet++'s x_d_l nodes)."""
    arch, port, _, _, variables, sd = pair
    back = from_flax(variables["params"], variables["batch_stats"], arch)
    assert set(back) == set(sd) == set(port.state_dict())
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k


def test_logits_match_flairtpu(pair):
    _, port, _, want, _, _ = pair
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs())).numpy()
    assert_close(got, want)


def test_logits_match_torch_mirror(pair):
    """The same weights through smp's mirror (NCHW, torch's BatchNorm, the
    PAB's transpose-free reshape and global softmax, UNet++'s two cats)."""
    _, port, mirror, _, _, _ = pair
    x = torch.from_numpy(inputs())
    with torch.inference_mode():
        want = mirror(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        got = port(x).numpy()
    assert_close(got, want)


def test_pab_reshape_is_not_a_transpose():
    """The PAB's attended (B, hw, C) tensor is reinterpreted as (B, C, h,
    w): at hw = 4 against C = 512 a transpose would give other values, and
    channels_last memory must not leak into the reshape."""
    model = FlairSegmentationModel("resnet18", 3, 5, arch="manet").eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(5)))
    mirror = tr.PAB(512).eval()
    mirror.load_state_dict({k.removeprefix("decoder.center."): v
                            for k, v in model.state_dict().items()
                            if k.startswith("decoder.center.")})
    x = torch.randn((2, 512, 2, 2), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        want = mirror(x)
        got = model.decoder.center(x.contiguous(memory_format=torch.channels_last))
    assert_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("margin", MARGINS)
def test_tail_input_drives_fused_tail(pair, margin):
    """``tail_input`` (the decoder through block 3 on whole tiles, cropped
    to ``plan_inner_crops``' block-3 extent) through the three plain tails:
    the logits equal the crop of the full decode within TAIL_TOL of the
    largest |logit|, the classes and probabilities follow them; at margin 0
    the whole tile (the sweep's logits)."""
    _, port, _, _, _, _ = pair
    x = torch.from_numpy(inputs())
    S, s = TILE, TILE - 2 * margin
    g, p = ft.tail_geometry(S, margin), port.zone_tail()
    assert isinstance(p, ft.TailParams)
    with torch.inference_mode():
        full = port(x)[:, margin:S - margin, margin:S - margin]
        x3 = port.tail_input(x, margin)
        logits = ft.fused_tail_logits(x3, p, g)
        cls, prob = ft.fused_tail(x3, p, g)
        plane = ft.fused_tail_probs(x3, p, g, torch.zeros((2 * s, s, N_CLASSES),
                                                           dtype=torch.uint8),
                                    ft.full_windows(2, s, torch.device("cpu")))
    assert tuple(x3.shape) == (2, 32, g.x3_extent, g.x3_extent)
    assert x3.is_contiguous(memory_format=torch.channels_last)
    assert_close(logits.numpy(), full.numpy(), TAIL_TOL)
    top2 = torch.topk(full, 2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * TAIL_TOL * float(full.abs().max())
    assert torch.equal(cls[sure], full.argmax(-1).to(torch.uint8)[sure])
    want = prob_to_u8(softmax(full, dim=-1))
    assert (prob.int() - want.max(-1).values.int()).abs().max() <= 1
    assert (plane.view(2, s, s, N_CLASSES).int() - want.int()).abs().max() <= 1


def test_inner_margin_decode_is_the_crop(pair):
    """``decode(..., inner_margin)``: the whole decode cropped, exactly."""
    _, port, _, _, _, _ = pair
    x = torch.from_numpy(inputs())
    with torch.inference_mode():
        got = port(x, inner_margin=16)
        full = port(x)
    assert torch.equal(got, full[:, 16:TILE - 16, 16:TILE - 16])
