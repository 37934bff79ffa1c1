"""flairtpu_torch's MobileOne encoders against flairtpu (CPU, float32): the
plan of all five variants at output stride 32, 16 and 8, the encoder's
features and the logits of s0 (four branches) and s4 (squeeze-excite)
under the U-Net, s4 dilated under DeepLabV3 (output stride 8), s1 under
DeepLabV3+ (16) and s2 under PSPNet (depth 3), the U-Net's interior
decode, the smp manifests and the mirror of smp's encoder, and the weights
both ways. ``tests/test_torch_mobileone_zone.py`` holds one block, the
kernels' plain versions and a ``flair-detect`` run.

One seeded smp-keyed state dict a case feeds both packages: the port loads
it strictly, ``flairtpu`` takes it through its own ``torch_to_flax``, and
one jitted ``flairtpu`` apply a case gives its logits and its encoder's
features (captured). The draws are ``tests/test_torch_models.py``'s, with
each block's BatchNorm gammas divided by the square root of its terms (its
branches and skip), so that a block's sum keeps the scale of its input as
a trained MobileOne's does: with the draws as they are, every block
multiplies the scale by its terms, s4's stage-3 maps reach 1e2-1e3 and
s0's deepest 1e8, and the squeeze-excite gate's small convs then cancel
terms of that size, where two float32 sums of the same terms in other
orders differ by more than the tolerance measures. The tolerance is
``tests/test_torch_mobilenet.py``'s: features and logits within 2e-5 of
the largest |value|.
"""

import dataclasses
import inspect
import json
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import flairtpu.models.mobileone as fmo
from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.train import checkpoints as fck
from flairtpu_torch import tools
from flairtpu_torch.models import mobileone as mo
from flairtpu_torch.models.convert import from_flax, load_weights, to_flax, write_native
from flairtpu_torch.models.factory import FlairSegmentationModel
from tests.test_torch_models import random_state_dict
from tests.test_torch_msgpack import assert_flax_trees_equal
from tests.torch_ref import _dilate_stage
from tests.torch_ref_mobileone import MobileOneEncoderTorch, MobileOneUnet

N_CLASSES, TILE = 5, 64
REL_TOL = 2e-5
MANIFESTS = Path(__file__).parent / "smp_manifests"
VARIANTS = tuple(mo.MOBILEONE_SPECS)
# (variant, arch): s0's four branches and s4's squeeze-excite at output
# stride 32, s4 dilated at 8, s1 at 16, s2 at depth 3
CASES = (("mobileone_s0", "unet"), ("mobileone_s4", "unet"), ("mobileone_s4", "deeplabv3"),
         ("mobileone_s1", "deeplabv3plus"), ("mobileone_s2", "pspnet"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mobileone_state_dict(model: torch.nn.Module, rng: np.random.Generator) -> dict:
    """``random_state_dict``'s draws, each MobileOne block's BatchNorm gammas
    divided by the square root of the block's terms (module docstring)."""
    sd = random_state_dict(model, rng)
    for name, block in model.named_modules():
        if isinstance(block, mo.MobileOneBlock):
            terms = len(block.branches()) + (block.rbr_skip is not None)
            for key in sd:
                if key.startswith(f"{name}.") and re.search(r"(\.bn|rbr_skip)\.weight$", key):
                    sd[key] = sd[key] / terms ** 0.5
    return sd


def inputs() -> np.ndarray:
    return np.random.default_rng(7).uniform(0, 1, (2, TILE, TILE, 5)).astype(np.float32)


def flax_model(name: str, n_classes: int = N_CLASSES):
    return flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": name}},
        "n_classes": n_classes, "channels": [1, 2, 3, 4, 5]})


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}_{c[1]}")
def case(request, tmp_path_factory):
    """(variant, arch, port model loaded from a .pth, flairtpu's logits of
    ``inputs()``, flairtpu's encoder features)."""
    variant, arch = request.param
    port = FlairSegmentationModel(variant, N_CLASSES, 5, arch=arch).eval()
    sd = mobileone_state_dict(port, np.random.default_rng(CASES.index(request.param) + 70))
    path = tmp_path_factory.mktemp("mobileone") / f"{variant}_{arch}.pth"
    torch.save(sd, path)
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel = flax_model(f"{variant}_{arch}")
    x = jnp.asarray(inputs())

    def apply(v):
        return fmodel.apply(v, x, train=False, mutable=["intermediates"],
                            capture_intermediates=lambda m, _: isinstance(
                                m, fmo.MobileOneEncoder))

    logits, inter = jax.jit(apply)(variables)
    (feats,), = [v for k, v in flatten_dict(inter["intermediates"]).items()
                 if k[-1] == "__call__"]
    return variant, arch, port, np.asarray(logits), [np.asarray(f) for f in feats]


def assert_close(got: np.ndarray, want: np.ndarray, rel: float = REL_TOL) -> None:
    assert got.shape == want.shape and got.dtype == np.float32
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (err, float(np.abs(want).max()))


# -- the plan ------------------------------------------------------------------


def flairtpu_plan(variant: str, output_stride: int) -> list[dict]:
    """The blocks ``flairtpu``'s MobileOneEncoder builds, in order, with
    their fields: its ``__call__`` run as plain Python with a recorder in
    place of MobileOneBlock (no tracing)."""
    fields = {f.name: f.default for f in dataclasses.fields(fmo.MobileOneBlock)
              if f.name not in ("parent", "name")}
    order = ("out_ch", "kernel", "stride")
    calls = []

    class Recorder:
        def __init__(self, *args, **kw):
            calls.append(dict(fields, **dict(zip(order, args)), **kw))

        def __call__(self, x, train):
            return x

    me = types.SimpleNamespace(name_spec=variant, output_stride=output_stride, depth=5,
                               remat=False, dtype=np.float32)
    block = fmo.MobileOneBlock
    fmo.MobileOneBlock = Recorder
    try:
        inspect.unwrap(fmo.MobileOneEncoder.__call__)(me, np.zeros((1, 8, 8, 5), np.float32))
    finally:
        fmo.MobileOneBlock = block
    return calls


@pytest.mark.parametrize("output_stride", (32, 16, 8))
@pytest.mark.parametrize("variant", VARIANTS)
def test_plan_equals_flairtpu(variant, output_stride):
    """Every block's name, widths, kernel, stride, dilation, depthwise,
    branches, squeeze-excite and skip; the widths are flairtpu's."""
    got = [b for stage in mo.mobileone_plan(variant, output_stride) for b in stage]
    want = flairtpu_plan(variant, output_stride)
    assert [(b["name"].replace(".", "_"), b["cout"], b["kernel"], b["stride"], b["dilation"],
             b["depthwise"], b["branches"], b["se"], b["skip"]) for b in got] == \
        [(w["name"], w["out_ch"], w["kernel"], w["stride"], w["dilation"], w["depthwise"],
          w["n_branches"], w["use_se"], w["skip"]) for w in want]
    assert [b["cin"] for b in got[1:]] == [b["cout"] for b in got[:-1]]
    assert mo.mobileone_out_channels(variant) == fmo.mobileone_out_channels(variant)


def test_plan_details():
    """s4 squeezes and excites at 12 blocks (stage 3's last 5 pairs, stage
    4's pair); s0 has 4 branches a block but stage0's 1; at output stride
    8 stage 3's and 4's first depthwise blocks lose their stride and have no
    skip, and dilate by 2 and 4; the plan refuses other output strides."""
    s4 = [b for stage in mo.mobileone_plan("mobileone_s4") for b in stage]
    assert [b["name"] for b in s4 if b["se"]] == \
        [f"stage3.{i}" for i in range(10, 20)] + ["stage4.0", "stage4.1"]
    s0 = mo.mobileone_plan("mobileone_s0")
    assert s0[0][0]["branches"] == 1 and {b["branches"] for st in s0[1:] for b in st} == {4}
    os8 = mo.mobileone_plan("mobileone_s0", 8)
    for s, rate in ((3, 2), (4, 4)):
        first = os8[s][0]
        assert first["stride"] == 1 and not first["skip"] and first["dilation"] == rate
        assert {b["dilation"] for b in os8[s] if b["depthwise"]} == {rate}
    with pytest.raises(ValueError, match="output_stride"):
        mo.mobileone_plan("mobileone_s0", 4)


# -- the model against flairtpu ----------------------------------------------


def test_features_match_flairtpu(case):
    """The pyramid [x, stage0, stage1..] at the arch's output stride and
    depth, each map within 2e-5 of its largest |value|."""
    variant, arch, port, _, want = case
    with torch.inference_mode():
        got = port.features(torch.from_numpy(inputs()))
    assert len(got) == len(want) == port.encoder.depth + 1 == (4 if arch == "pspnet" else 6)
    assert tuple(f.shape[1] for f in got[1:]) == mo.mobileone_out_channels(variant)[1:len(got)]
    for g, w in zip(got[1:], want[1:]):
        assert_close(g.permute(0, 2, 3, 1).numpy(), w)


def test_logits_match_flairtpu(case):
    _, _, port, want, _ = case
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


@pytest.mark.parametrize("variant,arch", [("mobileone_s0", "unet"), ("mobileone_s4", "deeplabv3")])
def test_weights_both_ways(variant, arch, tmp_path):
    """s0's four branches and skips and s4's squeeze-excite: ``to_flax``
    equals flairtpu's converter leaf by leaf, ``from_flax`` brings it back
    bit for bit, a ``.msgpack`` the port writes is read by flairtpu as that
    tree and loads back into the port strictly, and ``tools.py
    convert-weights`` of the ``.pth`` (its arch found from the keys) writes
    the same bytes."""
    sd = mobileone_state_dict(FlairSegmentationModel(variant, N_CLASSES, 5, arch=arch),
                              np.random.default_rng(5))
    want = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    got = to_flax(sd, arch)
    assert_flax_trees_equal(got, want)
    enc = got["params"]["encoder"]
    assert set(enc["stage0"]) == {"rbr_conv_0", "rbr_scale"}
    assert "rbr_skip" in got["batch_stats"]["encoder"]["stage1_2"]
    assert ("se" in enc["stage4_1"]) == (variant == "mobileone_s4")
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
    model = FlairSegmentationModel(variant, N_CLASSES, 5, arch=arch)
    load_weights(model, path)
    loaded = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k


@pytest.mark.parametrize("variant,output_stride", [("mobileone_s0", 32), ("mobileone_s4", 16)])
def test_keys_and_values_match_the_smp_mirror(variant, output_stride):
    """The encoder's keys and shapes are those of ``tests/
    torch_ref_mobileone.py``'s mirror of smp's (stage 4 dilated by smp's
    rule at output stride 16), which loads the port's state dict strictly
    and gives its features within 2e-5 (it adds the scale branch and the
    skip first)."""
    port = mo.MobileOneEncoder(variant, 5, output_stride=output_stride).eval()
    sd = mobileone_state_dict(port, np.random.default_rng(output_stride))
    port.load_state_dict(sd)
    mirror = MobileOneEncoderTorch(variant, in_channels=5).eval()
    if output_stride == 16:
        _dilate_stage(mirror.stage4, 2)
    assert {k: tuple(v.shape) for k, v in mirror.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    mirror.load_state_dict(sd, strict=True)
    x = torch.from_numpy(inputs()).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got, want = port(x), mirror(x)
    for g, w in zip(got[1:], want[1:]):
        assert_close(g.numpy(), w.numpy())


@pytest.mark.parametrize("variant,n_keys", [("mobileone_s0", 1147), ("mobileone_s4", 561)])
def test_state_dict_matches_smp_manifest(variant, n_keys):
    """The production shape (5 channels, 13 classes): the keys and shapes of
    the committed smp manifest, no more, no fewer; the mirror of smp's
    model has them too; BatchNorm eps 1e-5 and torch momentum 0.1."""
    model = FlairSegmentationModel(variant, 13, 5)
    got = {k: list(v.shape) for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    want = json.loads((MANIFESTS / f"{variant}_unet.json").read_text())
    assert got == want and len(want) == n_keys
    mirror = {k: list(v.shape) for k, v in MobileOneUnet(variant, 5, 13).state_dict().items()
              if not k.endswith("num_batches_tracked")}
    assert mirror == want
    assert all(m.eps == 1e-5 and m.momentum == 0.1 for m in model.encoder.modules()
               if isinstance(m, torch.nn.BatchNorm2d))
