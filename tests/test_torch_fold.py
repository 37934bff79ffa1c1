"""bn_fold in flairtpu_torch against flairtpu (CPU, float32): the folded
weights bit for bit, the folded walk's logits, the folded zone rasters
through both CLIs, and the knob checks of both configs.

resnet18-unet, 4 classes, 64/16 tiles, an 80 x 64 zone, one smp-keyed .pth
for both packages. Tolerances: logits atol = rtol = 2e-4 (float32 sums in
other orders, as tests/test_fold.py); rasters: class agreement >= 0.999 and
prob |diff| <= 1.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.io import TiffReader
from flairtpu.models import quantize as fq
from flairtpu.models.convert import torch_to_flax
from flairtpu.models.fold import fold_model as flax_fold_model
from flairtpu.zone.engine import run_pipeline
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import fold_encoder, fold_model, fold_unet_decoder
from flairtpu_torch.ops import epilogue as ep
from flairtpu_torch.ops import fused_tail as ft
from tests.test_torch_models import flax_model, random_state_dict

N_CLASSES, SIZE, MARGIN = 4, 64, 16
ZONE_W, ZONE_H = 80, 64


def make_setup(tmp: Path, seed: int = 9):
    """(port model, flax model, flax variables, make_config): a resnet18-unet
    with random BatchNorm statistics saved as one .pth, and an 80 x 64 zone."""
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    sd = random_state_dict(model, np.random.default_rng(seed))
    model.load_state_dict(sd)
    weights = tmp / "resnet18_unet.pth"
    torch.save(sd, weights)
    img = np.random.default_rng(seed + 1).integers(0, 256, (5, ZONE_H, ZONE_W)).astype(np.uint8)
    zone = tmp / "zone.tif"
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)

    def make_config(out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone-ARGMAX",
            "input_img_path": str(zone), "channels": [1, 2, 3, 4, 5],
            "img_pixels_detection": SIZE, "margin": MARGIN, "output_type": "argmax",
            "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    return model, flax_model("resnet18", N_CLASSES), variables, make_config


def run_both(tmp: Path, cfg: dict) -> tuple[np.ndarray, np.ndarray]:
    """The (2, H, W) rasters of flairtpu's and the port's flair-detect."""
    ref = flax_cfg.validate_detect_config(dict(cfg, output_path=cfg["output_path"] + "_ref"))
    run_pipeline(ref)
    conf = tmp / f"{Path(cfg['output_path']).name}.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    detect_main([f"--conf={conf}"])
    out = []
    for path in (ref["output_path"], cfg["output_path"]):
        with TiffReader(Path(path) / "zone-ARGMAX.tif") as r:
            assert (r.width, r.height, r.count) == (ZONE_W, ZONE_H, 2)
            out.append(r.read())
    return out[0], out[1]


def raster_agreement(want: np.ndarray, have: np.ndarray) -> tuple[float, int]:
    """(class agreement, largest prob |diff|); every pixel written."""
    assert (have[1] > 0).all()
    return (float((want[0] == have[0]).mean()),
            int(np.abs(want[1].astype(int) - have[1].astype(int)).max()))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_fold")
    return (tmp, *make_setup(tmp))


def test_folded_sites_equal_flairtpu_bit_for_bit(setup):
    """fold_encoder and fold_unet_decoder: the same float32 values (HWIO
    there, OIHW here) for every site."""
    _, model, _, variables, _ = setup
    p, s = variables["params"], variables["batch_stats"]
    for got, want in ((fold_encoder(model.encoder), fq.fold_encoder(p, s)),
                      (fold_unet_decoder(model.decoder), fq.fold_unet_decoder(p, s))):
        assert set(got) == set(want)
        for name, c in got.items():
            np.testing.assert_array_equal(c["w"].permute(2, 3, 1, 0).numpy(),
                                          np.asarray(want[name]["w"]), err_msg=name)
            np.testing.assert_array_equal(c["b"].numpy(), np.asarray(want[name]["b"]),
                                          err_msg=name)


@pytest.mark.parametrize("inner_margin", [None, MARGIN])
def test_folded_logits_match_flairtpu(setup, inner_margin):
    """FoldedZoneModel logits against flairtpu's FoldedZoneModel.apply."""
    _, model, fmodel, variables, _ = setup
    x = np.random.default_rng(3).uniform(0, 1, (2, SIZE, SIZE, 5)).astype(np.float32)
    folded = flax_fold_model(fmodel, variables["params"], variables["batch_stats"])
    want = np.asarray(folded.apply(variables, jnp.asarray(x), train=False,
                                   inner_margin=inner_margin))
    with torch.inference_mode():
        got = fold_model(model)(torch.from_numpy(x), inner_margin=inner_margin).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_fold_tail_params_drive_fused_tail(setup):
    """fused_tail on tail_input with fold_tail_params (block 4 with scale 1
    and shift = the folded bias) gives the walk's own interior logits."""
    _, model, _, _, _ = setup
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 1, (2, SIZE, SIZE, 5))
                         .astype(np.float32))
    fm = fold_model(model)
    with torch.inference_mode():
        logits = ft.fused_tail_logits(fm.tail_input(x, MARGIN), fm.tail,
                                      ft.tail_geometry(SIZE, MARGIN))
        want = fm(x, inner_margin=MARGIN)
    assert torch.equal(fm.tail.scale1, torch.ones(16)) and torch.equal(fm.tail.scale2,
                                                                       torch.ones(16))
    torch.testing.assert_close(logits, want, atol=1e-5, rtol=1e-5)


def test_epilogue_takes_a_residual_in_the_compute_dtype():
    """The folded walk's identity is in the compute dtype: the plain
    epilogue adds it as float32, as it adds a float32 residual."""
    g = torch.Generator().manual_seed(0)
    y = torch.randn((2, 16, 5, 7), generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    r = torch.randn((2, 16, 5, 7), generator=g).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    scale, shift = torch.ones(16), torch.randn(16, generator=g)
    out, out32 = ep.conv_epilogue(y, scale, shift, residual=r, keep_f32=True)
    want = torch.relu(y.float() + shift[:, None, None] + r.float())
    assert torch.equal(out32, want) and torch.equal(out, want.to(torch.bfloat16))


def test_bn_fold_rasters_match_flairtpu(setup):
    tmp, _, _, _, make_config = setup
    want, have = run_both(tmp, make_config("fold", bn_fold=True))
    agree, dprob = raster_agreement(want, have)
    assert agree >= 0.999 and dprob <= 1


def _check_outcome(validate, cfg: dict):
    try:
        validate(cfg)
    except (flax_cfg.ConfigError, cfgmod.ConfigError, NotImplementedError) as error:
        return type(error).__name__
    return "ok"


@pytest.mark.parametrize("knobs", [
    {"bn_fold": True}, {"bn_fold": False}, {"bn_fold": "yes"}, {"bn_fold": 1},
    {"quantize": "int8"}, {"quantize": False}, {"quantize": None}, {"quantize": "int4"},
    {"quantize": True}, {"quantize": "int8", "bn_fold": True},
    {"quantize": "int8", "int8_decoder": 0}, {"quantize": "int8", "int8_decoder": 4},
    {"quantize": "int8", "int8_decoder": True}, {"quantize": "int8", "int8_decoder": False},
    {"quantize": "int8", "int8_decoder": 6}, {"quantize": "int8", "int8_decoder": -1},
    {"quantize": "int8", "int8_decoder": "2"}, {"int8_decoder": 9},
])
def test_knob_checks_match_flairtpu(setup, knobs):
    """The port accepts and refuses the same knob values as
    flairtpu/config.py:306-346 (refusals as ConfigError in both)."""
    _, _, _, _, make_config = setup
    want = _check_outcome(flax_cfg.validate_detect_config, make_config("cfg_ref", **knobs))
    got = _check_outcome(cfgmod.validate_detect_config, make_config("cfg_port", **knobs))
    assert got == want
