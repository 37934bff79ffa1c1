"""flair-detect end to end on synthetic zones, CPU (use_gpu: false): the
port's ``detect_main`` against flairtpu's ``run_pipeline`` on one .pth.

Zones: 90x70, whose last row and column of tiles realign, and 24x20,
smaller than one tile. Bounds: same size and georeferencing; class band
equal except at near-ties (top-2 logit gap < 1e-4); prob band |diff| <= 1
and equal on >= 99.9% of pixels.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.io import TiffReader
from flairtpu.io.tiff import Affine, write_array
from flairtpu.zone.engine import run_pipeline
from flairtpu_torch.cli import detect_main
from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone.grid import slice_grid
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
SIZE, MARGIN = 32, 8
ZONES = {"realigned_90x70": (90, 70, 5), "below_tile_24x20": (24, 20, 6)}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_zone")
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(9)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)
    zones = {}
    for name, (w, h, seed) in ZONES.items():
        img = np.random.default_rng(seed).integers(0, 255, (5, h, w)).astype(np.uint8)
        path = tmp / f"{name}.tif"
        write_array(path, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                    crs=2154, blockxsize=64, blockysize=64)
        zones[name] = (path, img)

    def make_config(zone: str, out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone-ARGMAX",
            "input_img_path": str(zones[zone][0]), "channels": [1, 2, 3, 4, 5],
            "img_pixels_detection": SIZE, "margin": MARGIN, "output_type": "argmax",
            "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    refs = {}
    for name in ZONES:
        cfg = flax_cfg.validate_detect_config(make_config(name, f"ref_{name}"))
        run_pipeline(cfg)
        refs[name] = Path(cfg["output_path"]) / "zone-ARGMAX.tif"
    return tmp, make_config, model, zones, refs


def run_port(tmp: Path, cfg: dict) -> Path:
    conf = tmp / f"{Path(cfg['output_path']).name}.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    detect_main([f"--conf={conf}"])
    return Path(cfg["output_path"]) / "zone-ARGMAX.tif"


def stitched_logits(model, img: np.ndarray) -> np.ndarray:
    """Per-pixel logits of the tile that owns each pixel (last write wins)."""
    C, H, W = img.shape
    s = SIZE - 2 * MARGIN
    grid = slice_grid(W, H, SIZE, MARGIN)
    pad = ((MARGIN, max(MARGIN, SIZE - H - MARGIN)), (MARGIN, max(MARGIN, SIZE - W - MARGIN)))
    zone = np.pad(np.moveaxis(img, 0, -1), pad + ((0, 0),))
    Ho, Wo = max(H, s), max(W, s)
    out = np.zeros((Ho, Wo, N_CLASSES), np.float32)
    with torch.inference_mode():
        for t in grid.tiles:
            r, c = t.row0 + MARGIN, t.col0 + MARGIN
            x = normalize(torch.from_numpy(zone[None, r:r + SIZE, c:c + SIZE]), "scaling")
            r0, c0 = min(t.irow0, Ho - s), min(t.icol0, Wo - s)
            out[r0:r0 + s, c0:c0 + s] = model(x, inner_margin=MARGIN)[0].numpy()
    return out[:H, :W]


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_detect_matches_flairtpu(setup, zone):
    tmp, make_config, model, zones, refs = setup
    got = run_port(tmp, make_config(zone, f"port_{zone}"))
    with TiffReader(refs[zone]) as ref, TiffReader(got) as r:
        assert (r.width, r.height, r.count) == (ref.width, ref.height, 2)
        assert (r.width, r.height) == ZONES[zone][:2]
        assert r.transform == ref.transform and r.crs == ref.crs == 2154
        want, have = ref.read(), r.read()
    assert have.dtype == np.uint8
    logits = stitched_logits(model, zones[zone][1])
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    ties = (top2[..., 0] - top2[..., 1]) < 1e-4
    np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
    dprob = np.abs(have[1].astype(int) - want[1].astype(int))
    assert dprob.max() <= 1
    assert (dprob == 0).mean() >= 0.999
    assert (have[1] > 0).all()  # every pixel written


def test_batch_size_invariance(setup):
    """The stitched raster does not depend on batching (duplicate tail tiles
    rewrite the same values)."""
    tmp, make_config, _, _, _ = setup
    outs = []
    for bs in (2, 5):
        path = run_port(tmp, make_config("realigned_90x70", f"port_bs{bs}", batch_size=bs))
        with TiffReader(path) as r:
            outs.append(r.read())
    np.testing.assert_array_equal(outs[0], outs[1])
