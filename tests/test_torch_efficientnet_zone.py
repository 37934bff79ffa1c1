"""flair-detect end to end with an EfficientNet U-Net on a synthetic zone,
CPU (use_gpu: false): the SiLU epilogue and the squeeze-excite sites'
plain versions, the zone tail ``fused_tail``'s.

The zone, tiles and bounds are ``tests/test_torch_zone_archs.py``'s: 100 x
90 pixels, 64-pixel tiles, a 16-pixel margin, 4 classes. The port's argmax
raster is held against ``flairtpu``'s ``run_pipeline`` (its streaming
route, one compile) on the same ``.pth``: classes equal but at near-ties
(the owning tile's top-2 logit gap below 1e-4), probabilities within 1.
The port's class_prob raster is held to the softmax of the owning tiles'
logits (``tests/test_torch_zone_manet_unetpp.py``'s rule: within 1), and
its argmax to flairtpu's classes away from near-ties.
"""

import numpy as np
import pytest
import torch

from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from tests.test_torch_models import random_state_dict
from tests.test_torch_zone_archs import (HEIGHT, MARGIN, N_CLASSES, WIDTH, assert_argmax_close,
                                         exact_ties, raster, read, run_port)
from tests.test_torch_zone_manet_unetpp import assert_probs_close, owned_probs

ENCODER_DECODER = "efficientnet-b0_unet"
TILE = 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_zone_efficientnet")
    img = np.random.default_rng(29).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
    zone = tmp / "zone.tif"
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)
    encoder, arch = ENCODER_DECODER.rsplit("_", 1)
    model = FlairSegmentationModel(encoder, N_CLASSES, 5, arch=arch).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(97)))
    weights = tmp / f"{ENCODER_DECODER}.pth"
    torch.save(model.state_dict(), weights)

    def make_config(out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone", "input_img_path": str(zone),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": TILE, "margin": MARGIN,
            "output_type": "argmax", "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder":
                                                              ENCODER_DECODER}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    return dict(tmp=tmp, img=img, model=model, make_config=make_config)


@pytest.fixture(scope="module")
def reference(setup):
    """flairtpu's argmax raster, on its streaming route."""
    from flairtpu import config as flax_cfg
    from flairtpu.zone.engine import run_pipeline

    cfg = flax_cfg.validate_detect_config(setup["make_config"]("ref_argmax"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        run_pipeline(cfg)
    return read(raster(cfg))


def test_argmax_matches_flairtpu(setup, reference):
    have = read(run_port(setup["tmp"], setup["make_config"]("port_argmax"))[0])
    assert_argmax_close(have, reference, exact_ties(setup["model"], setup["img"], TILE))


def test_class_prob_follows_the_tiles(setup, reference):
    """class_prob (the tail's probs mode): every band round(255 * softmax)
    of the owning tile's logits within 1, and its argmax flairtpu's class
    away from near-ties."""
    cfg = setup["make_config"]("port_cp", output_type="class_prob")
    have = read(run_port(setup["tmp"], cfg)[0])
    assert have.shape == (N_CLASSES, HEIGHT, WIDTH)
    want = owned_probs(setup["model"], setup["img"])
    assert_probs_close(have, want)
    sure = ~exact_ties(setup["model"], setup["img"], TILE)
    np.testing.assert_array_equal(want.argmax(0)[sure], reference[0][sure])


def test_knobs_raise_before_the_zone_is_read(setup, tmp_path):
    """bn_fold and int8 raise flairtpu's ValueError on the loaded model,
    before a tile is read: the zone here is not a TIFF."""
    bogus = tmp_path / "zone.tif"
    bogus.write_bytes(b"not a tiff")
    make = setup["make_config"]
    for knobs, match in (({"bn_fold": True}, "bn_fold: supports the ResNet"),
                         ({"quantize": "int8"}, "int8 supports the ResNet")):
        cfg = make(f"knob_{len(knobs)}_{next(iter(knobs))}", input_img_path=str(bogus), **knobs)
        with pytest.raises(ValueError, match=match):
            run_port(tmp_path, cfg)
