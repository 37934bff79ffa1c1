"""flair-detect end to end with MAnet and UNet++ on a synthetic zone, CPU
(use_gpu: false): their zone tail is ``fused_tail`` (its plain versions
here) on the crop of the decoder's block-3 output.

The zone, tiles and bounds are ``tests/test_torch_zone_archs.py``'s: 100 x
90 pixels, 64-pixel tiles, a 16-pixel margin, resnet18 encoders, 4
classes. Each arch's argmax raster is held against one flairtpu
``run_pipeline`` (its streaming route) under that file's near-tie rule.
The other routes are held against the port itself: class_prob and the
sweep's four stitching methods against a float64 numpy composition of the
port's whole-tile logits (bands and probabilities within 1, classes equal
but at near-ties: a top-2 logit gap below 1e-4, or a stitched top-2 gap
below 1e-5); the streaming and banded routes bit for bit the device
route, and ``-b`` bit for bit the single-zone runs.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flairtpu_torch.cli import detect_main
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone.weights import patch_weights
from tests.test_torch_models import random_state_dict
from tests.test_torch_zone_archs import (HEIGHT, MARGIN, N_CLASSES, WIDTH, assert_argmax_close,
                                         exact_ties, raster, read, run_port, tile_logits)

ARCHS = ("manet", "unetplusplus")
TILE = 64
ROUTES = "manet"  # the arch that also runs the other routes
METHODS = ("average", "average_weights", "max", "exact-clipping")
SWEEP = {"tiling": {"enabled": True, "size_range": [TILE], "stride_range": [0.5]},
         "stitching": {"enabled": True, "methods": list(METHODS), "margin": [0.25]},
         "padding_overall": None}


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
    tmp = tmp_path_factory.mktemp("torch_zone_manet_unetpp")
    img = np.random.default_rng(23).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
    zone = tmp / "zone.tif"
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)
    models = {}
    for i, arch in enumerate(ARCHS):
        model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch).eval()
        model.load_state_dict(random_state_dict(model, np.random.default_rng(80 + i)))
        torch.save(model.state_dict(), tmp / f"resnet18_{arch}.pth")
        models[arch] = model

    def make_config(arch: str, out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone", "input_img_path": str(zone),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": TILE, "margin": MARGIN,
            "output_type": "argmax", "n_classes": N_CLASSES,
            "model_weights": str(tmp / f"resnet18_{arch}.pth"),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder":
                                                              f"resnet18_{arch}"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    return dict(tmp=tmp, img=img, models=models, make_config=make_config)


def softmax64(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def owned_probs(model, img: np.ndarray) -> np.ndarray:
    """(K, H, W) float64 softmax of each pixel's owning tile (the last in
    grid order whose interior holds it), from the port's float32 model."""
    s, m = TILE - 2 * MARGIN, MARGIN
    origins, logits, _ = tile_logits(model, img, TILE, m, s)
    out = np.zeros((max(HEIGHT, s), max(WIDTH, s), N_CLASSES))
    for (r, c), lg in zip(origins, logits):
        r0, c0 = min(r, out.shape[0] - s), min(c, out.shape[1] - s)
        out[r0:r0 + s, c0:c0 + s] = softmax64(lg[m:m + s, m:m + s])
    return np.moveaxis(out[:HEIGHT, :WIDTH], -1, 0)


def stitched(model, img: np.ndarray, method: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(class, prob, near-tie) (H, W) of a sweep method over tiles at stride
    TILE / 2 with margin TILE / 4, composed in float64 from the port's
    whole-tile logits."""
    m = TILE // 4
    if method == "exact-clipping":
        p = owned_probs(model, img)
        return p.argmax(0), p.max(0), exact_ties(model, img, TILE)
    origins, logits, (Hp, Wp) = tile_logits(model, img, TILE, m, TILE // 2)
    if method == "max":
        best = np.zeros((2, Hp, Wp))  # the two largest covering maxprobs
        cls = np.zeros((Hp, Wp), int)
        win_gap = np.full((Hp, Wp), np.inf)
        for (r, c), lg in zip(origins, logits):
            p = softmax64(lg)
            top2 = -np.sort(-lg, axis=-1)[..., :2]
            win = (slice(r, r + TILE), slice(c, c + TILE))
            new = p.max(-1) > best[0][win]
            best[1][win] = np.where(new, best[0][win], np.maximum(best[1][win], p.max(-1)))
            best[0][win] = np.where(new, p.max(-1), best[0][win])
            cls[win] = np.where(new, p.argmax(-1), cls[win])
            win_gap[win] = np.where(new, top2[..., 0] - top2[..., 1], win_gap[win])
        ties = (best[0] - best[1] < 1e-5) | (win_gap < 1e-4)
        crop = (slice(m, m + HEIGHT), slice(m, m + WIDTH))
        return cls[crop], best[0][crop], ties[crop]
    w = patch_weights(TILE) if method == "average_weights" else np.ones((TILE, TILE))
    acc, div = np.zeros((Hp, Wp, N_CLASSES)), np.zeros((Hp, Wp))
    for (r, c), lg in zip(origins, logits):
        acc[r:r + TILE, c:c + TILE] += softmax64(lg) * w[..., None]
        div[r:r + TILE, c:c + TILE] += w
    mean = (acc / np.maximum(div, 1e-8)[..., None])[m:m + HEIGHT, m:m + WIDTH]
    top2 = -np.sort(-mean, axis=-1)[..., :2]
    return mean.argmax(-1), mean.max(-1), top2[..., 0] - top2[..., 1] < 1e-5


def assert_probs_close(have: np.ndarray, want: np.ndarray) -> None:
    d = np.abs(have.astype(int) - np.round(255 * want).astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999


@pytest.mark.parametrize("arch", ARCHS)
def test_argmax_matches_flairtpu(setup, arch, monkeypatch):
    """The device route's raster against flairtpu's (one run_pipeline, on
    its streaming route, whose program compiles in less time)."""
    from flairtpu import config as flax_cfg
    from flairtpu.zone.engine import run_pipeline

    make = setup["make_config"]
    have = read(run_port(setup["tmp"], make(arch, f"port_{arch}"))[0])
    cfg = flax_cfg.validate_detect_config(make(arch, f"ref_{arch}"))
    monkeypatch.setenv("FLAIRTPU_STREAMING_ZONE", "1")
    run_pipeline(cfg)
    assert_argmax_close(have, read(raster(cfg)),
                        exact_ties(setup["models"][arch], setup["img"], TILE))


@pytest.mark.parametrize("arch", ARCHS)
def test_class_prob_follows_the_tiles(setup, arch):
    """class_prob (the tail's probs mode): every band round(255 * softmax)
    of the owning tile's logits, within 1."""
    cfg = setup["make_config"](arch, f"port_cp_{arch}", output_type="class_prob")
    have = read(run_port(setup["tmp"], cfg)[0])
    assert have.shape == (N_CLASSES, HEIGHT, WIDTH)
    assert_probs_close(have, owned_probs(setup["models"][arch], setup["img"]))


def test_streaming_and_banded_equal_the_device_route(setup, monkeypatch):
    """The streaming route (host stitchers, the tail's cropped payloads),
    argmax and class_prob, and the banded route (FLAIRTPU_ZONE_BANDS=2):
    bit for bit the device route."""
    make, tmp = setup["make_config"], setup["tmp"]
    device = {kind: read(run_port(tmp, make(ROUTES, f"dev_{kind}", output_type=kind))[0])
              for kind in ("argmax", "class_prob")}
    with monkeypatch.context() as mp:
        mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        for kind in ("argmax", "class_prob"):
            path, stats = run_port(tmp, make(ROUTES, f"stream_{kind}", output_type=kind))
            assert "reader_wait_seconds" in stats
            np.testing.assert_array_equal(read(path), device[kind])
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "2")
    path, stats = run_port(tmp, make(ROUTES, "banded"))
    assert stats["bands"] == 2
    np.testing.assert_array_equal(read(path), device["argmax"])


def test_sweep_four_methods_follow_the_tiles(setup):
    """``-c`` with the four stitching methods at stride 32 (each pixel under
    up to four tiles): the tail's logits mode at margin 0 through the
    stitches (and its argmax mode for exact-clipping), against the float64
    composition of the same tiles' logits."""
    cfg = setup["make_config"](ROUTES, "sweep", compare=True, strategies=copy.deepcopy(SWEEP),
                               overlap_strat=True)
    run_port(setup["tmp"], cfg, "-c")
    out = next(p for p in Path(cfg["output_path"]).iterdir() if p.is_dir())
    for method in METHODS:
        name = (f"zone_size={TILE}_stride={TILE // 2}_margin={TILE // 4}_padding=no-padding"
                f"_stitching={method}.tif")
        have = read(out / name)
        cls, prob, ties = stitched(setup["models"][ROUTES], setup["img"], method)
        assert have.shape == (2, HEIGHT, WIDTH) and (have[1] > 0).all(), method
        np.testing.assert_array_equal(have[0][~ties], cls[~ties], err_msg=method)
        assert np.abs(have[1].astype(int) - np.round(255 * prob)).max() <= 1, method


def test_batch_mode(setup):
    """``-b -m`` over a department of two zones: each raster bit for bit the
    port's single-zone run of the same zone."""
    tmp, make = setup["tmp"], setup["make_config"]
    dpt = "D099_2021"
    dept, truth = tmp / "dept" / dpt, tmp / "dept_truth"
    tr = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    for zone, seed in (("Z1_AA", 31), ("Z2_BB", 32)):
        rng = np.random.default_rng(seed)
        (dept / zone).mkdir(parents=True)
        (truth / dpt / zone).mkdir(parents=True)
        write_array(dept / zone / f"{dpt}_{zone}_irc.tif",
                    rng.integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8), transform=tr,
                    crs=2154)
        write_array(truth / dpt / zone / "truth.tif",
                    rng.integers(1, N_CLASSES + 1, (HEIGHT, WIDTH)).astype(np.uint8),
                    transform=tr, crs=2154)
    classes = {i + 1: [1, f"class_{i}"] for i in range(N_CLASSES)}
    cfg = make(ROUTES, "port_batch", input_path=str(dept), truth_root=str(truth),
               truth_path=str(truth / dpt / "Z1_AA" / "truth.tif"), data_type="irc",
               input_img_path=str(dept / "missing.tif"), classes=classes)
    conf = tmp / "port_batch.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    stats = detect_main([f"--conf={conf}", "-b", "-m"])
    assert [z["zone"] for z in stats["zones"]] == ["Z1_AA", "Z2_BB"]
    method = "size=64_stride=32_margin=16_padding=no-padding_stitching=exact-clipping"
    for zone in ("Z1_AA", "Z2_BB"):
        single = make(ROUTES, f"single_{zone}", classes=classes,
                      input_img_path=str(dept / zone / f"{dpt}_{zone}_irc.tif"))
        want = read(run_port(tmp, single)[0])
        have = read(tmp / "port_batch" / f"{dpt}_{zone}_irc-ARGMAX-S_{method}.tif")
        np.testing.assert_array_equal(have, want)
