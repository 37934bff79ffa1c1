"""flair-detect end to end with slice 5's smp models (deeplabv3plus,
deeplabv3, fpn, pspnet, pan, linknet) on a synthetic zone, CPU (use_gpu:
false): the port's ``detect_main`` against flairtpu's ``run_pipeline`` (its
streaming route, which equals its device route bit for bit) on one .pth per
architecture.

The zone is 100 x 90 (its last row and column of tiles realign), tiles of
64 pixels (PAN 128) with a 16-pixel margin, resnet18 encoders, 4 classes.
Bounds (the frameworks sum convolutions, means, the upsample and softmaxes
in other orders): classes equal except at near-ties, pixels whose owning
tile's top-2 logit gap is below 1e-4 (exact clipping) or whose stitched
mean's top-2 gap is below 1e-5 (average_weights); prob |diff| <= 1 and
equal on >= 99.9% of pixels; class_prob bands likewise. deeplabv3plus also
runs class_prob, the streaming route (against flairtpu's device route and
bit for bit against the port's), the banded route (bit for bit against the
unbanded one) and a sweep's average_weights method.
"""

import copy
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
from flairtpu_torch.zone.weights import patch_weights
from tests.test_torch_models import random_state_dict

ARCHS = ("deeplabv3plus", "deeplabv3", "fpn", "pspnet", "pan", "linknet")
N_CLASSES = 4
WIDTH, HEIGHT, MARGIN = 100, 90, 16
STRIDED = "deeplabv3plus"  # the arch that also runs the other routes
SWEEP = {"tiling": {"enabled": True, "size_range": [64], "stride_range": [0.5]},
         "stitching": {"enabled": True, "methods": ["average_weights"], "margin": [0.25]},
         "padding_overall": None}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile(arch: str) -> int:
    return 128 if arch == "pan" else 64


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_zone_archs")
    img = np.random.default_rng(23).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
    zone = tmp / "zone.tif"
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, blockxsize=64, blockysize=64)
    models = {}
    for i, arch in enumerate(ARCHS):
        model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch).eval()
        model.load_state_dict(random_state_dict(model, np.random.default_rng(60 + i)))
        torch.save(model.state_dict(), tmp / f"resnet18_{arch}.pth")
        models[arch] = model

    def make_config(arch: str, out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone", "input_img_path": str(zone),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": tile(arch),
            "margin": MARGIN, "output_type": "argmax", "n_classes": N_CLASSES,
            "model_weights": str(tmp / f"resnet18_{arch}.pth"),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder":
                                                              f"resnet18_{arch}"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    refs: dict[tuple, Path] = {}

    def reference(arch: str, kind: str = "argmax", **over) -> Path:
        """flairtpu's raster of one configuration, run once, on its
        streaming route (bit for bit its device route's; its per-batch
        program compiles in less time than the device route's scan)."""
        if (arch, kind) not in refs:
            cfg = flax_cfg.validate_detect_config(make_config(arch, f"ref_{arch}_{kind}", **over))
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
                run_pipeline(cfg)
            refs[arch, kind] = raster(cfg)
        return refs[arch, kind]

    return dict(tmp=tmp, img=img, models=models, make_config=make_config,
                reference=reference)


def raster(cfg: dict) -> Path:
    out = Path(cfg["output_path"])
    if cfg.get("compare"):
        out = next(p for p in out.iterdir() if p.is_dir())
    return next(out.glob("*.tif"))


def run_port(tmp: Path, cfg: dict, *flags: str) -> tuple[Path, dict]:
    """The port's raster of one configuration, and the run's stats."""
    conf = tmp / f"{Path(cfg['output_path']).name}.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    stats = detect_main([f"--conf={conf}", *flags])
    return raster(cfg), stats


def read(path: Path) -> np.ndarray:
    with TiffReader(path) as r:
        assert (r.width, r.height) == (WIDTH, HEIGHT) and r.crs == 2154
        return r.read()


def tile_logits(model, img: np.ndarray, size: int, margin: int, stride: int):
    """Every tile's padded origin and float64 whole-tile logits, from the
    port's float32 model."""
    grid = slice_grid(WIDTH, HEIGHT, size, margin, stride)
    pad = ((margin, max(margin, size - HEIGHT - margin)),
           (margin, max(margin, size - WIDTH - margin)))
    zone = np.pad(np.moveaxis(img, 0, -1), pad + ((0, 0),))
    origins = [(t.row0 + margin, t.col0 + margin) for t in grid.tiles]
    with torch.inference_mode():
        x = normalize(torch.from_numpy(np.stack([zone[r:r + size, c:c + size]
                                                 for r, c in origins])), "scaling")
        logits = model(x).double().numpy()
    return origins, logits, zone.shape[:2]


def exact_ties(model, img: np.ndarray, size: int) -> np.ndarray:
    """Pixels whose owning tile (the last in grid order whose interior holds
    it) has a top-2 logit gap below 1e-4."""
    origins, logits, _ = tile_logits(model, img, size, MARGIN, size - 2 * MARGIN)
    s, m = size - 2 * MARGIN, MARGIN
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    ties = np.zeros((max(HEIGHT, s), max(WIDTH, s)), bool)
    for (r, c), gap in zip(origins, top2[..., 0] - top2[..., 1]):
        r0, c0 = min(r, ties.shape[0] - s), min(c, ties.shape[1] - s)
        ties[r0:r0 + s, c0:c0 + s] = gap[m:m + s, m:m + s] < 1e-4
    return ties[:HEIGHT, :WIDTH]


def assert_argmax_close(have: np.ndarray, want: np.ndarray, ties: np.ndarray) -> None:
    assert have.shape == want.shape == (2, HEIGHT, WIDTH) and have.dtype == np.uint8
    np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
    dprob = np.abs(have[1].astype(int) - want[1].astype(int))
    assert dprob.max() <= 1 and (dprob == 0).mean() >= 0.999
    assert (have[1] > 0).all()  # every pixel written


@pytest.mark.parametrize("arch", ARCHS)
def test_argmax_matches_flairtpu(setup, arch):
    cfg = setup["make_config"](arch, f"port_{arch}")
    have = read(run_port(setup["tmp"], cfg)[0])
    want = read(setup["reference"](arch))
    assert_argmax_close(have, want, exact_ties(setup["models"][arch], setup["img"], tile(arch)))


def test_class_prob_matches_flairtpu(setup):
    make = setup["make_config"]
    have = read(run_port(setup["tmp"], make(STRIDED, "port_cp", output_type="class_prob"))[0])
    want = read(setup["reference"](STRIDED, "class_prob", output_type="class_prob"))
    assert have.shape == want.shape == (N_CLASSES, HEIGHT, WIDTH)
    diff = np.abs(have.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


def test_streaming_route(setup, monkeypatch):
    """The streaming route (host stitchers, the tail's cropped payloads):
    bit for bit the port's device route, and against flairtpu's."""
    make, tmp = setup["make_config"], setup["tmp"]
    path, stats = run_port(tmp, make(STRIDED, "port_device"))
    device = read(path)
    assert "h2d_seconds" in stats and "reader_wait_seconds" not in stats
    monkeypatch.setenv("FLAIRTPU_STREAMING_ZONE", "1")
    path, stats = run_port(tmp, make(STRIDED, "port_streaming"))
    have = read(path)
    assert "reader_wait_seconds" in stats
    np.testing.assert_array_equal(have, device)
    assert_argmax_close(have, read(setup["reference"](STRIDED)),
                        exact_ties(setup["models"][STRIDED], setup["img"], tile(STRIDED)))


def test_banded_route(setup, monkeypatch):
    """FLAIRTPU_ZONE_BANDS=2: bit for bit the unbanded raster."""
    make, tmp = setup["make_config"], setup["tmp"]
    device = read(run_port(tmp, make(STRIDED, "port_unbanded"))[0])
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "2")
    path, stats = run_port(tmp, make(STRIDED, "port_banded"))
    assert stats["bands"] == 2
    np.testing.assert_array_equal(read(path), device)


@pytest.mark.parametrize("arch", [STRIDED, "linknet"])
def test_sweep_average_weights_matches_flairtpu(setup, arch):
    """``-c`` with average_weights at stride 32 (each pixel under up to four
    tiles): the whole tiles' logits through the accumulate stitch, upsampled
    by the tail (a strided head) or handed through from the head (linknet)."""
    make = setup["make_config"]
    over = dict(compare=True, strategies=copy.deepcopy(SWEEP), overlap_strat=True)
    have = read(run_port(setup["tmp"], make(arch, f"port_sweep_{arch}", **over), "-c")[0])
    want = read(setup["reference"](arch, "sweep", **over))
    size = tile(arch)
    m = int(0.25 * size)
    origins, logits, (Hp, Wp) = tile_logits(setup["models"][arch], setup["img"], size, m,
                                            size // 2)
    w = patch_weights(size)
    acc, div = np.zeros((Hp, Wp, N_CLASSES)), np.zeros((Hp, Wp))
    for (r, c), lg in zip(origins, logits):
        e = np.exp(lg - lg.max(axis=-1, keepdims=True))
        acc[r:r + size, c:c + size] += e / e.sum(axis=-1, keepdims=True) * w[..., None]
        div[r:r + size, c:c + size] += w
    mean = -np.sort(-acc / np.maximum(div, 1e-8)[..., None], axis=-1)
    ties = (mean[..., 0] - mean[..., 1] < 1e-5)[m:m + HEIGHT, m:m + WIDTH]
    assert_argmax_close(have, want, ties)


def test_unported_knobs_and_training_raise(setup):
    """The knobs run every arch; int8_decoder: 5 (the U-Net's block 4 in
    int8) raises; flair training validates for fpn, manet and unetplusplus
    (every arch trains: tests/test_torch_flair_archs.py); PAN refuses
    tiles under 128 pixels (its pyramid pools the stride-16 map three
    times); MAnet and UNet++ validate, and an arch smp lacks raises with
    the supported list."""
    from flairtpu_torch import config as cfgmod

    make = setup["make_config"]
    for knobs in ({"bn_fold": True}, {"quantize": "int8"},
                  {"quantize": "int8", "int8_decoder": 5}):
        cfgmod.validate_detect_config(make(STRIDED, "knobs", **knobs))
    unet = dict(make(STRIDED, "knobs_unet"), model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}})
    with pytest.raises(NotImplementedError, match="slice 3"):
        cfgmod.validate_detect_config(dict(unet, quantize="int8", int8_decoder=5))
    with pytest.raises(cfgmod.ConfigError, match="at least 128"):
        cfgmod.validate_detect_config(make("pan", "pan64", img_pixels_detection=64))
    for arch in ("manet", "unetplusplus"):
        assert cfgmod.check_smp(f"resnet34_{arch}") == ("resnet34", arch)
    with pytest.raises(NotImplementedError, match="not ported \\(supported: unet"):
        cfgmod.check_smp("resnet34_segformer")
    for arch in ("fpn", "manet", "unetplusplus"):
        train = {"paths": {"out_folder": str(setup["tmp"] / "flair")}, "tasks": {"train": True},
                 "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                     "SegmentationModelsPytorch": {"encoder_decoder":
                                                                   f"resnet34_{arch}"}},
                 "channels": [1, 2, 3, 4, 5], "classes": {1: [1, "a"], 2: [1, "b"]},
                 "accelerator": "cpu"}
        assert cfgmod.validate_train_config(train)["accelerator"] == "cpu"


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
    cfg = make(STRIDED, "port_batch", input_path=str(dept), truth_root=str(truth),
               truth_path=str(truth / dpt / "Z1_AA" / "truth.tif"), data_type="irc",
               input_img_path=str(dept / "missing.tif"), classes=classes)
    conf = tmp / "port_batch.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    stats = detect_main([f"--conf={conf}", "-b", "-m"])
    assert [z["zone"] for z in stats["zones"]] == ["Z1_AA", "Z2_BB"]
    method = "size=64_stride=32_margin=16_padding=no-padding_stitching=exact-clipping"
    for zone in ("Z1_AA", "Z2_BB"):
        single = make(STRIDED, f"single_{zone}", classes=classes,
                      input_img_path=str(dept / zone / f"{dpt}_{zone}_irc.tif"))
        want = read(run_port(tmp, single)[0])
        have = read(tmp / "port_batch" / f"{dpt}_{zone}_irc-ARGMAX-S_{method}.tif")
        np.testing.assert_array_equal(have, want)
