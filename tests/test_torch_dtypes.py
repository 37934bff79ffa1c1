"""Zones that are not uint8 (uint16, int16, float32) on the CPU (use_gpu:
false): the typed gather's plain version against flairtpu's jitted gather
and ``normalize_device``, and both zone routes of the port against
flairtpu's device route, under ``scaling`` (which divides by 255 whatever
the dtype, as flairtpu does) and ``custom``.

Zones: 90x70 (last row and column of tiles realigned), 5 channels;
32-pixel tiles, margin 8, stride 16; resnet18-unet, 4 classes, one
numpy-seeded .pth for both packages.

Bounds: the gather exactly equal in float32 (and its bfloat16 output the
cast of that); rasters: classes equal except where the port's float32
top-2 logit gap is below 1e-4, prob |diff| <= 1 with >= 99.9% of pixels
equal; the port's two routes bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.data.normalize import normalize_device
from flairtpu.zone import engine as flax_eng
from flairtpu.zone.device_engine import DeviceZoneRunner as FlaxRunner
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import estimate_bytes, zone_padding
from flairtpu_torch.zone.grid import slice_grid
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
SIZE, MARGIN, STRIDE = 32, 8, 16
WIDTH, HEIGHT = 90, 70
DTYPES = ["uint16", "int16", "float32"]
# per dtype: a 12-bit image, an elevation with negative values, a float
# elevation; and custom means and stds of their scale
CUSTOM = {
    "uint16": ((2000.0, 2100.5, 1900.25, 2500.0, 300.5), (800.0, 750.5, 820.0, 900.25, 120.0)),
    "int16": ((400.0, -50.5, 120.25, 800.0, 10.0), (300.0, 250.5, 280.0, 310.75, 90.0)),
    "float32": ((210.5, 190.0, 205.25, 230.0, 12.5), (80.0, 75.5, 82.0, 90.25, 6.0)),
}
NORMS = ["scaling", "custom"]


def random_zone(dtype: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dtype == "uint16":
        return rng.integers(0, 4096, shape).astype(np.uint16)
    if dtype == "int16":
        return rng.integers(-1000, 3000, shape).astype(np.int16)
    return (rng.standard_normal(shape) * 80.0 + 200.0).astype(np.float32)


def norm_config(dtype: str, norm: str) -> list[dict]:
    means, stds = CUSTOM[dtype] if norm == "custom" else ((), ())
    return [{"norm_type": norm, "norm_means": list(means), "norm_stds": list(stds)}]


def norm_args(dtype: str, norm: str) -> dict:
    means, stds = CUSTOM[dtype] if norm == "custom" else ((), ())
    return dict(norm_type=norm, means=means, stds=stds)


def read(path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_typed_gather_plain_matches_flairtpu(dtype, norm):
    zone = random_zone(dtype, (70, 90, 5), 7)
    rng = np.random.default_rng(3)
    origins = np.stack([rng.integers(0, 70 - SIZE + 1, 6), rng.integers(0, 90 - SIZE + 1, 6)],
                       axis=1).astype(np.int32)
    runner = FlaxRunner({"img_pixels_detection": SIZE, "margin": MARGIN, "batch_size": 4,
                         "n_classes": N_CLASSES, "output_type": "argmax",
                         "norma_task": norm_config(dtype, norm)}, None, None, None)
    want = np.array(jax.jit(lambda z, o: normalize_device(
        runner._gather(z, o), src_dtype=np.uint8, **runner.norm))(zone, origins))
    ga.launches = ga.typed_launches = 0
    got = ga.gather_normalize(torch.from_numpy(zone), torch.from_numpy(origins), SIZE,
                              out_dtype=torch.float32, **norm_args(dtype, norm))
    assert ga.launches == ga.typed_launches == 0  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == (6, SIZE, SIZE, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    got16 = ga.gather_normalize(torch.from_numpy(zone), torch.from_numpy(origins), SIZE,
                                out_dtype=torch.bfloat16, **norm_args(dtype, norm))
    assert torch.equal(got16, torch.from_numpy(want).to(torch.bfloat16))


def test_scaling_divides_every_dtype_by_255():
    """flairtpu's zone programs scale as uint8 whatever the raster's dtype
    (ROADMAP queue 3); the port does the same, in one place."""
    zone = torch.from_numpy(np.full((SIZE, SIZE, 1), 510, np.uint16))
    x = ga.gather_normalize(zone, torch.zeros((1, 2), dtype=torch.int32), SIZE, "scaling")
    assert ga.SCALE_DTYPE == np.uint8
    assert float(x[0, 0, 0, 0]) == np.float32(510) * (np.float32(1) / np.float32(255))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dtypes")
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(19)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)
    zones = {}
    for k, dtype in enumerate(DTYPES):
        img = random_zone(dtype, (5, HEIGHT, WIDTH), 30 + k)
        write_array(tmp / f"{dtype}.tif", img,
                    transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                    crs=2154, blockxsize=64, blockysize=64)
        zones[dtype] = (tmp / f"{dtype}.tif", img)

    def make_config(dtype: str, norm: str, out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone-ARGMAX",
            "input_img_path": str(zones[dtype][0]), "channels": [1, 2, 3, 4, 5],
            "img_pixels_detection": SIZE, "margin": MARGIN, "output_type": "argmax",
            "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": norm_config(dtype, norm),
        }
        cfg.update(over)
        return cfg

    # flairtpu's device route, one model for every run (its device runner
    # keeps the normalization of the config it was made with: a new one a run)
    refs = {}
    engine = None
    for norm in NORMS:
        for dtype in DTYPES:
            cfg = flax_eng.setup_out_path(flax_cfg.validate_detect_config(
                make_config(dtype, norm, f"ref_{dtype}_{norm}")))
            if engine is None:
                engine = flax_eng.ZoneEngine(cfg, *flax_eng.prepare_model(cfg))
            engine._device_runner = None
            path, _, _ = flax_eng.run_single(cfg, engine, STRIDE, "exact-clipping")
            refs[dtype, norm] = read(path)
    return dict(model=model, zones=zones, make_config=make_config, refs=refs, tmp=tmp)


def run_port(setup, dtype: str, norm: str, streaming: bool) -> tuple[np.ndarray, dict]:
    route = "stream" if streaming else "device"
    cfg = eng.setup_out_path(cfgmod.validate_detect_config(
        setup["make_config"](dtype, norm, f"port_{route}_{dtype}_{norm}")))
    with pytest.MonkeyPatch.context() as mp:
        if streaming:
            mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        else:
            mp.delenv("FLAIRTPU_STREAMING_ZONE", raising=False)
        model, tail = eng.prepare_model(cfg, torch.device("cpu"))
        path, stats, _ = eng.run_single(cfg, model, tail, torch.device("cpu"), STRIDE,
                                        "exact-clipping")
    return read(path), stats


def exact_ties(model, img: np.ndarray, dtype: str, norm: str) -> np.ndarray:
    """(H, W) pixels whose tile-order owner's top-2 logit gap (the port's
    float32 model on the CPU) is below 1e-4."""
    s = SIZE - 2 * MARGIN
    grid = slice_grid(WIDTH, HEIGHT, SIZE, MARGIN, STRIDE)
    lo, hi_r, hi_c = zone_padding(HEIGHT, WIDTH, SIZE, MARGIN)
    zone = torch.from_numpy(np.pad(np.moveaxis(img, 0, -1), ((lo, hi_r), (lo, hi_c), (0, 0))))
    origins = torch.tensor([(t.row0 + lo, t.col0 + lo) for t in grid.tiles], dtype=torch.int32)
    with torch.inference_mode():
        x = ga.gather_normalize_plain(zone, origins, SIZE, **norm_args(dtype, norm))
        logits = model(x).double().numpy()
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    gap = top2[..., 0] - top2[..., 1]
    Ho, Wo = max(HEIGHT, s), max(WIDTH, s)
    ties = np.zeros((Ho, Wo), bool)
    for t, g in zip(grid.tiles, gap):
        r0, c0 = min(t.irow0, Ho - s), min(t.icol0, Wo - s)
        ties[r0:r0 + s, c0:c0 + s] = g[MARGIN:MARGIN + s, MARGIN:MARGIN + s] < 1e-4
    return ties[:HEIGHT, :WIDTH]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_typed_zone_matches_flairtpu_on_both_routes(setup, dtype, norm):
    want = setup["refs"][dtype, norm]
    device, stats = run_port(setup, dtype, norm, streaming=False)
    streamed, sstats = run_port(setup, dtype, norm, streaming=True)
    assert "h2d_seconds" in stats and "stitch_seconds" in sstats
    np.testing.assert_array_equal(streamed, device)
    assert device.shape == want.shape == (2, HEIGHT, WIDTH)
    ties = exact_ties(setup["model"], setup["zones"][dtype][1], dtype, norm)
    np.testing.assert_array_equal(device[0][~ties], want[0][~ties])
    dprob = np.abs(device[1].astype(int) - want[1].astype(int))
    assert dprob.max() <= 1 and (dprob == 0).mean() >= 0.999
    assert (device[1] > 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_typed_zone_staged_in_its_dtype(setup, dtype):
    cfg = cfgmod.validate_detect_config(setup["make_config"](dtype, "scaling", "unused"))
    staged = eng.stage_zone(cfg, torch.device("cpu"))
    want = np.moveaxis(setup["zones"][dtype][1], 0, -1)
    assert staged["zone_dev"].dtype == eng.torch_dtype(dtype)
    np.testing.assert_array_equal(staged["zone_host"].numpy(), want)


def test_estimate_counts_the_itemsize():
    grid = slice_grid(WIDTH, HEIGHT, SIZE, MARGIN, STRIDE)
    one = estimate_bytes(grid, 5, N_CLASSES, "exact-clipping", "argmax", 4)
    two = estimate_bytes(grid, 5, N_CLASSES, "exact-clipping", "argmax", 4, 2)
    planes = HEIGHT * WIDTH * 2
    assert two - planes == 2 * (one - planes)


@pytest.mark.parametrize("streaming", [False, True])
def test_other_dtypes_raise(setup, tmp_path, monkeypatch, streaming):
    img = np.random.default_rng(2).integers(0, 70000, (5, 40, 40)).astype(np.uint32)
    write_array(tmp_path / "zone32.tif", img, transform=Affine.from_origin(0.0, 0.0, 0.2, 0.2),
                crs=2154)
    cfg = setup["make_config"]("uint16", "scaling", str(tmp_path / "out"),
                               input_img_path=str(tmp_path / "zone32.tif"))
    conf = tmp_path / "detect.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    if streaming:
        monkeypatch.setenv("FLAIRTPU_STREAMING_ZONE", "1")
    route = "the streaming route" if streaming else "the device route"
    with pytest.raises(NotImplementedError, match=f"uint32 zone rasters on {route}.*slice 2"):
        detect_main([f"--conf={conf}"])
