"""The streaming zone route on the CPU (use_gpu: false): the full-tile
softmax payloads' plain versions, the host stitchers, and the route end to
end, against flairtpu's streaming route and against the port's own device
route.

Zones: 90x70, whose last row and column of tiles realign, and 24x20,
smaller than one tile; 32-pixel tiles, margin 8, stride 16; resnet18-unet,
4 classes, one numpy-seeded .pth for both packages.

Bounds: payloads |diff| <= 1e-6 (probs) and relative 1e-6 (prob), classes
equal except at top-2 gaps below 1e-6; host stitchers bit for bit; against
flairtpu, classes equal except at near-ties (``test_torch_compare.near_ties``)
and prob |diff| <= 1 with >= 99.9% of pixels equal, class_prob every band
|diff| <= 1; the port's two routes bit for bit.
"""

import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.io.tiff import TiffWriter as FlaxWriter
from flairtpu.ops.fused import softmax_argmax as flax_softmax_argmax
from flairtpu.zone import engine as flax_eng
from flairtpu.zone import stitch as flax_stitch
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.io import TiffReader, TiffWriter
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import tile_softmax as ts
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone import stitch as port_stitch
from flairtpu_torch.zone.device_engine import DeviceZoneRunner
from flairtpu_torch.zone.grid import slice_grid
from tests.test_torch_compare import near_ties
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
SIZE, MARGIN, STRIDE = 32, 8, 16
ZONES = {"realigned_90x70": (90, 70, 5), "below_tile_24x20": (24, 20, 6)}
METHODS = ["exact-clipping", "average", "average_weights", "max"]
# (zone, method, output_type) held against flairtpu's streaming route
REFERENCE_CASES = [("realigned_90x70", m, "argmax") for m in METHODS] + [
    ("below_tile_24x20", "exact-clipping", "argmax"),
    ("realigned_90x70", "exact-clipping", "class_prob")]


def read(path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_streaming")
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(13)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)
    zones = {}
    for name, (w, h, seed) in ZONES.items():
        img = np.random.default_rng(seed).integers(0, 255, (5, h, w)).astype(np.uint8)
        write_array(tmp / f"{name}.tif", img,
                    transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                    crs=2154, blockxsize=64, blockysize=64)
        zones[name] = (tmp / f"{name}.tif", img)

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

    # flairtpu's streaming route, one engine (and its compiled programs) for
    # every reference run
    refs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        engine = None
        for zone, method, out_type in REFERENCE_CASES:
            cfg = flax_eng.setup_out_path(flax_cfg.validate_detect_config(make_config(
                zone, f"ref_{zone}_{method}_{out_type}", output_type=out_type)))
            if engine is None:
                engine = flax_eng.ZoneEngine(cfg, *flax_eng.prepare_model(cfg))
            path, _, _ = flax_eng.run_single(cfg, engine, STRIDE, method)
            refs[zone, method, out_type] = read(path)
    return dict(tmp=tmp, model=model, zones=zones, make_config=make_config, refs=refs)


def run_port(setup, zone: str, method: str, out_type: str, streaming: bool,
             out: str | None = None, **over) -> tuple[np.ndarray, dict]:
    """One port run_single on the CPU; the raster and the stats."""
    route = "stream" if streaming else "device"
    cfg = cfgmod.validate_detect_config(setup["make_config"](
        zone, out or f"port_{route}_{zone}_{method}_{out_type}", output_type=out_type,
        **over))
    cfg = eng.setup_out_path(cfg)
    with pytest.MonkeyPatch.context() as mp:
        if streaming:
            mp.setenv("FLAIRTPU_STREAMING_ZONE", "1")
        else:
            mp.delenv("FLAIRTPU_STREAMING_ZONE", raising=False)
        model, tail = eng.prepare_model(cfg, torch.device("cpu"))
        path, stats, _ = eng.run_single(cfg, model, tail, torch.device("cpu"), STRIDE, method)
    return read(path), stats


# ---------------------------------------------------------------------------
# the payload kernel's plain versions
# ---------------------------------------------------------------------------

def random_logits(k: int) -> np.ndarray:
    return (np.random.default_rng(k).standard_normal((3, 16, 16, k)) * 3).astype(np.float32)


@pytest.mark.parametrize("k", [4, 19])
def test_tile_probs_plain_matches_jax(k):
    x = random_logits(k)
    want = np.asarray(jax.nn.softmax(x, axis=-1).transpose(0, 3, 1, 2))
    got = ts.tile_probs_plain(torch.from_numpy(x)).numpy()
    assert got.shape == (3, k, 16, 16) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("k", [4, 19])
def test_tile_argmax_plain_matches_flairtpu(k):
    x = random_logits(k)
    want_c, want_p = (np.asarray(a) for a in flax_softmax_argmax(x))
    got_c, got_p = (a.numpy() for a in ts.tile_argmax_plain(torch.from_numpy(x)))
    assert got_c.dtype == np.uint8 and got_p.dtype == np.float32
    top2 = -np.sort(-x, axis=-1)[..., :2]
    ties = top2[..., 0] - top2[..., 1] < 1e-6
    np.testing.assert_array_equal(got_c[~ties], want_c[~ties])
    assert (np.abs(got_p - want_p) / want_p).max() <= 1e-6


def test_tile_softmax_wrappers_run_plain_on_cpu_and_raise_elsewhere():
    x = torch.from_numpy(random_logits(4))
    for name in ts.launches:
        ts.launches[name] = 0
    assert torch.equal(ts.tile_probs(x), ts.tile_probs_plain(x))
    for got, want in zip(ts.tile_argmax(x), ts.tile_argmax_plain(x)):
        assert torch.equal(got, want)
    assert ts.launches == {"tile_probs": 0, "tile_argmax": 0}
    meta = torch.empty((1, 8, 8, 4), device="meta")
    for fn in (ts.tile_probs, ts.tile_argmax):
        with pytest.raises(RuntimeError, match="unsupported device"):
            fn(meta)


# ---------------------------------------------------------------------------
# host stitchers
# ---------------------------------------------------------------------------

def random_payload(rng, kind: str, S: int, s: int, k: int):
    if kind == "cropped_argmax":
        return (rng.integers(0, k, (s, s)).astype(np.uint8),
                rng.integers(1, 256, (s, s)).astype(np.uint8))
    if kind == "cropped_probs":
        return rng.integers(0, 256, (k, s, s)).astype(np.uint8)
    if kind == "full_probs":
        p = rng.random((k, S, S)).astype(np.float32)
        return p / p.sum(axis=0, dtype=np.float32)
    return (rng.integers(0, k, (S, S)).astype(np.uint8),
            rng.uniform(1.0 / k, 1.0, (S, S)).astype(np.float32))


@pytest.mark.parametrize("storage", ["ram", "memmap"])
@pytest.mark.parametrize("out_type", ["argmax", "class_prob"])
@pytest.mark.parametrize("method", METHODS)
def test_host_stitchers_match_flairtpu(tmp_path, monkeypatch, method, out_type, storage):
    """The same payloads through both packages' stitchers: the same raster,
    bit for bit, with the accumulators in RAM or in disk memmaps."""
    if storage == "memmap":
        monkeypatch.setattr(port_stitch, "_RAM_LIMIT_BYTES", 0)
        monkeypatch.setattr(flax_stitch, "_RAM_LIMIT_BYTES", 0)
    H, W, S, m, k = 37, 45, 16, 4, 5
    grid = slice_grid(W, H, S, m, 8)
    config = {"output_type": out_type, "n_classes": k}
    n_bands = 2 if out_type == "argmax" else k
    rasters = []
    for mod, writer_cls in ((port_stitch, TiffWriter), (flax_stitch, FlaxWriter)):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.tif"
        writer = writer_cls(path, W, H, n_bands, "uint8", compress="lzw", blockxsize=S,
                            blockysize=S)
        stitcher = mod.make_stitcher(method, writer, grid, config)
        if storage == "memmap" and hasattr(stitcher, "div"):
            assert isinstance(stitcher.acc, np.memmap) and isinstance(stitcher.div, np.memmap)
        rng = np.random.default_rng(3)
        for tile in grid.tiles:
            stitcher.add(tile, random_payload(rng, stitcher.needs, S, S - 2 * m, k))
        stitcher.finalize()
        writer.close()
        rasters.append(read(path))
    assert rasters[0].shape == (n_bands, H, W)
    np.testing.assert_array_equal(rasters[0], rasters[1])
    assert not list(tmp_path.glob(".flair-acc-*"))  # memmaps released


# ---------------------------------------------------------------------------
# the route end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zone,method,out_type", REFERENCE_CASES)
def test_streaming_matches_flairtpu(setup, zone, method, out_type):
    want = setup["refs"][zone, method, out_type]
    have, stats = run_port(setup, zone, method, out_type, streaming=True)
    assert stats["tiles"] == len(slice_grid(*ZONES[zone][:2], SIZE, MARGIN, STRIDE))
    assert have.shape == want.shape and have.dtype == np.uint8
    if out_type == "class_prob":
        assert have.shape[0] == N_CLASSES
        assert np.abs(have.astype(int) - want.astype(int)).max() <= 1
        return
    ties = near_ties(setup["model"], setup["zones"][zone][1], method)
    np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
    dprob = np.abs(have[1].astype(int) - want[1].astype(int))
    assert dprob.max() <= 1
    assert (dprob == 0).mean() >= 0.999
    assert (have[1] > 0).all()  # every pixel written


@pytest.mark.parametrize("zone,method,out_type", [
    *[("realigned_90x70", m, t) for m in METHODS for t in ("argmax", "class_prob")],
    ("below_tile_24x20", "exact-clipping", "argmax")])
def test_streaming_equals_device_route(setup, zone, method, out_type):
    """The port's two routes give the same raster bit for bit."""
    streamed, stats = run_port(setup, zone, method, out_type, streaming=True)
    resident, _ = run_port(setup, zone, method, out_type, streaming=False)
    np.testing.assert_array_equal(streamed, resident)
    for key in ("reader_wait", "dispatch", "card_wait", "d2h_wait", "stitch"):
        assert stats[f"{key}_seconds"] >= 0.0
    assert stats["d2h_bytes"] > 0 and len(stats["patch_times_ms"]) == stats["tiles"]


@pytest.mark.parametrize("method", ["exact-clipping", "average_weights"])
def test_streaming_batch_size_invariance(setup, method):
    outs = [run_port(setup, "realigned_90x70", method, "argmax", streaming=True,
                     out=f"port_stream_bs{bs}_{method}", batch_size=bs)[0] for bs in (2, 5)]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_streaming_zero_tile_on_read_error(setup, monkeypatch, capsys):
    """A failing tile read gives a zero tile and a printed line, not a crash
    (reference dataset.py:115-122)."""
    real_read = TiffReader.read
    calls = {"n": 0}

    def flaky_read(self, *a, **k):
        if k.get("boundless"):
            calls["n"] += 1
            if calls["n"] == 3:
                raise OSError("synthetic decode failure")
        return real_read(self, *a, **k)

    monkeypatch.setattr(TiffReader, "read", flaky_read)
    have, stats = run_port(setup, "realigned_90x70", "exact-clipping", "argmax",
                           streaming=True, out="port_stream_flaky")
    monkeypatch.setattr(TiffReader, "read", real_read)
    assert "read error on tile" in capsys.readouterr().out
    assert stats["tiles"] == 30 and (have[1] > 0).all()
    clean, _ = run_port(setup, "realigned_90x70", "exact-clipping", "argmax", streaming=True)
    assert not np.array_equal(have, clean)  # the zero tile changed its window


def test_streaming_failure_stops_the_reader(setup, monkeypatch):
    """A batch that fails on the device raises from the run, and the reader
    thread, blocked on a full queue or not, ends with it."""
    def fail(self, *args):
        raise RuntimeError("synthetic forward failure")

    monkeypatch.setattr(DeviceZoneRunner, "_forward_tiles", fail)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="synthetic forward failure"):
        run_port(setup, "realigned_90x70", "exact-clipping", "argmax", streaming=True,
                 out="port_stream_failure", batch_size=1)
    assert threading.active_count() == before


def test_streaming_non_uint8_zone_raises(setup, tmp_path, monkeypatch):
    """uint8, uint16, int16 and float32 zones stream; others raise."""
    img = np.random.default_rng(2).integers(0, 70000, (5, 40, 40)).astype(np.uint32)
    write_array(tmp_path / "zone32.tif", img, transform=Affine.from_origin(0.0, 0.0, 0.2, 0.2),
                crs=2154)
    cfg = setup["make_config"]("realigned_90x70", str(tmp_path / "out"),
                               input_img_path=str(tmp_path / "zone32.tif"))
    conf = tmp_path / "detect.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("FLAIRTPU_STREAMING_ZONE", "1")
    with pytest.raises(NotImplementedError, match="uint32 zone rasters on the streaming "
                                                  "route.*slice 2"):
        detect_main([f"--conf={conf}"])


def test_streaming_use_gpu_without_cuda_raises(setup, tmp_path, monkeypatch):
    """use_gpu: true on the streaming route needs the card too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FLAIRTPU_STREAMING_ZONE", "1")
    cfg = setup["make_config"]("realigned_90x70", str(tmp_path / "out"), use_gpu=True)
    conf = tmp_path / "detect.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_main([f"--conf={conf}"])
    assert not (tmp_path / "out" / "zone-ARGMAX.tif").exists()


def test_zone_kept_on_host_uploads_at_run_time(setup, monkeypatch, capsys):
    """A budget between the zone's estimate and 4x its bytes: staging keeps
    the zone on the host, the device route uploads it when it runs, and the
    raster is the one of the default budget."""
    cfg = cfgmod.validate_detect_config(setup["make_config"]("realigned_90x70", "unused"))
    nbytes = 90 * 70 * 5
    monkeypatch.setenv("FLAIRTPU_DEVICE_ZONE_BYTES", str(4 * nbytes - 1))
    staged = eng.stage_zone(cfg, torch.device("cpu"))
    assert "zone_dev" not in staged and tuple(staged["zone_host"].shape) == (70, 90, 5)
    late, _ = run_port(setup, "realigned_90x70", "exact-clipping", "argmax", streaming=False,
                       out="port_device_late_upload")
    assert "zone path: device-resident" in capsys.readouterr().out
    monkeypatch.delenv("FLAIRTPU_DEVICE_ZONE_BYTES")
    assert "zone_dev" in eng.stage_zone(cfg, torch.device("cpu"))
    default, _ = run_port(setup, "realigned_90x70", "exact-clipping", "argmax",
                          streaming=False)
    np.testing.assert_array_equal(late, default)


def test_estimate_over_budget_streams(setup, monkeypatch, capsys):
    """Without the switch, a budget below the zone's estimate routes it to
    the streaming route."""
    monkeypatch.setenv("FLAIRTPU_DEVICE_ZONE_BYTES", "10000")
    have, stats = run_port(setup, "realigned_90x70", "max", "argmax", streaming=False,
                           out="port_budget_max")
    assert "zone path: streaming" in capsys.readouterr().out
    assert "stitch_seconds" in stats and "h2d_seconds" not in stats
    streamed, _ = run_port(setup, "realigned_90x70", "max", "argmax", streaming=True)
    np.testing.assert_array_equal(have, streamed)
