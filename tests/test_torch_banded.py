"""The banded exact-clipping route (``FLAIRTPU_ZONE_BANDS``) on the CPU
(use_gpu: false): its band plans, the port's banded raster against its
unbanded one, and both packages' banded rasters.

Zone: 90x70, whose last row and column of tiles realign (5 tile rows);
32-pixel tiles, margin 8, stride 16; resnet18-unet, 4 classes, one
numpy-seeded .pth for both packages.

Bounds: the port's banded raster equals its unbanded raster bit for bit,
and flairtpu's banded raster its own unbanded one; against flairtpu,
classes equal except at near-ties (``test_torch_compare.near_ties``), prob
|diff| <= 1 with >= 99.9% of pixels equal; band windows exactly the
tile-order loop.
"""

import numpy as np
import pytest
import torch

from flairtpu import config as flax_cfg
from flairtpu.zone import engine as flax_eng
from flairtpu_torch import config as cfgmod
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import band_plans, band_rows, zone_bands
from flairtpu_torch.zone.grid import slice_grid
from tests.test_torch_compare import near_ties
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
SIZE, MARGIN, STRIDE = 32, 8, 16
WIDTH, HEIGHT = 90, 70
N_ROWS = 5  # distinct tile rows of the zone
# 2 and 3 bands; 4 (three bands: one of the ceil(5 / 4) = 2 row cuts is
# empty); one band a row; more bands than rows (the unbanded route)
BANDS = [2, 3, 4, 5, 50]


def read(path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_banded")
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(17)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)
    img = np.random.default_rng(8).integers(0, 255, (5, HEIGHT, WIDTH)).astype(np.uint8)
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
            "batch_size": 4, "use_gpu": False, "num_worker": 1, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
        }
        cfg.update(over)
        return cfg

    # flairtpu unbanded and banded, one engine for every run
    refs = {}
    engine = None
    for n in (1, 2, 3):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FLAIRTPU_ZONE_BANDS", str(n))
            cfg = flax_eng.setup_out_path(flax_cfg.validate_detect_config(
                make_config(f"ref_bands{n}")))
            if engine is None:
                engine = flax_eng.ZoneEngine(cfg, *flax_eng.prepare_model(cfg))
            engine._staged_zone = None  # stage anew: the banded route pads its own copy
            path, _, _ = flax_eng.run_single(cfg, engine, STRIDE, "exact-clipping")
            refs[n] = read(path)
    return dict(tmp=tmp, model=model, img=img, make_config=make_config, refs=refs)


def run_port(setup, n_bands: int, batch: int, staged: bool = True) -> tuple[np.ndarray, dict]:
    """One port run_single with FLAIRTPU_ZONE_BANDS = n_bands; ``staged``
    False passes a zone staged without padding (as a compare sweep's is)."""
    cfg = cfgmod.validate_detect_config(setup["make_config"](
        f"port_bands{n_bands}_b{batch}_{staged}", batch_size=batch))
    cfg = eng.setup_out_path(cfg)
    dev = torch.device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLAIRTPU_ZONE_BANDS", str(n_bands))
        model, tail = eng.prepare_model(cfg, dev)
        zone = eng.stage_zone(cfg if staged else dict(cfg, compare=True), dev)
        path, stats, _ = eng.run_single(cfg, model, tail, dev, STRIDE, "exact-clipping",
                                        staged=zone)
    return read(path), stats


def test_grid_has_the_rows_the_cases_need():
    grid = slice_grid(WIDTH, HEIGHT, SIZE, MARGIN, STRIDE)
    assert len({t.row0 for t in grid.tiles}) == N_ROWS
    assert [len(band_rows([t.row0 for t in grid.tiles], n)) for n in BANDS] == [2, 3, 3, 5, 5]


@pytest.mark.parametrize("n_bands,method,out_type,want", [
    (1, "exact-clipping", "argmax", 0), (2, "exact-clipping", "argmax", 2),
    (N_ROWS, "exact-clipping", "argmax", N_ROWS), (N_ROWS + 1, "exact-clipping", "argmax", 0),
    (2, "exact-clipping", "class_prob", 0), (2, "average", "argmax", 0)])
def test_zone_bands_takes_flairtpus_condition(monkeypatch, n_bands, method, out_type, want):
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", str(n_bands))
    grid = slice_grid(WIDTH, HEIGHT, SIZE, MARGIN, STRIDE)
    assert zone_bands(method, out_type, grid.tiles) == want


@pytest.mark.parametrize("n_bands", BANDS)
def test_band_windows_match_tile_order_loop(n_bands):
    """Each band's windows, written in band planes, give its owned rows the
    owners of a numpy tile-order loop over the band's tiles, which are the
    owners of the loop over the whole zone; owned rows are disjoint and
    cover the zone."""
    grid = slice_grid(WIDTH, HEIGHT, SIZE, MARGIN, STRIDE)
    s = SIZE - 2 * MARGIN
    Ho, Wo = max(HEIGHT, s), max(WIDTH, s)
    whole = np.full((Ho, Wo), -1)
    for i, t in enumerate(grid.tiles):  # the reference's tile-order writes
        whole[min(t.irow0, Ho - s):min(t.irow0, Ho - s) + s,
              min(t.icol0, Wo - s):min(t.icol0, Wo - s) + s] = i
    covered = np.zeros(Ho, int)
    plans = band_plans(grid, min(n_bands, N_ROWS), 4)
    for plan in plans:
        top = plan["rows"][0] - MARGIN  # the band's first tile row
        band_tiles = [i for i, t in enumerate(grid.tiles)
                      if top <= t.row0 <= top + plan["rows"][1] - SIZE]
        assert plan["tiles"] == band_tiles == sorted(band_tiles)
        loop = np.full((plan["out_h"], Wo), -1)
        got = np.full((plan["out_h"], Wo), -1)
        n = len(band_tiles)
        assert len(plan["windows"]) == len(plan["origins"]) == n + (-n) % 4
        assert not plan["windows"][n:].any()  # padding duplicates own nothing
        assert (plan["origins"][n:] == plan["origins"][n - 1]).all()
        for i, (r0, c0, rlo, rhi, clo, chi) in zip(band_tiles, plan["windows"]):
            t = grid.tiles[i]
            R0 = min(t.irow0, Ho - s) - plan["out_lo"]
            assert r0 == R0 and 0 <= r0 <= plan["out_h"] - s
            loop[R0:R0 + s, c0:c0 + s] = i
            block = got[r0 + rlo:r0 + rhi, c0 + clo:c0 + chi]
            assert (block == -1).all()  # disjoint
            block[...] = i
        lo, hi = plan["own"]
        np.testing.assert_array_equal(got[lo:hi], loop[lo:hi])
        np.testing.assert_array_equal(got[lo:hi], whole[plan["out_lo"] + lo:plan["out_lo"] + hi])
        covered[plan["out_lo"] + lo:plan["out_lo"] + hi] += 1
        # origins gather inside the slab
        assert (plan["origins"][:, 0] >= 0).all()
        assert (plan["origins"][:, 0] + SIZE <= plan["rows"][1]).all()
    np.testing.assert_array_equal(covered, 1)
    # bands run in descending row order
    assert [p["rows"][0] for p in plans] == sorted((p["rows"][0] for p in plans), reverse=True)


@pytest.mark.parametrize("batch", [4, 7])
@pytest.mark.parametrize("n_bands", BANDS)
def test_banded_equals_unbanded(setup, n_bands, batch):
    """Bit for bit, with batches that leave both routes padding
    duplicates."""
    unbanded, _ = run_port(setup, 1, batch)
    banded, stats = run_port(setup, n_bands, batch)
    np.testing.assert_array_equal(banded, unbanded)
    assert (banded[1] > 0).all()
    if n_bands <= N_ROWS:
        assert stats["bands"] == len(band_rows(list(range(N_ROWS)), n_bands))
        for key in ("h2d", "compute", "d2h", "wall"):
            assert stats[f"{key}_seconds"] >= 0.0
    else:
        assert "bands" not in stats


def test_banded_pads_a_zone_staged_without_padding(setup):
    """A zone staged for a sweep (no padding, uploaded) runs banded all the
    same: the route pads its own host copy."""
    plain, _ = run_port(setup, 1, 4)
    banded, stats = run_port(setup, 3, 4, staged=False)
    assert stats["bands"] == 3
    np.testing.assert_array_equal(banded, plain)


def test_stage_zone_pads_for_the_banded_route(setup, monkeypatch):
    cfg = cfgmod.validate_detect_config(setup["make_config"]("unused"))
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "2")
    staged = eng.stage_zone(cfg, torch.device("cpu"))
    (lo, hi_r, hi_c), zone_p = staged["zone_padded"]
    assert "zone_dev" not in staged and (lo, hi_r, hi_c) == (MARGIN, MARGIN, MARGIN)
    assert tuple(zone_p.shape) == (HEIGHT + 2 * MARGIN, WIDTH + 2 * MARGIN, 5)
    np.testing.assert_array_equal(zone_p[lo:lo + HEIGHT, lo:lo + WIDTH].numpy(),
                                  np.moveaxis(setup["img"], 0, -1))
    assert int(zone_p[:lo].sum()) == int(zone_p[:, :lo].sum()) == 0
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "1")
    assert "zone_dev" in eng.stage_zone(cfg, torch.device("cpu"))
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "2")
    assert "zone_dev" in eng.stage_zone(dict(cfg, output_type="class_prob"),
                                        torch.device("cpu"))


@pytest.mark.parametrize("n_bands", [2, 3])
def test_flairtpu_banded_equals_its_unbanded(setup, n_bands):
    np.testing.assert_array_equal(setup["refs"][n_bands], setup["refs"][1])


@pytest.mark.parametrize("n_bands", [2, 3])
def test_banded_matches_flairtpu(setup, n_bands):
    want = setup["refs"][n_bands]
    have, _ = run_port(setup, n_bands, 4)
    assert have.shape == want.shape == (2, HEIGHT, WIDTH)
    ties = near_ties(setup["model"], setup["img"], "exact-clipping")
    np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
    dprob = np.abs(have[1].astype(int) - want[1].astype(int))
    assert dprob.max() <= 1 and (dprob == 0).mean() >= 0.999
