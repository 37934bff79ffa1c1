"""class_prob and the compare sweep (``-c -m``) end to end on synthetic
zones, CPU (use_gpu: false): the port's ``detect_main`` against flairtpu's
``run_pipeline`` on one .pth.

Zones: 90x70, whose last row and column of tiles realign, and 24x20,
smaller than one tile, each laid out as ``<dpt>/<zone>/zone.tif`` with a
truth raster at ``truth/<dpt>/<zone>/truth.tif``. The sweep runs 32-pixel
tiles at stride 16 (each pixel under up to four tiles) with margin 8 and all
four stitching methods.

Bounds (the frameworks sum convolutions and softmaxes in other orders):
class_prob bands |diff| <= 1 and equal on >= 99.9% of pixels; classes equal
except at near-ties: the top-2 gap of the stitched mean below 1e-5
(average), the covering tiles' best two maxprobs within 1e-5 or the
winner's top-2 logit gap below 1e-4 (max), the top-2 logit gap below 1e-4
(exact-clipping); prob |diff| <= 1; per-patch metrics within 1e-3.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.io import TiffReader
from flairtpu.io.tiff import Affine, write_array
from flairtpu.zone.engine import run_pipeline
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.grid import slice_grid
from flairtpu_torch.zone.weights import patch_weights
from tests.test_torch_models import random_state_dict

ROOT = Path(__file__).resolve().parent.parent
N_CLASSES = 4
SIZE, MARGIN, STRIDE = 32, 8, 16
DPT = "D099_2021"
ZONES = {"realigned_90x70": (90, 70, 5), "below_tile_24x20": (24, 20, 6)}
METHODS = ["average", "average_weights", "max", "exact-clipping"]
STRATEGIES = {
    "tiling": {"enabled": True, "size_range": [SIZE], "stride_range": [0.5]},
    "stitching": {"enabled": True, "methods": METHODS, "margin": [0.25]},
    "padding_overall": None,
}


def method_name(stitch: str) -> str:
    return (f"size={SIZE}_stride={STRIDE}_margin={MARGIN}_padding=no-padding"
            f"_stitching={stitch}")


def sweep_dir(out: str) -> Path:
    stamped = [p for p in Path(out).iterdir() if p.is_dir()]
    assert len(stamped) == 1
    return stamped[0]


def read(path: Path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_compare")
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(11)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)
    tr = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    zones = {}
    for name, (w, h, seed) in ZONES.items():
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 255, (5, h, w)).astype(np.uint8)
        for sub, arr, fname in ((tmp / DPT / name, img, "zone.tif"),
                                (tmp / "truth" / DPT / name,
                                 rng.integers(1, N_CLASSES + 1, (h, w)).astype(np.uint8),
                                 "truth.tif")):
            sub.mkdir(parents=True)
            write_array(sub / fname, arr, transform=tr, crs=2154)
        zones[name] = (tmp / DPT / name / "zone.tif", img,
                       tmp / "truth" / DPT / name / "truth.tif")

    def make_config(zone: str, out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "zone-ARGMAX-S",
            "input_img_path": str(zones[zone][0]), "truth_path": str(zones[zone][2]),
            "channels": [1, 2, 3, 4, 5], "img_pixels_detection": SIZE, "margin": MARGIN,
            "output_type": "argmax", "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 2, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
            "overlap_strat": True, "strategies": copy.deepcopy(STRATEGIES),
            "classes": {i + 1: [1, f"class_{i}"] for i in range(N_CLASSES)},
        }
        cfg.update(over)
        return cfg

    def run_port(cfg: dict, *flags: str) -> None:
        conf = tmp / f"{Path(cfg['output_path']).name}.yaml"
        conf.write_text(yaml.safe_dump(cfg))
        detect_main([f"--conf={conf}", *flags])

    out = {}
    for name in ZONES:
        ref = make_config(name, f"ref_sweep_{name}", compare=True, metrics=True)
        run_pipeline(flax_cfg.validate_detect_config(ref))
        ref_cp = make_config(name, f"ref_cp_{name}", output_type="class_prob")
        run_pipeline(flax_cfg.validate_detect_config(ref_cp))
        port = make_config(name, f"port_sweep_{name}")
        run_port(port, "-c", "-m")
        port_cp = make_config(name, f"port_cp_{name}", output_type="class_prob")
        run_port(port_cp)
        out[name] = {"ref_sweep": sweep_dir(ref["output_path"]),
                     "port_sweep": sweep_dir(port["output_path"]),
                     "ref_cp": Path(ref_cp["output_path"]) / "zone-ARGMAX-S.tif",
                     "port_cp": Path(port_cp["output_path"]) / "zone-ARGMAX-S.tif"}
    return dict(tmp=tmp, model=model, zones=zones, make_config=make_config,
                run_port=run_port, out=out)


def tile_logits(model, img: np.ndarray, margin: int):
    """Every tile's float64 logits (N, S, S, K) with its padded origin, and
    the padded plane shape, from the port's float32 model on the CPU."""
    C, H, W = img.shape
    grid = slice_grid(W, H, SIZE, margin, STRIDE)
    pad = ((margin, max(margin, SIZE - H - margin)), (margin, max(margin, SIZE - W - margin)))
    zone = np.pad(np.moveaxis(img, 0, -1), pad + ((0, 0),))
    origins = [(t.row0 + margin, t.col0 + margin) for t in grid.tiles]
    with torch.inference_mode():
        x = normalize(torch.from_numpy(np.stack([zone[r:r + SIZE, c:c + SIZE]
                                                 for r, c in origins])), "scaling")
        logits = model(x).double().numpy()
    return origins, logits, zone.shape[:2], margin


def softmax64(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def near_ties(model, img: np.ndarray, method: str) -> np.ndarray:
    """(H, W) pixels whose stitched class the two frameworks may resolve
    differently."""
    origins, logits, (Hp, Wp), m = tile_logits(model, img, MARGIN)
    H, W = img.shape[1:]
    top2 = -np.sort(-logits, axis=-1)[..., :2]
    lgap = top2[..., 0] - top2[..., 1]
    if method in ("average", "average_weights"):
        w = patch_weights(SIZE) if method == "average_weights" else np.ones((SIZE, SIZE))
        acc = np.zeros((Hp, Wp, N_CLASSES))
        div = np.zeros((Hp, Wp))
        for (r, c), lg in zip(origins, logits):
            acc[r:r + SIZE, c:c + SIZE] += softmax64(lg) * w[..., None]
            div[r:r + SIZE, c:c + SIZE] += w
        mean = -np.sort(-acc / np.maximum(div, 1e-8)[..., None], axis=-1)
        ties = mean[..., 0] - mean[..., 1] < 1e-5
    elif method == "max":
        best = np.zeros((2, Hp, Wp))  # the two largest covering maxprobs
        win_gap = np.full((Hp, Wp), np.inf)
        for (r, c), lg, gap in zip(origins, logits, lgap):
            p = softmax64(lg).max(axis=-1)
            b0, b1 = best[0, r:r + SIZE, c:c + SIZE], best[1, r:r + SIZE, c:c + SIZE]
            wg = win_gap[r:r + SIZE, c:c + SIZE]
            new = p > b0
            b1[...] = np.where(new, b0, np.maximum(b1, p))
            wg[...] = np.where(new, gap, wg)
            b0[...] = np.where(new, p, b0)
        ties = (best[0] - best[1] < 1e-5) | (win_gap < 1e-4)
    else:  # exact-clipping: the last tile in order whose interior holds the pixel
        s = SIZE - 2 * m
        ties = np.zeros((max(H, s), max(W, s)), bool)
        for (r, c), gap in zip(origins, lgap):
            r0, c0 = min(r, max(H, s) - s), min(c, max(W, s) - s)
            ties[r0:r0 + s, c0:c0 + s] = gap[m:m + s, m:m + s] < 1e-4
        return ties[:H, :W]
    return ties[m:m + H, m:m + W]


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_class_prob_matches_flairtpu(setup, zone):
    out = setup["out"][zone]
    with TiffReader(out["ref_cp"]) as ref, TiffReader(out["port_cp"]) as r:
        assert (r.width, r.height, r.count) == (ref.width, ref.height, N_CLASSES)
        assert (r.width, r.height) == ZONES[zone][:2]
        assert r.transform == ref.transform and r.crs == ref.crs == 2154
        want, have = ref.read(), r.read()
    assert have.dtype == np.uint8
    diff = np.abs(have.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("zone", sorted(ZONES))
def test_sweep_rasters_match_flairtpu(setup, zone, method):
    out = setup["out"][zone]
    name = f"zone-ARGMAX-S_{method_name(method)}.tif"
    want, have = read(out["ref_sweep"] / name), read(out["port_sweep"] / name)
    assert have.shape == want.shape == (2, *ZONES[zone][1::-1])
    ties = near_ties(setup["model"], setup["zones"][zone][1], method)
    np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
    assert np.abs(have[1].astype(int) - want[1].astype(int)).max() <= 1
    assert (have[1] > 0).all()  # stride 16 = interior 16: every pixel written


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_sweep_files_and_metrics_match_flairtpu(setup, zone):
    out = setup["out"][zone]
    tifs = sorted(p.name for p in out["port_sweep"].glob("*.tif"))
    assert tifs == sorted(p.name for p in out["ref_sweep"].glob("*.tif"))
    assert tifs == sorted(f"zone-ARGMAX-S_{method_name(m)}.tif" for m in METHODS)
    name = f"metrics_per-patch_{DPT}_{zone}.json"
    want = json.loads((out["ref_sweep"] / name).read_text())
    have = json.loads((out["port_sweep"] / name).read_text())
    assert [list(r) for r in have] == [list(r) for r in want] and have
    for h, w in zip(have, want):
        (key, hv), wv = next(iter(h.items())), next(iter(w.values()))
        assert key.startswith(method_name(METHODS[-1]))
        assert list(hv) == list(wv)
        assert hv["classes"] == wv["classes"] and hv["Avg_metrics_name"] == wv["Avg_metrics_name"]
        for field in ("Avg_metrics", "per_class_iou", "per_class_fscore"):
            np.testing.assert_allclose(hv[field], wv[field], atol=1e-3)


@pytest.mark.parametrize("method", ["average", "max"])
def test_class_prob_forces_exact_clipping(setup, method):
    """Any stitch method with class_prob gives the exact-clipping output."""
    outs = {}
    for m in (method, "exact-clipping"):
        cfg = cfgmod.validate_detect_config(setup["make_config"](
            "realigned_90x70", f"port_force_{method}_{m}", output_type="class_prob"))
        cfg = eng.setup_out_path(cfg)
        model, tail = eng.prepare_model(cfg, torch.device("cpu"))
        path, _, _ = eng.run_single(cfg, model, tail, torch.device("cpu"),
                                    SIZE - 2 * MARGIN, m)
        outs[m] = read(Path(path))
    assert outs[method].shape[0] == N_CLASSES
    np.testing.assert_array_equal(outs[method], outs["exact-clipping"])


@pytest.mark.parametrize("method", ["average", "max"])
def test_batch_size_invariance(setup, method):
    """The stitched raster does not depend on batching: padding duplicates
    add nothing (valid 0) or cannot win (strict >)."""
    outs = []
    for bs in (2, 7):  # 30 tiles: no padding, then 5 duplicates
        cfg = setup["make_config"]("realigned_90x70", f"port_bs_{method}_{bs}", batch_size=bs,
                                   strategies={**copy.deepcopy(STRATEGIES), "stitching": {
                                       "enabled": True, "methods": [method], "margin": [0.25]}})
        setup["run_port"](cfg, "-c")
        outs.append(read(sweep_dir(cfg["output_path"]) /
                         f"zone-ARGMAX-S_{method_name(method)}.tif"))
    np.testing.assert_array_equal(outs[0], outs[1])


def _strategy_cases():
    cases = {}
    for name in ("flair-1-config-detect-compare.yaml", "config_detect_compare_metrics.yaml"):
        conf = yaml.safe_load((ROOT / "configs" / name).read_text())
        cases[name] = {k: conf[k] for k in ("strategies", "overlap_strat",
                                             "img_pixels_detection", "margin")}
    cases["skipped_combinations"] = {
        "strategies": {"tiling": {"enabled": True, "size_range": [16, 32, 64],
                                  "stride_range": [0.5, 1]},
                       "stitching": {"enabled": True, "method": "max", "margin": [0.25, 0.5]},
                       "padding_overall": "no-padding"},
        "overlap_strat": True, "img_pixels_detection": SIZE, "margin": MARGIN}
    return cases


@pytest.mark.parametrize("case", sorted(_strategy_cases()))
def test_gen_param_combination_matches_flairtpu(setup, case):
    over = _strategy_cases()[case]
    cfgs = []
    for validate in (flax_cfg.validate_detect_config, cfgmod.validate_detect_config):
        cfg = setup["make_config"]("realigned_90x70", f"strategies_{case}", compare=True,
                                   **copy.deepcopy(over))
        cfgs.append(validate(cfg))
    assert cfgs[1]["strategies"] == cfgs[0]["strategies"]
    want = flax_cfg.gen_param_combination(cfgs[0])
    assert cfgmod.gen_param_combination(cfgs[1]) == want
    assert want


def test_compare_config_errors_match_flairtpu(setup):
    for strat, msg in ((["tiling", "stride_range", [1.5]], "Stride"),
                       (["stitching", "methods", ["median"]], "Unknown stitching"),
                       (["stitching", "margin", [2.0]], "Margin")):
        for mod in (flax_cfg, cfgmod):
            cfg = setup["make_config"]("realigned_90x70", "strategy_errors", compare=True)
            cfg["strategies"][strat[0]][strat[1]] = strat[2]
            with pytest.raises(mod.ConfigError, match=msg):
                mod.validate_detect_config(cfg)
