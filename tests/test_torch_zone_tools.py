"""The ``tools.py`` zone subcommands of flairtpu_torch against flairtpu's
(CPU, no JAX program): ``error-maps``, ``analyze-compare``, the weight maps
and the drawings of ``zone/visualization.py``, ``convert-weights`` and the
``export-model`` refusal.

The numeric stages (disagreement maps, smoothing, per-method means, the
metric-by-parameter means, overlap counts and summed weights) are held to
``flairtpu``'s exactly: both are the same numpy. ``convert-weights`` writes
the bytes ``flairtpu``'s writes for the same ``.pth``. matplotlib draws the
PNGs; where it is missing (beside the card) the subcommands raise its
``ImportError``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import flairtpu.zone.error_maps as ferr
from flairtpu import tools as ftools
from flairtpu.zone import analysis as fanalysis
from flairtpu.zone import weights as fweights
from flairtpu_torch import tools
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone import analysis, error_maps, visualization
from flairtpu_torch.zone import weights as pweights
from flairtpu_torch.zone.grid import slice_grid
from flairtpu_torch.zone.naming import method_string
from tests.test_torch_models import random_state_dict

K = 4
METHODS = (method_string(64, 32, 16, "no-padding", "average"),
           method_string(64, 48, 8, "no-padding", "exact-clipping"))
ZONES = ("Z1", "Z2")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def compare_outputs(tmp_path_factory):
    """A truth raster a zone (1-based classes) and a prediction a zone and
    method, named as the compare sweep names them, in timestamped folders."""
    root = tmp_path_factory.mktemp("compare")
    rng = np.random.default_rng(5)
    tr = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    for z, zone in enumerate(ZONES):
        truth = rng.integers(0, K, (48, 56))
        (root / "truth" / zone).mkdir(parents=True)
        write_array(root / "truth" / zone / "truth.tif", (truth + 1).astype(np.uint8)[None],
                    transform=tr, crs=2154)
        for m, method in enumerate(METHODS):
            pred = np.where(rng.uniform(size=truth.shape) < 0.3 + 0.2 * m,
                            rng.integers(0, K, truth.shape), truth).astype(np.uint8)
            folder = root / "preds" / f"2024010{z}_12000{m}"
            folder.mkdir(parents=True, exist_ok=True)
            write_array(folder / f"D033_2018_{zone}_RGB-ARGMAX-S_{method}.tif",
                        np.stack([pred, np.full_like(pred, 200)]), transform=tr, crs=2154)
    return root


def test_error_maps_match_flairtpu(compare_outputs, monkeypatch, tmp_path):
    """Each method's smoothed mean disagreement map equals flairtpu's (the
    map it hands to its PNG writer), and the port's PNGs are written."""
    root = compare_outputs
    drawn = {}
    monkeypatch.setattr(ferr, "save_heatmap_png",
                        lambda err, png, title="": drawn.setdefault(title, err))
    ferr.error_rate_loop(root / "truth", tmp_path / "f", root / "preds", sigma=1.5)
    got = error_maps.method_error_maps(root / "truth", root / "preds", sigma=1.5)
    assert list(got) == sorted(METHODS) == list(drawn)
    for method, smooth in got.items():
        assert smooth.shape == (48, 56)
        np.testing.assert_array_equal(smooth, drawn[method], err_msg=method)
    out = error_maps.error_rate_loop(root / "truth", tmp_path / "p", root / "preds", sigma=1.5)
    assert sorted(p.name for p in out.values()) == sorted(
        f"error-rate_{m}.png" for m in METHODS)
    assert all(p.stat().st_size > 0 for p in out.values())


def test_error_maps_subcommand(compare_outputs, tmp_path, capsys):
    root = compare_outputs
    tools.main(["error-maps", "--truth-dir", str(root / "truth"), "--pred-dir",
                str(root / "preds"), "--out-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert all(f"[x] {m}: " in printed for m in METHODS)
    assert len(list(tmp_path.glob("error-rate_*.png"))) == len(METHODS)


def sweep_metrics() -> list:
    """A compare sweep's per-patch metrics JSON: records keyed by method
    string, with the named averages and per-class lists."""
    rng = np.random.default_rng(2)
    names = ["mIoU", "Overall Accuracy", "Fscore"]
    return [{method_string(size, stride, margin, "no-padding", stitch): {
        "Avg_metrics_name": names, "Avg_metrics": [float(v) for v in rng.uniform(0, 1, 3)],
        "Per_class_IoU": [float(v) for v in rng.uniform(0, 1, K)]}
        for size in (64, 128) for stride, margin in ((32, 16), (48, 8))
        for stitch in ("average", "max")} for _ in range(2)]


@pytest.mark.parametrize("param,metric", [("size", "mIoU"), ("stride", "Fscore"),
                                          ("margin", "Overall Accuracy")])
def test_analyze_compare_matches_flairtpu(tmp_path, capsys, param, metric):
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(sweep_metrics()))
    rows = analysis.flatten_metrics(analysis.load_metrics_json(path))
    assert rows == fanalysis.flatten_metrics(fanalysis.load_metrics_json(path))
    points = analysis.analyze_param(rows, param, metric)
    assert points == fanalysis.analyze_param(rows, param, metric) and len(points) == 2
    png = tmp_path / "p.png"
    args = ["analyze-compare", str(path), "--param", param, "--metric", metric]
    ftools.main(args + ["--out-png", str(tmp_path / "f.png")])
    want = capsys.readouterr().out.replace(str(tmp_path / "f.png"), "PNG")
    tools.main(args + ["--out-png", str(png)])
    assert capsys.readouterr().out.replace(str(png), "PNG") == want
    assert png.stat().st_size > 0


@pytest.mark.parametrize("image_size,patch,bounds,stride", [
    ((100, 80), 32, [0, 100, 0, 80], 16), ((100, 80), 32, [10, 70, 5, 60], 24),
    ((64, 64), 64, [0, 64, 0, 64], 32), ((150, 90), 40, [20, 130, 0, 90], 30)])
def test_overlap_and_total_weights_match_flairtpu(image_size, patch, bounds, stride):
    got = pweights.patch_overlap(image_size, patch, bounds, stride)
    want = fweights.patch_overlap(image_size, patch, bounds, stride)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    for mode in ("exp", "gaussian"):
        got = pweights.total_weights(image_size, patch, bounds, stride, sigma=0.7, mode=mode)
        want = fweights.total_weights(image_size, patch, bounds, stride, sigma=0.7, mode=mode)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_visualization_maps_and_drawings(tmp_path):
    """The two maps visualize_weights draws are flairtpu's; both drawings
    are written."""
    w, tw = visualization.weight_maps(32, 16)
    np.testing.assert_array_equal(w, fweights.patch_weights(32))
    np.testing.assert_array_equal(tw, fweights.total_weights((96, 96), 32, [0, 96, 0, 96], 16))
    visualization.visualize_weights(32, 16, out_png=tmp_path / "w.png")
    grid = slice_grid(100, 80, 32, 8, 16, Affine.from_origin(0.0, 0.0, 0.2, 0.2), 2154)
    visualization.viz_slicing(grid, out_png=tmp_path / "g.png")
    assert (tmp_path / "w.png").stat().st_size > 0 and (tmp_path / "g.png").stat().st_size > 0


def test_matplotlib_missing_raises_naming_it(compare_outputs, tmp_path, monkeypatch):
    """Without matplotlib the subcommands raise its ImportError (after the
    numeric stages), and write no PNG."""
    root = compare_outputs
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tools.main(["error-maps", "--truth-dir", str(root / "truth"), "--pred-dir",
                    str(root / "preds"), "--out-dir", str(tmp_path)])
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(sweep_metrics()))
    with pytest.raises(ImportError, match="matplotlib"):
        tools.main(["analyze-compare", str(path), "--out-png", str(tmp_path / "a.png")])
    assert not list(tmp_path.glob("*.png"))


@pytest.mark.parametrize("arch", ["unet", "linknet", "manet"])
def test_convert_weights_writes_flairtpus_bytes(tmp_path, arch):
    """The port's convert-weights of an smp .pth writes the bytes
    flairtpu's writes (linknet's transposed kernels flipped, manet's
    modules), and with --conf holds it strictly against that model."""
    model = FlairSegmentationModel("resnet18", K, 5, arch=arch)
    src = tmp_path / "w.pth"
    torch.save(random_state_dict(model, np.random.default_rng(1)), src)
    ftools.main(["convert-weights", str(src), str(tmp_path / "f.msgpack")])
    tools.main(["convert-weights", str(src), str(tmp_path / "p.msgpack")])
    assert (tmp_path / "p.msgpack").read_bytes() == (tmp_path / "f.msgpack").read_bytes()
    conf = tmp_path / "c.yaml"
    mf = {"model_provider": "SegmentationModelsPytorch",
          "SegmentationModelsPytorch": {"encoder_decoder": f"resnet18_{arch}"}}
    conf.write_text(yaml.safe_dump({"model_framework": mf, "channels": [1, 2, 3, 4, 5],
                                    "n_classes": K}))
    tools.main(["convert-weights", str(src), str(tmp_path / "c.msgpack"), "--conf", str(conf)])
    assert (tmp_path / "c.msgpack").read_bytes() == (tmp_path / "f.msgpack").read_bytes()
    conf.write_text(yaml.safe_dump({"model_framework": mf, "channels": [1, 2, 3, 4, 5],
                                    "n_classes": K + 1}))
    with pytest.raises(RuntimeError, match="size mismatch"):
        tools.main(["convert-weights", str(src), str(tmp_path / "x.msgpack"), "--conf",
                    str(conf)])


@pytest.mark.parametrize("keys,slice_name", [
    ({"segformer.encoder.patch_embeddings.0.proj.weight": (8, 3, 7, 7)}, "slice 7"),
    ({"encoder.features.conv0.weight": (8, 3, 7, 7), "decoder.blocks.0.conv1.0.weight": (8, 8, 3, 3)},
     "slice 6")])
def test_convert_weights_refuses_unported_families(tmp_path, keys, slice_name):
    src = tmp_path / "w.pth"
    torch.save({k: torch.zeros(s) for k, s in keys.items()}, src)
    with pytest.raises(NotImplementedError, match=slice_name):
        tools.main(["convert-weights", str(src), str(tmp_path / "w.msgpack")])


def test_export_model_raises_naming_slice_8(tmp_path):
    with pytest.raises(NotImplementedError, match="slice 8"):
        tools.main(["export-model", "--conf", str(tmp_path / "c.yaml"), "--out",
                    str(tmp_path / "m")])
    assert not Path(tmp_path / "m").exists()
