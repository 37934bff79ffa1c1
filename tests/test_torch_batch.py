"""Department batch mode (``flair-detect -b``) on the CPU (use_gpu: false):
the port's ``detect_main -b`` against flairtpu's ``batch_metrics_pipeline``
on one department and one .pth, laid out as ``tests/test_zone_batch.py``
lays it out, with a third zone that has no truth raster.

Zones: 48x64, 5 channels, each from its own numpy seed; 32-pixel tiles,
margin 8; resnet18-unet, 4 classes.

Bounds: the same raster names; classes equal except at near-ties
(``test_torch_compare.near_ties``), prob |diff| <= 1; the metrics JSON with
the same keys and values within 1e-6; each port raster bit for bit the
port's single-zone run of the same zone.
"""

import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.zone.batch import batch_metrics_pipeline as flax_batch
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.zone import batch as port_batch
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import PinnedBuffers
from tests.test_torch_compare import near_ties
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
DPT = "D099_2021"
ZONES = {"Z1_AA": 41, "Z2_BB": 42, "Z3_NOTRUTH": 43}
SIZE, MARGIN = 32, 8
METHOD = (f"size={SIZE}_stride={SIZE - 2 * MARGIN}_margin={MARGIN}_padding=no-padding"
          "_stitching=exact-clipping")


def read(path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_batch")
    dpt_in, truth_root = tmp / "inputs" / DPT, tmp / "truth"
    imgs = {}
    for zone, seed in ZONES.items():
        rng = np.random.default_rng(seed)
        imgs[zone] = rng.integers(0, 255, (5, 48, 64)).astype(np.uint8)
        (dpt_in / zone).mkdir(parents=True)
        write_array(dpt_in / zone / f"{DPT}_{zone}_irc.tif", imgs[zone],
                    transform=Affine.from_origin(0, 100, 0.2, 0.2), crs=2154)
        if zone != "Z3_NOTRUTH":
            (truth_root / DPT / zone).mkdir(parents=True)
            write_array(truth_root / DPT / zone / "truth.tif",
                        rng.integers(1, N_CLASSES + 1, (48, 64)).astype(np.uint8))
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(23)))
    weights = tmp / "resnet18_unet.pth"
    torch.save(model.state_dict(), weights)

    def make_config(out: str, **over) -> dict:
        cfg = {
            "output_path": str(tmp / out), "output_name": "placeholder",
            "input_img_path": str(dpt_in / "missing.tif"), "input_path": str(dpt_in),
            "truth_root": str(truth_root),
            "truth_path": str(truth_root / DPT / "Z1_AA" / "truth.tif"),
            "data_type": "irc", "model_name": "resnet18_unet", "channels": [1, 2, 3, 4, 5],
            "img_pixels_detection": SIZE, "margin": MARGIN, "output_type": "argmax",
            "n_classes": N_CLASSES, "model_weights": str(weights),
            "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
            "batch_size": 4, "use_gpu": False, "num_worker": 1, "write_dataframe": False,
            "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
            "classes": {i + 1: [1, f"class_{i}"] for i in range(N_CLASSES)},
        }
        cfg.update(over)
        return cfg

    def run_port(out: str, **over) -> dict:
        cfg = make_config(out, **over)
        conf = tmp / f"{out}.yaml"
        conf.write_text(yaml.safe_dump(cfg))
        return detect_main([f"--conf={conf}", "-b", "-m"])

    ref = make_config("ref", metrics=True, batch_mode=True)
    flax_batch(flax_cfg.validate_detect_config(ref))
    return dict(tmp=tmp, model=model, imgs=imgs, make_config=make_config,
                run_port=run_port, ref=Path(ref["output_path"]))


@pytest.fixture(scope="module")
def port_run(setup):
    return setup["run_port"]("port")


def test_batch_rasters_match_flairtpu(setup, port_run):
    port, ref = setup["tmp"] / "port", setup["ref"]
    names = sorted(p.name for p in port.glob("*.tif"))
    assert names == sorted(p.name for p in ref.glob("*.tif"))
    assert names == [f"{DPT}_{z}_irc-ARGMAX-S_{METHOD}.tif" for z in ("Z1_AA", "Z2_BB")]
    for name in names:
        zone = name.split("_irc")[0][len(DPT) + 1:]
        have, want = read(port / name), read(ref / name)
        assert have.shape == want.shape == (2, 48, 64)
        ties = near_ties(setup["model"], setup["imgs"][zone], "exact-clipping")
        np.testing.assert_array_equal(have[0][~ties], want[0][~ties])
        assert np.abs(have[1].astype(int) - want[1].astype(int)).max() <= 1
    assert [z["zone"] for z in port_run["zones"]] == ["Z1_AA", "Z2_BB"]


def test_batch_metrics_json_matches_flairtpu(setup, port_run):
    want = json.loads((setup["ref"] / "metrics.json").read_text())
    have = json.loads((setup["tmp"] / "port" / "metrics.json").read_text())
    assert have == json.loads(json.dumps(port_run["metrics"]))
    assert len(have) == len(want) == 1  # one method
    for h, w in zip(have, want):
        assert list(h) == list(w)
        for key in ("Method parameters", "Parameters values", "Avg_metrics_name", "classes"):
            assert h[key] == w[key]
        for key in ("Avg_metrics", "per_class_iou", "per_class_fscore"):
            np.testing.assert_allclose(h[key], w[key], atol=1e-6, rtol=0)
    assert have[0]["Parameters values"][:2] == ["resnet18_unet", SIZE]


def test_zone_without_truth_is_skipped_with_flairtpus_message(setup, capsys):
    cfg = cfgmod.validate_detect_config(setup["make_config"]("unused", metrics=True,
                                                             batch_mode=True))
    jobs, truth_dpt = port_batch.find_jobs(cfg)
    assert "No ground truth found for zone: Z3_NOTRUTH" in capsys.readouterr().out
    assert [j[0].parts[-2] for j in jobs] == ["Z1_AA", "Z2_BB"]
    assert truth_dpt == setup["tmp"] / "truth" / DPT


def test_batch_rasters_equal_single_zone_runs(setup, port_run):
    """The prefetched, staged-ahead zones give the single-zone runs' rasters."""
    dpt_in = setup["tmp"] / "inputs" / DPT
    for zone in ("Z1_AA", "Z2_BB"):
        cfg = setup["make_config"](f"single_{zone}",
                                   input_img_path=str(dpt_in / zone / f"{DPT}_{zone}_irc.tif"))
        conf = setup["tmp"] / f"single_{zone}.yaml"
        conf.write_text(yaml.safe_dump(cfg))
        detect_main([f"--conf={conf}"])
        np.testing.assert_array_equal(
            read(setup["tmp"] / "port" / f"{DPT}_{zone}_irc-ARGMAX-S_{METHOD}.tif"),
            read(Path(cfg["output_path"]) / "placeholder.tif"))


def test_batch_banded_equals_unbanded(setup, port_run, monkeypatch):
    monkeypatch.setenv("FLAIRTPU_ZONE_BANDS", "2")
    banded = setup["run_port"]("port_banded")
    assert [(z["tiles"], z["bands"]) for z in banded["zones"]] == [(12, 2)] * 2
    for z in ("Z1_AA", "Z2_BB"):
        name = f"{DPT}_{z}_irc-ARGMAX-S_{METHOD}.tif"
        np.testing.assert_array_equal(read(setup["tmp"] / "port_banded" / name),
                                      read(setup["tmp"] / "port" / name))


def test_batch_records_where_each_zone_went(port_run):
    for z in port_run["zones"]:
        for key in ("read_seconds", "h2d_seconds", "compute_seconds", "d2h_seconds",
                    "write_seconds", "prefetch_wait_seconds"):
            assert z[key] >= 0.0
        assert z["run_span"][0] <= z["run_span"][1] <= port_run["seconds"]
        assert "h2d_span" not in z  # the card's span only on the card


def test_prefetch_error_fails_the_run_and_leaves_no_thread(setup, monkeypatch):
    real = port_batch.stage_zone

    def failing(config, device, img_path=None, buffers=None):
        if "Z2_BB" in str(img_path):
            raise OSError("synthetic read failure")
        return real(config, device, img_path, buffers)

    monkeypatch.setattr(port_batch, "stage_zone", failing)
    before = threading.active_count()
    with pytest.raises(OSError, match="synthetic read failure"):
        setup["run_port"]("port_failure")
    assert threading.active_count() == before
    assert not (setup["tmp"] / "port_failure" / "metrics.json").exists()


def test_pinned_buffers_go_round_two_in_turn():
    pool = PinnedBuffers(torch.device("cpu"))
    a, b, c = (pool.take((4, 5, 3), torch.uint16) for _ in range(3))
    assert a is c and a is not b and a.dtype == torch.uint16
    assert pool.take((4, 6, 3), torch.uint16) is not a


@pytest.mark.parametrize("metrics", [False, True])
def test_batch_mode_needs_no_input_or_truth_path(setup, metrics):
    """As flairtpu: -b finds its zones under input_path, so neither
    input_img_path nor truth_path has to exist; without -b both do."""
    over = dict(metrics=metrics, truth_path=str(setup["tmp"] / "no" / "truth.tif"))
    for mod in (flax_cfg, cfgmod):
        cfg = mod.validate_detect_config(setup["make_config"]("unused", batch_mode=True,
                                                              **over))
        assert ("metrics_out" in cfg) == metrics
        with pytest.raises(mod.ConfigError, match="Input image path does not exist"):
            mod.validate_detect_config(setup["make_config"]("unused", **over))


def test_run_single_stages_anew_for_another_path(setup, port_run):
    dpt_in = setup["tmp"] / "inputs" / DPT
    cfg = eng.setup_out_path(cfgmod.validate_detect_config(setup["make_config"](
        "port_other_path", input_img_path=str(dpt_in / "Z2_BB" / f"{DPT}_Z2_BB_irc.tif"))))
    dev = torch.device("cpu")
    other = eng.stage_zone(cfg, dev, dpt_in / "Z1_AA" / f"{DPT}_Z1_AA_irc.tif")
    model, tail = eng.prepare_model(cfg, dev)
    path, _, _ = eng.run_single(cfg, model, tail, dev, SIZE - 2 * MARGIN, "exact-clipping",
                                staged=other)
    np.testing.assert_array_equal(
        read(path), read(setup["tmp"] / "port" / f"{DPT}_Z2_BB_irc-ARGMAX-S_{METHOD}.tif"))
