"""flairtpu_torch stands alone: no JAX, Flax or flairtpu import; the card or
an error, never a silent fall back to the CPU; kernel wrappers count only
their kernel launches; what the port does not run yet says so."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import flairtpu_torch
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main, flair_main
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.zone.engine import stage_zone

ROOT = Path(__file__).resolve().parent.parent
PORT = Path(flairtpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "flairtpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_importing_every_module_loads_no_jax():
    names = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                   for p in PORT.rglob("*.py"))
    assert len(names) > 20
    code = (
        "import sys\n"
        "for n in %r: __import__(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n" % (names, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def _tiny_detect_setup(tmp_path: Path, **over) -> Path:
    img = np.random.default_rng(1).integers(0, 255, (5, 40, 40)).astype(np.uint8)
    write_array(tmp_path / "zone.tif", img, transform=Affine.from_origin(0.0, 0.0, 0.2, 0.2),
                crs=2154)
    model = FlairSegmentationModel("resnet18", 4, 5)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    cfg = {
        "output_path": str(tmp_path / "out"), "output_name": "z",
        "input_img_path": str(tmp_path / "zone.tif"), "channels": [1, 2, 3, 4, 5],
        "img_pixels_detection": 32, "margin": 8, "output_type": "argmax", "n_classes": 4,
        "model_weights": str(tmp_path / "w.pth"),
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
        "batch_size": 4,
        "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
    }
    cfg.update(over)
    conf = tmp_path / "detect.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    return conf


def test_use_gpu_without_cuda_raises(tmp_path, monkeypatch):
    """use_gpu defaults to true: the run needs the card and does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = _tiny_detect_setup(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        detect_main([f"--conf={conf}"])
    assert not (tmp_path / "out" / "z.tif").exists()


def test_use_gpu_false_runs_on_cpu(tmp_path):
    conf = _tiny_detect_setup(tmp_path, use_gpu=False)
    ft.launches = ga.launches = 0
    stats = detect_main([f"--conf={conf}"])
    assert (tmp_path / "out" / "z.tif").exists()
    assert stats["tiles"] == 9
    assert ft.launches == ga.launches == 0  # the plain versions ran


def test_module_entry_point_writes_raster(tmp_path):
    conf = _tiny_detect_setup(tmp_path, use_gpu=False)
    out = subprocess.run([sys.executable, "-m", "flairtpu_torch.cli", "flair-detect",
                          f"--conf={conf}"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    with TiffReader(tmp_path / "out" / "z.tif") as r:
        assert (r.width, r.height, r.count, r.crs) == (40, 40, 2, 2154)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    rng = np.random.default_rng(4)
    g = ft.tail_geometry(32, 8)
    x3 = torch.from_numpy(rng.standard_normal((2, g.x3_extent, g.x3_extent, 32))
                          .astype(np.float32)).permute(0, 3, 1, 2)
    model = FlairSegmentationModel("resnet18", 4, 5).eval()
    p = ft.tail_params(model, torch.float32)
    zone = torch.from_numpy(rng.integers(0, 256, (48, 48, 5), dtype=np.uint8))
    org = torch.tensor([[0, 0], [16, 8]], dtype=torch.int32)
    ft.launches = ga.launches = 0
    with torch.inference_mode():
        for got, want in zip(ft.fused_tail(x3, p, g), ft.fused_tail_plain(x3, p, g)):
            assert torch.equal(got, want)
    assert torch.equal(ga.gather_normalize(zone, org, 32, "scaling"),
                       ga.gather_normalize_plain(zone, org, 32, "scaling"))
    assert ft.launches == ga.launches == 0


def test_wrappers_raise_on_other_devices():
    """Neither CPU nor CUDA: no fallback, an error."""
    g = ft.tail_geometry(32, 8)
    x3 = torch.empty((1, 32, g.x3_extent, g.x3_extent), device="meta")
    p = ft.tail_params(FlairSegmentationModel("resnet18", 4, 5), torch.float32)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ft.fused_tail(x3, p, g)
    zone = torch.empty((48, 48, 5), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        ga.gather_normalize(zone, torch.zeros((1, 2), dtype=torch.int32), 32, "scaling")


@pytest.mark.parametrize("over,slice_name", [
    ({"quantize": "int8", "int8_decoder": 5}, "slice 3"),
    ({"quantize": "int8", "model_framework": {
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": "mit_b0_unet"}}}, "slice 6"),
    ({"model_framework": {"model_provider": "SegmentationModelsPytorch",
                          "SegmentationModelsPytorch": {"encoder_decoder": "vgg16_bn_manet"}}},
     "slice 6"),
    ({"model_framework": {"model_provider": "SegmentationModelsPytorch",
                          "SegmentationModelsPytorch": {"encoder_decoder": "dpn68_unet"}}},
     "slice 6"),
    ({"model_framework": {"model_provider": "HuggingFace",
                          "HuggingFace": {"org_model": "nvidia/mit-b0"}}}, "slice 7"),
])
def test_unported_options_raise(tmp_path, over, slice_name):
    conf = _tiny_detect_setup(tmp_path, use_gpu=False, **over)
    with pytest.raises(NotImplementedError, match=slice_name):
        cfgmod.validate_detect_config(cfgmod.read_config(conf))


def test_zone_over_device_budget_raises(tmp_path, monkeypatch, capsys):
    """A zone the device budget cannot hold no longer raises: it takes the
    streaming route, the raster is written, and staging does not upload it."""
    monkeypatch.setenv("FLAIRTPU_DEVICE_ZONE_BYTES", "1000")
    conf = _tiny_detect_setup(tmp_path, use_gpu=False)
    stats = detect_main([f"--conf={conf}"])
    assert "zone path: streaming" in capsys.readouterr().out
    assert stats["tiles"] == 9 and "stitch_seconds" in stats
    with TiffReader(tmp_path / "out" / "z.tif") as r:
        assert (r.width, r.height, r.count) == (40, 40, 2)
        assert (r.read(2) > 0).all()
    staged = stage_zone(cfgmod.validate_detect_config(cfgmod.read_config(conf)),
                        torch.device("cpu"))
    assert "zone_dev" not in staged and tuple(staged["zone_host"].shape) == (40, 40, 5)


def test_msgpack_weights_and_flair_raise(tmp_path):
    # native weights are read since step 3: an empty or garbled .msgpack
    # passes the config and raises the decoder's ValueError at the load
    for name, data in (("empty.msgpack", b""), ("garbled.msgpack", b"\xc1\x00\x01")):
        (tmp_path / name).write_bytes(data)
        conf = _tiny_detect_setup(tmp_path, use_gpu=False, model_weights=str(tmp_path / name))
        cfgmod.validate_detect_config(cfgmod.read_config(conf))
        with pytest.raises(ValueError, match="msgpack"):
            detect_main([f"--conf={conf}"])
    # flair runs since slice 4; what it does not run yet raises, naming its slice
    flair_conf = tmp_path / "flair.yaml"
    flair_conf.write_text(yaml.safe_dump({
        "paths": {"out_folder": str(tmp_path / "flair")}, "tasks": {"train": True},
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet34_unet"}},
        "channels": [1, 2, 3, 4, 5], "classes": {1: [1, "a"], 2: [1, "b"]},
        "param_sharding": "fsdp", "accelerator": "cpu"}))
    with pytest.raises(NotImplementedError, match="slice 8"):
        flair_main([f"--conf={flair_conf}"])


@pytest.mark.parametrize("encoder", ["resnet18", "resnet34", "resnet50", "resnet101",
                                     "resnet152", "resnext50_32x4d", "resnext101_32x4d",
                                     "resnext101_32x8d", "resnext101_32x16d",
                                     "resnext101_32x32d", "resnext101_32x48d"])
def test_resnet_unets_validate(encoder):
    assert cfgmod.validate_model_framework({
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_unet"}}) == (encoder, "unet")
