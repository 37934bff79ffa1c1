"""``flairtpu``'s native ``.msgpack`` weights in flairtpu_torch (CPU).

- The codec (``flairtpu_torch/io/msgpack.py``) against flax 0.12.3's
  ``msgpack_serialize`` / ``msgpack_restore``: the same bytes, the same
  arrays bit for bit, chunked arrays with ``MAX_CHUNK_SIZE`` made small,
  and a ``ValueError`` for what it does not read.
- The tree: ``models/convert.py:to_flax`` equals ``flairtpu``'s
  ``any_state_dict_to_flax`` leaf for leaf (paths, dtype, values) for the
  nine archs over resnet18, resnext50_32x4d-unet and a metadata U-Net, and
  ``from_flax`` takes it back to the same state dict (numpy and torch only).
- The files both ways: ``flairtpu``'s own ``make_toy_zone`` weights load
  strictly into the port, whose zone raster from them equals the raster of
  the same weights saved as ``.pth``; the port's ``make-toy-zone`` weights
  pass ``flairtpu``'s ``load_pretrained(strict=True)``, and both tools
  write the same rasters and YAMLs; class-count surgery from a 13-class
  file zeroes the 19-class head as ``flairtpu``'s does.

The zone runs use 128-pixel tiles on the 256² toy zone, so that each takes
about a second; ``flairtpu``'s ``make_toy_zone`` initializes its model
once (the file's one ``flairtpu`` compile).
"""

from pathlib import Path

import flax.serialization as fser
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flairtpu.models import convert as fconvert
from flairtpu.tools import make_toy_zone as flax_make_toy_zone
from flairtpu.train import checkpoints as fck
from flairtpu_torch import config as cfgmod
from flairtpu_torch.cli import detect_main
from flairtpu_torch.config import SMP_ARCHS
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io import msgpack as mp
from flairtpu_torch.models.convert import from_flax, load_weights, to_flax
from flairtpu_torch.models.factory import FlairSegmentationModel, create_model
from flairtpu_torch.tools import make_toy_zone
from flairtpu_torch.train import checkpoints as ckpt_lib
from tests.test_torch_models import random_state_dict

TOY_ZONE, TILE, TILE_MARGIN = 256, 128, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

def sample_tree(seed: int) -> dict:
    """Dicts of arrays of every supported dtype, numpy scalars, empty and
    0-d arrays, Python scalars, and keys of every str length class."""
    rng = np.random.default_rng(seed)
    tree = {"params": {"conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                                "bias": np.zeros(8, np.float32)},
                       "b" * 40: rng.standard_normal(300).astype(np.float16)},
            "batch_stats": {"x": {"mean": rng.standard_normal(5).astype(np.float64)}},
            "empty": np.zeros((2, 0), np.int8), "zero_d": np.array(3.5, np.float32),
            "scalars": {"f32": np.float32(2.5), "i64": np.int64(-70000), "b": np.bool_(True),
                        "u8": np.uint8(200), "py_int": 300, "py_neg": -40, "py_float": 0.1,
                        "py_true": True, "none": None, "text": "k" * 300},
            "k" * 70000: np.arange(5, dtype=np.uint16)}
    for name in mp.DTYPES:
        tree.setdefault("dtypes", {})[name] = (rng.integers(0, 2, 17) if name == "bool" else
                                               rng.integers(-100, 100, 17)).astype(name)
    return tree


def assert_trees_equal(got, want) -> None:
    """Same structure, and each leaf of the same type, dtype and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            assert_trees_equal(got[k], want[k])
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert np.shape(got) == np.shape(want)
        np.testing.assert_array_equal(got, want)
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("seed", [0, 1])
def test_encoder_bytes_equal_flax(seed):
    tree = sample_tree(seed)
    want = fser.msgpack_serialize(tree)
    assert mp.packb(tree) == want
    assert_trees_equal(mp.unpackb(want), fser.msgpack_restore(want))


def test_decoder_arrays_are_writable_copies():
    data = fser.msgpack_serialize({"w": np.arange(6, dtype=np.float32).reshape(2, 3)})
    w = mp.unpackb(data)["w"]
    w[0, 0] = 9.0  # a frombuffer view of the file would be read-only
    assert w.flags.c_contiguous and w.shape == (2, 3)


def test_chunked_arrays_match_flax(monkeypatch):
    """Arrays over MAX_CHUNK_SIZE bytes (made 96 here) are written in flat
    pieces as flax writes them, and read back whole."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 96)
    rng = np.random.default_rng(3)
    tree = {"a": {"big": rng.standard_normal((7, 11)).astype(np.float32),
                  "small": np.ones(3, np.float32)},
            "odd": rng.integers(-9, 9, (5, 5, 5)).astype(np.int16)}
    data = fser.msgpack_serialize(tree)
    assert mp.packb(tree) == data
    assert mp.CHUNKED.encode() in data
    got = mp.unpackb(data)
    assert_trees_equal(got, fser.msgpack_restore(data))
    np.testing.assert_array_equal(got["a"]["big"], tree["a"]["big"])


@pytest.mark.parametrize("data,match", [
    (fser.msgpack_serialize({"c": 1 + 2j}), "ext type 2"),
    (fser.msgpack_serialize({"c": np.zeros(3, np.complex64)}), "complex64"),
    (fser.msgpack_serialize({"c": jnp.zeros(3, jnp.bfloat16)}), "bfloat16"),
    (b"", "truncated"),
    (fser.msgpack_serialize({"w": np.zeros(9, np.float32)})[:-5], "truncated"),
    (b"\xc1", "reserved"),
    (b"\x80\x00", "after the end"),
])
def test_what_the_decoder_refuses_raises(data, match):
    with pytest.raises(ValueError, match=match):
        mp.unpackb(data)


def test_what_the_encoder_refuses_raises():
    with pytest.raises(ValueError, match="complex128"):
        mp.packb({"c": np.zeros(2, np.complex128)})
    with pytest.raises(ValueError, match="tuple"):
        mp.packb({"t": (1, 2)})


# ---------------------------------------------------------------------------
# the variable tree
# ---------------------------------------------------------------------------

def assert_flax_trees_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"params", "batch_stats"}
    for coll in want:
        paths = sorted(fconvert._tree_paths(want[coll]))
        assert sorted(fconvert._tree_paths(got[coll])) == paths, coll
        for p in paths:
            a, b = fconvert._tree_get(got[coll], p), np.asarray(fconvert._tree_get(want[coll], p))
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, p
            np.testing.assert_array_equal(a, b, err_msg="/".join(p))


TREE_CASES = ([("resnet18", arch, False) for arch in SMP_ARCHS]
              + [("resnext50_32x4d", "unet", False), ("resnet18", "unet", True)])


@pytest.mark.parametrize("encoder,arch,metadata", TREE_CASES)
def test_to_flax_equals_flairtpu_converter(encoder, arch, metadata):
    model = FlairSegmentationModel(encoder, 4, 5, arch=arch, use_metadata=metadata)
    sd = random_state_dict(model, np.random.default_rng(SMP_ARCHS.index(arch) + 11))
    got = to_flax(sd, arch)
    assert_flax_trees_equal(got, fconvert.any_state_dict_to_flax(
        {k: v.numpy() for k, v in sd.items()}))
    back = from_flax(got["params"], got["batch_stats"], arch)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# the files, both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zones(tmp_path_factory):
    """Both tools' toy zones (256², 13 classes, resnet34-unet weights)."""
    root = tmp_path_factory.mktemp("toy_zones")
    flax_conf = flax_make_toy_zone(root / "flairtpu", zone=TOY_ZONE)
    port_conf = make_toy_zone(root / "port", zone=TOY_ZONE)
    return root, flax_conf, port_conf


def run_zone(conf: Path, weights: Path, out: Path) -> np.ndarray:
    """The port's flair-detect of a toy config at 128-pixel tiles on the CPU
    with ``weights``: the raster's two bands."""
    cfg = yaml.safe_load(conf.read_text())
    cfg.update(use_gpu=False, img_pixels_detection=TILE, margin=TILE_MARGIN, batch_size=4,
               model_weights=str(weights), output_path=str(out))
    path = out.parent / f"{out.name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    detect_main([f"--conf={path}"])
    with TiffReader(out / f"{cfg['output_name']}.tif") as r:
        return r.read()


def test_port_reads_flairtpu_weights_strictly(zones, tmp_path):
    """flairtpu's own .msgpack loads strictly; the zone from it equals, byte
    for byte, the zone from the same weights saved as .pth."""
    root, flax_conf, _ = zones
    weights = root / "flairtpu" / "toy-weights.msgpack"
    model = create_model(yaml.safe_load(flax_conf.read_text()))
    load_weights(model, weights)
    tree = fser.msgpack_restore(weights.read_bytes())
    want = from_flax(tree["params"], tree["batch_stats"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    pth = tmp_path / "toy-weights.pth"
    torch.save(model.state_dict(), pth)
    from_msgpack = run_zone(flax_conf, weights, tmp_path / "msgpack")
    from_pth = run_zone(flax_conf, pth, tmp_path / "pth")
    assert from_msgpack.shape == (2, TOY_ZONE, TOY_ZONE)
    assert from_msgpack.tobytes() == from_pth.tobytes()


def test_flairtpu_reads_port_weights_and_the_tools_agree(zones):
    """The port's .msgpack passes flairtpu's strict load (its tree that of
    flairtpu's own file, every shape and dtype); zone, truth and YAMLs are
    flairtpu's."""
    root, flax_conf, port_conf = zones
    reference = fser.msgpack_restore((root / "flairtpu" / "toy-weights.msgpack").read_bytes())
    port_path = root / "port" / "toy-weights.msgpack"
    got = fck.load_pretrained(port_path, reference, strict=True)
    assert not fconvert.validate_against(got, reference, strict=True)
    for coll in ("params", "batch_stats"):
        for p in fconvert._tree_paths(reference[coll]):
            assert fconvert._tree_get(got[coll], p).dtype == np.float32
    for name in ("toy-zone.tif", "toy-zone-truth.tif"):
        with TiffReader(root / "flairtpu" / name) as a, TiffReader(root / "port" / name) as b:
            assert (a.width, a.height, a.count, a.crs) == (b.width, b.height, b.count, b.crs)
            assert a.transform == b.transform
            np.testing.assert_array_equal(a.read(), b.read())
    for name in (flax_conf.name, "toy-config-detect-compare.yaml"):
        want = (root / "flairtpu" / name).read_text().replace(str(root / "flairtpu"), "ROOT")
        assert (root / "port" / name).read_text().replace(str(root / "port"), "ROOT") == want
    assert port_conf.name == flax_conf.name


def test_class_surgery_from_native_weights(zones, tmp_path):
    """A 13-class .msgpack initializing a 19-class model: the head zeroed
    and named, every other tensor loaded, as flairtpu's surgery merges it."""
    root, flax_conf, _ = zones
    weights = root / "flairtpu" / "toy-weights.msgpack"
    cfg = dict(yaml.safe_load(flax_conf.read_text()), n_classes=19)
    model = create_model(cfg)
    reference = to_flax(model.state_dict())
    zeroed = ckpt_lib.init_weights_with_surgery(weights, model)
    assert zeroed == ["segmentation_head.0.weight", "segmentation_head.0.bias"]
    want = fck.init_weights_with_surgery(weights, reference, verbose=False)
    assert_flax_trees_equal(to_flax(model.state_dict()), want)
    assert not model.segmentation_head[0].weight.any()


def test_saved_native_weights_read_back(zones, tmp_path):
    """save_weights_msgpack, then read back: the same state dict; flax's
    decoder reads the file as flairtpu writes it."""
    root, flax_conf, _ = zones
    model = create_model(yaml.safe_load(flax_conf.read_text()))
    load_weights(model, root / "port" / "toy-weights.msgpack")
    path = tmp_path / "again.flax"
    ckpt_lib.save_weights_msgpack(path, model)
    assert path.read_bytes() == (root / "port" / "toy-weights.msgpack").read_bytes()
    back = ckpt_lib.load_state_dict_file(path)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    tree = fser.msgpack_restore(path.read_bytes())
    assert set(tree) == {"params", "batch_stats"}


def test_detect_config_takes_native_weights(zones, tmp_path):
    """.msgpack and .flax pass validate_detect_config; another extension
    fails with flairtpu's message."""
    root, flax_conf, _ = zones
    cfg = yaml.safe_load(flax_conf.read_text())
    for ext in (".flax", ".bin"):
        w = tmp_path / f"w{ext}"
        w.write_bytes((root / "flairtpu" / "toy-weights.msgpack").read_bytes()[:16])
        path = tmp_path / f"c{ext}.yaml"
        path.write_text(yaml.safe_dump(dict(cfg, model_weights=str(w))))
        if ext == ".flax":
            cfgmod.validate_detect_config(cfgmod.read_config(path))
        else:
            with pytest.raises(cfgmod.ConfigError, match=r"\.msgpack/\.flax \(native\)"):
                cfgmod.validate_detect_config(cfgmod.read_config(path))
