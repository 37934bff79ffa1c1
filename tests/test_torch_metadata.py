"""``use_metadata`` in the port (CPU) against ``flairtpu``.

The 45-d encoding and the manifest's ``MTD`` column bit for bit; the
metadata MLP in eval and in train mode (``flairtpu``'s dropout keep masks,
read from its ``capture_intermediates``, handed to the port); the fusion
indexed by height; a ``.pth`` with the MLP loading into both packages; and
the slice at 512 x 512 (the fusion needs a 16 x 16 deepest map): resnet18
U-Net eval logits, one train step against ``flairtpu``'s ``_micro_step``
and SGD with the same augmentation choices and masks, and predict over a
ragged last batch against ``flairtpu``'s PRED rasters from one ``.pth``.
"""

import copy
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flairtpu import config as fcfg
from flairtpu.data import metadata as fmeta
from flairtpu.data.normalize import normalize_device
from flairtpu.models.metadata_mlp import MetadataMLP as FlaxMLP
from flairtpu.models.metadata_mlp import fuse_metadata as flax_fuse
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import config as cfgmod
from flairtpu_torch.data import metadata as pmeta
from flairtpu_torch.data.manifest import gather_paths
from flairtpu_torch.data.patches import PatchDataset, PatchLoader
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.convert import from_flax, load_weights
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import fold_model
from flairtpu_torch.models.metadata_mlp import MetadataMLP, fuse_metadata
from flairtpu_torch.models.quantize import quantize_model
from flairtpu_torch.predict.runner import predict
from flairtpu_torch.train import checkpoints as ckpt_lib
from flairtpu_torch.train.loop import SegmentationTrainer


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for PyTorch's CPU kernels here: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_CLASSES, SIZE = 4, 512
YEARS = ("2018", "2019", "2020", "2021")
CAMERAS = ("UCE-M3-f120-s06", "ADS100-f-A-s03")


def entry(rng, year: str, camera: str, month: int, time: str, day: int = 17) -> dict:
    """One flair_aerial_metadata.json entry: a Lambert-93 centroid, an altitude."""
    return {"patch_centroid_x": float(rng.uniform(100000, 1200000)),
            "patch_centroid_y": float(rng.uniform(6050000, 7100000)),
            "patch_centroid_z": float(rng.uniform(0, 3000)), "camera": camera,
            "date": f"{year}-{month:02d}-{day:02d}", "time": time}


def random_entries(rng, n: int) -> list[dict]:
    return [entry(rng, YEARS[i % 4], CAMERAS[i % 2], int(rng.integers(1, 13)),
                  f"{int(rng.integers(0, 24)):02d}h{int(rng.integers(0, 60)):02d}",
                  int(rng.integers(1, 32))) for i in range(n)]


@pytest.mark.parametrize("year", YEARS)
def test_encode_patch_metadata_bit_for_bit(year):
    """Both camera kinds, months 1 and 12, times 00h00 and 23h59, on each year."""
    rng = np.random.default_rng(int(year))
    for camera, month, time in itertools.product(CAMERAS, (1, 12), ("00h00", "23h59")):
        e = entry(rng, year, camera, month, time)
        got, want = pmeta.encode_patch_metadata(e), fmeta.encode_patch_metadata(e)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), e


def write_patches(root: Path, n: int, size: int, rng) -> tuple[Path, Path]:
    """n random 5-band patches and 1-based masks, a CSV of them and a
    metadata JSON keyed by the image stems."""
    root.mkdir(parents=True)
    rows, meta = [], {}
    for i, e in enumerate(random_entries(rng, n)):
        ip, mp = root / f"IMG_{i:06d}.tif", root / f"MSK_{i:06d}.tif"
        tr = Affine.from_origin(650000.0 + i * size * 0.2, 6860000.0, 0.2, 0.2)
        write_array(ip, rng.integers(0, 256, (5, size, size), dtype=np.uint8), transform=tr,
                    crs=2154, tiled=False)
        write_array(mp, rng.integers(1, N_CLASSES + 1, (size, size), dtype=np.uint8),
                    transform=tr, crs=2154, tiled=False)
        rows.append(f"{ip},{mp}")
        meta[ip.stem] = e
    csv = root / "split.csv"
    csv.write_text("\n".join(rows) + "\n")
    js = root / "flair_aerial_metadata.json"
    js.write_text(json.dumps(meta))
    return csv, js


def test_manifest_and_loader_carry_the_metadata(tmp_path):
    """gather_paths' MTD equals flairtpu's bit for bit; the loader stacks it
    as (B, 45) float32 beside flairtpu's, the ragged last batch too."""
    from flairtpu.data.manifest import gather_paths as fgather
    from flairtpu.data.patches import PatchDataset as FDataset, PatchLoader as FLoader

    csv, js = write_patches(tmp_path / "p", 5, 16, np.random.default_rng(4))
    cfg = {"use_metadata": True, "paths": {"test_csv": str(csv),
                                           "path_metadata_aerial": str(js)}}
    got, want = gather_paths(cfg, "test"), fgather(cfg, "test")
    assert len(got["MTD"]) == 5
    for a, b in zip(got["MTD"], want["MTD"], strict=True):
        assert a.tobytes() == b.tobytes()
    assert gather_paths(dict(cfg, use_metadata=False), "test")["MTD"] == []
    ours = list(PatchLoader(PatchDataset(got, use_metadata=True), 2))
    theirs = list(FLoader(FDataset(want, use_metadata=True), 2))
    assert [b["mtd"].shape[0] for b in ours] == [2, 2, 1]
    for a, b in zip(ours, theirs, strict=True):
        assert a["mtd"].dtype == torch.float32
        np.testing.assert_array_equal(a["mtd"].numpy(), b["mtd"])


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def flax_mlp(seed: int, batch: int = 8):
    """flairtpu's MLP, its variables and a batch of real encodings."""
    rng = np.random.default_rng(seed)
    mtd = np.stack([fmeta.encode_patch_metadata(e) for e in random_entries(rng, batch)])
    mlp = FlaxMLP()
    variables = mlp.init(jax.random.PRNGKey(seed), jnp.asarray(mtd))
    return mlp, variables, mtd


def port_mlp(variables) -> MetadataMLP:
    """The port's MLP on flairtpu's weights, carried by from_flax."""
    sd = from_flax({"metadata_mlp": host(variables["params"])}, {})
    mlp = MetadataMLP()
    mlp.load_state_dict({k[len("enc."):]: v for k, v in sd.items()}, strict=True)
    return mlp


def captured_masks(intermediates) -> list[torch.Tensor]:
    """flairtpu's keep masks: where its Dropout outputs are not zero."""
    return [torch.from_numpy(np.asarray(intermediates[f"Dropout_{i}"]["__call__"][0]) != 0)
            for i in range(3)]


def test_mlp_eval_matches_flairtpu():
    mlp, variables, mtd = flax_mlp(1)
    want = np.asarray(mlp.apply(variables, jnp.asarray(mtd), train=False))
    got = port_mlp(variables)(torch.from_numpy(mtd)).detach().numpy()
    assert got.shape == (8, 16) and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_mlp_train_matches_flairtpu_with_its_masks():
    mlp, variables, mtd = flax_mlp(2)
    want, state = mlp.apply(variables, jnp.asarray(mtd), train=True,
                            rngs={"dropout": jax.random.PRNGKey(9)},
                            capture_intermediates=True, mutable=["intermediates"])
    masks = captured_masks(state["intermediates"])
    assert [tuple(m.shape) for m in masks] == [(8, 64), (8, 32), (8, 16)]
    assert 0.4 < float(torch.cat([m.flatten() for m in masks]).float().mean()) < 0.8
    got = port_mlp(variables)(torch.from_numpy(mtd), masks).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def test_dropout_draws_from_the_generator_it_is_given():
    """The keep masks come from the caller's generator (kept with
    probability 0.6), never from PyTorch's global one: the same generator
    state gives the same masks."""
    mlp = MetadataMLP()
    state = torch.get_rng_state()
    a = mlp.draw_masks(4096, torch.Generator().manual_seed(5))
    b = mlp.draw_masks(4096, torch.Generator().manual_seed(5))
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [m.dtype for m in a] == [torch.bool] * 3
    assert abs(float(a[0].float().mean()) - 0.6) < 0.01
    mtd = torch.rand(4096, 45)
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(mlp(mtd, gen), mlp(mtd, a))


def test_fuse_metadata_matches_flairtpu():
    """A (2, 16, 3, 8) NHWC map (W != H, so an embedding indexed by W or C
    fails); the port's NCHW view of channels_last memory stays channels_last;
    a height other than the embedding's raises in both."""
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 16, 3, 8)).astype(np.float32)
    emb = rng.standard_normal((2, 16)).astype(np.float32)
    want = np.asarray(flax_fuse(jnp.asarray(feat), jnp.asarray(emb)))
    x = torch.from_numpy(feat).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    got = fuse_metadata(x, torch.from_numpy(emb))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    with pytest.raises(ValueError, match="deepest feature height"):
        flax_fuse(jnp.asarray(feat[:, :8]), jnp.asarray(emb))
    with pytest.raises(ValueError, match="deepest feature height"):
        fuse_metadata(x[:, :, :8], torch.from_numpy(emb))


def test_metadata_model_refusals():
    """A missing mtd raises; bn_fold and int8 refuse a metadata model."""
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, use_metadata=True).eval()
    x = torch.zeros((1, 64, 64, 5))
    with torch.inference_mode():
        with pytest.raises(ValueError, match="no metadata passed"):
            model(x)
        with pytest.raises(ValueError, match="deepest feature height"):
            model(x, mtd=torch.zeros((1, 45)))
    with pytest.raises(ValueError, match="use_metadata"):
        fold_model(model)
    with pytest.raises(ValueError, match="use_metadata"):
        quantize_model({}, model, [])


def meta_config(tmp: Path | None = None, **over) -> dict:
    cfg = {
        "paths": {"out_folder": str(tmp / "out") if tmp else "out", "out_model_name": "meta",
                  "train_csv": "", "val_csv": "", "test_csv": "", "ckpt_model_path": "",
                  "path_metadata_aerial": ""},
        "tasks": {"train": False, "predict": True, "metrics": False},
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
        "use_augmentation": True, "use_metadata": True, "channels": [1, 2, 3, 4, 5],
        "norm_type": "custom", "norm_means": [105.08, 110.87, 101.82, 106.38, 53.26],
        "norm_stds": [52.17, 45.38, 44, 39.69, 79.3], "seed": 2022, "batch_size": 2,
        "learning_rate": 0.02, "num_epochs": 1, "use_weights": True,
        "classes": {i + 1: [0 if i == N_CLASSES - 1 else 1, f"class_{i}"]
                    for i in range(N_CLASSES)},
        "georeferencing_output": True, "accelerator": "cpu", "num_workers": 2,
    }
    cfg.update(over)
    return cfg


@pytest.fixture(scope="module")
def flax_trainer():
    """flairtpu's resnet18 U-Net with the metadata MLP (initialized at 512²)."""
    return FlaxTrainer(fcfg.validate_train_config(meta_config()))


def port_trainer(ftr: FlaxTrainer, **over) -> SegmentationTrainer:
    """The port's trainer on flairtpu's weights."""
    tr = SegmentationTrainer(cfgmod.validate_train_config(meta_config(**over)))
    tr.model.load_state_dict(from_flax(host(ftr.params), host(ftr.batch_stats)), strict=True)
    return tr


@pytest.mark.parametrize("wrap", ["bare", "lightning"])
def test_pth_with_the_mlp_loads_into_both_packages(flax_trainer, tmp_path, wrap):
    """A .pth with enc.enc_mlp.* keys (bare, or a Lightning .ckpt under
    model.seg_model.* and model.enc.*) loads strictly into both, to the same
    weights."""
    from flairtpu.train.checkpoints import load_pretrained

    rng = np.random.default_rng(6)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          if v.is_floating_point() else v
          for k, v in FlairSegmentationModel("resnet18", N_CLASSES, 5,
                                             use_metadata=True).state_dict().items()}
    assert {f"enc.enc_mlp.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias")} <= set(sd)
    if wrap == "bare":
        path = tmp_path / "w.pth"
        torch.save(sd, path)
    else:
        path = tmp_path / "w.ckpt"
        torch.save({"state_dict": {("model." if k.startswith("enc.") else "model.seg_model.")
                                   + k: v for k, v in sd.items()}}, path)
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, use_metadata=True)
    load_weights(model, path)
    got = model.state_dict()
    ftr = flax_trainer
    variables = load_pretrained(path, {"params": ftr.params, "batch_stats": ftr.batch_stats})
    back = from_flax(host(variables["params"]), host(variables["batch_stats"]))
    assert set(back) == set(got)
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
        assert torch.equal(back[k], v), k


def test_eval_logits_match_flairtpu(flax_trainer):
    """512² eval logits from the same weights and metadata: 1e-4 as
    tests/test_torch_models.py; the metadata moves them."""
    ftr = flax_trainer
    tr = port_trainer(ftr)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 5)).astype(np.float32)
    mtd = np.stack([fmeta.encode_patch_metadata(e) for e in random_entries(rng, 2)])
    apply = jax.jit(lambda v, a, m: ftr.model.apply(v, a, m, train=False))
    want = np.asarray(apply({"params": ftr.params, "batch_stats": ftr.batch_stats},
                            jnp.asarray(x), jnp.asarray(mtd)))
    with torch.inference_mode():
        got = tr.model(torch.from_numpy(x), mtd=torch.from_numpy(mtd)).numpy()
        other = tr.model(torch.from_numpy(x), mtd=torch.from_numpy(mtd[::-1].copy())).numpy()
    assert got.shape == (2, SIZE, SIZE, N_CLASSES)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert np.abs(other - got).max() > 1e-3


def augment_np(img: np.ndarray, msk: np.ndarray, choices: np.ndarray):
    """flairtpu/data/augment.py:_augment_one with its choices given."""
    out_i, out_m = [], []
    for a, b, (v, h, k) in zip(img, msk, choices):
        if v:
            a, b = a[::-1], b[::-1]
        if h:
            a, b = a[:, ::-1], b[:, ::-1]
        out_i.append(np.rot90(a, k, axes=(0, 1)))
        out_m.append(np.rot90(b, k, axes=(0, 1)))
    return np.ascontiguousarray(np.stack(out_i)), np.ascontiguousarray(np.stack(out_m))


def test_train_step_matches_flairtpu(flax_trainer):
    """One train step at 512², batch 2, with augmentation and the metadata
    MLP's dropout: the port's train_step with flairtpu's choices and keep
    masks against flairtpu's _micro_step (its dropout key) and SGD. The
    tolerances of tests/test_torch_train.py: loss 1e-5, every tensor within
    1e-5 of its scale. Each tensor's change (lr * g, or the statistics' move)
    is held to 4e-2 in relative L2, not 5e-3: over 524,288 pixels a
    gradient's float32 sums cancel more, and the same step without the
    metadata drifts as far (2.95e-2 at layer4's BatchNorm scales; 3.23e-2
    here, the MLP's tensors 9.3e-3). Of the confusion matrix's pixels up to
    1e-5 may move (2 do), where the two packages' top-2 logits tie within
    their float32 sums, as its two-microbatch case allows at 64²."""
    ftr = flax_trainer
    cfg = ftr.config
    tr = port_trainer(ftr)
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (2, SIZE, SIZE, 5), dtype=np.uint8)
    msk = rng.integers(0, N_CLASSES + 3, (2, SIZE, SIZE), dtype=np.uint8)
    mtd = np.stack([fmeta.encode_patch_metadata(e) for e in random_entries(rng, 2)])
    choices = np.array([[1, 0, 3], [0, 1, 1]], np.int32)
    key = jax.random.PRNGKey(4)

    a_img, a_msk = augment_np(img, msk, choices)
    x = jax.jit(lambda a: normalize_device(a, cfg["norm_type"], tuple(cfg["norm_means"]),
                                           tuple(cfg["norm_stds"]), src_dtype=np.uint8))(
        jnp.asarray(a_img))
    tgt = ftr._clean_targets(jnp.asarray(a_msk, jnp.int32) - 1)
    g, stats_j, loss_j, cm_j = jax.jit(ftr._micro_step)(ftr.params, ftr.batch_stats, x, tgt,
                                                         jnp.asarray(mtd), key)
    updates, _ = ftr.tx.update(g, ftr.opt_state, ftr.params)
    params_j = optax.apply_updates(ftr.params, updates)
    _, state = ftr.model.apply({"params": ftr.params, "batch_stats": ftr.batch_stats},
                               jnp.asarray(mtd),
                               method=lambda m, a: m.metadata_mlp(a, train=True),
                               rngs={"dropout": key}, capture_intermediates=True,
                               mutable=["intermediates"])
    masks = captured_masks(state["intermediates"]["metadata_mlp"])

    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk),
                          "mtd": torch.from_numpy(mtd)}, cm, choices=torch.from_numpy(choices),
                         masks=[{"enc": masks}])

    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    moved = int(np.abs(cm.numpy() - np.asarray(cm_j)).sum()) // 2
    assert moved <= 1e-5 * img.shape[0] * SIZE * SIZE, moved
    before = from_flax(host(ftr.params), host(ftr.batch_stats))
    want = from_flax(host(params_j), host(stats_j))
    got = tr.model.state_dict()
    worst = []
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(float(w.abs().max()), 1.0), err_msg=k)
        step_want, step_got = w - before[k], got[k] - before[k]
        worst.append((float((step_got - step_want).norm() / step_want.norm()), k))
    assert all(float((got[k] - before[k]).abs().max()) > 0 for k in got if k.startswith("enc."))
    assert max(worst)[0] < 4e-2, max(worst)


def test_predict_pads_the_metadata_as_flairtpu(flax_trainer, tmp_path):
    """Three 512² test patches at batch 2 (the second batch padded, its
    metadata with it): the port's PRED rasters against flairtpu's predict from
    the same .pth, >= 0.999 of the pixels equal as tests/test_torch_train.py
    holds predict (the two float32 sums can flip near-tied argmaxes)."""
    from flairtpu.data.manifest import gather_paths as fgather
    from flairtpu.predict.runner import predict as fpredict
    from flairtpu.train.checkpoints import init_weights_with_surgery

    csv, js = write_patches(tmp_path / "test", 3, SIZE, np.random.default_rng(9))
    cfg = meta_config(tmp_path)
    cfg["paths"].update(test_csv=str(csv), path_metadata_aerial=str(js))
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, use_metadata=True)
    rng = np.random.default_rng(10)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            if k.endswith("running_var"):
                v.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, tuple(v.shape))))
            elif v.is_floating_point() and v.dim() > 1:
                v.copy_(torch.from_numpy(rng.standard_normal(tuple(v.shape)) *
                                         np.sqrt(2.0 / v[0].numel())))
    pth = tmp_path / "w.pth"
    torch.save(model.state_dict(), pth)

    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    ckpt_lib.init_weights_with_surgery(pth, tr.model)
    out = predict(cfg, gather_paths(cfg, "test"), tmp_path / "port", tr,
                  progress=lambda _: None)
    assert out["patches"] == 3
    ftr = flax_trainer
    ftr.load_state(init_weights_with_surgery(
        pth, {"params": ftr.params, "batch_stats": ftr.batch_stats}))
    fcf = fcfg.validate_train_config(copy.deepcopy(cfg))
    fpredict(fcf, fgather(fcf, "test"), tmp_path / "flairtpu", ftr, progress=lambda _: None)
    same = total = 0
    for p in sorted((tmp_path / "port").glob("PRED_*.tif")):
        with TiffReader(p) as a, TiffReader(tmp_path / "flairtpu" / p.name) as b:
            x, y = a.read(1), b.read(1)
        same += int((x == y).sum())
        total += x.size
    assert total == 3 * SIZE * SIZE
    assert same / total >= 0.999, same / total
