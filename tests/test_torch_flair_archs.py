"""``flair`` train / predict / metrics with the slice-5 decoders, end to
end on the CPU against ``flairtpu``, and the rules around them.

- deeplabv3plus (the arch FLAIR users pick most after the U-Net) through
  the port's ``flair_main`` (train 2 epochs, predict, metrics) and through
  ``flairtpu``'s ``fit``, from one ``.pth``; then ``flairtpu``'s predict and
  metrics on the port's best weights against the port's.
- fpn (``strided_tail`` at U = 4), pspnet (U = 8), linknet (U = 1) and
  manet (``fused_tail``): the port's ``flair_main`` predict and metrics
  from a ``.pth`` against ``flairtpu``'s predict on the same weights.
- every arch validates for ``flair``; the refusals left still raise; PAN's
  128-pixel minimum at the first batch (``flairtpu``'s ``IndexError`` at
  112 pinned beside it); ``init_encoder_weights`` at output stride 16 and 8
  and PSPNet's depth-3 refusal; class surgery on 1x1 and 3x3 heads.

resnet18, 4 classes, 64 x 64 patches (128 for PAN), batch 4, torch on one
thread.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as fcfg
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import cli
from flairtpu_torch import config as cfgmod
from flairtpu_torch.config import SMP_ARCHS
from flairtpu_torch.data.manifest import gather_paths
from flairtpu_torch.data.patches import PatchDataset, PatchLoader
from flairtpu_torch.io import TiffReader
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models.factory import FUSED_TAIL_ARCHS, FlairSegmentationModel, init_weights
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.train import checkpoints as ckpt_lib
from flairtpu_torch.train.loop import SegmentationTrainer
from tests.test_torch_pretrained import classifier
from tests.test_torch_train import N_CLASSES, train_config, write_split

ARCHS = tuple(a for a in SMP_ARCHS if a != "unet")
# logits' top-2 gap under which the two packages' float32 sums may order a
# pixel's classes differently (their logits agree within about 2e-6 here)
GAP_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smp(arch: str, encoder: str = "resnet18") -> dict:
    return {"model_provider": "SegmentationModelsPytorch",
            "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_{arch}"}}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory) -> tuple[Path, dict]:
    tmp = tmp_path_factory.mktemp("flair_archs")
    paths = {split: str(write_split(tmp / split, n, seed))
             for split, n, seed in (("train", 8, 1), ("val", 4, 2), ("test", 4, 3))}
    return tmp, paths


def arch_config(tmp: Path, paths: dict, arch: str, name: str, weights: Path,
                train: bool) -> dict:
    """The toy flair config for ``arch`` into ``tmp / name``, initialized from
    ``weights`` (train) or predicting from them (no train)."""
    cfg = train_config(tmp / name, model_framework=smp(arch))
    cfg["paths"].update(train_csv=paths["train"], val_csv=paths["val"], test_csv=paths["test"],
                        ckpt_model_path=str(weights), out_model_name=arch)
    cfg["tasks"]["train"] = train
    cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = train
    return cfg


def write_weights(tmp: Path, arch: str, seed: int) -> Path:
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch)
    init_weights(model, seed)
    path = tmp / f"{arch}_init.pth"
    torch.save(model.state_dict(), path)
    return path


def flax_predict(cfg: dict, weights: Path, out: Path) -> None:
    """flairtpu's predict stage on ``weights`` (an smp-keyed .pth)."""
    from flairtpu.data.manifest import gather_paths as fgather
    from flairtpu.predict.runner import predict
    from flairtpu.train.checkpoints import init_weights_with_surgery

    trainer = FlaxTrainer(fcfg.validate_train_config(copy.deepcopy(cfg)))
    trainer.load_state(init_weights_with_surgery(
        weights, {"params": trainer.params, "batch_stats": trainer.batch_stats}))
    predict(trainer.config, fgather(trainer.config, "test"), out, trainer)


def preds(folder: Path) -> dict[str, np.ndarray]:
    out = {}
    for p in sorted(folder.glob("PRED_*.tif")):
        with TiffReader(p) as r:
            out[p.name] = r.read(1)
    return out


def port_top2_gaps(cfg: dict, weights: Path) -> dict[str, np.ndarray]:
    """The top-2 gap of the port's float32 logits at each test pixel, by
    PRED name."""
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    ckpt_lib.init_weights_with_surgery(weights, tr.model, verbose=False)
    ds = PatchDataset(gather_paths(cfg, "test"), cfg["channels"], with_masks=False)
    gaps = {}
    with torch.inference_mode():
        for batch in PatchLoader(ds, 4):
            x, _ = tr.prepare(batch)
            top2 = tr.model(x, epilogue=conv_epilogue).topk(2, dim=-1).values
            for src, gap in zip(batch["id"], (top2[..., 0] - top2[..., 1]).numpy()):
                gaps[f"PRED_{Path(src).name}"] = gap
    return gaps


@pytest.fixture(scope="module")
def deeplab_runs(dataset):
    """deeplabv3plus through the port's flair_main and flairtpu's fit from
    one .pth; flairtpu's predict and metrics on the port's best weights."""
    from flairtpu.data.manifest import gather_paths as fgather
    from flairtpu.eval.metrics import metrics
    from flairtpu.predict.runner import predict
    from flairtpu.train.checkpoints import init_weights_with_surgery
    from flairtpu.train.loop import fit

    tmp, paths = dataset
    weights = write_weights(tmp, "deeplabv3plus", 7)
    runs = {name: arch_config(tmp, paths, "deeplabv3plus", name, weights, True)
            for name in ("port", "flairtpu")}
    conf = tmp / "port.yaml"
    conf.write_text(yaml.safe_dump(runs["port"]))
    port = cli.flair_main([f"--conf={conf}"])
    cfg = fcfg.validate_train_config(runs["flairtpu"])
    out = Path(cfg["paths"]["out_folder"], "deeplabv3plus")
    trainer, info = fit(cfg, fgather(cfg, "train"), fgather(cfg, "val"), out)
    best = torch.load(port["train"]["best_path"], weights_only=True)["state_dict"]
    torch.save(best, tmp / "port_best.pth")
    trainer.load_state(init_weights_with_surgery(
        tmp / "port_best.pth", {"params": trainer.params, "batch_stats": trainer.batch_stats}))
    predict(cfg, fgather(cfg, "test"), out / "predictions_deeplabv3plus", trainer)
    ref = {"train": info, "metrics": metrics(cfg, out / "predictions_deeplabv3plus")}
    return tmp, port, ref


def test_deeplabv3plus_slice_matches_flairtpu(deeplab_runs):
    """The artifacts; two epochs each with finite losses within 5e-2 of
    flairtpu's (the fits draw their ASPP dropout masks from different
    generators, torch's and jax.random's, so they agree in distribution, not
    in value: tests/test_torch_train_archs.py holds one step on the same
    masks to 1e-5); predictions on the port's best weights >= 0.999 equal to
    flairtpu's, and metrics.json within 1e-3."""
    tmp, port, ref = deeplab_runs
    out = tmp / "port" / "out" / "deeplabv3plus"
    for name in ("flair-compute.log", "history.json", "metrics.jsonl", "last", "best",
                 "metrics/confmat.npy", "metrics/metrics.json"):
        assert (out / name).exists(), name
    got_h, want_h = port["train"]["history"], ref["train"]["history"]
    assert [h["epoch"] for h in got_h] == [h["epoch"] for h in want_h] == [0, 1]
    for got, want in zip(got_h, want_h):
        for key in ("train_loss", "val_loss"):
            assert np.isfinite(got[key])
            np.testing.assert_allclose(got[key], want[key], rtol=5e-2, err_msg=key)
    assert port["predict"]["patches"] == 4
    mine = preds(out / "predictions_deeplabv3plus")
    theirs = preds(tmp / "flairtpu" / "out" / "deeplabv3plus" / "predictions_deeplabv3plus")
    assert mine.keys() == theirs.keys() and len(mine) == 4
    same = sum(int((mine[k] == theirs[k]).sum()) for k in mine)
    assert same / sum(v.size for v in mine.values()) >= 0.999
    got = json.loads((out / "metrics" / "metrics.json").read_text())
    assert got.keys() == ref["metrics"].keys()
    for key in ("Avg_metrics", "per_class_iou", "per_class_fscore", "per_class_precision",
                "per_class_recall"):
        np.testing.assert_allclose(got[key], ref["metrics"][key], atol=1e-3, err_msg=key)


@pytest.mark.parametrize("arch", ["fpn", "pspnet", "linknet", "manet"])
def test_predict_matches_flairtpu(dataset, arch):
    """The port's flair_main predict (its tail at margin 0: strided_tail at
    U = 4, 8 and 1, fused_tail for manet) and metrics from a .pth, against
    flairtpu's predict on the same weights: every class equal where the
    logits' top-2 gap is at least GAP_TOL."""
    tmp, paths = dataset
    weights = write_weights(tmp, arch, 11)
    cfg = arch_config(tmp, paths, arch, f"predict_{arch}", weights, False)
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch)
    assert (type(model.zone_tail()).__name__, model.up) == (
        ("TailParams", 1) if arch in FUSED_TAIL_ARCHS else
        ("StridedTail", {"fpn": 4, "pspnet": 8, "linknet": 1}[arch]))
    conf = tmp / f"predict_{arch}.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    result = cli.flair_main([f"--conf={conf}"])
    assert result["predict"]["patches"] == 4 and "metrics" in result
    out = tmp / f"predict_{arch}" / "out" / arch
    flax_predict(cfg, weights, tmp / f"flax_{arch}")
    mine, theirs = preds(out / f"predictions_{arch}"), preds(tmp / f"flax_{arch}")
    assert mine.keys() == theirs.keys() and len(mine) == 4
    gaps = port_top2_gaps(cfg, weights)
    for name, cls in mine.items():
        differ = cls != theirs[name]
        assert not (differ & (gaps[name] >= GAP_TOL)).any(), name
    assert (out / "metrics" / "metrics.json").exists()


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_validates_for_flair(arch):
    cfg = cfgmod.validate_train_config(train_config(model_framework=smp(arch, "resnet34")))
    assert cfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] == \
        f"resnet34_{arch}"


@pytest.mark.parametrize("mf,exc,match", [
    (smp("segformer"), NotImplementedError, "not ported \\(supported: unet"),
    (smp("deeplabv3plus", "vgg16_bn"), NotImplementedError, "slice 6"),
    ({"model_provider": "HuggingFace"}, NotImplementedError, "slice 7"),
])
def test_flair_refusals_still_raise(mf, exc, match):
    with pytest.raises(exc, match=match):
        cfgmod.validate_train_config(train_config(model_framework=mf))


def test_pan_needs_128_pixel_patches():
    """The port's train step on 112 x 112 patches raises a ValueError naming
    the 128-pixel minimum (flair reads the patch size at its first batch);
    flairtpu's PAN fails there with an IndexError. Both train at 128 (the
    port here; both in tests/test_torch_train_archs_full.py)."""
    cfg = cfgmod.validate_train_config(train_config(model_framework=smp("pan")))
    tr = SegmentationTrainer(cfg)
    rng = np.random.default_rng(2)
    for size in (112, 128):
        batch = {"img": torch.from_numpy(rng.integers(0, 255, (2, size, size, 5), np.uint8)),
                 "msk": torch.from_numpy(rng.integers(1, N_CLASSES + 1, (2, size, size),
                                                      np.uint8))}
        if size == 112:
            with pytest.raises(ValueError, match="at least 128 pixels"):
                tr.train_step(batch)
            flax = flax_create_model(train_config(model_framework=smp("pan")))
            with pytest.raises(IndexError):
                jax.jit(lambda k, x: flax.init(k, x, train=False))(
                    jax.random.PRNGKey(0), jnp.zeros((1, size, size, 5)))
        else:
            assert np.isfinite(tr.train_step(batch).item())


@pytest.mark.parametrize("arch", ["deeplabv3plus", "deeplabv3", "pspnet"])
def test_init_encoder_weights_at_each_output_stride(tmp_path, arch):
    """A resnet18 classifier loads into the encoder at output stride 16
    (deeplabv3plus) and 8 (deeplabv3): the dilated stages keep their
    shapes. PSPNet's depth-3 encoder has no layer3 or layer4, and the strict
    cover raises on the full classifier, as flairtpu's does."""
    sd = classifier("resnet18", 3)
    path = tmp_path / "cls.pth"
    torch.save(sd, path)
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch)
    if arch == "pspnet":
        with pytest.raises(ValueError, match="unexpected encoder.layer3"):
            ppre.init_encoder_from_classifier(path, model)
        return
    ppre.init_encoder_from_classifier(path, model)
    assert torch.equal(model.encoder.layer4[1].conv2.weight, sd["layer4.1.conv2.weight"])
    assert model.encoder.layer4[0].conv1.dilation == ((2, 2) if arch == "deeplabv3plus"
                                                      else (4, 4))


@pytest.mark.parametrize("arch,kernel", [("fpn", 1), ("pan", 3)])
def test_class_surgery_on_the_head(tmp_path, arch, kernel):
    """A checkpoint of another class count loads all but the head (1x1 or
    3x3), which is zeroed."""
    src = FlairSegmentationModel("resnet18", 7, 5, arch=arch)
    init_weights(src, 1)
    path = tmp_path / "seven.pth"
    torch.save(src.state_dict(), path)
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch=arch)
    assert model.segmentation_head[0].kernel_size == (kernel, kernel)
    zeroed = ckpt_lib.init_weights_with_surgery(path, model, verbose=False)
    assert zeroed == ["segmentation_head.0.weight", "segmentation_head.0.bias"]
    assert not model.segmentation_head[0].weight.any()
    assert torch.equal(model.decoder.state_dict()[next(iter(model.decoder.state_dict()))],
                       src.decoder.state_dict()[next(iter(src.decoder.state_dict()))])
