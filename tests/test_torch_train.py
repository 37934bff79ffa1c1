"""``flair`` train / predict / metrics of the port (CPU) against ``flairtpu``.

One train step of resnet18_unet (the port's ``train_step``: normalize, train-
mode forward, weighted cross-entropy, backward, SGD) from weights carried by
``models/convert.py:from_flax``, against ``flairtpu``'s ``_micro_step`` and
its SGD update, with one microbatch and with two; the whole ``flair``
pipeline on a toy dataset against ``flairtpu``'s ``fit``, ``predict`` and
``metrics`` from the same ``.pth``; and the small rules: the initial
distributions, the knobs that raise ``not_ported``, the device an
``accelerator`` names, checkpoint surgery.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from flairtpu import config as fcfg
from flairtpu.data.normalize import normalize_device
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import cli
from flairtpu_torch import config as cfgmod
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.models.factory import FlairSegmentationModel, init_weights
from flairtpu_torch.train import checkpoints as ckpt_lib
from flairtpu_torch.data.manifest import gather_paths
from flairtpu_torch.train.loop import SegmentationTrainer, fit


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for PyTorch's CPU kernels here: the suite runs
    several test processes side by side, and a process that takes every
    core for its convolutions slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_CLASSES, SIZE = 4, 32


def host(tree):
    """A Flax variable tree as writable numpy arrays."""
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


def train_config(tmp: Path | None = None, **over) -> dict:
    cfg = {
        "paths": {"out_folder": str(tmp / "out") if tmp else "out", "out_model_name": "toy",
                  "train_csv": "", "val_csv": "", "test_csv": "", "ckpt_model_path": ""},
        "tasks": {"train": True, "train_tasks": {"init_weights_only_from_ckpt": False,
                                                 "resume_training_from_ckpt": False},
                  "predict": True, "metrics": True, "delete_preds": False},
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
        "use_augmentation": False, "use_metadata": False, "channels": [1, 2, 3, 4, 5],
        "norm_type": "custom", "norm_means": [105.08, 110.87, 101.82, 106.38, 53.26],
        "norm_stds": [52.17, 45.38, 44, 39.69, 79.3], "seed": 2022, "batch_size": 4,
        "learning_rate": 0.02, "num_epochs": 2, "use_weights": True,
        "classes": {i + 1: [0 if i == N_CLASSES - 1 else 1, f"class_{i}"]
                    for i in range(N_CLASSES)},
        "georeferencing_output": True, "accelerator": "cpu", "num_workers": 2,
        "ckpt_save_also_last": True, "ckpt_weights_only": False, "ckpt_monitor": "val_loss",
        "ckpt_monitor_mode": "min", "ckpt_earlystopping_patience": 30,
        "cp_csv_and_conf_to_output": True, "enable_progress_bar": False,
    }
    cfg.update(over)
    return cfg


def toy_batch(seed: int, n: int = 4, size: int = SIZE):
    """uint8 (n, size, size, 5) images and 1-based uint8 masks, 0 and > K included."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (n, size, size, 5), dtype=np.uint8)
    msk = rng.integers(0, N_CLASSES + 3, (n, size, size), dtype=np.uint8)
    return img, msk


def flax_step(trainer: FlaxTrainer, img, msk, accumulate: int):
    """flairtpu's train step replayed: normalize_device and _clean_targets,
    _micro_step over the microbatches (stats chained, grads averaged), SGD."""
    cfg = trainer.config
    x = jax.jit(lambda a: normalize_device(a, cfg["norm_type"], tuple(cfg["norm_means"]),
                                           tuple(cfg["norm_stds"]), src_dtype=np.uint8))(
        jnp.asarray(img))
    tgt = trainer._clean_targets(jnp.asarray(msk, jnp.int32) - 1)
    micro = jax.jit(trainer._micro_step)
    b = x.shape[0] // accumulate
    stats, gsum, losses, cm = trainer.batch_stats, None, [], 0
    for i in range(accumulate):
        sl = slice(i * b, (i + 1) * b)
        g, stats, loss, c = micro(trainer.params, stats, x[sl], tgt[sl],
                                  jnp.zeros((b, 45), jnp.float32), jax.random.PRNGKey(0))
        gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
        losses.append(loss)
        cm = cm + np.asarray(c)
    grads = jax.tree_util.tree_map(lambda a: a / accumulate, gsum)
    updates, _ = trainer.tx.update(grads, trainer.opt_state, trainer.params)
    params = optax.apply_updates(trainer.params, updates)
    return float(jnp.mean(jnp.stack(losses))), params, stats, cm


@pytest.mark.parametrize("accumulate,size", [(1, 32), (2, 64)])
def test_train_step_matches_flairtpu(accumulate, size):
    """Loss (1e-5), every parameter and running statistic after the step
    (1e-5 of its scale), the step's change of each (5e-3 in relative L2) and
    the confusion matrix (exact), with one microbatch.

    Two microbatches of 2 patches run at 64 x 64: at 32 x 32, layer4 is 1 x 1
    and its BatchNorm's statistics over 2 values amplify float32 summation
    differences to 7e-5 in the loss, with or without accumulation. At 64 x 64
    layer4's statistics still cover only 8 values a channel: the change of
    its BatchNorm scales is held to 3e-2, and up to 2 pixels of the
    confusion matrix may move, where the two packages' top-2 logits tie
    within their float32 sums."""
    cfg = train_config(accumulate_steps=accumulate)
    ftr = FlaxTrainer(fcfg.validate_train_config(copy.deepcopy(cfg)))
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    tr.model.load_state_dict(from_flax(host(ftr.params), host(ftr.batch_stats)))
    img, msk = toy_batch(11, size=size)

    loss_j, params_j, stats_j, cm_j = flax_step(ftr, img, msk, accumulate)
    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk)}, cm)

    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    moved = int(np.abs(cm.numpy() - cm_j).sum()) // 2
    assert moved <= (0 if accumulate == 1 else 2)
    before = from_flax(host(ftr.params), host(ftr.batch_stats))
    want = from_flax(host(params_j), host(stats_j))
    got = tr.model.state_dict()
    worst = []
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        # every tensor within 1e-5 of its scale (at least 1); the step's
        # change (lr * g, or the statistics' move) within 1e-2 in relative L2
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * max(float(w.abs().max()), 1.0), err_msg=key)
        step_want, step_got = w - before[key], got[key] - before[key]
        worst.append((float((step_got - step_want).norm() / step_want.norm()), key))
    assert max(worst)[0] < (5e-3 if accumulate == 1 else 3e-2), max(worst)


def write_split(root: Path, n: int, seed: int, size: int = 64) -> Path:
    """n learnable toy patches (8 x 8 blocks of one class, band 1 encodes the
    class) and a CSV of them, written with the port's TIFF writer."""
    rng = np.random.default_rng(seed)
    (root / "img").mkdir(parents=True)
    (root / "msk").mkdir()
    rows = []
    for i in range(n):
        cls = np.kron(rng.integers(0, N_CLASSES, (size // 8,) * 2), np.ones((8, 8), np.int64))
        img = rng.integers(0, 40, (5, size, size)).astype(np.uint8)
        img[0] = (cls * 60 + 20).astype(np.uint8)
        tr = Affine.from_origin(700000.0 + i * size, 6600000.0, 0.2, 0.2)
        ip, mp = root / "img" / f"IMG_{i:06d}.tif", root / "msk" / f"MSK_{i:06d}.tif"
        write_array(ip, img, transform=tr, crs=2154, tiled=False)
        write_array(mp, (cls + 1).astype(np.uint8), transform=tr, crs=2154, tiled=False)
        rows.append(f"{ip},{mp}")
    csv = root.parent / f"{root.name}.csv"
    csv.write_text("\n".join(rows) + "\n")
    return csv


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """The toy run through both packages from one .pth: the port's
    flair_main (train, predict, metrics), flairtpu's fit, and flairtpu's
    predict and metrics on the port's best weights.

    The predict and metrics stages are compared on the same weights: after a
    few steps from random weights the logits of most pixels are close, and
    the two fits' float32 sums (about 1e-3 apart after four steps) move
    about 2% of the argmaxes."""
    tmp = tmp_path_factory.mktemp("flair")
    paths = {split: str(write_split(tmp / split, n, seed))
             for split, n, seed in (("train", 8, 1), ("val", 4, 2), ("test", 4, 3))}
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5)
    init_weights(model, 7)
    weights = tmp / "init.pth"
    torch.save(model.state_dict(), weights)
    runs = {}
    for name in ("port", "flairtpu"):
        cfg = train_config(tmp / name)
        cfg["paths"].update(train_csv=paths["train"], val_csv=paths["val"],
                            test_csv=paths["test"], ckpt_model_path=str(weights))
        cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = True
        runs[name] = cfg
    conf = tmp / "port.yaml"
    conf.write_text(yaml.safe_dump(runs["port"]))
    port = cli.flair_main([f"--conf={conf}"])

    from flairtpu.data.manifest import gather_paths
    from flairtpu.eval.metrics import metrics
    from flairtpu.predict.runner import predict
    from flairtpu.train.checkpoints import init_weights_with_surgery
    from flairtpu.train.loop import fit

    cfg = fcfg.validate_train_config(runs["flairtpu"])
    out = Path(cfg["paths"]["out_folder"], "toy")
    trainer, info = fit(cfg, gather_paths(cfg, "train"), gather_paths(cfg, "val"), out)
    best = torch.load(port["train"]["best_path"], weights_only=True)["state_dict"]
    torch.save(best, tmp / "port_best.pth")
    trainer.load_state(init_weights_with_surgery(
        tmp / "port_best.pth", {"params": trainer.params, "batch_stats": trainer.batch_stats}))
    predict(cfg, gather_paths(cfg, "test"), out / "predictions_toy", trainer)
    ref = {"train": info, "metrics": metrics(cfg, out / "predictions_toy")}
    return tmp, port, ref


def test_flair_slice_writes_the_reference_artifacts(slice_runs):
    tmp, port, _ = slice_runs
    out = tmp / "port" / "out" / "toy"
    for name in ("flair-compute.log", "history.json", "metrics.jsonl", "last", "best",
                 "metrics/confmat.npy", "metrics/metrics.json"):
        assert (out / name).exists(), name
    copied = sorted(p.name for p in (out / "used_csv_and_config").iterdir())
    assert copied == ["port.yaml", "test.csv", "train.csv", "val.csv"]
    preds = sorted((out / "predictions_toy").glob("PRED_*.tif"))
    assert len(preds) == 4
    with TiffReader(preds[0]) as r:
        assert (r.count, r.crs, r.dtype) == (1, 2154, np.uint8)
    best = Path(port["train"]["best_path"])
    assert best.name == (out / "best").read_text() and best.exists()
    assert torch.load(out / "last", weights_only=True)["epoch"] == 1
    assert len(json.loads((out / "history.json").read_text())) == 2
    assert len((out / "metrics.jsonl").read_text().splitlines()) == 2


def test_flair_slice_matches_flairtpu(slice_runs):
    """Per-epoch losses (1e-3) and mIoU (5e-3) and the checkpoint names
    against flairtpu's fit from the same weights; PRED pixels (>= 0.999
    equal) and metrics.json (1e-3) against flairtpu's predict and metrics on
    the port's trained weights.

    The losses agree to 1e-5 at the first step (test_train_step_matches_
    flairtpu); from random weights the two fits' float32 sums drift apart by
    about 3e-4 in the loss over four steps, and the mIoU of a model that has
    barely learned moves with a few flipped argmaxes."""
    tmp, port, ref = slice_runs
    for got, want in zip(port["train"]["history"], ref["train"]["history"], strict=True):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
        for key in ("train_miou", "val_miou"):
            np.testing.assert_allclose(got[key], want[key], atol=5e-3, err_msg=key)
    assert Path(port["train"]["best_path"]).name == Path(ref["train"]["best_path"]).name
    same = total = 0
    for p in sorted((tmp / "port" / "out" / "toy" / "predictions_toy").glob("PRED_*.tif")):
        with TiffReader(p) as a, TiffReader(tmp / "flairtpu" / "out" / "toy" /
                                            "predictions_toy" / p.name) as b:
            x, y = a.read(1), b.read(1)
        same += int((x == y).sum())
        total += x.size
    assert same / total >= 0.999
    got = json.loads((tmp / "port" / "out" / "toy" / "metrics" / "metrics.json").read_text())
    assert got.keys() == ref["metrics"].keys()
    assert got["classes"] == ref["metrics"]["classes"]
    for key in ("Avg_metrics", "per_class_iou", "per_class_fscore", "per_class_precision",
                "per_class_recall"):
        np.testing.assert_allclose(got[key], ref["metrics"][key], atol=1e-3, err_msg=key)


def test_predict_from_checkpoint_with_class_surgery(slice_runs, tmp_path):
    """predict without train loads ckpt_model_path; a checkpoint of another
    class count loads all but the head, which is zeroed."""
    tmp, port, _ = slice_runs
    cfg = cfgmod.validate_train_config(train_config(
        tmp_path, classes={i + 1: [1, f"c{i}"] for i in range(6)}))
    tr = SegmentationTrainer(cfg)
    zeroed = ckpt_lib.init_weights_with_surgery(port["train"]["best_path"], tr.model)
    assert zeroed == ["segmentation_head.0.weight", "segmentation_head.0.bias"]
    assert not tr.model.segmentation_head[0].weight.any()
    best = torch.load(port["train"]["best_path"], weights_only=True)["state_dict"]
    assert torch.equal(tr.model.encoder.conv1.weight, best["encoder.conv1.weight"])


def test_autosave_resume_and_resume_from_last(slice_runs, tmp_path):
    """A step autosave left by a killed run is resumed at its epoch and step
    (with its running loss) and cleared at the end; a run resumed from
    ``last`` goes on at the next epoch."""
    tmp, port, _ = slice_runs
    cfg = train_config(tmp_path, autosave_every_steps=1, num_epochs=2)
    cfg["paths"].update({k: str(tmp / f"{k[:-4]}.csv") for k in ("train_csv", "val_csv",
                                                                  "test_csv")})
    cfg = cfgmod.validate_train_config(cfg)
    out = tmp_path / "out"
    tr = SegmentationTrainer(cfg)
    ckpt_lib.StepAutosaver(out, 1).save(
        dict(tr.state(), generator=tr.generator.get_state(),
             cm_sum=torch.zeros((N_CLASSES, N_CLASSES), dtype=torch.int64)),
        {"epoch": 1, "step": 1, "loss_sum": 1.5, "n_batches": 1,
         "plateau": {"lr": 0.02, "best": None, "num_bad_epochs": 0, "cooldown_counter": 0},
         "stopper": {"best": None, "wait": 0, "stopped": False},
         "manager": {"best_metric": None, "best_path": None},
         "history": [{"epoch": 0, "val_loss": 9.0}]})
    _, info = fit(cfg, gather_paths(cfg, "train"), gather_paths(cfg, "val"), out)
    assert [h["epoch"] for h in info["history"]] == [0, 1]
    assert [e["train_patches"] for e in info["epochs"]] == [4]  # the epoch's second batch
    assert not (out / "autosave").exists()

    cfg["paths"]["ckpt_model_path"] = str(out / "last")
    cfg["tasks"]["train_tasks"]["resume_training_from_ckpt"] = True
    cfg.update(num_epochs=3, autosave_every_steps=0)
    _, info = fit(cfg, gather_paths(cfg, "train"), gather_paths(cfg, "val"), tmp_path / "out2")
    assert [h["epoch"] for h in info["history"]] == [2]


def test_init_distributions():
    """flax's lecun_normal for every conv kernel (std sqrt(1 / fan_in), cut at
    two standard deviations), zero biases, BatchNorm 1 / 0 / 0 / 1."""
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5)
    init_weights(model, 3)
    w = model.encoder.layer3[0].conv2.weight.detach()  # 256 x 256 x 3 x 3
    std = (1 / (256 * 9)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not model.segmentation_head[0].bias.any()
    bn = model.decoder.blocks[0].conv1[1]
    assert bn.weight.eq(1).all() and not bn.bias.any()
    assert not bn.running_mean.any() and bn.running_var.eq(1).all()
    other = FlairSegmentationModel("resnet18", N_CLASSES, 5)
    init_weights(other, 3)
    assert torch.equal(other.encoder.conv1.weight, model.encoder.conv1.weight)


def test_init_distributions_transposed_conv():
    """LinkNet's transposed convs are drawn as flairtpu's TorchConvTranspose
    (lecun_normal on its (k, k, in, out) kernel): std sqrt(1 / (k * k *
    in)), cut at two standard deviations, from torch's (in, out, k, k)
    weight; bias zero."""
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5, arch="linknet")
    init_weights(model, 3)
    t = model.decoder.blocks[0].block[1][0]  # ConvTranspose2d(128, 128, 4)
    assert isinstance(t, torch.nn.ConvTranspose2d) and t.weight.shape == (128, 128, 4, 4)
    w = t.weight.detach()
    std = (1 / (128 * 16)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    assert not t.bias.any()


@pytest.mark.parametrize("over,match", [
    ({"param_sharding": "fsdp"}, "param_sharding"),
    ({"tensor_parallel": 2, "param_sharding": "tensor"}, "param_sharding"),
    ({"spatial_parallel": 2}, "spatial_parallel"),
    ({"remat_policy": "dots_saveable"}, "remat"),
    ({"bn_dtype": "bfloat16"}, "bn_dtype"),
    ({"init_hf_pretrained": "hf"}, "init_hf_pretrained"),
    ({"auxiliary_loss_weight": 0.4}, "auxiliary_loss_weight"),
    ({"loader_backend": "grain"}, "grain"),
])
def test_unported_train_knobs_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        cfgmod.validate_train_config(train_config(**over))


def test_accelerator_names_the_card(tmp_path, monkeypatch):
    """accelerator: tpu (the reference config's) means the CUDA card and
    raises without one; cpu is the only route to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = tmp_path / "c.yaml"
    conf.write_text(yaml.safe_dump(train_config(tmp_path, accelerator="tpu")))
    with pytest.raises(RuntimeError, match="accelerator 'tpu' runs on the CUDA card"):
        cli.flair_main([f"--conf={conf}"])
    assert not (tmp_path / "out").exists()
    cfg = cfgmod.validate_train_config(train_config(tmp_path))
    assert SegmentationTrainer(cfg).device == torch.device("cpu")
