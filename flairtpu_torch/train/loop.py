"""Training and eval loop (counterpart of ``flairtpu/train/loop.py:101-752``;
reference Trainer.fit, training_step and the epoch metrics,
tasks.py:34-110, task_module.py:31-168).

A train step, on the device the config's ``accelerator`` names:

1. the batch (uint8 images and masks, from pinned host memory) goes to the
   device, and one ``augment_normalize`` pass cleans the labels, applies
   each sample's D4 choice (drawn from a ``torch.Generator`` seeded with
   ``seed``) and normalizes (``ops/augment.py``);
2. for each of the ``accumulate_steps`` microbatches: the model's forward
   with every BatchNorm site in train mode (``ops/bn_train.py``: batch
   statistics, the running ones chained from one microbatch to the next)
   and, with ``use_metadata``, the metadata MLP's dropout masks drawn fresh
   from the same generator (``models/metadata_mlp.py``),
   the weighted cross-entropy normalized by the microbatch's own weight sum,
   which also counts the epoch's confusion matrix on the device
   (``ops/weighted_ce.py``), and the backward, gradients summed;
3. the mean gradient and one SGD update ``p <- p - lr * g``.

The loss and the confusion matrix stay on the device and are fetched once
an epoch (``_drain_epoch``): no step waits on the host. Eval runs the same
model with its running statistics through the inference epilogue; the
model is never prepared for inference (``prepare_inference`` casts the
weights and caches BatchNorm constants), so eval and predict always see the
current weights and statistics. The learning-rate plateau, early stopping,
best/last checkpoints, the autosave and the final validate of the restored
best checkpoint follow ``flairtpu``'s ``fit``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from flairtpu_torch import config as cfgmod
from flairtpu_torch.data.patches import PatchDataset, PatchLoader, make_loader
from flairtpu_torch.models.factory import create_model, init_weights
from flairtpu_torch.models.pretrained import init_encoder_from_classifier
from flairtpu_torch.ops.augment import augment_normalize, draw_choices, norm_constants
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.confmat import per_class_jaccard, weighted_jaccard
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.weighted_ce import WeightedCE, weighted_ce
from flairtpu_torch.train import checkpoints as ckpt_lib
from flairtpu_torch.train.logging import MetricsLogger
from flairtpu_torch.train.optim import (EarlyStopping, ReduceLROnPlateau, make_optimizer,
                                        set_learning_rate)
from flairtpu_torch.utils.logger import seed_everything
from flairtpu_torch.zone.engine import compute_dtype

# metric names the epoch loop always logs; val_iou_<name> of a weight != 0
# class is a valid monitor too (flairtpu/train/loop.py:62-86)
_MONITORABLE_METRICS = frozenset({"val_loss", "val_miou", "train_loss", "train_miou"})


def resolve_device(config: dict) -> torch.device:
    """``accelerator: cpu`` -> the CPU; any other value (``tpu`` and ``gpu``
    included) -> the CUDA card, which must be there."""
    if config.get("accelerator", "tpu") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"accelerator {config.get('accelerator', 'tpu')!r} runs on the CUDA card, but CUDA "
            "is not available; set accelerator: cpu to run flair on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _validate_monitor(monitor: str, config: dict) -> None:
    if monitor in _MONITORABLE_METRICS:
        return
    if monitor.startswith("val_iou_"):
        name = monitor[len("val_iou_"):]
        logged = [n for n, w in zip(cfgmod.class_names(config), cfgmod.class_weights(config))
                  if w != 0]
        if name in logged:
            return
        raise ValueError(f"ckpt_monitor {monitor!r}: {name!r} is not a weight!=0 class "
                         f"(per-class IoU is only logged for {sorted(logged)})")
    raise ValueError(f"ckpt_monitor {monitor!r} is not a logged metric; valid monitors: "
                     f"{sorted(_MONITORABLE_METRICS)} or val_iou_<class-name> for any "
                     "weight!=0 class")


class SegmentationTrainer:
    """The model, its optimizer and the steps, from a validated train config."""

    def __init__(self, config: dict, device: torch.device | None = None):
        self.config = config
        self.device = device or resolve_device(config)
        self.dtype = compute_dtype(self.device)
        self.num_classes = cfgmod.num_classes(config)
        self.use_augmentation = bool(config.get("use_augmentation", False))
        weights = (cfgmod.class_weights(config) if config.get("use_weights", True)
                   else [1.0] * self.num_classes)
        self.class_weights = torch.tensor(weights, dtype=torch.float32, device=self.device)
        mean, mul = norm_constants(config.get("norm_type", "scaling"),
                                   config.get("norm_means") or (),
                                   config.get("norm_stds") or (), len(config["channels"]))
        self.norm_mean = torch.from_numpy(mean).to(self.device)
        self.norm_mul = torch.from_numpy(mul).to(self.device)
        self.accumulate_steps = int(config.get("accumulate_steps", 1))
        self.use_metadata = bool(config.get("use_metadata", False))
        seed = int(config.get("seed", 2022))
        self.model = create_model(config, dtype=self.dtype)
        init_weights(self.model, seed)
        self.model.to(self.device, memory_format=torch.channels_last)
        self.opt = make_optimizer(self.model.parameters(),
                                  float(config.get("learning_rate", 0.02)))
        # the augmentation choices and the dropout masks: one generator on
        # the batch's device
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.sites = TrainSites()

    # -- state plumbing --

    def state(self) -> dict:
        return {"state_dict": self.model.state_dict(), "opt_state": self.opt.state_dict()}

    def load_state(self, state: dict) -> None:
        sd = dict(state["state_dict"])
        for k, v in self.model.state_dict().items():  # counters carry no weights
            if k.endswith("num_batches_tracked"):
                sd.setdefault(k, v)
        self.model.load_state_dict(sd, strict=True)
        if state.get("opt_state"):
            self.opt.load_state_dict(state["opt_state"])

    def new_confmat(self) -> torch.Tensor:
        return torch.zeros((self.num_classes,) * 2, dtype=torch.int32, device=self.device)

    # -- steps --

    def prepare(self, batch: dict, augment: bool = False, choices=None):
        """(x (B, H, W, C) in the compute dtype, target (B, H, W) int32 or
        None) on the device; ``choices`` overrides the drawn ones."""
        img = batch["img"].to(self.device, non_blocking=True)
        msk = batch.get("msk")
        if msk is not None:
            msk = msk.to(self.device, non_blocking=True)
        if augment and choices is None:
            choices = draw_choices(img.shape[0], self.generator)
        return augment_normalize(img, msk, choices, self.norm_mean, self.norm_mul,
                                 self.num_classes, self.dtype)

    def metadata(self, batch: dict) -> torch.Tensor | None:
        """The batch's (B, 45) metadata on the device, or None."""
        mtd = batch.get("mtd")
        return None if mtd is None else mtd.to(self.device, non_blocking=True)

    def micro_step(self, x: torch.Tensor, tgt: torch.Tensor, cm: torch.Tensor | None,
                   mtd: torch.Tensor | None = None, masks=None):
        """One forward and backward on a (micro)batch; gradients add into
        ``.grad``, counts into ``cm``. Returns the detached loss. A metadata
        model's dropout takes ``masks`` (its three keep masks), else draws
        them from ``self.generator``."""
        logits = self.model(x, epilogue=self.sites, mtd=mtd,
                            dropout=self.generator if masks is None else masks)
        loss = WeightedCE.apply(logits, tgt, self.class_weights, cm)
        loss.backward()
        return loss.detach()

    def train_step(self, batch: dict, cm: torch.Tensor | None = None, choices=None,
                   masks=None):
        """One optimizer step on ``batch``; returns the loss (a 0-d tensor on
        the device: the microbatches' mean). ``choices`` overrides the drawn
        augmentation choices, ``masks`` (one entry a microbatch) the dropout
        masks."""
        x, tgt = self.prepare(batch, self.use_augmentation, choices)
        mtd = self.metadata(batch)
        A = self.accumulate_steps
        masks = masks or [None] * A
        if A == 1:
            loss = self.micro_step(x, tgt, cm, mtd, masks[0])
        else:
            b = x.shape[0] // A
            losses = []
            for i in range(A):
                sl = slice(i * b, (i + 1) * b)
                losses.append(self.micro_step(x[sl], tgt[sl], cm,
                                              None if mtd is None else mtd[sl], masks[i]))
            with torch.no_grad():
                torch._foreach_div_([p.grad for p in self.opt.params if p.grad is not None],
                                    float(A))
            loss = torch.stack(losses).mean()
        self.opt.step()
        self.opt.zero_grad()
        return loss

    @torch.inference_mode()
    def eval_step(self, batch: dict, cm: torch.Tensor | None = None):
        x, tgt = self.prepare(batch)
        logits = self.model(x, epilogue=conv_epilogue, mtd=self.metadata(batch))
        loss, _ = weighted_ce(logits, tgt, self.class_weights, cm)
        return loss


def _drain_epoch(losses: list, cm: torch.Tensor | None) -> tuple[float, np.ndarray]:
    """One host fetch for a whole epoch's device losses and confusion matrix
    (``flairtpu/train/loop.py:438-449``): the float32 sum of the losses."""
    if not losses:
        return 0.0, np.zeros((0, 0), np.int64)
    loss_sum = float(torch.stack(losses).cpu().numpy().sum())
    return loss_sum, cm.cpu().numpy().astype(np.int64)


def _epoch_metrics(loss_sum: float, n_batches: int, cm: np.ndarray) -> dict:
    return {"loss": loss_sum / max(n_batches, 1), "miou": weighted_jaccard(cm)}


def evaluate(trainer: SegmentationTrainer, loader: PatchLoader) -> dict:
    t0 = time.perf_counter()
    losses, cm, n = [], trainer.new_confmat(), 0
    for batch in loader:
        losses.append(trainer.eval_step(batch, cm))
        n += batch["img"].shape[0]
    loss_sum, cm_host = _drain_epoch(losses, cm)
    if cm_host.size == 0:
        cm_host = np.zeros((trainer.num_classes,) * 2, np.int64)
    m = _epoch_metrics(loss_sum, len(losses), cm_host)
    return {"val_loss": m["loss"], "val_miou": m["miou"], "confmat": cm_host,
            "seconds": time.perf_counter() - t0, "patches": n}


def _timed(batches, stats: dict):
    """Yields from ``batches``, adding the seconds spent waiting for each
    batch to ``stats['loader_wait_seconds']``."""
    it = iter(batches)
    while True:
        t0 = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        stats["loader_wait_seconds"] += time.perf_counter() - t0
        yield batch


def fit(config: dict, dict_train: dict, dict_val: dict, out_dir: str | Path,
        trainer: SegmentationTrainer | None = None,
        progress: Callable[[str], None] = print) -> tuple[SegmentationTrainer, dict]:
    """The training stage (reference flair/main.py:150-185, tasks.py:34-110).

    Returns (trainer, info): info holds ``history``, ``best_path``, the
    stage's ``seconds`` and ``epochs``, one record of timings an epoch
    (train seconds and patches, the loader's wait, eval seconds and patches)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seed = int(config.get("seed", 2022))
    seed_everything(seed)

    batch_size = int(config["batch_size"])
    if batch_size == 1:
        raise SystemExit(
            "batch_size=1 with BatchNorm models is unsupported (reference "
            "tasks.py:14-30 aborts for the same reason); use batch_size >= 2.")
    monitor = config.get("ckpt_monitor", "val_loss")
    _validate_monitor(monitor, config)

    trainer = trainer or SegmentationTrainer(config)
    pin = trainer.device.type == "cuda"
    channels = config["channels"]
    nw = int(config.get("num_workers", 4))
    backend = config.get("loader_backend", "threads")
    meta = trainer.use_metadata
    train_loader = make_loader(backend, PatchDataset(dict_train, channels, use_metadata=meta),
                               batch_size=batch_size, shuffle=True, seed=seed,
                               drop_last=True, num_workers=nw, pin=pin)
    val_loader = make_loader(backend, PatchDataset(dict_val, channels, use_metadata=meta),
                             batch_size=batch_size, shuffle=False, drop_last=True,
                             num_workers=nw, pin=pin)

    tasks = config.get("tasks", {})
    train_tasks = tasks.get("train_tasks", {})
    ckpt_path = config.get("paths", {}).get("ckpt_model_path") or ""
    manager = ckpt_lib.CheckpointManager(
        out_dir, model_name=config.get("paths", {}).get("out_model_name") or "model",
        monitor=monitor, mode=config.get("ckpt_monitor_mode", "min"),
        save_last=bool(config.get("ckpt_save_also_last", True)),
        weights_only=bool(config.get("ckpt_weights_only", False)))

    # the reference's implicit ImageNet encoder (smp's encoder_weights
    # default), from a local classifier state dict; before any checkpoint
    # init or resume, so that a checkpoint still wins
    enc_weights = config.get("init_encoder_weights") or ""
    if enc_weights:
        init_encoder_from_classifier(enc_weights, trainer.model)
        progress(f"    [x] encoder initialized from classifier weights {enc_weights}")

    start_epoch = 0
    if train_tasks.get("init_weights_only_from_ckpt") and ckpt_path:
        ckpt_lib.init_weights_with_surgery(ckpt_path, trainer.model)
        progress(f"    [x] initialized weights from {ckpt_path}")
    elif train_tasks.get("resume_training_from_ckpt") and ckpt_path:
        restored = manager.restore(ckpt_path)
        trainer.load_state(restored)
        start_epoch = int(restored.get("epoch", -1)) + 1
        progress(f"    [x] resumed from {ckpt_path} at epoch {start_epoch}")

    autosaver = ckpt_lib.StepAutosaver(out_dir, int(config.get("autosave_every_steps", 0) or 0))
    autosave_host = None
    acc_loss, acc_n, acc_cm = 0.0, 0, None
    start_batch = 0
    plateau = ReduceLROnPlateau(lr=float(config.get("learning_rate", 0.02)))
    stopper = EarlyStopping(monitor_mode=config.get("ckpt_monitor_mode", "min"),
                            patience=int(config.get("ckpt_earlystopping_patience", 30)))
    history: list[dict] = []
    if autosaver.every > 0 and bool(config.get("autosave_resume", True)):
        snap = autosaver.restore()
        if snap is not None:
            arrays, autosave_host = snap
            trainer.load_state(arrays)
            trainer.generator.set_state(arrays["generator"])
            acc_cm = arrays["cm_sum"].numpy().astype(np.int64)
            start_epoch = int(autosave_host["epoch"])
            start_batch = int(autosave_host["step"])
            acc_loss = float(autosave_host["loss_sum"])
            acc_n = int(autosave_host["n_batches"])
            for k, v in (autosave_host.get("plateau") or {}).items():
                setattr(plateau, k, v)
            set_learning_rate(trainer.opt, plateau.lr)
            for k, v in (autosave_host.get("stopper") or {}).items():
                setattr(stopper, k, v)
            mstate = autosave_host.get("manager") or {}
            manager.best_metric = mstate.get("best_metric")
            if mstate.get("best_path"):
                manager.best_path = out_dir / mstate["best_path"]
            history[:] = autosave_host.get("history") or []
            progress(f"    [x] autosave resume: epoch {start_epoch + 1} step {start_batch}")
    elif start_epoch:
        # a resumed run continues the augmentation stream where a fresh run
        # would not repeat it (flairtpu folds the epoch into its key)
        trainer.generator.manual_seed(seed + start_epoch)

    logger = MetricsLogger(out_dir)
    class_names = cfgmod.class_names(config)
    class_w = cfgmod.class_weights(config)
    epochs: list[dict] = []
    t_start = time.time()
    num_epochs = int(config.get("num_epochs", 1))
    for epoch in range(start_epoch, num_epochs):
        sb = start_batch if epoch == start_epoch else 0
        stats = {"epoch": epoch, "loader_wait_seconds": 0.0, "train_patches": 0}
        t0 = time.perf_counter()
        losses, cm = [], trainer.new_confmat()
        for bi, batch in enumerate(_timed(train_loader.epoch_iter(epoch, sb), stats), start=sb):
            losses.append(trainer.train_step(batch, cm))
            stats["train_patches"] += batch["img"].shape[0]
            if autosaver.due(bi):
                dl, dc = _drain_epoch(losses, cm)
                acc_loss += dl
                acc_n += len(losses)
                acc_cm = dc if acc_cm is None else acc_cm + dc
                losses, cm = [], trainer.new_confmat()
                autosaver.save(
                    arrays=dict(trainer.state(), generator=trainer.generator.get_state(),
                                cm_sum=torch.from_numpy(acc_cm)),
                    host={"epoch": epoch, "step": bi + 1, "loss_sum": acc_loss,
                          "n_batches": acc_n,
                          "plateau": {"lr": plateau.lr, "best": plateau.best,
                                      "num_bad_epochs": plateau.num_bad_epochs,
                                      "cooldown_counter": plateau.cooldown_counter},
                          "stopper": {"best": stopper.best, "wait": stopper.wait,
                                      "stopped": stopper.stopped},
                          "manager": {"best_metric": manager.best_metric,
                                      "best_path": (manager.best_path.name
                                                    if manager.best_path else None)},
                          "history": history})
        loss_sum, cm_host = _drain_epoch(losses, cm)
        stats["train_seconds"] = time.perf_counter() - t0
        loss_sum += acc_loss
        n_batches = acc_n + len(losses)
        if cm_host.size == 0:
            cm_host = np.zeros((trainer.num_classes,) * 2, np.int64)
        if acc_cm is not None:
            cm_host = cm_host + acc_cm
        acc_loss, acc_n, acc_cm = 0.0, 0, None
        tm = _epoch_metrics(loss_sum, n_batches, cm_host)

        vm = evaluate(trainer, val_loader)
        stats.update(eval_seconds=vm["seconds"], eval_patches=vm["patches"])
        epochs.append(stats)
        per_class = per_class_jaccard(vm["confmat"])
        scalars = {"train_loss": tm["loss"], "train_miou": tm["miou"],
                   "val_loss": vm["val_loss"], "val_miou": vm["val_miou"], "lr": plateau.lr}
        for name, w, iou in zip(class_names, class_w, per_class):
            if w != 0:
                scalars[f"val_iou_{name}"] = float(iou)
        logger.log(epoch, scalars)
        progress(f"    epoch {epoch + 1}/{num_epochs}  train_loss={tm['loss']:.4f} "
                 f"val_loss={vm['val_loss']:.4f} val_miou={vm['val_miou']:.4f} "
                 f"lr={plateau.lr:.2e}")

        metrics = {"val_loss": vm["val_loss"], "val_miou": vm["val_miou"],
                   "train_loss": tm["loss"], "train_miou": tm["miou"]}
        if monitor not in metrics:  # per-class val_iou_<name> monitor
            metrics[monitor] = scalars[monitor]
        manager.on_epoch_end(epoch, metrics, trainer.state())
        history.append({"epoch": epoch, **metrics})

        # the reference's scheduler always monitors val_loss in min mode
        # (task_module.py:156-168); checkpoints and early stopping follow
        # ckpt_monitor (tasks.py:47-63)
        set_learning_rate(trainer.opt, plateau.step(vm["val_loss"]))
        if stopper.step(metrics[manager.monitor]):
            progress(f"    [x] early stopping at epoch {epoch + 1}")
            break

    autosaver.clear()
    elapsed = time.time() - t_start
    progress(f"    [x] training time: {int(elapsed // 3600):02d}:"
             f"{int(elapsed % 3600 // 60):02d}:{int(elapsed % 60):02d}")
    ckpt_lib.write_history(out_dir, history)
    logger.close()

    if manager.best_path is not None:  # reload the best weights (reference flair/main.py:175)
        trainer.load_state(manager.restore_best())
        progress(f"    [x] restored best checkpoint: {manager.best_path.name}")
        final = evaluate(trainer, val_loader)  # post-fit validate (tasks.py:107)
        progress(f"    [x] best-checkpoint validation: val_loss={final['val_loss']:.4f} "
                 f"val_miou={final['val_miou']:.4f}")
    return trainer, {"history": history, "best_path": str(manager.best_path),
                     "seconds": elapsed, "epochs": epochs}
