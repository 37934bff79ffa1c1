"""One ``flair`` train step of the slice-5 decoders (deeplabv3plus,
deeplabv3, fpn, pspnet here; pan, linknet, manet and unetplusplus in
``tests/test_torch_train_archs_full.py``) against ``flairtpu``.

The port's ``train_step`` (normalize, train-mode forward with every
BatchNorm and GroupNorm site in train mode, weighted cross-entropy,
backward, SGD) from weights carried by ``models/convert.py:from_flax``,
against ``flairtpu``'s ``_micro_step`` and its SGD update on the same
batch, as ``tests/test_torch_train.py`` holds the U-Net's. Dropout: the
port takes ``flairtpu``'s own keep masks, captured from its step (the
Dropout modules' outputs, through a wrapper of the trainer's ``_apply``
that adds ``capture_intermediates``; one jitted ``_micro_step`` an arch),
as ``tests/test_torch_metadata.py`` does for the metadata MLP. resnet18,
4 classes, batch 4, 64 x 64 patches (PAN 128 x 128), torch on one thread.
"""

import copy
import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flairtpu import config as fcfg
from flairtpu.data.normalize import normalize_device
from flairtpu.train import loop as floop
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.train.loop import SegmentationTrainer
from tests.test_torch_train import host, toy_batch, train_config

DROPOUT_KEY = 5
# conv biases in front of a train-mode BatchNorm (PAN's ConvBnRelu convs,
# LinkNet's transposed convs): their gradient is zero in exact arithmetic,
# so each package's step is float32 noise, held to 1e-6 in absolute value
BIAS_BEFORE_BN = re.compile(r"^decoder\.(fpa|gau\d)\..*conv\.bias$|"
                            r"^decoder\.blocks\.\d\.block\.1\.0\.bias$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def arch_config(arch: str) -> dict:
    return train_config(model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": f"resnet18_{arch}"}})


def flax_trainer(arch: str, size: int) -> FlaxTrainer:
    """flairtpu's trainer for ``arch``; its variables initialized at ``size``
    (its own init runs at 64 x 64, where PAN's pyramid fails: ROADMAP.md
    section 3)."""
    init = floop.init_model
    floop.init_model = lambda model, shape, seed=0: init(model, (1, size, size, shape[-1]), seed)
    try:
        return FlaxTrainer(fcfg.validate_train_config(arch_config(arch)))
    finally:
        floop.init_model = init


def capture_dropout(trainer: FlaxTrainer) -> None:
    """Make ``trainer._micro_step`` return its Dropout modules' outputs
    beside the batch statistics, under the key ``__dropout__``."""
    def apply(variables, x, mtd, train, rngs=None, mutable=False, return_aux=False):
        out, mut = trainer.model.apply(
            variables, x, train=train, rngs=rngs, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout))
        return out, {"batch_stats": dict(mut["batch_stats"],
                                         __dropout__=mut.get("intermediates", {}))}

    trainer._apply = apply


def keep_masks(captured: dict, channels: bool) -> dict | None:
    """The decoder's keep mask where flairtpu's Dropout output is not zero:
    (B, C, H, W), or with ``channels`` (Dropout2d) (B, C, 1, 1), a channel
    kept where any of its outputs is. Where the input is zero (a ReLU's
    output, or FPN's sum of four) the mask changes neither the output nor a
    gradient: the ReLU before it passes none."""
    outs = jax.tree_util.tree_leaves(captured)
    if not outs:
        return None
    (out,) = outs
    keep = torch.from_numpy(np.asarray(out) != 0).permute(0, 3, 1, 2)
    return {"decoder": keep.any(dim=(2, 3), keepdim=True) if channels else keep}


def flax_step(trainer: FlaxTrainer, img, msk):
    """flairtpu's step: normalize_device, _clean_targets, _micro_step (its
    dropout captured), SGD. Returns (loss, params, stats, cm, masks)."""
    cfg = trainer.config
    x = jax.jit(lambda a: normalize_device(a, cfg["norm_type"], tuple(cfg["norm_means"]),
                                           tuple(cfg["norm_stds"]), src_dtype=np.uint8))(
        jnp.asarray(img))
    tgt = trainer._clean_targets(jnp.asarray(msk, jnp.int32) - 1)
    capture_dropout(trainer)
    g, stats, loss, cm = jax.jit(trainer._micro_step)(
        trainer.params, trainer.batch_stats, x, tgt, jnp.zeros((x.shape[0], 45), jnp.float32),
        jax.random.PRNGKey(DROPOUT_KEY))
    stats = dict(stats)
    captured = stats.pop("__dropout__")
    updates, _ = trainer.tx.update(g, trainer.opt_state, trainer.params)
    return (float(loss), optax.apply_updates(trainer.params, updates), stats, np.asarray(cm),
            captured)


def check_train_step(arch: str, size: int, step_tol: float = 5e-3, atol: float = 1e-5,
                     cm_moved: int = 0) -> None:
    """The port's train step against flairtpu's on one batch: the loss
    within 1e-5 (relative); every parameter and running statistic after the
    step within ``atol`` of its scale (at least 1); each tensor's change in
    the step (lr * g, or the statistics' move) within ``step_tol`` in
    relative L2; at most ``cm_moved`` pixels of the confusion matrix
    moved."""
    ftr = flax_trainer(arch, size)
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(ftr.config)))
    before = from_flax(host(ftr.params), host(ftr.batch_stats), arch)
    tr.model.load_state_dict(before)
    img, msk = toy_batch(11, size=size)
    loss_j, params_j, stats_j, cm_j, captured = flax_step(ftr, img, msk)
    masks = keep_masks(captured, arch in ("fpn", "pspnet"))
    assert (masks is not None) == (arch in ("deeplabv3plus", "deeplabv3", "fpn", "pspnet"))
    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk)}, cm,
                         masks=None if masks is None else [masks])

    np.testing.assert_allclose(loss.item(), loss_j, rtol=1e-5)
    moved = int(np.abs(cm.numpy() - cm_j).sum()) // 2
    assert moved <= cm_moved, moved
    want = from_flax(host(params_j), host(stats_j), arch)
    got = tr.model.state_dict()
    assert got.keys() == want.keys()
    worst = []
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0,
                                   atol=atol * max(float(w.abs().max()), 1.0), err_msg=key)
        step_want, step_got = w - before[key], got[key] - before[key]
        if BIAS_BEFORE_BN.match(key) or not step_want.any():
            assert max(float(step_got.abs().max()), float(step_want.abs().max())) <= 1e-6, key
            continue
        worst.append((float((step_got - step_want).norm() / step_want.norm()), key))
    assert max(worst)[0] < step_tol, max(worst)


# (step_tol, atol) by arch. deeplabv3's step is ill-conditioned at this
# size: the port's own step on the batch in reverse order moves its encoder
# tensors by 2.5e-2 in relative L2 (float32 sums in another order; about
# 2e-2 at 128 x 128 too), against 1.1e-2 between the two packages; the
# parameters after it differ by up to 2.3e-5 of their scale
# (encoder.conv1.weight). Its bounds are 5e-2 and 5e-5.
TOLS = {"deeplabv3plus": (5e-3, 1e-5), "deeplabv3": (5e-2, 5e-5), "fpn": (5e-3, 1e-5),
        "pspnet": (5e-3, 1e-5)}


@pytest.mark.parametrize("arch", list(TOLS))
def test_train_step_matches_flairtpu(arch):
    check_train_step(arch, 64, *TOLS[arch])
