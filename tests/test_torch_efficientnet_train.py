"""EfficientNet training in the port (CPU, float32) against ``flairtpu``.

(a) One ``flair`` train step of efficientnet-b0 under the U-Net and under
PSPNet (depth 3: 5 of b0's 16 blocks built, the drop rate still
``0.2 j / 16``) against ``flairtpu``'s ``_micro_step`` and its SGD update,
from weights carried by ``models/convert.py:from_flax``, with
``tests/test_torch_train_archs.py:check_train_step``'s rule: the loss
within 1e-5 (relative), every tensor after the step within 1e-5 of its
scale, each tensor's step within 5e-3 in relative L2. The drop-connect
masks are ``flairtpu``'s own: its step captures every ``MBConvBlock``'s
output, and sample b dropped at block j where the block's output equals
its input (block j - 1's output) bit for bit (a dropped sample adds 0 to
its identity). PSPNet's decoder dropout is captured as in
``tests/test_torch_train_archs.py``. One jitted ``flairtpu`` step an arch.
(b) The plain versions of the new kernels' arithmetic (the SiLU site's
backward, the squeeze-excite site with the gate's gradient, the project
site's drop-connect) against ``jax.vjp`` of the Flax expressions
(``nn.BatchNorm`` in train mode at eps 1e-3 and momentum 0.99), at 32
channels and at 2688 (efficientnet-b4's widest map, above the 2048 that
one block's threads cover), within 1e-5. (c) The BatchNorm plan at every
site of b0-b7 at the train batch: each channel in one tile, the tiles'
blocks covering the pixels, the combiners every channel once. (d) The
ReLU and no-activation sites keep their bits. (e) ``init_encoder_weights``
from an efficientnet classifier against ``flairtpu``'s.
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
import torch.nn as nn
from flax.traverse_util import flatten_dict

from flairtpu import config as fcfg
from flairtpu.data.normalize import normalize_device
from flairtpu.models import pretrained as fpre
from flairtpu.models.convert import torch_to_flax
from flairtpu.models.efficientnet import MBConvBlock as FlaxMBConvBlock
from flairtpu.train import loop as floop
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models import efficientnet as en
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.models.factory import FlairSegmentationModel, init_weights
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops import se_gate as sg
from flairtpu_torch.train.loop import SegmentationTrainer
from tests.test_torch_train import host, toy_batch, train_config
from tests.test_torch_train_archs import keep_masks
from tests.torch_ref_efficientnet import EfficientNetEncoderTorch

ENCODER = "efficientnet-b0"
# flairtpu's dropout key of each arch's step: under it a sample drops at
# one of PSPNet's two dropping blocks (rates 0.025 and 0.05 at batch 4:
# sample 3 at block 4) and three samples at the U-Net's blocks 12-14
DROPOUT_KEY = {"unet": 5, "pspnet": 0}
STEP_TOL, ATOL = 5e-3, 1e-5
# the batch's two other orders, whose steps give the port's own drift, and
# the drift rule's factors (tests/test_torch_resnext_train.py's)
ORDERS = ([3, 2, 1, 0], [1, 3, 0, 2])
DRIFT_ABS, DRIFT_REL = 15, 5
PLAIN_TOL = 1e-5
BLOCK = re.compile(r"^block(\d+)$")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def effnet_config(arch: str) -> dict:
    return train_config(model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": f"{ENCODER}_{arch}"}})


def capture(trainer: FlaxTrainer) -> None:
    """Make ``trainer._micro_step`` return its MBConvBlocks' and Dropout
    modules' outputs beside the batch statistics, under ``__captured__``."""
    def apply(variables, x, mtd, train, rngs=None, mutable=False, return_aux=False):
        out, mut = trainer.model.apply(
            variables, x, train=train, rngs=rngs, mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, _: isinstance(m, (FlaxMBConvBlock, fnn.Dropout)))
        return out, {"batch_stats": dict(mut["batch_stats"],
                                         __captured__=mut.get("intermediates", {}))}

    trainer._apply = apply


def drop_connect_masks(captured: dict) -> tuple[dict, dict]:
    """(the keep masks of the encoder's drop-connect by block index, the
    captured Dropout outputs): sample b kept at block j unless the block's
    output equals block j - 1's bit for bit."""
    outs, dropout = {}, {}
    for path, value in flatten_dict(captured).items():
        blocks = [int(m.group(1)) for m in map(BLOCK.match, path) if m]
        if blocks:
            outs[blocks[-1]] = np.asarray(value[0])
        else:
            dropout[path] = value
    masks = {}
    for j, plan in enumerate(en.efficientnet_plan(ENCODER)["blocks"][:len(outs)]):
        if j and plan["skip"]:
            same = (outs[j] == outs[j - 1]).reshape(outs[j].shape[0], -1).all(axis=1)
            masks[j] = torch.from_numpy(~same)
    return masks, dropout


@pytest.fixture(scope="module", params=["unet", "pspnet"])
def flax_run(request):
    return flax_step(request.param)


def flax_trainer(arch: str) -> FlaxTrainer:
    """flairtpu's trainer for ``arch``, its variables flairtpu's own
    ``torch_to_flax`` of the port's initial weights (Flax's distributions,
    ``models/factory.py:init_weights``) in place of its jitted
    ``init_model``, the most of this test's time otherwise."""
    cfg = fcfg.validate_train_config(effnet_config(arch))
    model = FlairSegmentationModel(ENCODER, len(cfg["classes"]), len(cfg["channels"]),
                                   arch=arch)
    init_weights(model, 7)
    variables = torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()})
    init = floop.init_model
    floop.init_model = lambda *a, **k: (jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                        jax.tree_util.tree_map(jnp.asarray,
                                                               variables["batch_stats"]))
    try:
        return FlaxTrainer(cfg)
    finally:
        floop.init_model = init


def flax_step(arch: str) -> tuple:
    """flairtpu's trainer and its step on one batch (normalize_device,
    _clean_targets, _micro_step with its modules' outputs captured, SGD):
    (arch, trainer, loss, params, stats, cm, masks for the port's step,
    the batch)."""
    ftr = flax_trainer(arch)
    cfg = ftr.config
    img, msk = toy_batch(11)
    x = jax.jit(lambda a: normalize_device(a, cfg["norm_type"], tuple(cfg["norm_means"]),
                                           tuple(cfg["norm_stds"]), src_dtype=np.uint8))(
        jnp.asarray(img))
    tgt = ftr._clean_targets(jnp.asarray(msk, jnp.int32) - 1)
    capture(ftr)
    g, stats, loss, cm = jax.jit(ftr._micro_step)(
        ftr.params, ftr.batch_stats, x, tgt, jnp.zeros((x.shape[0], 45), jnp.float32),
        jax.random.PRNGKey(DROPOUT_KEY[arch]))
    stats = dict(stats)
    drop, dropout = drop_connect_masks(stats.pop("__captured__"))
    masks = {"drop_connect": drop}
    decoder = keep_masks(dropout, channels=True)
    if decoder is not None:
        masks.update(decoder)
    assert (decoder is not None) == (arch == "pspnet")
    updates, _ = ftr.tx.update(g, ftr.opt_state, ftr.params)
    return (arch, ftr, float(loss), optax.apply_updates(ftr.params, updates), stats,
            np.asarray(cm), masks, (img, msk))


def permuted(masks: dict, order) -> dict:
    """A step's dropout masks for its samples in ``order``."""
    out = {"drop_connect": {j: m[order] for j, m in masks["drop_connect"].items()}}
    if "decoder" in masks:
        out["decoder"] = masks["decoder"][order]
    return out


def port_step(cfg: dict, state: dict, img, msk, masks) -> tuple[float, dict, np.ndarray]:
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    tr.model.load_state_dict(state)
    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk)}, cm,
                         masks=[masks])
    return loss.item(), tr.model.state_dict(), cm.numpy()


def test_train_step_matches_flairtpu(flax_run):
    """The port's train step against flairtpu's on one batch, on its
    drop-connect masks (at least one sample dropped): the loss and the
    confusion matrix, the change over all tensors, and each tensor under
    the drift rule (the module docstring)."""
    arch, ftr, loss_j, params_j, stats_j, cm_j, masks, (img, msk) = flax_run
    n_blocks = {"unet": 16, "pspnet": 5}[arch]
    assert max(masks["drop_connect"]) < n_blocks
    assert any(not bool(m.all()) for m in masks["drop_connect"].values())
    before = from_flax(host(ftr.params), host(ftr.batch_stats), arch)
    loss, got, cm = port_step(ftr.config, before, img, msk, masks)
    others = [port_step(ftr.config, before, img[p].copy(), msk[p].copy(), permuted(masks, p))[1]
              for p in ORDERS]
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(ftr.config)))
    assert len(tr.model.encoder._blocks) == n_blocks and tr.model.encoder.n_blocks == 16

    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert np.array_equal(cm, cm_j)
    want = from_flax(host(params_j), host(stats_j), arch)
    assert got.keys() == want.keys()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    gap = sum(float((got[k] - want[k]).norm()) ** 2 for k in keys)
    change = sum(float((want[k] - before[k]).norm()) ** 2 for k in keys)
    assert (gap / change) ** 0.5 < STEP_TOL
    for key in keys:
        w = want[key]
        drift = max(float((got[key] - o[key]).abs().max()) for o in others)
        err = float((got[key] - w).abs().max())
        assert err <= max(ATOL * max(float(w.abs().max()), 1.0), DRIFT_ABS * drift), (
            key, err, drift)
        step_want = w - before[key]
        if not step_want.any():
            assert err <= 1e-6, key
            continue
        rel = float((got[key] - w).norm() / step_want.norm())
        self_rel = max(float((got[key] - o[key]).norm() / step_want.norm()) for o in others)
        assert rel <= max(STEP_TOL, DRIFT_REL * self_rel), (key, rel, self_rel)


def test_init_encoder_weights_equals_flairtpus(tmp_path):
    """An efficientnet-pytorch classifier (tests/torch_ref_efficientnet.py's
    encoder keys at 3 input channels, with the head's _conv_head, _bn1 and
    _fc) loaded into the port's encoder at 5 channels equals flairtpu's
    encoder after its init, carried by from_flax; nothing else moves."""
    arch, ftr = "unet", flax_trainer("unet")
    rng = np.random.default_rng(24)
    ref = EfficientNetEncoderTorch(ENCODER, in_channels=3)
    shapes = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    shapes.update({"_conv_head.weight": (1280, 320, 1, 1), "_bn1.weight": (1280,),
                   "_bn1.bias": (1280,), "_bn1.running_mean": (1280,),
                   "_bn1.running_var": (1280,), "_fc.weight": (1000, 1280), "_fc.bias": (1000,)})
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
            continue
        a = (rng.uniform(0.5, 2.0, shape) if k.endswith("running_var") else
             rng.normal(0.0, 0.5, shape))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    sd["_bn1.num_batches_tracked"] = torch.tensor(7)
    pth = tmp_path / "classifier.pth"
    torch.save(sd, pth)
    out = fpre.init_encoder_from_classifier(
        pth, ENCODER, 5, {"params": ftr.params, "batch_stats": ftr.batch_stats})
    want = from_flax(host(out["params"]), host(out["batch_stats"]), arch)

    model = FlairSegmentationModel(ENCODER, ftr.num_classes, 5)
    init_weights(model, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ppre.init_encoder_from_classifier(pth, model)
    got = model.state_dict()
    enc = [k for k in got if k.startswith("encoder.") and not k.endswith("num_batches_tracked")]
    assert "encoder._blocks.3._bn1.weight" in enc and len(enc) == len(
        [k for k in want if k.startswith("encoder.") and not k.endswith("num_batches_tracked")])
    assert ppre.stem_in_channels(model.encoder) == 5
    for k in enc:
        assert torch.equal(got[k], want[k]), k
    for k in got:
        if not k.startswith("encoder."):
            assert torch.equal(got[k], before[k]), k


# -- (b) the plain versions against jax.vjp -----------------------------------

SHAPES = {32: (3, 5, 6), 2688: (2, 3, 5)}  # channels: (B, H, W)
KEEP = 0.8


def bn_vars(rng, c: int) -> dict:
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.2, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}


def bn_module(v: dict) -> nn.BatchNorm2d:
    c = v["params"]["scale"].shape[0]
    bn = en.bn2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    return bn


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def close(got, want, what: str) -> None:
    got = nhwc(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=PLAIN_TOL, atol=PLAIN_TOL,
                               err_msg=what)


def flax_bn(v: dict):
    """Flax's train-mode BatchNorm at EfficientNet's constants: f(y, params)
    -> (out, new batch stats)."""
    module = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                           dtype=jnp.float32)
    stats = jax.tree_util.tree_map(jnp.asarray, v["batch_stats"])

    def f(y, params):
        out, mut = module.apply({"params": params, "batch_stats": stats}, y,
                                mutable=["batch_stats"])
        return out, mut["batch_stats"]

    return f


@pytest.mark.parametrize("channels", list(SHAPES))
@pytest.mark.parametrize("kind", ["silu", "se", "drop", "gate_grad"])
def test_plain_versions_match_jax_vjp(kind, channels):
    """The SiLU site (a stem or expand), the depthwise site (BatchNorm,
    SiLU, squeeze-excite), the project site's drop-connect and the gate's
    gradient alone (se_backward_plain), through the plain versions,
    against jax.vjp of flairtpu's expressions (flairtpu/models/
    efficientnet.py:182, :191-211) on numpy-seeded inputs: outputs,
    running statistics and every gradient within 1e-5."""
    rng = np.random.default_rng(channels + len(kind))
    B, H, W = SHAPES[channels]
    shape = (B, H, W, channels)
    y = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    v = bn_vars(rng, channels)
    jp = jax.tree_util.tree_map(jnp.asarray, v["params"])
    bnf = flax_bn(v)
    bn = bn_module(v)
    yt = nchw(y).requires_grad_(True)

    if kind == "silu":
        def f(yy, p):
            out, st = bnf(yy, p)
            return jax.nn.silu(out), st

        out_j, vjp, st_j = jax.vjp(f, jnp.asarray(y), jp, has_aux=True)
        dy_j, dp_j = vjp(jnp.asarray(g))
        out, _ = bt.TrainSites().site(yt, bn, act="silu")
        out.backward(nchw(g))
    elif kind == "drop":
        r = rng.standard_normal(shape).astype(np.float32)
        mask = np.array([0.0] + [1.0] * (B - 1), np.float32)

        def f(yy, rr, p):
            out, st = bnf(yy, p)
            return out / KEEP * jnp.asarray(mask)[:, None, None, None] + rr, st

        out_j, vjp, st_j = jax.vjp(f, jnp.asarray(y), jnp.asarray(r), jp, has_aux=True)
        dy_j, dr_j, dp_j = vjp(jnp.asarray(g))
        rt = nchw(r).requires_grad_(True)
        out, _ = bt.TrainSites().site(yt, bn, residual=rt, act=None,
                                      drop=(torch.from_numpy(mask), KEEP))
        out.backward(nchw(g))
        close(rt.grad, dr_j, "identity gradient")
        assert torch.equal(out[0].detach(), rt[0].detach())  # the dropped sample
    else:
        se = 8
        w_r = (rng.standard_normal((se, channels)) / np.sqrt(channels)).astype(np.float32)
        b_r = rng.normal(0, 0.1, se).astype(np.float32)
        w_e = (rng.standard_normal((channels, se)) / np.sqrt(se)).astype(np.float32)
        b_e = rng.normal(0, 0.1, channels).astype(np.float32)
        reduce, expand = nn.Conv2d(channels, se, 1), nn.Conv2d(se, channels, 1)
        with torch.no_grad():
            for m, w, b in ((reduce, w_r, b_r), (expand, w_e, b_e)):
                m.weight.copy_(torch.from_numpy(w)[:, :, None, None])
                m.bias.copy_(torch.from_numpy(b))

        def gate_of(a, wr, br, we, be):
            s = jnp.mean(a, axis=(1, 2)) @ wr.T + br
            return jax.nn.sigmoid(jax.nn.silu(s) @ we.T + be)

        ws = tuple(map(jnp.asarray, (w_r, b_r, w_e, b_e)))
        if kind == "gate_grad":
            out_j, st_j = bnf(jnp.asarray(y), jp)
            a = jax.nn.silu(out_j)
            gate = np.asarray(gate_of(a, *ws))
            _, vjp = jax.vjp(lambda gt: a * gt[:, None, None, :], jnp.asarray(gate))
            (dgate_j,) = vjp(jnp.asarray(g))
            mean, invstd, scale, shift = bt.bn_stats_plain(
                yt.detach(), bn.weight.detach(), bn.bias.detach(), bn.running_mean,
                bn.running_var, 1e-3, 0.99)
            dgate = sg.se_backward(nchw(g).contiguous(memory_format=torch.channels_last),
                                   yt.detach().contiguous(memory_format=torch.channels_last),
                                   scale, shift)
            close(dgate, dgate_j, "dgate")
            close(bn.running_var, st_j["var"], "running var")
            return

        def f(yy, p, *w):
            out, st = bnf(yy, p)
            a = jax.nn.silu(out)
            return a * gate_of(a, *w)[:, None, None, :], st

        out_j, vjp, st_j = jax.vjp(f, jnp.asarray(y), jp, *ws, has_aux=True)
        dy_j, dp_j, dwr, dbr, dwe, dbe = vjp(jnp.asarray(g))
        out = bt.TrainSites().se_site(yt, bn, reduce, expand)
        out.backward(nchw(g))
        close(reduce.weight.grad[:, :, 0, 0], dwr, "reduce weight")
        close(reduce.bias.grad, dbr, "reduce bias")
        close(expand.weight.grad[:, :, 0, 0], dwe, "expand weight")
        close(expand.bias.grad, dbe, "expand bias")
    close(out, out_j, "out")
    close(bn.running_mean, st_j["mean"], "running mean")
    close(bn.running_var, st_j["var"], "running var")
    close(yt.grad, dy_j, "dy")
    close(bn.weight.grad, dp_j["scale"], "dgamma")
    close(bn.bias.grad, dp_j["bias"], "dbeta")


# -- (c) the plan above 2048 channels --------------------------------------------

CO_RESIDENT = (132, 264, 528, 1056)


def encoder_sites(encoder: str, batch: int = 16, size: int = 512) -> set:
    """(pixels, channels) of every BatchNorm site of ``encoder`` on size²
    tiles: the stem, each expand, depthwise and project."""
    side = size // 2
    plan = en.efficientnet_plan(encoder)
    out = {(batch * side * side, plan["stem_ch"])}
    for b in plan["blocks"]:
        mid = b["cin"] * b["expand"]
        if b["expand"] != 1:
            out.add((batch * side * side, mid))
        side = -(-side // b["stride"])
        out |= {(batch * side * side, mid), (batch * side * side, b["cout"])}
    return out


def test_every_wide_site_is_tiled():
    """b2-b7 have maps above 2048 channels (b3's last stage too), b0 and b1
    none; every channel
    count of b0-b7 takes equal tiles of whole 8-channel groups, each at
    most 2048 and, above 2048, at least MIN_TILE_CHANNELS wide."""
    wide = {e: sorted({c for _, c in encoder_sites(e) if c > 8 * bt.THREADS})
            for e in en.EFFICIENTNET_SPECS}
    assert wide == {"efficientnet-b0": [], "efficientnet-b1": [], "efficientnet-b2": [2112],
                    "efficientnet-b3": [2304], "efficientnet-b4": [2688],
                    "efficientnet-b5": [3072], "efficientnet-b6": [2064, 3456],
                    "efficientnet-b7": [2304, 3840]}
    for e in en.EFFICIENTNET_SPECS:
        for _, c in encoder_sites(e):
            t = bt.channel_tiles(c)
            width = c // t
            assert t * width == c and width % 8 == 0 and width <= 8 * bt.THREADS
            assert t == 1 if c <= 8 * bt.THREADS else width >= bt.MIN_TILE_CHANNELS


def combined_channels(plan: bt.Plan, channels: int) -> list[int]:
    """The channels each combiner takes in csrc/bn_train.cu's combine, in
    order: combiner r's teams take r * teams + team, then every
    combiners * teams further (teams = WARPS / the warps a channel)."""
    nb = plan.grid // plan.channel_tiles
    seg = 1
    while seg < bt.WARPS and seg * 32 * bt.COMBINE_LOADS < nb:
        seg *= 2
    teams = bt.WARPS // seg
    return [c0 + team for r in range(plan.combiners)
            for c0 in range(r * teams, channels, plan.combiners * teams)
            for team in range(teams) if c0 + team < channels]


@pytest.mark.parametrize("encoder", list(en.EFFICIENTNET_SPECS))
def test_launch_plan_at_every_site(encoder):
    """At every site of the encoder at batch 16 x 512² and every grid cap:
    the grid a whole number of blocks a tile and at most the cap; block i
    takes tile i % tiles, so each channel lies in one tile and each tile's
    blocks take whole pixel tiles that cover the map once; the scratch
    holds each block's sums of its tile; the combiners take every channel
    once."""
    for m, c in sorted(encoder_sites(encoder)):
        for mode in ("stats", "backward"):
            for co in CO_RESIDENT:
                plan = bt.launch_plan(m, c, mode, co)
                t = plan.channel_tiles
                width, nb = c // t, plan.grid // t
                assert plan.grid % t == 0 and 1 <= nb and plan.grid <= max(co, t)
                assert plan.tile == bt.THREADS // (width // 8) * bt.UNROLL[mode]
                owner = np.repeat(np.arange(t), width)  # each channel's tile
                assert len(owner) == c
                assert sorted(set(i % t for i in range(plan.grid))) == list(range(t))
                starts = np.arange(0, m, plan.tile)
                share = np.bincount(np.arange(len(starts)) % nb,
                                    weights=np.minimum(plan.tile, m - starts), minlength=nb)
                assert share.sum() == m and (nb == 1 or 2 * width * share.min()
                                             >= bt.MIN_BLOCK_BYTES)
                assert plan.partials == plan.sums * c * nb
                assert 1 <= plan.combiners <= nb
                assert sorted(combined_channels(plan, c)) == list(range(c))


def test_plan_is_unchanged_at_2048_channels_or_fewer():
    """One tile, and the plan of the sites that slices 1-5 launch."""
    for c in (8, 64, 512, 2048):
        for m in (16, 4096, 16 * 256 * 256):
            plan = bt.launch_plan(m, c, "backward", 528)
            assert plan.channel_tiles == 1
            rows = bt.THREADS // (c // 8)
            tile = rows * bt.UNROLL["backward"]
            grid = max(1, min(528, (m // tile) // -(-bt.MIN_BLOCK_BYTES // (2 * tile * c))))
            assert plan[:6] == (grid, tile, 2, bt.combiners(grid, c), 2 * c * grid, bt.COUNTERS)


# -- (d) ReLU and no-activation sites keep their bits -------------------------


def before_site(y, bn, residual, relu):
    """The site as the plain versions computed it before the SiLU and the
    gradient affine: (out, dy, dgamma, dbeta, dres) for the incoming g."""
    def run(g):
        C, m = y.shape[1], y.numel() // y.shape[1]
        yf = y.float()
        mean, ex2 = yf.mean(dim=(0, 2, 3)), (yf * yf).mean(dim=(0, 2, 3))
        var = torch.clamp_min(ex2 - mean * mean, 0)
        invstd = torch.rsqrt(var + bn.eps)
        scale = bn.weight.detach() * invstd
        shift = bn.bias.detach() - mean * scale
        v = yf * scale[:, None, None] + shift[:, None, None]
        if residual is not None:
            v = v + residual.float()
        out = torch.relu(v) if relu else v
        gz = g.float() * (out > 0) if relu else g.float()
        xh = (yf - mean[:, None, None]) * invstd[:, None, None]
        dbeta = gz.sum(dim=(0, 2, 3))
        dgamma = (gz * xh).sum(dim=(0, 2, 3))
        k = (bn.weight.detach() * invstd)[:, None, None]
        dy = k * (gz - (dbeta[:, None, None] + xh * dgamma[:, None, None]) / m)
        return out, dy, dgamma, dbeta, gz
    return run


@pytest.mark.parametrize("act", [True, "relu", None, False])
@pytest.mark.parametrize("residual", [False, True])
def test_relu_and_identity_sites_keep_their_bits(act, residual):
    """TrainSites.site at a resnet18 site (layer1's second BatchNorm, 64
    channels), ReLU (``act`` True, as bn_site and the positional callers
    pass it, or "relu") or none, with and without its float32 residual:
    the output and every gradient exactly as the site computed them before
    this port's SiLU and gradient affine."""
    rng = np.random.default_rng(3 + 2 * residual)
    model = FlairSegmentationModel("resnet18", 4, 5)
    bn = model.encoder.layer1[0].bn2
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0, 0.2)
    y = nchw(rng.standard_normal((2, 16, 16, 64)).astype(np.float32))
    g = nchw(rng.standard_normal((2, 16, 16, 64)).astype(np.float32))
    r = nchw(rng.standard_normal((2, 16, 16, 64)).astype(np.float32)) if residual else None
    relu = act in (True, "relu")
    want = before_site(y, bn, r, relu)(g)
    yt = y.clone().requires_grad_(True)
    rt = r.clone().requires_grad_(True) if residual else None
    out, _ = bt.TrainSites().site(yt, bn, residual=rt, act=act)
    out.backward(g)
    assert torch.equal(out.detach(), want[0])
    assert torch.equal(yt.grad, want[1])
    assert torch.equal(bn.weight.grad, want[2]) and torch.equal(bn.bias.grad, want[3])
    if residual:
        assert torch.equal(rt.grad, want[4])
