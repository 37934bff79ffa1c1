"""MobileNetV2 training in the port (CPU, float32) against ``flairtpu``.

(a) One ``flair`` train step of mobilenet_v2-unet (128², batch 2) against
``flairtpu``'s jitted ``_micro_step`` and its SGD update, from weights
carried by ``models/convert.py:from_flax``, with
``tests/test_torch_efficientnet_train.py``'s rule: the loss within 1e-5
(relative), the confusion matrix but at near-ties (at most 1e-4 of the
pixels), every tensor after the step within 1e-5 of its scale, or 15 x
the port's own drift over the batch's other order, and each tensor's step
within 5e-3 in relative L2, or 5 x that drift, where the step is above
float32 rounding. The weights are ``random_state_dict``'s (nonzero beta and
running statistics): at Flax's initial ones every BatchNorm output is
exactly zero-mean, so the next 1x1 conv's running mean steps by rounding
alone. The model has no dropout.
(b) The ReLU6 site's plain versions (``ops/bn_train.py``: the forward, and
the backward that recomputes z) against ``jax.vjp`` of Flax's train-mode
``BatchNorm`` followed by ``jnp.clip(·, 0, 6)`` (``flairtpu/models/
tv_encoders.py:111, 115``), at 32 and 1280 channels, within 1e-5; with
channels whose gamma is 0 and beta is -1, 0, 3, 6 or 7, where z is beta in
both packages, so the 1/2 of ``jnp.clip``'s VJP at z = 0 and z = 6 shows
in dgamma and dbeta. (c) A z in [5.984375, 6), which bf16 rounds to 6,
gets gradient 1: the mask does not come from the bf16 output. (d)
``init_encoder_weights`` from a torchvision classifier against
``flairtpu``'s.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flairtpu import config as fcfg
from flairtpu.data.normalize import normalize_device
from flairtpu.models import pretrained as fpre
from flairtpu.models.convert import torch_to_flax
from flairtpu.train import loop as floop
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models import mobilenet as mn
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.models.factory import FlairSegmentationModel, init_weights
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops.epilogue import conv_epilogue_plain
from flairtpu_torch.train.loop import SegmentationTrainer
from tests.test_torch_models import random_state_dict
from tests.test_torch_train import host, toy_batch, train_config
from tests.torch_ref_tv import MobileNetV2EncoderTorch

ENCODER_DECODER = "mobilenet_v2_unet"
# 128² tiles: at 64² the deepest maps are 2 x 2, and the step is chaotic
# (the port's own step moves by about twice its size in relative L2 when
# torch's CPU convolutions change backend); at 128² the flairtpu gap, the
# port's backend change and its order drift are all near 1e-4
BATCH, SIZE = 2, 128
STEP_TOL, ATOL = 5e-3, 1e-5
ORDERS = ([1, 0],)  # the batch's other order, whose step gives the port's own drift
DRIFT_ABS, DRIFT_REL = 15, 5
# a tensor's step below 8 float32 ulps of its largest value (a deep block's
# bias at the initial weights moves by 1e-11) is rounding, not a step: the
# relative rule does not apply to it
RESOLUTION = 2.0 ** -20
PLAIN_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mobilenet_config() -> dict:
    return train_config(batch_size=BATCH, model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": ENCODER_DECODER}})


def initial_variables(cfg: dict, seed: int, trained: bool = False):
    """The port's model at Flax's initial distributions (``trained``: at
    ``random_state_dict``'s, BatchNorms with nonzero beta and running
    statistics, as a trained model's) and flairtpu's ``torch_to_flax`` of
    it."""
    model = FlairSegmentationModel("mobilenet_v2", len(cfg["classes"]), len(cfg["channels"]))
    if trained:
        model.load_state_dict(random_state_dict(model, np.random.default_rng(seed)))
    else:
        init_weights(model, seed)
    return model, torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()})


@pytest.fixture(scope="module")
def flax_run():
    return flax_step(BATCH, SIZE)


def flax_step(batch: int, size: int = SIZE, trained: bool = True) -> tuple:
    """flairtpu's trainer, its variables ``initial_variables`` in place of
    its jitted ``init_model``, and its step on one batch of ``batch``
    (normalize_device, _clean_targets, _micro_step, SGD): (trainer, loss,
    params, stats, cm, the batch)."""
    cfg = fcfg.validate_train_config(train_config(batch_size=batch, model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": ENCODER_DECODER}}))
    _, variables = initial_variables(cfg, 7, trained)
    init = floop.init_model
    floop.init_model = lambda *a, **k: (jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                                        jax.tree_util.tree_map(jnp.asarray,
                                                               variables["batch_stats"]))
    try:
        ftr = FlaxTrainer(cfg)
    finally:
        floop.init_model = init
    img, msk = toy_batch(13, n=batch, size=size)
    x = jax.jit(lambda a: normalize_device(a, cfg["norm_type"], tuple(cfg["norm_means"]),
                                           tuple(cfg["norm_stds"]), src_dtype=np.uint8))(
        jnp.asarray(img))
    tgt = ftr._clean_targets(jnp.asarray(msk, jnp.int32) - 1)
    g, stats, loss, cm = jax.jit(ftr._micro_step)(
        ftr.params, ftr.batch_stats, x, tgt, jnp.zeros((batch, 45), jnp.float32),
        jax.random.PRNGKey(0))
    updates, _ = ftr.tx.update(g, ftr.opt_state, ftr.params)
    return (ftr, float(loss), optax.apply_updates(ftr.params, updates), stats, np.asarray(cm),
            (img, msk))


def port_step(cfg: dict, state: dict, img, msk) -> tuple[float, dict, np.ndarray]:
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    tr.model.load_state_dict(state)
    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk)}, cm)
    return loss.item(), tr.model.state_dict(), cm.numpy()


def test_train_step_matches_flairtpu(flax_run):
    """The port's train step against flairtpu's on one batch: the loss and
    the confusion matrix, the change over all tensors, and each tensor
    under the drift rule (the module docstring)."""
    ftr, loss_j, params_j, stats_j, cm_j, (img, msk) = flax_run
    before = from_flax(host(ftr.params), host(ftr.batch_stats))
    loss, got, cm = port_step(ftr.config, before, img, msk)
    others = [port_step(ftr.config, before, img[p].copy(), msk[p].copy())[1] for p in ORDERS]

    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    # the same truth in each row; a pixel's class may differ only at a
    # near-tie of its logits: at most 1e-4 of the pixels
    np.testing.assert_array_equal(cm.sum(axis=1), cm_j.sum(axis=1))
    assert np.abs(cm - cm_j).sum() // 2 <= cm_j.sum() // 10 ** 4
    want = from_flax(host(params_j), host(stats_j))
    assert got.keys() == want.keys()
    assert "encoder.features.18.1.running_var" in want
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
        if float(step_want.abs().max()) <= RESOLUTION * max(float(w.abs().max()), 1.0):
            continue  # a step within float32 rounding of the tensor: the rule above holds it
        rel = float((got[key] - w).norm() / step_want.norm())
        self_rel = max(float((got[key] - o[key]).norm() / step_want.norm()) for o in others)
        assert rel <= max(STEP_TOL, DRIFT_REL * self_rel), (key, rel, self_rel)


def test_train_sites_are_relu6_and_project_sites():
    """35 ReLU6 sites (the stem, each expand, each depthwise, features.18)
    and 17 project sites with no activation, 10 of them with the identity,
    in one train forward of the encoder."""
    sites = []

    class Recorder(bt.TrainSites):
        def site(self, y, bn, residual=None, branch=None, act="relu", keep_f32=False,
                 drop=None):
            sites.append((bt.ACTIVATIONS[act], residual is not None))
            return super().site(y, bn, residual, branch, act, keep_f32, drop)

    enc = mn.MobileNetV2Encoder(5)
    with torch.no_grad():
        enc(torch.rand(2, 5, 32, 32), epilogue=Recorder())
    assert sites.count(("relu6", False)) == 35 and len(sites) == 52
    assert sites.count((None, True)) == 10 and sites.count((None, False)) == 7


def test_init_encoder_weights_equals_flairtpus(tmp_path):
    """A torchvision MobileNetV2 classifier (``tests/torch_ref_tv.py``'s
    encoder keys at 3 input channels, with its ``classifier.1``) loaded
    into the port's encoder at 5 channels equals flairtpu's encoder after
    its init, carried by from_flax; nothing else moves."""
    cfg = mobilenet_config()
    model, variables = initial_variables(cfg, 2)
    rng = np.random.default_rng(24)
    shapes = {k: tuple(v.shape) for k, v in MobileNetV2EncoderTorch(3).state_dict().items()}
    shapes.update({"classifier.1.weight": (1000, 1280), "classifier.1.bias": (1000,)})
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
            continue
        a = (rng.uniform(0.5, 2.0, shape) if k.endswith("running_var") else
             rng.normal(0.0, 0.5, shape))
        sd[k] = torch.from_numpy(a.astype(np.float32))
    pth = tmp_path / "classifier.pth"
    torch.save(sd, pth)
    out = fpre.init_encoder_from_classifier(pth, "mobilenet_v2", 5, variables)
    want = from_flax(host(out["params"]), host(out["batch_stats"]))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    ppre.init_encoder_from_classifier(pth, model)
    got = model.state_dict()
    enc = [k for k in got if k.startswith("encoder.") and not k.endswith("num_batches_tracked")]
    assert "encoder.features.1.conv.2.running_var" in enc and len(enc) == len(
        [k for k in want if k.startswith("encoder.") and not k.endswith("num_batches_tracked")])
    assert ppre.stem_in_channels(model.encoder) == 5
    assert not torch.equal(got["encoder.features.0.0.weight"],
                           before["encoder.features.0.0.weight"])
    for k in enc:
        assert torch.equal(got[k], want[k]), k
    for k in got:
        if not k.startswith("encoder."):
            assert torch.equal(got[k], before[k]), k


# -- (b) the ReLU6 site's plain versions against jax.vjp ---------------------

SHAPES = {32: (3, 5, 6), 1280: (2, 3, 4)}  # channels: (B, H, W)
TIE_BETAS = (-1.0, 0.0, 3.0, 6.0, 7.0)  # at gamma 0, z = beta


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def close(got, want, what: str) -> None:
    got = nhwc(got) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=PLAIN_TOL, atol=PLAIN_TOL,
                               err_msg=what)


@pytest.mark.parametrize("channels", list(SHAPES))
def test_relu6_site_matches_jax_vjp(channels):
    """TrainSites.site(act="relu6") through the plain versions against
    jax.vjp of Flax's train-mode BatchNorm (momentum 0.9, eps 1e-5) and
    jnp.clip(·, 0, 6): the output, the running statistics, dy, dgamma and
    dbeta within 1e-5; at the gamma-0 channels dbeta is the sum of g times
    0, 1/2, 1, 1/2, 0 for beta -1, 0, 3, 6, 7."""
    rng = np.random.default_rng(channels)
    B, H, W = SHAPES[channels]
    shape = (B, H, W, channels)
    y = rng.standard_normal(shape).astype(np.float32) * 3
    g = rng.standard_normal(shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    beta = rng.normal(2.5, 1.5, channels).astype(np.float32)
    gamma[:len(TIE_BETAS)] = 0.0
    beta[:len(TIE_BETAS)] = TIE_BETAS
    stats = {"mean": rng.normal(0, 0.1, channels).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, channels).astype(np.float32)}
    module = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           dtype=jnp.float32)

    def f(yy, p):
        out, mut = module.apply({"params": p, "batch_stats": stats}, yy, mutable=["batch_stats"])
        return jnp.clip(out, 0.0, 6.0), mut["batch_stats"]

    params = {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)}
    out_j, vjp, st_j = jax.vjp(f, jnp.asarray(y), params, has_aux=True)
    dy_j, dp_j = vjp(jnp.asarray(g))

    bn = mn.bn2d(channels)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    yt = nchw(y).requires_grad_(True)
    out, _ = bt.TrainSites().site(yt, bn, act="relu6")
    out.backward(nchw(g))
    close(out, out_j, "out")
    close(bn.running_mean, st_j["mean"], "running mean")
    close(bn.running_var, st_j["var"], "running var")
    close(yt.grad, dy_j, "dy")
    close(bn.weight.grad, dp_j["scale"], "dgamma")
    close(bn.bias.grad, dp_j["bias"], "dbeta")
    gsum = g.sum(axis=(0, 1, 2))[:len(TIE_BETAS)]
    want_ties = gsum * np.array([0.0, 0.5, 1.0, 0.5, 0.0], np.float32)
    np.testing.assert_allclose(np.asarray(dp_j["bias"])[:len(TIE_BETAS)], want_ties, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad[:len(TIE_BETAS)].numpy(), want_ties, rtol=1e-5,
                               atol=1e-5)
    assert np.all(np.abs(gsum[[1, 3]]) > 1e-3)  # the 1/2 is visible


def test_relu6_gradient_below_6_is_1_though_bf16_rounds_it_to_6():
    """A bf16 map whose z = y scale + shift lies in [5.984375, 6): the
    site's bf16 output is 6 everywhere (so a mask read from it, as the ReLU
    reads its own, would be 0), and the backward's gz is g itself: dbeta is
    sum(g) per channel, dgamma sum(g xh). Through bn_backward's CPU path
    (the plain version) and bn_backward_plain."""
    C = 8
    y = torch.linspace(0, 0.99, 2 * 4 * 4 * C).reshape(2, 4, 4, C).permute(0, 3, 1, 2)
    y = y.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    mean, invstd = torch.zeros(C), torch.full((C,), 1 / 64)
    gamma, shift = torch.ones(C), torch.full((C,), 5.984375)
    z = y.float() * (gamma * invstd)[:, None, None] + shift[:, None, None]
    assert bool(((z >= 5.984375) & (z < 6)).all())
    out = conv_epilogue_plain(y, gamma * invstd, shift, act="relu6")[0]
    assert bool((out == 6).all())
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    for fn in (bt.bn_backward, bt.bn_backward_plain):
        dy, dgamma, dbeta, _, _ = fn(g, None, out, y, mean, invstd, gamma, None, "relu6",
                                     False, shift=shift)
        torch.testing.assert_close(dbeta, g.float().sum(dim=(0, 2, 3)), rtol=1e-6, atol=1e-6)
        xh = (y.float() - mean[:, None, None]) * invstd[:, None, None]
        torch.testing.assert_close(dgamma, (g.float() * xh).sum(dim=(0, 2, 3)), rtol=1e-6,
                                   atol=1e-6)


def test_relu6_derivative_at_ties_and_nan():
    """1 inside (0, 6), 1/2 at 0 (either sign) and 6, 0 outside and at NaN:
    JAX's VJP of jnp.clip at the same points."""
    z = torch.tensor([-1.0, -0.0, 0.0, 1e-30, 3.0, 5.9999995, 6.0, 6.0000005, 7.0,
                      float("nan")])
    want = np.asarray(jax.grad(lambda v: jnp.clip(v, 0.0, 6.0).sum())(jnp.asarray(z.numpy()[:-1])))
    got = bt.relu6_derivative(z)
    np.testing.assert_array_equal(got[:-1].numpy(), want)
    assert got.tolist() == [0.0, 0.5, 0.5, 1.0, 1.0, 1.0, 0.5, 0.0, 0.0, 0.0]


def test_relu6_backward_refuses_what_it_has_no_instance_for():
    """The ReLU6 backward needs the forward's shift (and a site without a
    SiLU or ReLU6 takes none), and has no gradient affine or float32-gradient
    instance (no site needs one)."""
    y = torch.zeros((2, 8, 4, 4)).contiguous(memory_format=torch.channels_last)
    vec = [torch.ones(8) for _ in range(3)]
    with pytest.raises(ValueError, match="shift"):
        bt.bn_backward(y, None, None, y, *vec, act="relu6")
    with pytest.raises(ValueError, match="shift"):
        bt.bn_backward_plain(y, None, None, y, *vec, act=None, shift=torch.zeros(8))
    with pytest.raises(ValueError, match="ReLU6 instance"):
        bt.backward_kind("relu6", False, True)
    with pytest.raises(ValueError, match="ReLU6 instance"):
        bt.backward_kind("relu6", False, False, g32=True)
    assert bt.backward_kind("relu6", False, False) == "relu6"
