"""The train step's kernels' plain versions (CPU) against ``flairtpu``:
augment_normalize against the D4 composition, ``normalize_device`` and
``_clean_targets``; weighted_ce against ``_loss``, its ``jax.grad`` and the
confusion matrix; the train-mode BatchNorm site against Flax's BatchNorm
with residual, branch and ReLU, forward, VJP and running statistics.

The CUDA kernels run only on a card: ``chip_smoke.py`` holds each against
its plain version there.
"""

from types import SimpleNamespace

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.data.augment import _rot90
from flairtpu.data.normalize import normalize_device
from flairtpu.models.resnet import batch_norm as flax_batch_norm
from flairtpu.ops.confmat import confusion_matrix
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch.ops import augment as au
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops import weighted_ce as wc


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for PyTorch's CPU kernels here: the suite runs
    several test processes side by side, and a process that takes every
    core for its convolutions slows them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CHOICES = [(v, h, k) for v in (0, 1) for h in (0, 1) for k in range(4)]
MEANS, STDS = [105.08, 110.87, 101.82, 106.38, 53.26], [52.17, 45.38, 44, 39.69, 79.3]
K = 19
WEIGHTS = np.array([0 if i in (14, 15, 16, 18) else 1 for i in range(K)], np.float32)


def jax_augment(img, msk, v, h, k):
    """flairtpu/data/augment.py:_augment_one with its choices given."""
    if v:
        img, msk = jnp.flip(img, axis=0), jnp.flip(msk, axis=0)
    if h:
        img, msk = jnp.flip(img, axis=1), jnp.flip(msk, axis=1)
    return _rot90(img, jnp.int32(k)), _rot90(msk, jnp.int32(k))


@pytest.mark.parametrize("norm_type", ["custom", "scaling", "without"])
def test_augment_normalize_plain_matches_flairtpu(norm_type):
    """All 16 (v, h, k) choices, labels 0 and > K on disk: bit for bit."""
    rng = np.random.default_rng(3)
    n = len(CHOICES)
    img = rng.integers(0, 256, (n, 12, 12, 5), dtype=np.uint8)
    raw = rng.integers(0, K + 6, (n, 12, 12), dtype=np.uint8)  # 0 and > K included
    means, stds = (MEANS, STDS) if norm_type == "custom" else ((), ())
    mean, mul = au.norm_constants(norm_type, means, stds, 5)
    x, tgt = au.augment_normalize_plain(
        torch.from_numpy(img), torch.from_numpy(raw),
        torch.tensor(CHOICES, dtype=torch.int32), torch.from_numpy(mean),
        torch.from_numpy(mul), K)

    norm = jax.jit(lambda a: normalize_device(a, norm_type, tuple(means), tuple(stds),
                                              src_dtype=np.uint8))
    clean = FlaxTrainer._clean_targets(SimpleNamespace(num_classes=K),
                                       jnp.asarray(raw, jnp.int32) - 1)
    for b, (v, h, k) in enumerate(CHOICES):
        want_x, want_t = jax_augment(jnp.asarray(img[b]), clean[b], v, h, k)
        np.testing.assert_array_equal(x[b].numpy(), np.asarray(norm(want_x)))
        np.testing.assert_array_equal(tgt[b].numpy(), np.asarray(want_t))


def test_augment_identity_and_wrapper_checks():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.integers(0, 256, (2, 8, 8, 5), dtype=np.uint8))
    mean, mul = (torch.from_numpy(a) for a in au.norm_constants("scaling", channels=5))
    x, tgt = au.augment_normalize(img, None, None, mean, mul, K)
    assert tgt is None and torch.equal(x, img.float() * float(np.float32(1) / np.float32(255)))
    with pytest.raises(ValueError, match="square"):
        au.augment_normalize(img[:, :, :6].contiguous(), None,
                             torch.zeros((2, 3), dtype=torch.int32), mean, mul, K)
    with pytest.raises(ValueError, match="uint8"):
        au.augment_normalize(img.float(), None, None, mean, mul, K)


def test_draw_choices_distribution():
    """flairtpu/data/augment.py:35-40: flips at 1/2; k = 0 unless a rotation
    (1/2) draws it uniformly, so P(k = 0) = 5/8."""
    ch = au.draw_choices(40000, torch.Generator().manual_seed(1)).numpy()
    assert ch.dtype == np.int32 and ch.shape == (40000, 3)
    assert abs(ch[:, 0].mean() - 0.5) < 0.02 and abs(ch[:, 1].mean() - 0.5) < 0.02
    assert abs((ch[:, 2] == 0).mean() - 0.625) < 0.02
    assert all(abs((ch[:, 2] == k).mean() - 0.125) < 0.01 for k in (1, 2, 3))


def ce_case(seed=5):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((2, 9, 11, K)) * 3).astype(np.float32)
    logits[0, 0, 0, :2] = 4.0  # a tie: the first maximum wins
    tgt = rng.integers(0, K, (2, 9, 11)).astype(np.int32)
    return logits, tgt


def test_weighted_ce_plain_matches_flairtpu_loss_grad_and_confmat():
    logits, tgt = ce_case()
    ns = SimpleNamespace(class_weights=jnp.asarray(WEIGHTS))
    want = FlaxTrainer._loss(ns, jnp.asarray(logits), jnp.asarray(tgt))
    want_g = jax.grad(lambda l: FlaxTrainer._loss(ns, l, jnp.asarray(tgt)))(jnp.asarray(logits))
    want_cm = confusion_matrix(jnp.argmax(jnp.asarray(logits), axis=-1), jnp.asarray(tgt), K)

    lt, tt, wt = torch.from_numpy(logits), torch.from_numpy(tgt), torch.from_numpy(WEIGHTS)
    cm = torch.zeros((K, K), dtype=torch.int32)
    loss, w_sum = wc.weighted_ce(lt, tt, wt, cm)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    assert w_sum.item() == float(WEIGHTS[tgt].sum())
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want_cm))
    g = wc.weighted_ce_grad(lt, tt, wt, w_sum, torch.tensor(1.0))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_g).max()))

    # the autograd Function: the same loss, the same gradient, counts added
    leaf = lt.clone().requires_grad_(True)
    cm2 = cm.clone()
    fn_loss = wc.WeightedCE.apply(leaf, tt, wt, cm2)
    fn_loss.backward()
    assert fn_loss.item() == loss.item()
    assert torch.equal(leaf.grad, g)
    assert torch.equal(cm2, 2 * cm)


def test_weighted_ce_refuses_other_layouts():
    logits, tgt = ce_case()
    lt = torch.from_numpy(logits).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wc.weighted_ce(lt, torch.from_numpy(tgt), torch.from_numpy(WEIGHTS))
    with pytest.raises(ValueError, match="int32"):
        wc.weighted_ce(torch.from_numpy(logits), torch.from_numpy(tgt).long(),
                       torch.from_numpy(WEIGHTS))


SHAPE = (3, 6, 7, 16)  # NHWC


def bn_vars(rng, c):
    return {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "bias": rng.normal(0, 0.1, c).astype(np.float32)},
            "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}}


def flax_site(kind, y, r, d, vy, vd):
    """Flax train-mode BatchNorm of y (+ r, or + its BatchNorm of d), ReLU:
    (out, new stats of y, new stats of d)."""
    bn = flax_batch_norm(jnp.float32)

    def apply(v, x):
        out, mut = bn.apply(v, x, use_running_average=False, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    out, sy = apply(vy, y)
    sd = None
    if kind == "residual":
        out = out + r
    elif kind == "branch":
        od, sd = apply(vd, d)
        out = out + od
    return jax.nn.relu(out), sy, sd


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def bn_module(v):
    m = torch.nn.BatchNorm2d(len(v["params"]["scale"]))
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        m.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        m.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        m.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    return m


@pytest.mark.parametrize("kind,keep_f32", [("none", False), ("residual", False),
                                           ("residual", True), ("branch", False),
                                           ("branch", True)])
def test_bn_train_site_matches_flax(kind, keep_f32):
    """Forward and VJP within 1e-5, running statistics within 1e-6; a site
    that hands its output on twice sums both gradients."""
    rng = np.random.default_rng(7)
    y, r, d, g, g32 = (rng.standard_normal(SHAPE).astype(np.float32) * 2 for _ in range(5))
    vy, vd = bn_vars(rng, SHAPE[-1]), bn_vars(rng, SHAPE[-1])
    jv = jax.tree_util.tree_map(jnp.asarray, (vy, vd))

    def f(yy, ry, dd, py, pd):
        out, _, _ = flax_site(kind, yy, ry, dd, {"params": py, "batch_stats": jv[0]["batch_stats"]},
                              {"params": pd, "batch_stats": jv[1]["batch_stats"]})
        return out

    out_j, vjp = jax.vjp(f, jnp.asarray(y), jnp.asarray(r), jnp.asarray(d), jv[0]["params"],
                         jv[1]["params"])
    cot = g + g32 if keep_f32 else g
    dy_j, dr_j, dd_j, dpy_j, dpd_j = vjp(jnp.asarray(cot))
    _, sy_j, sd_j = flax_site(kind, jnp.asarray(y), jnp.asarray(r), jnp.asarray(d), jv[0], jv[1])

    bn, bn_d = bn_module(vy), bn_module(vd)
    yt = nchw(y).requires_grad_(True)
    rt = nchw(r).requires_grad_(True) if kind == "residual" else None
    dt = nchw(d).requires_grad_(True) if kind == "branch" else None
    out, out32 = bt.TrainSites().site(yt, bn, residual=rt,
                                      branch=(dt, bn_d) if dt is not None else None,
                                      keep_f32=keep_f32)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out_j),
                               atol=1e-5, rtol=1e-5)
    grads = [nchw(g)] + ([nchw(g32)] if keep_f32 else [])
    torch.autograd.backward([out] + ([out32] if keep_f32 else []), grads)

    def close(t, a, tol=1e-5):
        t = t.permute(0, 2, 3, 1) if t.dim() == 4 else t
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=tol, rtol=tol)

    close(yt.grad, dy_j)
    close(bn.weight.grad, dpy_j["scale"])
    close(bn.bias.grad, dpy_j["bias"])
    close(bn.running_mean, sy_j["mean"], 1e-6)
    close(bn.running_var, sy_j["var"], 1e-6)
    if kind == "residual":
        close(rt.grad, dr_j)
    if kind == "branch":
        close(dt.grad, dd_j)
        close(bn_d.weight.grad, dpd_j["scale"])
        close(bn_d.bias.grad, dpd_j["bias"])
        close(bn_d.running_var, sd_j["var"], 1e-6)


@pytest.mark.parametrize("channels,eps,momentum", [(16, 1e-3, 0.01), (3, 1e-3, 0.01),
                                                   (16, 1e-5, 0.1)])
def test_bn_train_site_takes_the_modules_eps_and_momentum(channels, eps, momentum):
    """TrainSites.site with an ``nn.BatchNorm2d(eps, momentum)``: EfficientNet's
    1e-3 and 0.01 at a wide site and a narrow one (3 channels, its own entry
    point), and the resnet sites' 1e-5 and 0.1, against Flax's BatchNorm with
    that epsilon and momentum 1 - 0.01 / 1 - 0.1: the output, the running
    statistics and the gradients within 1e-5."""
    rng = np.random.default_rng(11)
    shape = (3, 6, 7, channels)
    y = rng.standard_normal(shape).astype(np.float32) * 0.3
    g = rng.standard_normal(shape).astype(np.float32)
    v = bn_vars(rng, channels)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    flax_bn = flax.linen.BatchNorm(use_running_average=False, epsilon=eps,
                                   momentum=1 - momentum, dtype=jnp.float32)

    def f(yy, params):
        out, mut = flax_bn.apply({"params": params, "batch_stats": jv["batch_stats"]}, yy,
                                 mutable=["batch_stats"])
        return jax.nn.relu(out), mut["batch_stats"]

    out_j, vjp, stats_j = jax.vjp(f, jnp.asarray(y), jv["params"], has_aux=True)
    dy_j, dp_j = vjp(jnp.asarray(g))

    bn = bn_module(v)
    bn.eps, bn.momentum = eps, momentum
    yt = nchw(y).requires_grad_(True)
    out, _ = bt.TrainSites().site(yt, bn)
    out.backward(nchw(g))

    def close(t, a):
        t = t.permute(0, 2, 3, 1) if t.dim() == 4 else t
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(a), atol=1e-5, rtol=1e-5)

    close(out, out_j)
    close(bn.running_mean, stats_j["mean"])
    close(bn.running_var, stats_j["var"])
    close(yt.grad, dy_j)
    close(bn.weight.grad, dp_j["scale"])
    close(bn.bias.grad, dp_j["bias"])


def test_running_variance_is_biased_unlike_batchnorm2d():
    """Flax (and the port) average the biased batch variance into the running
    one; torch's nn.BatchNorm2d the unbiased: M / (M - 1) apart."""
    rng = np.random.default_rng(8)
    y = rng.standard_normal(SHAPE).astype(np.float32) * 2
    v = bn_vars(rng, SHAPE[-1])
    _, sy_j, _ = flax_site("none", jnp.asarray(y), None, None,
                           jax.tree_util.tree_map(jnp.asarray, v), None)
    port, torch_bn = bn_module(v), bn_module(v).train()
    bt.TrainSites().site(nchw(y), port)
    torch_bn(nchw(y))
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(sy_j["var"]), rtol=1e-6)
    gap = np.abs(torch_bn.running_var.detach().numpy() - np.asarray(sy_j["var"]))
    assert gap.min() > 1e-4  # every channel: 0.1 * var / (M - 1), M = 126


def test_bn_wrappers_check_operands():
    y = torch.zeros(2, 16, 4, 4)
    ones = torch.ones(16)
    with pytest.raises(ValueError, match=r"\(B, C, H, W\)"):
        bt.bn_stats(y[0], ones, ones, ones.clone(), ones.clone())
    with pytest.raises(RuntimeError, match="unsupported device"):
        bt.bn_stats(y.to("meta"), ones, ones, ones, ones)
