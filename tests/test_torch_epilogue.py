"""conv_epilogue (plain, CPU) against flairtpu's BatchNorm + residual + ReLU,
against the unfused operations it replaces, and where the models call it.

The CUDA kernel runs only on a card: ``chip_smoke.py`` holds it against
``conv_epilogue_plain`` there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from flairtpu.models.resnet import batch_norm as flax_batch_norm
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.resnet import bn_scale_shift
from flairtpu_torch.ops import epilogue as ep

SHAPE = (2, 6, 7, 16)  # NHWC
KINDS = ("none", "residual", "branch")


def bn_params(rng, c: int) -> dict:
    return {"gamma": rng.uniform(0.5, 1.5, c), "beta": rng.normal(0, 0.1, c),
            "mean": rng.normal(0, 0.1, c), "var": rng.uniform(0.5, 2.0, c)}


def to_bn(p: dict) -> torch.nn.BatchNorm2d:
    m = torch.nn.BatchNorm2d(len(p["gamma"]), eps=1e-5).eval()
    with torch.no_grad():
        for name, key in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(m, name).copy_(torch.from_numpy(p[key].astype(np.float32)))
    return m


def flax_bn(x: np.ndarray, p: dict) -> np.ndarray:
    variables = {"params": {"scale": p["gamma"], "bias": p["beta"]},
                 "batch_stats": {"mean": p["mean"], "var": p["var"]}}
    variables = {k: {n: jnp.asarray(v, jnp.float32) for n, v in d.items()}
                 for k, d in variables.items()}
    return np.asarray(flax_batch_norm(jnp.float32).apply(variables, jnp.asarray(x),
                                                         use_running_average=True))


def nchw(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    """NHWC numpy -> NCHW channels_last view of the same layout."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(dtype)


def case(kind: str, seed: int = 0):
    """NHWC float32 inputs: conv output y, float32 residual r, branch d, and
    the BatchNorm parameters of y and d."""
    rng = np.random.default_rng(seed)
    y, r, d = (rng.standard_normal(SHAPE).astype(np.float32) * 2 for _ in range(3))
    return y, (r if kind == "residual" else None), (d if kind == "branch" else None), \
        bn_params(rng, SHAPE[-1]), bn_params(rng, SHAPE[-1])


def plain_args(y, r, d, p, pd, dtype):
    with torch.no_grad():
        scale, shift = bn_scale_shift(to_bn(p))
        scale_d, shift_d = bn_scale_shift(to_bn(pd))
    branch = None
    if d is not None:
        branch = (nchw(d, dtype), scale_d, shift_d)
    return dict(y=nchw(y, dtype), scale=scale, shift=shift,
                residual=None if r is None else nchw(r), branch=branch)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_flairtpu_batchnorm_residual_relu(kind):
    """float32, against flax's BatchNorm (+ residual or BatchNorm'd branch) +
    relu as flairtpu's blocks apply them. atol 1e-5: the (scale, shift) form
    rounds y * scale + shift where flax rounds ((y - mean) * mul) + bias, so
    the two differ by a few float32 ulps of values below 16 (ulp 1.9e-6)."""
    y, r, d, p, pd = case(kind)
    want = flax_bn(y, p)
    if r is not None:
        want = want + r
    if d is not None:
        want = want + flax_bn(d, pd)
    want = np.asarray(nn.relu(jnp.asarray(want)))
    out, out32 = ep.conv_epilogue_plain(**plain_args(y, r, d, p, pd, torch.float32),
                                        keep_f32=True)
    assert out.dtype == torch.float32 and out32 is out
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_is_the_unfused_ops_bit_for_bit(kind, relu):
    """bfloat16 conv output: the same float32 operations one at a time (numpy,
    each rounded on its own), then the round-to-nearest-even bf16 cast."""
    y, r, d, p, pd = case(kind, seed=1)
    args = plain_args(y, r, d, p, pd, torch.bfloat16)
    out, out32 = ep.conv_epilogue_plain(**args, act=relu, keep_f32=True)

    def affine(t: torch.Tensor, scale, shift) -> np.ndarray:
        v = t.float().permute(0, 2, 3, 1).numpy()
        return np.add(np.multiply(v, scale.numpy()), shift.numpy())

    v = affine(args["y"], args["scale"], args["shift"])
    if r is not None:
        v = np.add(v, r)
    if d is not None:
        v = np.add(v, affine(*args["branch"]))
    if relu:
        v = np.where(v < 0, np.float32(0), v)
    assert out.dtype == torch.bfloat16 and out32.dtype == torch.float32
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out32, nchw(v))
    assert torch.equal(out, nchw(v).to(torch.bfloat16))
    assert ep.conv_epilogue_plain(**args, act=relu)[1] is None


def test_wrapper_runs_plain_on_cpu_and_counts_nothing():
    y, r, d, p, pd = case("branch", seed=2)
    args = plain_args(y, r, d, p, pd, torch.bfloat16)
    ep.launches = 0
    got = ep.conv_epilogue(**args, keep_f32=True)
    want = ep.conv_epilogue_plain(**args, keep_f32=True)
    assert ep.launches == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _bad(name: str) -> dict:
    y, r, _, p, pd = case("residual", seed=3)
    args = plain_args(y, r, None, p, pd, torch.bfloat16)
    if name == "nchw_y":
        args["y"] = args["y"].contiguous()
    elif name == "nchw_residual":
        args["residual"] = args["residual"].contiguous()
    elif name == "bf16_residual":  # a residual in the compute dtype, not y's
        args["y"] = args["y"].float()
        args["residual"] = args["residual"].to(torch.bfloat16)
    elif name == "short_scale":
        args["scale"] = args["scale"][:-1]
    elif name == "residual_and_branch":
        args["branch"] = (args["y"], args["scale"], args["shift"])
    elif name == "other_shape_residual":
        args["residual"] = args["residual"][:1]
    return args


@pytest.mark.parametrize("name", ["nchw_y", "nchw_residual", "bf16_residual", "short_scale",
                                  "residual_and_branch", "other_shape_residual"])
def test_wrapper_rejects_bad_operands(name):
    with pytest.raises(ValueError):
        ep.conv_epilogue(**_bad(name))


def test_wrapper_raises_on_other_devices():
    y = torch.empty((1, 8, 4, 4), device="meta").contiguous(memory_format=torch.channels_last)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ep.conv_epilogue(y, torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


class Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, y, scale, shift, residual=None, branch=None, act="relu",
                 keep_f32=False):
        relu = ep.activation(act) == "relu"
        kind = "branch" if branch is not None else "residual" if residual is not None else "none"
        self.calls.append((kind, keep_f32, relu))
        return ep.conv_epilogue(y, scale, shift, residual, branch, relu, keep_f32)


@pytest.mark.parametrize("encoder,sites,residuals,branches,fp32_outs", [
    ("resnet18", 25, 5, 3, 5),
    ("resnet34", 41, 13, 3, 13),
    ("resnet50", 57, 12, 4, 12),
])
def test_every_batchnorm_site_is_one_epilogue(encoder, sites, residuals, branches, fp32_outs):
    """One call per BatchNorm site of the encoder and decoder blocks 0-3 (a
    downsample's folded into its block's last site); float32 written only
    where the next block adds it as its identity."""
    model = FlairSegmentationModel(encoder, 4, 5).eval()
    rec = Recorder()
    with torch.inference_mode():
        model.tail_input(torch.rand(1, 64, 64, 5), 16, epilogue=rec)
    assert len(rec.calls) == sites
    assert sum(k == "residual" for k, _, _ in rec.calls) == residuals
    assert sum(k == "branch" for k, _, _ in rec.calls) == branches
    assert sum(keep for _, keep, _ in rec.calls) == fp32_outs
    assert all(relu for _, _, relu in rec.calls)


def test_prepare_inference_keeps_logits_and_casts_weights():
    """Preparing stores each BatchNorm's (scale, shift) and casts the conv
    weights to the compute dtype; float32 logits do not move by a bit."""
    rng = np.random.default_rng(5)
    model = FlairSegmentationModel("resnet18", 4, 5).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, m.num_features)))
    x = torch.rand(1, 32, 32, 5)
    with torch.inference_mode():
        before = model(x, inner_margin=8)
        model.prepare_inference()
        after = model(x, inner_margin=8)
    assert torch.equal(before, after)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert all(torch.equal(m.scale_shift[0], bn_scale_shift(m)[0]) for m in bns)

    bf16 = FlairSegmentationModel("resnet18", 4, 5, dtype=torch.bfloat16).eval()
    bf16.prepare_inference()
    convs = [m for m in bf16.modules() if isinstance(m, torch.nn.Conv2d)]
    assert convs and all(m.weight.dtype == torch.bfloat16 for m in convs)
    with torch.inference_mode():
        x3 = bf16.tail_input(x.to(torch.bfloat16), 8)
    assert x3.dtype == torch.bfloat16
    assert x3.is_contiguous(memory_format=torch.channels_last)
