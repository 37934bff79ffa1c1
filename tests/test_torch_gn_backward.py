"""The train-mode pieces of the slice-5 decoders that run below a model:
``group_norm_relu``'s backward, the narrow ``bn_train`` entry points, the
decoders' dropout.

- ``ops/group_norm.py:group_norm_relu_backward_plain`` (with torch's conv
  VJP around it) and the ``GroupNormReLU`` autograd entry (through FPN's
  ``Conv3x3GNReLU`` in train mode, on the CPU) against ``jax.vjp`` of
  ``flairtpu``'s ``Conv3x3GNReLU`` (``flairtpu/models/smp_extra.py:52-68``)
  with the conv weights carried over: dx at the conv input, dW, dgamma and
  dbeta within 1e-5 of each reference's largest |value| (float32; the sums
  run in other orders). With and without the upsample, with a group whose
  ReLU passes nothing (beta -100) and with a group whose conv output is
  zero (its variance at the clamp ``max(0, E[x^2] - E[x]^2)``).
- the wrappers' card paths on CPU tensors with their C entry points
  recorded (``group_norm_backward``'s plan and scratch, the narrow
  BatchNorm's arguments: one launch each way at a 1-channel site, no
  ``conv_epilogue``), and the checks they raise on.
- the narrow sites' fused forward's plain version
  (``bn_stats_apply_plain``) against ``bn_stats_plain`` then
  ``conv_epilogue_plain``, bit for bit.
- ``models/deeplab.py:dropout``: keep masks from the generator it is given,
  one value a (sample, channel) for Dropout2d, Flax's scaling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flairtpu.models.smp_extra import Conv3x3GNReLU as FlaxConv3x3GNReLU
from flairtpu_torch.models.deeplab import dropout
from flairtpu_torch.models.smp_extra import Conv3x3GNReLU
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops import group_norm as gn
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.epilogue import conv_epilogue_plain

B, CIN, C, H = 2, 16, 64, 8
TOL = 1e-5
CL = torch.channels_last


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def case_params(case: str, rng):
    """Conv kernel (HWIO), gamma, beta and input for ``case``: ``dead``
    sets group 0's beta to -100 (its ReLU passes nothing), ``clamped``
    zeroes group 1's conv weights (its output 0, variance 0)."""
    w = (rng.normal(0, 1, (3, 3, CIN, C)) / np.sqrt(9 * CIN)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.normal(0, 0.3, C).astype(np.float32)
    gs = C // 32
    if case == "dead":
        beta[:gs] = -100.0
    if case == "clamped":
        w[..., gs:2 * gs] = 0.0
    x = rng.normal(0.2, 1.0, (B, H, H, CIN)).astype(np.float32)
    return w, gamma, beta, x


def flax_vjp(w, gamma, beta, x, g, upsample: bool):
    """(dx, dW (HWIO), dgamma, dbeta) of flairtpu's block for the output
    gradient g (NHWC)."""
    block = FlaxConv3x3GNReLU(C, upsample=upsample)
    params = {"conv": {"kernel": jnp.asarray(w)}, "gn": {"scale": jnp.asarray(gamma),
                                                          "bias": jnp.asarray(beta)}}

    def f(p, xx):
        return block.apply({"params": p}, xx)

    _, vjp = jax.vjp(f, params, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    return (np.asarray(dx), np.asarray(dp["conv"]["kernel"]), np.asarray(dp["gn"]["scale"]),
            np.asarray(dp["gn"]["bias"]))


def assert_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("case", ["random", "dead", "clamped"])
@pytest.mark.parametrize("upsample", [False, True])
def test_backward_matches_jax_vjp(case, upsample):
    rng = np.random.default_rng(3)
    w, gamma, beta, x = case_params(case, rng)
    u = 2 if upsample else 1
    g = rng.normal(0, 1, (B, u * H, u * H, C)).astype(np.float32)
    want = flax_vjp(w, gamma, beta, x, g, upsample)
    if case == "dead":
        assert not want[3][:C // 32].any()  # the dead group's dbeta: its ReLU passed nothing
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=CL)
    gt = torch.from_numpy(g).permute(0, 3, 1, 2).contiguous(memory_format=CL)
    gam, bet = torch.from_numpy(gamma), torch.from_numpy(beta)

    # the plain backward, composed with torch's conv VJP
    y = F.conv2d(xt, wt, padding=1).contiguous(memory_format=CL)
    out, mean, rstd = gn.group_norm_relu_plain(y, gam, bet, upsample=upsample, stats=True)
    if case == "clamped":
        assert not mean[:, 1].any()
        assert torch.equal(rstd[:, 1], torch.rsqrt(torch.full((B,), 1e-5)))
    dy, dgamma, dbeta = gn.group_norm_relu_backward_plain(gt, y, mean, rstd, gam, bet,
                                                          upsample=upsample)
    dx = torch.nn.grad.conv2d_input(xt.shape, wt, dy, padding=1)
    dw = torch.nn.grad.conv2d_weight(xt, wt.shape, dy, padding=1)
    plain = (dx.permute(0, 2, 3, 1).numpy(), dw.permute(2, 3, 1, 0).numpy(), dgamma.numpy(),
             dbeta.numpy())

    # the autograd entry, through the port's block in train mode
    block = Conv3x3GNReLU(CIN, C, upsample=upsample)
    with torch.no_grad():
        block.block[0].weight.copy_(wt)
        block.block[1].weight.copy_(gam)
        block.block[1].bias.copy_(bet)
    xg = xt.clone().requires_grad_(True)
    gn.launches = gn.backward_launches = 0
    got_out = block(xg, TrainSites().group_norm)
    torch.testing.assert_close(got_out, out, rtol=0, atol=0)
    got_out.backward(gt)
    assert gn.launches == gn.backward_launches == 0  # CPU tensors: the plain versions
    auto = (xg.grad.permute(0, 2, 3, 1).numpy(),
            block.block[0].weight.grad.permute(2, 3, 1, 0).numpy(),
            block.block[1].weight.grad.numpy(), block.block[1].bias.grad.numpy())

    for name, got in (("plain", plain), ("autograd", auto)):
        for what, a, b in zip(("dx", "dW", "dgamma", "dbeta"), got, want):
            assert_close(a, b, f"{name} {what}")


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card paths on CPU tensors; each C entry point's call
    recorded as (symbol, args)."""
    calls = []

    def entry(name, argtypes, symbol=None):
        def call(*args):
            assert len(args) == len(argtypes), (symbol, len(args), len(argtypes))
            calls.append((symbol or name, args))
            return 0
        return call

    monkeypatch.setattr(gn, "_on_card", lambda *a: True)
    monkeypatch.setattr(bt, "_on_card", lambda x, what: True)
    monkeypatch.setattr(gn._build, "entry", entry)
    monkeypatch.setattr(gn._build, "stream_handle", lambda t: 7)
    for mod, names in ((gn, ("launches", "backward_launches")),
                       (bt, ("launches", "backward_launches", "narrow_launches",
                             "narrow_backward_launches"))):
        for n in names:
            monkeypatch.setattr(mod, n, 0)
    return calls


def cl(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).contiguous(memory_format=CL)


# an H100's limits, the backward's occupancy as shared memory allows at two
# blocks of 256 threads an SM at most
H100 = gn.Limits(132, 232448, 50 * 2 ** 20, lambda up, on_chip, smem: min(2, 233472 // (smem + 1024)))


@pytest.mark.parametrize("upsample", [False, True])
def test_group_norm_wrappers_pass_the_entry_points_their_shapes(fake_card, monkeypatch,
                                                                upsample):
    """The forward with ``stats`` hands the apply pass a (2, B, G) buffer
    (none without); the backward launches once with (B, H, W, C, G,
    upsample) and its plan (route, item pixels, grid, shared memory), one
    float32 scratch of the plan's size and the stream's int32 tickets; one
    launch counted a call."""
    monkeypatch.setattr(gn, "device_limits", lambda device: H100)
    monkeypatch.setattr(gn, "_PLANS", {})
    monkeypatch.setattr(gn, "_COUNTERS", {})
    Bn, Cn, Hn, Wn = 3, 128, 32, 16
    y = cl((Bn, Cn, Hn, Wn), torch.bfloat16)
    vec = torch.ones(Cn)
    out, mean, rstd = gn.group_norm_relu(y, vec, vec, upsample=upsample, stats=True)
    gn.group_norm_relu(y, vec, vec, upsample=upsample)
    u = 2 if upsample else 1
    assert out.shape == (Bn, Cn, u * Hn, u * Wn) and mean.shape == rstd.shape == (Bn, 32)
    (s1, _), (a1, args1), (_, _), (_, args2) = fake_card
    assert (s1, a1) == ("group_norm_stats", "group_norm_apply")
    assert args1[5] is not None and args2[5] is None  # the stats pointer
    g = cl((Bn, Cn, u * Hn, u * Wn))
    dy, dgamma, dbeta = gn.group_norm_relu_backward(g, y, mean, rstd, vec, vec,
                                                    upsample=upsample)
    sym, args = fake_card[-1]
    plan = gn.launch_plan(Bn, Hn, Wn, Cn, 32, upsample, H100)
    assert plan.on_chip == upsample
    n_scratch, n_counters = gn.scratch_sizes(plan, Bn, Cn, 32)
    assert sym == "group_norm_backward" and len(fake_card) == 5
    assert args[7] == n_scratch and args[9] >= n_counters and args[6] == args[11] + 8 * Cn
    assert args[12:] == (Bn, Hn, Wn, Cn, 32, int(upsample), int(upsample), plan.part, plan.grid,
                         plan.smem, 7)
    assert dy.dtype == torch.bfloat16 and dy.is_contiguous(memory_format=CL)
    assert dgamma.shape == dbeta.shape == (Cn,)
    assert (gn.launches, gn.backward_launches) == (2, 1)
    with pytest.raises(ValueError, match="g must be"):
        gn.group_norm_relu_backward(cl((Bn, Cn, Hn, Wn + 1)), y, mean, rstd, vec, vec,
                                    upsample=upsample)
    with pytest.raises(ValueError, match="mean must be"):
        gn.group_norm_relu_backward(g, y, mean[:, :16], rstd, vec, vec, upsample=upsample)


def test_narrow_batchnorm_sites_take_their_entry_points(fake_card, monkeypatch):
    """A 1-channel site (PAN's pyramid) through ``BNTrainSite``: one launch
    each way, bn_train_narrow_forward (the statistics and the site's output,
    so no conv_epilogue) and bn_train_narrow_backward, counted in their own
    counts; bn_stats alone takes the forward entry point without an output;
    a residual or a branch at such a site raises; 8 channels take the main
    entry points."""
    monkeypatch.setattr(bt, "_co_resident", lambda device, mode, c, branch=False: 528)
    monkeypatch.setattr(bt, "_COUNTERS", {})

    def no_epilogue(*args, **kw):
        raise AssertionError("conv_epilogue at a narrow site")

    monkeypatch.setattr(bt, "conv_epilogue", no_epilogue)
    y = cl((4, 1, 16, 16), torch.bfloat16).requires_grad_(True)
    vec = [torch.ones(1) for _ in range(4)]
    out = bt.BNTrainSite.apply(y, *vec, None, None, None, None, None, None, True, False)
    out.backward(cl((4, 1, 16, 16), torch.bfloat16))
    assert [c[0] for c in fake_card] == ["bn_train_narrow_forward", "bn_train_narrow_backward"]
    fwd, back = fake_card[0][1], fake_card[1][1]
    assert fwd[9] is not None and fwd[10] is None  # the output, no float32 copy
    assert fwd[11:14] == (4 * 16 * 16, 1, 1) and back[9:11] == (1024, 1)
    assert y.grad.shape == y.shape
    assert (bt.narrow_launches, bt.narrow_backward_launches) == (1, 1)
    assert bt.launches == bt.backward_launches == 0
    bt.bn_stats(y.detach(), *vec)
    assert fake_card[-1][0] == "bn_train_narrow_forward" and fake_card[-1][1][9] is None
    assert bt.narrow_launches == 2
    with pytest.raises(ValueError, match="no residual or branch"):
        bt.bn_backward(y, None, y, y, *vec[:3], residual=True)
    y8 = cl((4, 8, 4, 4), torch.bfloat16)
    bt.bn_stats(y8, *[torch.ones(8) for _ in range(4)])
    assert fake_card[-1][0] == "bn_train_stats"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu,keep_f32", [(True, True), (True, False), (False, True),
                                           (False, False)])
def test_fused_narrow_forward_plain_gives_stats_then_epilogue(dtype, relu, keep_f32):
    """bn_stats_apply on CPU tensors (its plain version): the bits of
    bn_stats_plain then conv_epilogue_plain from its scale and shift, the
    running statistics included; and BNTrainSite at a 1-channel site gives
    them too, with the CPU's launch counts untouched."""
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.normal(0.3, 1.5, (4, 1, 9, 7)).astype(np.float32)).to(
        dtype).contiguous(memory_format=CL)
    gamma = torch.tensor([1.3])
    beta = torch.tensor([-0.2])
    ra = [torch.tensor([0.1]), torch.tensor([0.9])]
    rb = [t.clone() for t in ra]
    got = bt.bn_stats_apply(y, gamma, beta, *ra, relu, keep_f32)
    stats = bt.bn_stats_plain(y, gamma, beta, *rb)
    want = (*stats, *conv_epilogue_plain(y, stats[2], stats[3], act=relu, keep_f32=keep_f32))
    for a, b in zip(got + tuple(ra), want + tuple(rb)):
        assert (a is None and b is None) or torch.equal(a, b)
    bt.launches = bt.narrow_launches = 0
    site = bt.BNTrainSite.apply(y, gamma, beta, *[t.clone() for t in rb], None, None, None,
                                None, None, None, relu, keep_f32)
    if keep_f32:
        assert torch.equal(site[0], want[4]) and torch.equal(site[1], want[5])
    else:
        assert torch.equal(site, want[4])
    assert bt.launches == bt.narrow_launches == 0


def test_dropout_draws_from_its_generator():
    """Kept values / (1 - rate), the others 0; the same generator state gives
    the same mask; Dropout2d keeps whole (sample, channel) planes; None is
    the identity."""
    x = torch.rand(8, 32, 6, 6).contiguous(memory_format=CL) + 0.5
    assert dropout(x, 0.5, None) is x
    a = dropout(x, 0.5, torch.Generator().manual_seed(1))
    b = dropout(x, 0.5, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.is_contiguous(memory_format=CL)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.5, rtol=0, atol=0)
    assert 0.4 < float(kept.float().mean()) < 0.6
    c = dropout(x, 0.2, torch.Generator().manual_seed(2), channels=True)
    planes = (c != 0).float().mean(dim=(2, 3))
    assert set(planes.unique().tolist()) <= {0.0, 1.0}
    assert 0.65 < float(planes.mean()) < 0.95
    keep = torch.zeros(8, 32, 1, 1, dtype=torch.bool)
    keep[:, ::2] = True
    d = dropout(x, 0.2, keep, channels=True)
    torch.testing.assert_close(d[:, ::2], x[:, ::2] / 0.8, rtol=0, atol=0)
    assert not d[:, 1::2].any()


@pytest.mark.parametrize("m,channels", [(16, 256), (16, 32), (4, 512), (64, 128), (144, 32)])
def test_launch_plan_at_the_decoders_few_pixel_sites(m, channels):
    """bn_train's plan at the decoders' 1 x 1 and small pooled sites (the
    ASPP and PAN pooling branches, the GAU gates, PSPNet's pools: m = B to
    36 B pixels): one block, whose tiles cover the site, scratch for its
    sums."""
    for mode in ("stats", "backward"):
        plan = bt.launch_plan(m, channels, mode, 528)
        assert plan.grid == 1
        assert plan.tile * -(-m // plan.tile) >= m
        assert plan.partials == plan.sums * channels and plan.combiners == 1
