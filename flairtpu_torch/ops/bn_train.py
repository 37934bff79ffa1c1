"""Train-mode BatchNorm with the residual (or downsample branch) and the ReLU
after it, forward and backward (``csrc/bn_train.cu``, and
``csrc/conv_epilogue.cu`` for the forward's apply).

Ports Flax's train-mode ``BatchNorm`` as ``flairtpu`` builds it
(``flairtpu/models/resnet.py:40-70``: momentum 0.9, epsilon 1e-5, float32
statistics, ``use_fast_variance``) at every site of the resnet encoders and
the U-Net decoder, with its VJP:

- forward: :func:`bn_stats` reduces the conv output's per-channel float32
  sum and sum of squares, takes var = E[x^2] - E[x]^2 clipped at 0 (biased),
  derives the batch (scale, shift) and updates the running statistics as
  Flax does, ``ra = 0.9 ra + 0.1 stat`` with the biased variance (torch's
  ``nn.BatchNorm2d`` keeps the unbiased one, so it is not used); then
  ``conv_epilogue`` applies (scale, shift), the residual or the branch's own
  batch (scale, shift), the ReLU and the casts;
- backward: :func:`bn_backward` masks the incoming gradient (the bf16 one
  and, where the site also handed on its float32 value, the float32 one,
  summed) by the ReLU from the saved output, reduces sum(g) and sum(g x^)
  per channel and writes dy, dgamma and dbeta, and the residual's gradient
  or the branch's dy, dgamma and dbeta.

:class:`BNTrainSite` is the ``autograd.Function`` over one site
(:func:`site_forward` and :func:`site_backward` through the kernels), and
:class:`TrainSites` the object a model's forward takes in place of its
inference epilogue (``models/resnet.py:bn_site``).

Each wrapper runs the plain PyTorch version for CPU tensors and launches the
kernel for bfloat16 CUDA tensors; it has no fallback, and counts its
launches (one a call, however many kernels the call runs).
"""

from __future__ import annotations

import ctypes

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.epilogue import conv_epilogue

MOMENTUM = 0.9  # flax's, on the running average (torch's momentum 0.1)
EPS = 1e-5
THREADS = 256
MAX_BLOCKS = 528  # 4 blocks on each of the H100's 132 SMs
STATS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset, one count per entry
# point (the CPU path does not count)
launches = 0  # statistics
backward_launches = 0


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_stats_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   eps: float = EPS, momentum: float = MOMENTUM):
    """x (B, C, H, W) -> float32 (mean, invstd, scale, shift) per channel;
    the running statistics updated in place."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0)
    invstd = torch.rsqrt(var + eps)
    scale = gamma * invstd
    shift = beta - mean * scale
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * var)
    return mean, invstd, scale, shift


def _layout(x: torch.Tensor) -> tuple[int, int, int]:
    """(pixels, channels, blocks) of the kernels' walk over x."""
    C = x.shape[1]
    m = x.numel() // C
    rows = THREADS // (C // 8)
    return m, C, max(1, min(-(-m // rows), MAX_BLOCKS))


def _check_map(t: torch.Tensor, like: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if (t.device != like.device or t.dtype != dtype or t.shape != like.shape
            or not t.is_contiguous(memory_format=torch.channels_last) or t.data_ptr() % 16):
        raise ValueError(f"bn_train: {what} must be a channels_last {dtype} tensor of shape "
                         f"{tuple(like.shape)} on {like.device}, 16-byte aligned")


def _check_vector(v: torch.Tensor, C: int, device, what: str) -> None:
    if (v.device != device or v.dtype != torch.float32 or tuple(v.shape) != (C,)
            or not v.is_contiguous()):
        raise ValueError(f"bn_train: {what} must be a contiguous ({C},) float32 tensor "
                         f"on {device}")


def _on_card(x: torch.Tensor, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: dtype {x.dtype} (the kernel takes bfloat16)")
    C = x.shape[1]
    if C % 8 or not 8 <= C <= 8 * THREADS:
        raise ValueError(f"{what}: {C} channels (the kernel takes a multiple of 8 up to "
                         f"{8 * THREADS})")
    return True


def bn_stats(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor,
             eps: float = EPS, momentum: float = MOMENTUM):
    """As :func:`bn_stats_plain`; x channels_last. CPU tensors: the plain
    version. bfloat16 CUDA tensors: the kernel, or an error."""
    global launches
    if x.dim() != 4:
        raise ValueError(f"bn_stats: x must be (B, C, H, W), got {tuple(x.shape)}")
    if not _on_card(x, "bn_stats"):
        return bn_stats_plain(x, gamma, beta, running_mean, running_var, eps, momentum)
    _check_map(x, x, torch.bfloat16, "x")
    m, C, blocks = _layout(x)
    for name, v in (("gamma", gamma), ("beta", beta), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vector(v, C, x.device, name)
    partials = torch.empty((blocks, 2, C), dtype=torch.float32, device=x.device)
    out = torch.empty((4, C), dtype=torch.float32, device=x.device)
    mean, invstd, scale, shift = out
    err = _build.entry("bn_train", STATS_ARGTYPES, "bn_train_stats")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), partials.data_ptr(), blocks, mean.data_ptr(),
        invstd.data_ptr(), scale.data_ptr(), shift.data_ptr(), m, C, eps, momentum,
        _build.stream_handle(x))
    _build.check(err, "bn_stats")
    launches += 1
    return mean, invstd, scale, shift


def _grad_in(g, g32, out, relu: bool) -> torch.Tensor:
    gz = 0
    if g is not None:
        gz = g.float()
    if g32 is not None:
        gz = gz + g32.float()
    return gz * (out > 0) if relu else gz


def _bn_input_grad(gz, x, mean, invstd, gamma):
    """(dx, dgamma, dbeta) of a train-mode BatchNorm for the output gradient gz."""
    m = x.numel() // x.shape[1]
    xh = (x.float() - _chw(mean)) * _chw(invstd)
    dbeta = gz.sum(dim=(0, 2, 3))
    dgamma = (gz * xh).sum(dim=(0, 2, 3))
    dx = _chw(gamma * invstd) * (gz - (_chw(dbeta) + xh * _chw(dgamma)) / m)
    return dx.to(x.dtype), dgamma, dbeta


def bn_backward_plain(g, g32, out, y, mean, invstd, gamma, branch=None, relu: bool = True,
                      residual: bool = False):
    """The site's backward: g (y's dtype) and g32 (float32), either may be
    None, out the forward's output (y's dtype). ``branch`` = (d, mean_d,
    invstd_d, gamma_d). Returns (dy, dgamma, dbeta, dres, (dd, dgamma_d,
    dbeta_d) or None): dres (float32) where ``residual``."""
    gz = _grad_in(g, g32, out, relu)
    dy, dgamma, dbeta = _bn_input_grad(gz, y, mean, invstd, gamma)
    dres = gz.contiguous(memory_format=torch.channels_last) if residual else None
    db = None
    if branch is not None:
        db = _bn_input_grad(gz, *branch)
    return dy, dgamma, dbeta, dres, db


def bn_backward(g, g32, out, y, mean, invstd, gamma, branch=None, relu: bool = True,
                residual: bool = False):
    """As :func:`bn_backward_plain`; every map channels_last. CPU tensors:
    the plain version. bfloat16 CUDA tensors: the kernel, or an error."""
    global backward_launches
    if not _on_card(y, "bn_backward"):
        return bn_backward_plain(g, g32, out, y, mean, invstd, gamma, branch, relu, residual)
    if residual and branch is not None:
        raise ValueError("bn_backward: a residual or a branch, not both")
    _check_map(y, y, torch.bfloat16, "y")
    if g is not None:
        _check_map(g, y, torch.bfloat16, "g")
    if g32 is not None:
        _check_map(g32, y, torch.float32, "g32")
    if relu:
        _check_map(out, y, torch.bfloat16, "out")
    m, C, blocks = _layout(y)
    for name, v in (("mean", mean), ("invstd", invstd), ("gamma", gamma)):
        _check_vector(v, C, y.device, name)
    d = mean_d = invstd_d = gamma_d = dd = None
    if branch is not None:
        d, mean_d, invstd_d, gamma_d = branch
        _check_map(d, y, torch.bfloat16, "branch")
        for name, v in (("mean_d", mean_d), ("invstd_d", invstd_d), ("gamma_d", gamma_d)):
            _check_vector(v, C, y.device, name)
        dd = torch.empty_like(d)
    dy = torch.empty_like(y)
    dres = torch.empty_like(y, dtype=torch.float32) if residual else None
    partials = torch.empty((blocks, 3, C), dtype=torch.float32, device=y.device)
    sums = torch.empty((3, C), dtype=torch.float32, device=y.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("bn_train", BACKWARD_ARGTYPES, "bn_train_backward")(
        ptr(g), ptr(g32), ptr(out) if relu else None, ptr(y), ptr(mean), ptr(invstd),
        ptr(gamma), ptr(d), ptr(mean_d), ptr(invstd_d), ptr(gamma_d), ptr(partials), blocks,
        ptr(sums), ptr(dy), ptr(dres), ptr(dd), m, C, _build.stream_handle(y))
    _build.check(err, "bn_backward")
    backward_launches += 1
    dbeta, dgamma, dgamma_d = sums
    return dy, dgamma, dbeta, dres, (None if d is None else (dd, dgamma_d, dbeta))


def _channels_last(t):
    return None if t is None else t.contiguous(memory_format=torch.channels_last)


def site_forward(ctx, stats, epilogue, y, gamma, beta, rm, rv, residual, d, gamma_d, beta_d,
                 rm_d, rv_d, relu, keep_f32):
    """The forward of :class:`BNTrainSite` through ``stats`` and
    ``epilogue`` (:func:`bn_stats` and ``conv_epilogue``, or functions of
    their signatures), saving on ``ctx`` what :func:`site_backward` needs."""
    ctx.set_materialize_grads(False)
    mean, invstd, scale, shift = stats(y, gamma, beta, rm, rv)
    branch = stats_d = None
    if d is not None:
        stats_d = stats(d, gamma_d, beta_d, rm_d, rv_d)
        branch = (d, stats_d[2], stats_d[3])
    out, out32 = epilogue(y, scale, shift, residual=residual, branch=branch, relu=relu,
                          keep_f32=keep_f32)
    ctx.relu = relu
    ctx.residual = residual is not None
    ctx.residual_dtype = None if residual is None else residual.dtype
    ctx.save_for_backward(y, out, mean, invstd, gamma, d,
                          *(stats_d[:2] if d is not None else (None, None)), gamma_d)
    if not keep_f32:
        return out
    if out32 is out:  # float32 y: one tensor, handed on twice
        out32 = out.clone()
    return out, out32


def site_backward(ctx, backward, g, g32):
    """The gradients of :func:`site_forward`'s tensor inputs through
    ``backward`` (:func:`bn_backward` or a function of its signature)."""
    y, out, mean, invstd, gamma, d, mean_d, invstd_d, gamma_d = ctx.saved_tensors
    branch = None if d is None else (d, mean_d, invstd_d, gamma_d)
    dy, dgamma, dbeta, dres, db = backward(_channels_last(g), _channels_last(g32), out, y, mean,
                                           invstd, gamma, branch, ctx.relu, ctx.residual)
    if dres is not None:
        dres = dres.to(ctx.residual_dtype)
    dd, dgamma_d, dbeta_d = db if db is not None else (None, None, None)
    return dy, dgamma, dbeta, None, None, dres, dd, dgamma_d, dbeta_d, None, None, None, None


class BNTrainSite(torch.autograd.Function):
    """One site: out = ReLU(BN(y) + residual) or ReLU(BN(y) + BN_d(d)),
    with batch statistics; returns (out, out32) where ``keep_f32``, else out.

    apply(y, gamma, beta, running_mean, running_var, residual, d, gamma_d,
    beta_d, running_mean_d, running_var_d, relu, keep_f32)."""

    @staticmethod
    def forward(ctx, *args):
        return site_forward(ctx, bn_stats, conv_epilogue, *args)

    @staticmethod
    def backward(ctx, g, g32=None):
        return site_backward(ctx, bn_backward, g, g32)


class TrainSites:
    """What a model's forward takes in place of its inference epilogue to
    train: each BatchNorm site through :class:`BNTrainSite`, with the
    BatchNorm modules (their gamma, beta and running statistics)."""

    def apply(self, *args):
        """One site's autograd Function applied to :class:`BNTrainSite`'s
        arguments."""
        return BNTrainSite.apply(*args)

    def site(self, y, bn, residual=None, branch=None, relu: bool = True,
             keep_f32: bool = False):
        """``branch`` = (d, bn_d). Returns (out, out32 or None)."""
        d, bn_d = branch if branch is not None else (None, None)
        res = self.apply(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, residual, d,
                         *((bn_d.weight, bn_d.bias, bn_d.running_mean, bn_d.running_var)
                           if bn_d is not None else (None,) * 4), relu, keep_f32)
        return res if keep_f32 else (res, None)
