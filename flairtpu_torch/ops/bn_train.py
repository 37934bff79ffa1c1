"""Train-mode BatchNorm with the residual (or downsample branch) and the ReLU
after it, forward and backward (``csrc/bn_train.cu``, and
``csrc/conv_epilogue.cu`` for the forward's apply).

Ports Flax's train-mode ``BatchNorm`` as ``flairtpu`` builds it
(``flairtpu/models/resnet.py:40-70``: momentum 0.9, epsilon 1e-5, float32
statistics, ``use_fast_variance``) at every site of the resnet encoders and
the U-Net decoder, with its VJP; a site takes its module's eps and momentum
(:meth:`TrainSites.site`), so EfficientNet's 1e-3 and 0.99 too:

- forward: :func:`bn_stats` reduces the conv output's per-channel float32
  sum and sum of squares, takes var = E[x^2] - E[x]^2 clipped at 0 (biased),
  derives the batch (scale, shift) and updates the running statistics as
  Flax does, ``ra = m ra + (1 - m) stat`` (m = 0.9 at the resnet sites)
  with the biased variance (torch's ``nn.BatchNorm2d`` keeps the unbiased
  one, so it is not used); then
  ``conv_epilogue`` applies (scale, shift), the residual or the branch's own
  batch (scale, shift), the ReLU and the casts. At a narrow site (below)
  :func:`bn_stats_apply` does both in one launch;
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
launches (one a call, however many kernels the call runs: the statistics
are one, the backward two). A site whose channel count is not a multiple of
8 (PAN's 1-channel pyramid) takes the narrow entry points, a block a
channel, one launch each way, with no residual or branch: the forward
(:func:`bn_stats_apply`) writes the statistics and the site's output, so
no ``conv_epilogue`` follows; they count in ``narrow_launches`` and
``narrow_backward_launches``. :func:`launch_plan`
sizes a call's grid and scratch; each call allocates its partials with ``torch.empty``, and the
kernels' int32 ticket counters are cached, one pair per (device, stream):
the kernels leave them at 0, and calls on one stream run in order, so no
call needs a memset (a fresh zeroed pair would cost a fill launch a call,
89 a train step). Nothing syncs with the host, so a call can be captured
in a CUDA graph once a call outside the capture has made its stream's
counters.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain
from flairtpu_torch.ops.group_norm import GroupNormReLU

MOMENTUM = 0.9  # flax's, on the running average (torch's momentum 0.1)
EPS = 1e-5
THREADS = 256
# pixels a thread loads at once (csrc/bn_train.cu kStatsUnroll, kBackUnroll)
UNROLL = {"stats": 4, "backward": 2}
WARPS = THREADS // 32
COMBINE_LOADS = 8  # partials a lane of the combine loads at once (kCombineLoads)
COUNTERS = 2  # int32 ticket counters a call uses (kCounters)
MIN_BLOCK_BYTES = 64 * 1024  # of the site's bf16 map, the least a block takes
STATS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
NARROW_FORWARD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
NARROW_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset, one count per entry
# point (the CPU path does not count)
launches = 0  # statistics
backward_launches = 0
narrow_launches = 0  # the narrow entry points'
narrow_backward_launches = 0


def _chw(v: torch.Tensor) -> torch.Tensor:
    return v[:, None, None]


def bn_stats_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor,
                   eps: float = EPS, momentum: float = MOMENTUM):
    """x (B, C, H, W) -> float32 (mean, invstd, scale, shift) per channel;
    the running statistics updated in place. A narrow site's sums run in
    double, as its kernel's do."""
    xf = x.float()
    if x.shape[1] % 8:
        m = xf.numel() // x.shape[1]
        mean = (xf.sum(dim=(0, 2, 3), dtype=torch.float64) / m).float()
        ex2 = ((xf * xf).sum(dim=(0, 2, 3), dtype=torch.float64) / m).float()
    else:
        mean, ex2 = xf.mean(dim=(0, 2, 3)), (xf * xf).mean(dim=(0, 2, 3))
    var = torch.clamp_min(ex2 - mean * mean, 0)
    invstd = torch.rsqrt(var + eps)
    scale = gamma * invstd
    shift = beta - mean * scale
    running_mean.copy_(momentum * running_mean + (1 - momentum) * mean)
    running_var.copy_(momentum * running_var + (1 - momentum) * var)
    return mean, invstd, scale, shift


def bn_stats_apply_plain(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor,
                         relu: bool = True, keep_f32: bool = False, eps: float = EPS,
                         momentum: float = MOMENTUM):
    """A site's statistics and its output, no residual or branch: the bits
    of :func:`bn_stats_plain` then ``conv_epilogue_plain``. Returns (mean,
    invstd, scale, shift, out, out32 or None)."""
    stats = bn_stats_plain(y, gamma, beta, running_mean, running_var, eps, momentum)
    return (*stats, *conv_epilogue_plain(y, stats[2], stats[3], relu=relu, keep_f32=keep_f32))


class Plan(NamedTuple):
    """One call's launch: ``grid`` blocks of THREADS threads, each walking
    tiles of ``tile`` pixels; ``sums`` per-channel sums a block writes; the
    last ``combiners`` blocks to arrive combine them; float32 ``partials``
    and int32 ``counters`` of scratch."""
    grid: int
    tile: int
    sums: int
    combiners: int
    partials: int
    counters: int


def launch_plan(m: int, channels: int, mode: str, co_resident: int,
                branch: bool = False) -> Plan:
    """The grid and scratch of a ``mode`` call ("stats" or "backward", with
    or without a ``branch``) over ``m`` pixels of ``channels``: blocks of
    THREADS threads, C / 8 to a pixel, walk tiles of rows x UNROLL[mode]
    pixels; each block takes whole tiles of at least MIN_BLOCK_BYTES of the
    bf16 map, and the grid holds at most ``co_resident`` blocks (the card's
    SMs times the kernel's occupancy), so a site smaller than one block's
    share takes one block. The backward's two launches share the grid."""
    rows = THREADS // (channels // 8)
    tile = rows * UNROLL[mode]
    min_tiles = -(-MIN_BLOCK_BYTES // (2 * tile * channels))
    grid = max(1, min(co_resident, (m // tile) // min_tiles))
    sums = 2 + (mode == "backward" and branch)
    return Plan(grid, tile, sums, combiners(grid, channels), sums * channels * grid, COUNTERS)


def combiners(grid: int, channels: int) -> int:
    """The last blocks of a call that combine its sums (csrc/bn_train.cu
    combiners_for): a team of warps to a channel, each lane loading at most
    COMBINE_LOADS of a sum's partials, one channel a team."""
    seg = 1
    while seg < WARPS and seg * 32 * COMBINE_LOADS < grid:
        seg *= 2
    return min(grid, -(-channels * seg // WARPS))


_CO_RESIDENT: dict[tuple, int] = {}
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _co_resident(device: torch.device, mode: str, channels: int, branch: bool = False) -> int:
    """The blocks of ``mode``'s kernels that ``device`` holds at once: its
    SMs times their occupancy at this channel count (queried once)."""
    key = (device.index, mode, channels, branch)
    n = _CO_RESIDENT.get(key)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _build.entry("bn_train", OCCUPANCY_ARGTYPES, "bn_train_occupancy")(
                int(mode != "stats"), channels, int(branch), ctypes.byref(per_sm))
        _build.check(err, "bn_train occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = _CO_RESIDENT[key] = sms * max(1, per_sm.value)
    return n


def _counters(device: torch.device, stream: int) -> torch.Tensor:
    """The ticket counters of calls on ``stream``: zero, and left zero by
    every call."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(COUNTERS, dtype=torch.int32, device=device)
    return buf


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
    if not 1 <= C <= 8 * THREADS:
        raise ValueError(f"{what}: {C} channels (the kernels take 1 to {8 * THREADS}; a "
                         "multiple of 8, or the narrow entry points)")
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
    C = x.shape[1]
    m = x.numel() // C
    for name, v in (("gamma", gamma), ("beta", beta), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vector(v, C, x.device, name)
    out = torch.empty((4, C), dtype=torch.float32, device=x.device)
    mean, invstd, scale, shift = out
    if C % 8:
        _narrow_forward(x, gamma, beta, running_mean, running_var, out, eps=eps,
                        momentum=momentum)
        return mean, invstd, scale, shift
    plan = launch_plan(m, C, "stats", _co_resident(x.device, "stats", C))
    stream = _build.stream_handle(x)
    partials = torch.empty(plan.partials, dtype=torch.float32, device=x.device)
    counters = _counters(x.device, stream)
    err = _build.entry("bn_train", STATS_ARGTYPES, "bn_train_stats")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), partials.data_ptr(), partials.numel(), counters.data_ptr(),
        counters.numel(), plan.grid, mean.data_ptr(), invstd.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), m, C, eps, momentum, stream)
    _build.check(err, "bn_stats")
    launches += 1
    return mean, invstd, scale, shift


def _narrow_forward(x, gamma, beta, running_mean, running_var, stats, out=None, out32=None,
                    relu: bool = True, eps: float = EPS, momentum: float = MOMENTUM) -> None:
    """One launch of the narrow forward into ``stats`` (4, C) (and the
    site's ``out`` and ``out32`` where given)."""
    global narrow_launches
    C = x.shape[1]

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("bn_train", NARROW_FORWARD_ARGTYPES, "bn_train_narrow_forward")(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), running_mean.data_ptr(),
        running_var.data_ptr(), *(t.data_ptr() for t in stats), ptr(out), ptr(out32),
        x.numel() // C, C, int(relu), eps, momentum, _build.stream_handle(x))
    _build.check(err, "bn_stats (narrow)")
    narrow_launches += 1


def bn_stats_apply(y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, relu: bool = True,
                   keep_f32: bool = False, eps: float = EPS, momentum: float = MOMENTUM):
    """As :func:`bn_stats_apply_plain` at a narrow site (channels not a
    multiple of 8); y channels_last. CPU tensors: the plain version.
    bfloat16 CUDA tensors: one launch of the narrow forward, or an error."""
    if y.dim() != 4:
        raise ValueError(f"bn_stats_apply: y must be (B, C, H, W), got {tuple(y.shape)}")
    if not _on_card(y, "bn_stats_apply"):
        return bn_stats_apply_plain(y, gamma, beta, running_mean, running_var, relu, keep_f32,
                                    eps, momentum)
    C = y.shape[1]
    if C % 8 == 0:
        raise ValueError(f"bn_stats_apply: {C} channels (the narrow entry point takes a count "
                         "that is not a multiple of 8; bn_stats and conv_epilogue the others)")
    _check_map(y, y, torch.bfloat16, "y")
    for name, v in (("gamma", gamma), ("beta", beta), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _check_vector(v, C, y.device, name)
    stats = torch.empty((4, C), dtype=torch.float32, device=y.device)
    out = torch.empty_like(y)
    out32 = torch.empty_like(y, dtype=torch.float32) if keep_f32 else None
    _narrow_forward(y, gamma, beta, running_mean, running_var, stats, out, out32, relu, eps,
                    momentum)
    return (*stats, out, out32)


def _grad_in(g, g32, out, relu: bool) -> torch.Tensor:
    gz = 0
    if g is not None:
        gz = g.float()
    if g32 is not None:
        gz = gz + g32.float()
    return gz * (out > 0) if relu else gz


def _bn_input_grad(gz, x, mean, invstd, gamma):
    """(dx, dgamma, dbeta) of a train-mode BatchNorm for the output gradient
    gz; a narrow site's sums in double, as its kernel's (one channel's sum
    over the batch cancels to a small fraction of its terms: PAN's
    pyramid)."""
    m = x.numel() // x.shape[1]
    xh = (x.float() - _chw(mean)) * _chw(invstd)
    acc = torch.float64 if x.shape[1] % 8 else torch.float32
    dbeta = gz.sum(dim=(0, 2, 3), dtype=acc).float()
    dgamma = (gz * xh).sum(dim=(0, 2, 3), dtype=acc).float()
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
    global backward_launches, narrow_backward_launches
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
    C = y.shape[1]
    m = y.numel() // C
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
    if C % 8:
        if residual or branch is not None:
            raise ValueError(f"bn_backward: a {C}-channel site takes no residual or branch "
                             "(the narrow entry point)")
        sums = torch.empty((2, C), dtype=torch.float32, device=y.device)
        err = _build.entry("bn_train", NARROW_BACKWARD_ARGTYPES, "bn_train_narrow_backward")(
            None if g is None else g.data_ptr(), None if g32 is None else g32.data_ptr(),
            out.data_ptr() if relu else None, y.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
            gamma.data_ptr(), sums.data_ptr(), dy.data_ptr(), m, C, _build.stream_handle(y))
        _build.check(err, "bn_backward (narrow)")
        narrow_backward_launches += 1
        return dy, sums[1], sums[0], None, None
    dres = torch.empty_like(y, dtype=torch.float32) if residual else None
    branched = branch is not None
    plan = launch_plan(m, C, "backward", _co_resident(y.device, "backward", C, branched),
                       branched)
    stream = _build.stream_handle(y)
    partials = torch.empty(plan.partials, dtype=torch.float32, device=y.device)
    counters = _counters(y.device, stream)
    sums = torch.empty((3, C), dtype=torch.float32, device=y.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _build.entry("bn_train", BACKWARD_ARGTYPES, "bn_train_backward")(
        ptr(g), ptr(g32), ptr(out) if relu else None, ptr(y), ptr(mean), ptr(invstd),
        ptr(gamma), ptr(d), ptr(mean_d), ptr(invstd_d), ptr(gamma_d), ptr(partials),
        partials.numel(), ptr(counters), counters.numel(), plan.grid, ptr(sums), ptr(dy),
        ptr(dres), ptr(dd), m, C, stream)
    _build.check(err, "bn_backward")
    backward_launches += 1
    dbeta, dgamma, dgamma_d = sums
    return dy, dgamma, dbeta, dres, (None if d is None else (dd, dgamma_d, dbeta))


def _channels_last(t):
    return None if t is None else t.contiguous(memory_format=torch.channels_last)


def site_forward(ctx, stats, epilogue, stats_apply, y, gamma, beta, rm, rv, residual, d, gamma_d,
                 beta_d, rm_d, rv_d, relu, keep_f32, eps=EPS, momentum=MOMENTUM):
    """The forward of :class:`BNTrainSite` through ``stats`` and
    ``epilogue`` (:func:`bn_stats` and ``conv_epilogue``), or at a narrow
    site with no residual or branch ``stats_apply`` (:func:`bn_stats_apply`),
    or functions of their signatures, saving on ``ctx`` what
    :func:`site_backward` needs. ``eps`` and the Flax ``momentum`` are the
    site's BatchNorm's (and its branch's)."""
    ctx.set_materialize_grads(False)
    branch = stats_d = None
    if y.shape[1] % 8 and residual is None and d is None:
        mean, invstd, scale, shift, out, out32 = stats_apply(y, gamma, beta, rm, rv, relu,
                                                             keep_f32, eps, momentum)
    else:
        mean, invstd, scale, shift = stats(y, gamma, beta, rm, rv, eps, momentum)
        if d is not None:
            stats_d = stats(d, gamma_d, beta_d, rm_d, rv_d, eps, momentum)
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
    return (dy, dgamma, dbeta, None, None, dres, dd, dgamma_d, dbeta_d, None, None, None, None,
            None, None)


class BNTrainSite(torch.autograd.Function):
    """One site: out = ReLU(BN(y) + residual) or ReLU(BN(y) + BN_d(d)),
    with batch statistics; returns (out, out32) where ``keep_f32``, else out.

    apply(y, gamma, beta, running_mean, running_var, residual, d, gamma_d,
    beta_d, running_mean_d, running_var_d, relu, keep_f32[, eps, momentum]):
    ``momentum`` in Flax's sense (``ra = momentum ra + (1 - momentum)
    stat``)."""

    @staticmethod
    def forward(ctx, *args):
        return site_forward(ctx, bn_stats, conv_epilogue, bn_stats_apply, *args)

    @staticmethod
    def backward(ctx, g, g32=None):
        return site_backward(ctx, bn_backward, g, g32)


def bn_constants(bn) -> tuple[float, float]:
    """An ``nn.BatchNorm2d``'s (eps, Flax momentum)."""
    if bn.momentum is None:
        raise ValueError("TrainSites: a BatchNorm with momentum None (a cumulative average) "
                         "has no Flax counterpart")
    return float(bn.eps), 1.0 - float(bn.momentum)


class TrainSites:
    """What a model's forward takes in place of its inference epilogue to
    train: each BatchNorm site through :class:`BNTrainSite`, with the
    BatchNorm modules (their gamma, beta and running statistics), and each
    GroupNorm site through ``GroupNormReLU``."""

    def apply(self, *args):
        """One site's autograd Function applied to :class:`BNTrainSite`'s
        arguments."""
        return BNTrainSite.apply(*args)

    def site(self, y, bn, residual=None, branch=None, relu: bool = True,
             keep_f32: bool = False):
        """``branch`` = (d, bn_d). Returns (out, out32 or None). The site
        takes ``bn``'s eps and momentum (torch's ``momentum`` m is Flax's
        1 - m)."""
        d, bn_d = branch if branch is not None else (None, None)
        eps, momentum = bn_constants(bn)
        if bn_d is not None and bn_constants(bn_d) != (eps, momentum):
            raise ValueError("TrainSites.site: the branch's BatchNorm has another eps or "
                             "momentum than the site's")
        res = self.apply(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, residual, d,
                         *((bn_d.weight, bn_d.bias, bn_d.running_mean, bn_d.running_var)
                           if bn_d is not None else (None,) * 4), relu, keep_f32, eps, momentum)
        return res if keep_f32 else (res, None)

    def group_norm(self, y, gamma, beta, groups: int, eps: float, upsample: bool):
        """A GroupNorm + ReLU (+ 2x nearest) site in train mode (FPN's):
        ``ops/group_norm.py:GroupNormReLU``, float32 out."""
        return GroupNormReLU.apply(y, gamma, beta, groups, eps, upsample)
