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

EfficientNet's train sites (``flairtpu/models/efficientnet.py:170-212,
:234-262``) take the same two kernels with more operands: a SiLU site (the
stem, each expand) recomputes the SiLU's input from the saved map and the
forward's shift and multiplies the gradient by the SiLU's derivative; the
depthwise site (:class:`SEGateSite`: BatchNorm, SiLU and the squeeze-excite
gate as one node) sums its two gradients, the excite's multiply by the
(B, C) gate and the squeeze's mean, into one per-(b, c) affine of the
gradient before that derivative (the gate's own gradient comes from
``ops/se_gate.py:se_backward``); the project site takes the drop-connect
(``conv_epilogue``'s ``drop`` forward, the gradient times mask[b] / keep,
the identity's gradient untouched). Above 2048 channels (b2-b7's expanded
maps) the channels are cut into tiles that blocks take
(:func:`channel_tiles`). The backward is one template instance a mode
(:data:`KINDS`, :func:`backward_kind`): the ReLU and branch sites at U =
2, the lean ones (no ReLU, no branch) with the SiLU's sigmoid on the
special-function units, U = 4 where a pixel loads only g and y, and the
sample index of the affine by the multiply-high of :func:`sample_divisor`.

:class:`BNTrainSite` is the ``autograd.Function`` over one site
(:func:`site_forward` and :func:`site_backward` through the kernels),
:class:`SEGateSite` the depthwise site's (:func:`se_site_forward` and
:func:`se_site_backward`), and :class:`TrainSites` the object a model's
forward takes in place of its inference epilogue
(``models/resnet.py:bn_site``, ``models/efficientnet.py``).

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
from flairtpu_torch.ops.epilogue import conv_epilogue, conv_epilogue_plain, inverse_keep
from flairtpu_torch.ops.group_norm import GroupNormReLU
from flairtpu_torch.ops.se_gate import gate_from, se_backward, se_excite, se_squeeze

MOMENTUM = 0.9  # flax's, on the running average (torch's momentum 0.1)
EPS = 1e-5
THREADS = 256
# pixels a thread loads at once (csrc/bn_train.cu kStatsUnroll; kBackUnroll
# in a backward whose pixel also loads the ReLU's output, a branch or g32,
# kLeanUnroll in one that loads only g and y)
UNROLL = {"stats": 4, "backward": 2, "lean": 4}
# the backward's template instances (csrc/bn_train.cu Kind): the lean ones
# (no ReLU, no branch) with and without a float32 gradient
KINDS = ("relu", "branch", "lean", "silu", "affine", "silu_affine", "lean_g32", "silu_g32",
         "affine_g32", "silu_affine_g32")
MAX_BACKWARD_PIXELS = 2 ** 31  # a backward's pixel index fits 31 bits (kMaxBackPixels)
WARPS = THREADS // 32
COMBINE_LOADS = 8  # partials a lane of the combine loads at once (kCombineLoads)
COUNTERS = 2  # int32 ticket counters a call uses (kCounters)
MIN_BLOCK_BYTES = 64 * 1024  # of the site's bf16 map, the least a block takes
MIN_LEAN_BLOCK_BYTES = 16 * 1024  # the same in a lean backward (no ReLU, no branch)
MIN_TILE_CHANNELS = 512  # a channel tile's least width, above 8 * THREADS channels
STATS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
    ctypes.c_void_p]
BACKWARD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                                              ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
OCCUPANCY_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
NARROW_FORWARD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
NARROW_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_void_p]

# kernel launches on CUDA tensors since the last reset, one count per entry
# point (the CPU path does not count), and of them by mode: over channel
# tiles (above 2048 channels), the backward with the SiLU alone (the stem's
# and expand sites') and with the gradient affine (the depthwise and
# drop-connect sites')
launches = 0  # statistics
backward_launches = 0
narrow_launches = 0  # the narrow entry points'
narrow_backward_launches = 0
wide_launches = 0
wide_backward_launches = 0
silu_backward_launches = 0
affine_backward_launches = 0


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
    tiles of ``tile`` = rows x ``unroll`` pixels of its channel tile
    (``channel_tiles`` of them, block i taking tile i % channel_tiles);
    ``sums`` per-channel sums a block writes; the last ``combiners`` blocks
    to arrive combine them; float32 ``partials`` and int32 ``counters`` of
    scratch; a backward's sample index constant (:func:`sample_divisor`)."""
    grid: int
    tile: int
    sums: int
    combiners: int
    partials: int
    counters: int
    channel_tiles: int = 1
    unroll: int = 0
    sample_magic: int = 0
    sample_shift: int = 0


def channel_tiles(channels: int) -> int:
    """The channel tiles a block takes one of: 1 up to 8 x THREADS channels
    (a pixel's C / 8 threads fit a block); above, the count of equal tiles of
    whole 8-channel groups, each at most 8 x THREADS and at least
    MIN_TILE_CHANNELS wide, that keeps the most of a block's threads busy
    (rows x lanes of THREADS), the fewest of those."""
    groups = channels // 8
    if groups <= THREADS:
        return 1
    fits = [t for t in range(-(-groups // THREADS), groups + 1) if groups % t == 0]
    wide = [t for t in fits if groups // t * 8 >= MIN_TILE_CHANNELS] or fits[:1]
    return max(wide, key=lambda t: (THREADS // (groups // t) * (groups // t), -t))


def sample_divisor(hw: int) -> tuple[int, int]:
    """(magic, shift) with (p * magic) >> shift == p // hw for every pixel
    p < 2^31: shift = 31 + ceil(log2 hw), magic = ceil(2^shift / hw), below
    2^32 (csrc/bn_train.cu sample_divisor_ok checks it; the kernel's
    multiply is 32 x 32 -> 64 bits)."""
    if not 1 <= hw <= MAX_BACKWARD_PIXELS:
        raise ValueError(f"bn_train: {hw} pixels a sample")
    shift = 31 + (hw - 1).bit_length()
    return -(-(1 << shift) // hw), shift


def backward_kind(relu: bool, branch: bool, silu: bool, affine: bool, g32: bool = False) -> str:
    """The backward's instance (:data:`KINDS`) of a call's operands (``g32``:
    a float32 gradient; the ReLU and branch instances test for it at run
    time)."""
    if branch:
        return "branch"
    if relu:
        return "relu"
    kind = {(True, True): "silu_affine", (False, True): "affine", (True, False): "silu",
            (False, False): "lean"}[silu, affine]
    return kind + "_g32" if g32 else kind


def launch_plan(m: int, channels: int, mode: str, co_resident: int,
                branch: bool = False, lean: bool = False, hw: int = 1,
                g32: bool = False, sms: int = 0) -> Plan:
    """The grid and scratch of a ``mode`` call ("stats" or "backward", with
    or without a ``branch``; ``lean``: a backward with no ReLU and no
    branch, ``g32``: with a float32 gradient) over ``m`` pixels of
    ``channels`` (``hw`` of them a sample): blocks of THREADS threads, W / 8
    to a pixel (W the channel tile's width: C up to 2048), walk tiles of
    rows x U pixels (UNROLL: the statistics', the backward's, or the lean
    backward's where a pixel loads only g and y); each block takes whole
    tiles of at least MIN_BLOCK_BYTES (a lean backward's
    MIN_LEAN_BLOCK_BYTES) of its channel tile's bf16 map, and the grid
    holds at most ``co_resident`` blocks (the card's SMs times the kernel's
    occupancy), so a site smaller than one block's share takes one block a
    channel tile; a lean backward's grid over one channel tile that exceeds
    the card's ``sms`` is a multiple of them (as many blocks on each SM).
    The backward's two launches share the grid; it refuses
    MAX_BACKWARD_PIXELS or more."""
    backward = mode == "backward"
    if backward and m >= MAX_BACKWARD_PIXELS:
        raise ValueError(f"bn_backward: {m} pixels (the kernel takes fewer than 2^31)")
    ct = channel_tiles(channels)
    width = channels // ct
    rows = THREADS // (width // 8)
    lean = backward and lean and not branch
    unroll = UNROLL["lean" if lean and not g32 else mode]
    tile = rows * unroll
    min_tiles = -(-(MIN_LEAN_BLOCK_BYTES if lean else MIN_BLOCK_BYTES) // (2 * tile * width))
    nb = max(1, min(co_resident // ct, (m // tile) // min_tiles))
    if lean and ct == 1 and sms and nb > sms:
        nb -= nb % sms
    sums = 2 + (backward and branch)
    magic, shift = sample_divisor(hw) if backward else (0, 0)
    return Plan(nb * ct, tile, sums, combiners(nb, channels), sums * channels * nb, COUNTERS,
                ct, unroll, magic, shift)


def combiners(grid: int, channels: int) -> int:
    """The last blocks of a call that combine its sums (csrc/bn_train.cu
    combiners_for), ``grid`` the blocks of a channel tile: a team of warps
    to a channel, each lane loading at most COMBINE_LOADS of a sum's
    partials, one channel a team."""
    seg = 1
    while seg < WARPS and seg * 32 * COMBINE_LOADS < grid:
        seg *= 2
    return min(grid, -(-channels * seg // WARPS))


_CO_RESIDENT: dict[tuple, int] = {}
_SMS: dict[int, int] = {}
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _co_resident(device: torch.device, mode: str, channels: int, kind=0) -> int:
    """The blocks of ``mode``'s kernels that ``device`` holds at once: its
    SMs times their occupancy at this channel count's tile width (queried
    once); a backward's ``kind`` is its instance (:data:`KINDS`, a name or
    its index: 0 the ReLU sites', 1 the branch's)."""
    kind = KINDS.index(kind) if isinstance(kind, str) else int(kind)
    key = (device.index, mode, channels, kind)
    n = _CO_RESIDENT.get(key)
    if n is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _build.entry("bn_train", OCCUPANCY_ARGTYPES, "bn_train_occupancy")(
                int(mode != "stats"), channels // channel_tiles(channels), kind,
                ctypes.byref(per_sm))
        _build.check(err, "bn_train occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = _CO_RESIDENT[key] = sms * max(1, per_sm.value)
    return n


def _sms(device: torch.device) -> int:
    """``device``'s SMs (queried once)."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
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
    if C < 1 or (C % 8 and C > 8 * THREADS):
        raise ValueError(f"{what}: {C} channels (the kernels take a multiple of 8, or up to "
                         f"{8 * THREADS} through the narrow entry points)")
    return True


def bn_stats(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             running_mean: torch.Tensor, running_var: torch.Tensor,
             eps: float = EPS, momentum: float = MOMENTUM):
    """As :func:`bn_stats_plain`; x channels_last. CPU tensors: the plain
    version. bfloat16 CUDA tensors: the kernel, or an error."""
    global launches, wide_launches
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
        shift.data_ptr(), m, C, eps, momentum, plan.channel_tiles, stream)
    _build.check(err, "bn_stats")
    launches += 1
    wide_launches += plan.channel_tiles > 1
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


def _site_grad(gr, y, gamma, invstd, shift=None, gmul=None, gadd=None) -> torch.Tensor:
    """The BatchNorm output's gradient from the site's ``gr``: times the
    (B, C) ``gmul``, plus the (B, C) ``gadd``, then at a SiLU site (the
    forward's ``shift`` given) times the SiLU's derivative at z = y scale +
    shift, each step rounded on its own as the kernel rounds it."""
    gz = gr
    if gmul is not None:
        gz = gz * gmul[:, :, None, None]
    if gadd is not None:
        gz = gz + gadd[:, :, None, None]
    if shift is not None:
        z = y.float() * _chw(gamma * invstd) + _chw(shift)
        s = torch.sigmoid(z)
        gz = gz * (s * (1 + z * (1 - s)))
    return gz


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
                      residual: bool = False, shift=None, gmul=None, gadd=None):
    """The site's backward: g (y's dtype) and g32 (float32), either may be
    None, out the forward's output (y's dtype). ``branch`` = (d, mean_d,
    invstd_d, gamma_d). ``shift``: a SiLU site's forward shift; ``gmul``,
    ``gadd``: the (B, C) float32 gradient affine (:func:`_site_grad`).
    Returns (dy, dgamma, dbeta, dres, (dd, dgamma_d, dbeta_d) or None): dres
    (float32, the gradient before the affine) where ``residual``."""
    gr = _grad_in(g, g32, out, relu)
    gz = _site_grad(gr, y, gamma, invstd, shift, gmul, gadd)
    dy, dgamma, dbeta = _bn_input_grad(gz, y, mean, invstd, gamma)
    dres = gr.contiguous(memory_format=torch.channels_last) if residual else None
    db = None
    if branch is not None:
        db = _bn_input_grad(gz, *branch)
    return dy, dgamma, dbeta, dres, db


def _check_affine(t, y, what: str) -> None:
    B, C = y.shape[:2]
    if (t.device != y.device or t.dtype != torch.float32 or tuple(t.shape) != (B, C)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"bn_backward: {what} must be a contiguous ({B}, {C}) float32 tensor "
                         f"on {y.device}, 16-byte aligned")


def bn_backward(g, g32, out, y, mean, invstd, gamma, branch=None, relu: bool = True,
                residual: bool = False, shift=None, gmul=None, gadd=None):
    """As :func:`bn_backward_plain`; every map channels_last. CPU tensors:
    the plain version. bfloat16 CUDA tensors: the kernel, or an error."""
    global backward_launches, narrow_backward_launches, wide_backward_launches
    global silu_backward_launches, affine_backward_launches
    if not _on_card(y, "bn_backward"):
        return bn_backward_plain(g, g32, out, y, mean, invstd, gamma, branch, relu, residual,
                                 shift, gmul, gadd)
    if residual and branch is not None:
        raise ValueError("bn_backward: a residual or a branch, not both")
    affine = gmul is not None or gadd is not None
    if (shift is not None or affine) and (branch is not None or relu or y.shape[1] % 8):
        raise ValueError("bn_backward: the SiLU and the gradient affine take no branch, no "
                         "ReLU, and a multiple of 8 channels")
    if shift is not None:
        _check_vector(shift, y.shape[1], y.device, "shift")
    for name, t in (("gmul", gmul), ("gadd", gadd)):
        if t is not None:
            _check_affine(t, y, name)
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
    kind = backward_kind(relu, branched, shift is not None, affine, g32 is not None)
    plan = launch_plan(m, C, "backward", _co_resident(y.device, "backward", C, kind), branched,
                       not relu, y.shape[2] * y.shape[3], g32 is not None, _sms(y.device))
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
        ptr(dres), ptr(dd), m, C, plan.channel_tiles, ptr(shift), ptr(gmul), ptr(gadd),
        y.shape[2] * y.shape[3], plan.unroll, plan.sample_magic, plan.sample_shift, stream)
    _build.check(err, "bn_backward")
    backward_launches += 1
    wide_backward_launches += plan.channel_tiles > 1
    affine_backward_launches += affine
    silu_backward_launches += shift is not None and not affine
    dbeta, dgamma, dgamma_d = sums
    return dy, dgamma, dbeta, dres, (None if d is None else (dd, dgamma_d, dbeta))


def _channels_last(t):
    return None if t is None else t.contiguous(memory_format=torch.channels_last)


# a site's activation: ReLU (True, as the sites of slices 1-5 pass it), the
# SiLU, or none (False or None)
ACTIVATIONS = {True: "relu", "relu": "relu", "silu": "silu", False: None, None: None}


def site_forward(ctx, stats, epilogue, stats_apply, y, gamma, beta, rm, rv, residual, d, gamma_d,
                 beta_d, rm_d, rv_d, act, keep_f32, eps=EPS, momentum=MOMENTUM, mask=None,
                 keep=1.0):
    """The forward of :class:`BNTrainSite` through ``stats`` and
    ``epilogue`` (:func:`bn_stats` and ``conv_epilogue``), or at a narrow
    site with no residual or branch ``stats_apply`` (:func:`bn_stats_apply`),
    or functions of their signatures, saving on ``ctx`` what
    :func:`site_backward` needs. ``act`` one of :data:`ACTIVATIONS`; ``eps``
    and the Flax ``momentum`` are the site's BatchNorm's (and its
    branch's); ``mask`` (B,) float32 and ``keep``: the drop-connect before
    the residual, (BN(y) / keep) mask[b] + residual."""
    ctx.set_materialize_grads(False)
    act = ACTIVATIONS[act]
    relu = act == "relu"
    branch = stats_d = gmul = None
    if y.shape[1] % 8 and residual is None and d is None:
        if act == "silu" or mask is not None:
            raise ValueError("a narrow site (channels not a multiple of 8) takes a ReLU or no "
                             "activation, and no drop-connect")
        mean, invstd, scale, shift, out, out32 = stats_apply(y, gamma, beta, rm, rv, relu,
                                                             keep_f32, eps, momentum)
    else:
        mean, invstd, scale, shift = stats(y, gamma, beta, rm, rv, eps, momentum)
        if d is not None:
            stats_d = stats(d, gamma_d, beta_d, rm_d, rv_d, eps, momentum)
            branch = (d, stats_d[2], stats_d[3])
        kw = {"silu": True} if act == "silu" else {}
        if mask is not None:
            kw["drop"] = (mask, keep)
            gmul = (mask * inverse_keep(keep))[:, None].expand(y.shape[:2]).contiguous()
        out, out32 = epilogue(y, scale, shift, residual=residual, branch=branch, relu=relu,
                              keep_f32=keep_f32, **kw)
    ctx.relu = relu
    ctx.residual = residual is not None
    ctx.residual_dtype = None if residual is None else residual.dtype
    ctx.save_for_backward(y, out, mean, invstd, gamma, d,
                          *(stats_d[:2] if d is not None else (None, None)), gamma_d,
                          shift if act == "silu" else None, gmul)
    if not keep_f32:
        return out
    if out32 is out:  # float32 y: one tensor, handed on twice
        out32 = out.clone()
    return out, out32


def site_backward(ctx, backward, g, g32):
    """The gradients of :func:`site_forward`'s tensor inputs through
    ``backward`` (:func:`bn_backward` or a function of its signature)."""
    y, out, mean, invstd, gamma, d, mean_d, invstd_d, gamma_d, shift, gmul = ctx.saved_tensors
    branch = None if d is None else (d, mean_d, invstd_d, gamma_d)
    kw = {k: v for k, v in (("shift", shift), ("gmul", gmul)) if v is not None}
    dy, dgamma, dbeta, dres, db = backward(_channels_last(g), _channels_last(g32), out, y, mean,
                                           invstd, gamma, branch, ctx.relu, ctx.residual, **kw)
    if dres is not None:
        dres = dres.to(ctx.residual_dtype)
    dd, dgamma_d, dbeta_d = db if db is not None else (None, None, None)
    return (dy, dgamma, dbeta, None, None, dres, dd, dgamma_d, dbeta_d) + (None,) * 8


class BNTrainSite(torch.autograd.Function):
    """One site: out = act(BN(y) + residual) or act(BN(y) + BN_d(d)), with
    batch statistics, or (BN(y) / keep) mask[b] + residual with a
    drop-connect; returns (out, out32) where ``keep_f32``, else out.

    apply(y, gamma, beta, running_mean, running_var, residual, d, gamma_d,
    beta_d, running_mean_d, running_var_d, act, keep_f32[, eps, momentum[,
    mask, keep]]): ``act`` one of :data:`ACTIVATIONS`, ``momentum`` in Flax's
    sense (``ra = momentum ra + (1 - momentum) stat``)."""

    @staticmethod
    def forward(ctx, *args):
        return site_forward(ctx, bn_stats, conv_epilogue, bn_stats_apply, *args)

    @staticmethod
    def backward(ctx, g, g32=None):
        return site_backward(ctx, bn_backward, g, g32)


class SiteKernels:
    """The kernels of :class:`SEGateSite` (a seam: a caller's object with
    these functions runs the site through them)."""
    stats = staticmethod(bn_stats)
    squeeze = staticmethod(se_squeeze)
    excite = staticmethod(se_excite)
    squeeze_backward = staticmethod(se_backward)
    backward = staticmethod(bn_backward)


def se_site_forward(ctx, impl, y, gamma, beta, rm, rv, w_r, b_r, w_e, b_e, eps=EPS,
                    momentum=MOMENTUM):
    """The depthwise site's forward (``flairtpu/models/efficientnet.py:
    190-201``) through ``impl`` (:class:`SiteKernels`): the batch
    statistics of the depthwise output ``y``, the squeeze of silu(y scale +
    shift), the gate's convs (``ops/se_gate.py:gate_from``) and the excite,
    the project conv's input in y's dtype."""
    mean, invstd, scale, shift = impl.stats(y, gamma, beta, rm, rv, eps, momentum)
    sq = impl.squeeze(y, scale, shift)
    gate = gate_from(sq, w_r, b_r, w_e, b_e, y.dtype)
    ctx.save_for_backward(y, mean, invstd, gamma, scale, shift, sq, gate, w_r, b_r, w_e, b_e)
    return impl.excite(y, scale, shift, gate)


def se_site_backward(ctx, impl, g):
    """The depthwise site's gradients: the gate's (B, C) gradient by the
    squeeze backward, the small convs' VJP on a recomputed (B, C) graph,
    then one BatchNorm backward whose gradient is g gate[b, c] +
    dmean[b, c] / HW times the SiLU's derivative."""
    y, mean, invstd, gamma, scale, shift, sq, gate, *w = ctx.saved_tensors
    g = _channels_last(g)
    dgate = impl.squeeze_backward(g, y, scale, shift)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (sq, *w)]
        dsq, *dw = torch.autograd.grad(gate_from(*leaves, y.dtype), leaves, dgate)
    gadd = (dsq.float() / (y.shape[2] * y.shape[3])).contiguous()
    dy, dgamma, dbeta, _, _ = impl.backward(g, None, None, y, mean, invstd, gamma, None, False,
                                            False, shift=shift, gmul=gate, gadd=gadd)
    return (dy, dgamma, dbeta, None, None, *dw, None, None)


class SEGateSite(torch.autograd.Function):
    """The depthwise site as one node: silu(BN(y)) times its squeeze-excite
    gate, with batch statistics.

    apply(y, gamma, beta, running_mean, running_var, w_reduce, b_reduce,
    w_expand, b_expand[, eps, momentum])."""

    @staticmethod
    def forward(ctx, *args):
        return se_site_forward(ctx, SiteKernels, *args)

    @staticmethod
    def backward(ctx, g):
        return se_site_backward(ctx, SiteKernels, g)


def bn_constants(bn) -> tuple[float, float]:
    """An ``nn.BatchNorm2d``'s (eps, Flax momentum)."""
    if bn.momentum is None:
        raise ValueError("TrainSites: a BatchNorm with momentum None (a cumulative average) "
                         "has no Flax counterpart")
    return float(bn.eps), 1.0 - float(bn.momentum)


class TrainSites:
    """What a model's forward takes in place of its inference epilogue to
    train: each BatchNorm site through :class:`BNTrainSite`, with the
    BatchNorm modules (their gamma, beta and running statistics), each
    GroupNorm site through ``GroupNormReLU``, and each EfficientNet
    depthwise site through :class:`SEGateSite`."""

    def apply(self, *args):
        """One site's autograd Function applied to :class:`BNTrainSite`'s
        arguments."""
        return BNTrainSite.apply(*args)

    def apply_se(self, *args):
        """The depthwise site's autograd Function applied to
        :class:`SEGateSite`'s arguments."""
        return SEGateSite.apply(*args)

    def site(self, y, bn, residual=None, branch=None, act="relu", keep_f32: bool = False,
             drop=None):
        """``branch`` = (d, bn_d); ``act`` one of :data:`ACTIVATIONS` (True:
        ReLU); ``drop`` = ((B,) float32 keep mask, keep probability): the
        drop-connect before the residual. Returns (out, out32 or None). The
        site takes ``bn``'s eps and momentum (torch's ``momentum`` m is
        Flax's 1 - m)."""
        d, bn_d = branch if branch is not None else (None, None)
        eps, momentum = bn_constants(bn)
        if bn_d is not None and bn_constants(bn_d) != (eps, momentum):
            raise ValueError("TrainSites.site: the branch's BatchNorm has another eps or "
                             "momentum than the site's")
        res = self.apply(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, residual, d,
                         *((bn_d.weight, bn_d.bias, bn_d.running_mean, bn_d.running_var)
                           if bn_d is not None else (None,) * 4), act, keep_f32, eps, momentum,
                         *(drop if drop is not None else ()))
        return res if keep_f32 else (res, None)

    def se_site(self, y, bn, reduce, expand):
        """EfficientNet's depthwise site on the depthwise output ``y``:
        ``bn`` in train mode, SiLU, and the squeeze-excite gate of the
        biased 1x1 convs ``reduce`` and ``expand``; the project conv's
        input in y's dtype."""
        return self.apply_se(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                             reduce.weight, reduce.bias, expand.weight, expand.bias,
                             *bn_constants(bn))

    def group_norm(self, y, gamma, beta, groups: int, eps: float, upsample: bool):
        """A GroupNorm + ReLU (+ 2x nearest) site in train mode (FPN's):
        ``ops/group_norm.py:GroupNormReLU``, float32 out."""
        return GroupNormReLU.apply(y, gamma, beta, groups, eps, upsample)
