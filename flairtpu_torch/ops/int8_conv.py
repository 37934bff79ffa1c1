"""int8 convolution with its dequantize epilogue (``csrc/int8_conv.cu``,
hand-written implicit GEMM on Hopper's wgmma s8 tensor cores, with TMA
weight tiles and an mbarrier ring).

Replaces the XLA int8 convolution of ``flairtpu/models/quantize.py:218-230``
(``_quant_conv``), with the element-wise ops of the walk that XLA fused into
it on the TPU: int8 NHWC activations x int8 weights -> int32, then per
output element

    v = fma(float(acc), deq[co], b[co])   as XLA contracts y * deq + b
    v = v + residual                        (optional, float32)
    v = max(v, 0)                           (optional)

written as float32 only where a later op reads float32 (``keep_f32``: the
next block's identity, a feature, a pool or a float site), and as the next
int8 site's input, ``clip(round(v * float32(1 / sx)), -127, 127)``, where
that site follows (``out_sx``), so that only int8 crosses device memory
between int8 sites.

The plain version convolves float64 copies of the int8 operands (float64
holds every sum exactly; float32 does not, since K * 127^2 exceeds 2^24)
and rounds the multiply-add once, as the FMA does (:func:`fma_f32`).
``int8_conv`` runs it for a CPU tensor and launches the kernel for a CUDA
tensor; it has no fallback.

The kernel has eight instances (:func:`kernel_instance`): 128 or 64
output columns a tile, and the activations loaded by 8- or 16-byte
cp.async gathers or by im2col TMA boxes of 128- or 64-byte rows. The
wrapper picks one per site and checks what it needs of the operands on
either device: channels_last, and the bases the loads, the weights' TMA
map and the 16-byte epilogue accesses need (:func:`_check`).

A grouped site (a ResNeXt's 3x3, ``Int8ConvParams.groups`` > 1) goes to
the second entry point, :func:`int8_conv_grouped` (``int8_conv_grouped``
in the same source): s8 tensor-core MMAs (``mma.sync`` m16n8k32) over
bundles of whole groups, each output channel summing over its group's
channels only (:func:`pack_grouped` lays the weights out block-diagonally
in the MMA's fragment order), the input of a band of output rows staged
once in shared memory, with the same epilogue. :func:`grouped_plan` picks
its instance (compiled for cg 4, 8, 16, 32 at stride 1 or 2, or the
general one), band and copy depth; it counts its launches in
``grouped_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from flairtpu_torch.ops import _build
from flairtpu_torch.ops.quantize_act import inverse_scale, padded_channels, quantize_values

ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 14
            + [ctypes.c_void_p, ctypes.c_int])
GROUPED_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 12
                    + [ctypes.c_void_p] + [ctypes.c_int] * 10)
K_CHUNK = 32  # bytes of K per wgmma step: the packed rows' multiple

# kernel launches on CUDA tensors since the last reset (the CPU path does not
# count): the ungrouped entry point's, and the grouped one's
launches = 0
grouped_launches = 0


@dataclass
class Int8ConvParams:
    """One int8 site: weights (Co, Ci / groups, kh, kw) int8 and their
    per-channel dequantize factor ``deq`` = sw * sx and bias ``b``
    (float32), with the input's scale ``sx`` (a float32 value). ``packed``
    is the kernel's copy: ungrouped, (Co, Kp), row co holding tap-major,
    channel-minor weights over :func:`padded_channels` channels, zero past
    Ci and past K; grouped (a 3x3 with as many output as input channels a
    group), :func:`pack_grouped`'s (bundles, 3, steps, cb / 8, 32, 8)."""

    wq: torch.Tensor
    sx: float
    deq: torch.Tensor
    b: torch.Tensor
    groups: int = 1
    packed: torch.Tensor = field(init=False, repr=False)

    def __post_init__(self):
        co, ci, kh, kw = self.wq.shape
        if self.groups > 1:
            if ci % 4 or co % (4 * self.groups) or (ci * self.groups) % 8:
                raise ValueError(f"int8_conv: {self.groups} groups of {ci} input and "
                                 f"{co // self.groups} output channels (multiples of 4)")
            if co != ci * self.groups or (kh, kw) != (3, 3):
                raise ValueError(f"int8_conv: a grouped site is a 3x3 with as many output as "
                                 f"input channels a group, got {co // self.groups} of {ci}, "
                                 f"{kh}x{kw}")
            self.packed = pack_grouped(self.wq, self.groups)
            return
        cp = padded_channels(ci)
        k = kh * kw * cp
        w = self.wq.new_zeros((co, kh, kw, cp))
        w[..., :ci] = self.wq.permute(0, 2, 3, 1)
        self.packed = self.wq.new_zeros((co, -(-k // K_CHUNK) * K_CHUNK))
        self.packed[:, :k] = w.reshape(co, k)

    @property
    def in_channels(self) -> int:
        """Channels of the int8 input the site takes (Ci padded to 8; a
        grouped site's Ci, a multiple of 8)."""
        return padded_channels(self.wq.shape[1] * self.groups)


def grouped_bundle(cg: int) -> tuple[int, int, int]:
    """(cb, units, steps) of a grouped 3x3 at ``cg`` channels a group: the
    bundle, the smallest run of whole groups that is a multiple of 8
    channels (its output channels share the MMA's A operand), its 8-byte
    units of K a tap row (3 taps) and the k32 steps they take."""
    cb = math.lcm(cg, 8)
    units = 3 * cb // 8
    return cb, units, -(-units // 4)


def pack_grouped(wq: torch.Tensor, groups: int) -> torch.Tensor:
    """The grouped kernel's weights: wq (Co, cg, 3, 3) int8 (cg = Co /
    groups) -> (Co / cb, 3, steps, cb / 8, 32, 8) int8, for bundle, tap row
    ky, k32 step s, n8 tile j and lane 4 g + tig, the MMA's b0 (bytes 0-3)
    and b1 (4-7) of output channel 8 j + g of the bundle. Word p of a step
    (b0: p = tig, b1: p = tig + 4) holds unit t = 4 s + p % 4 of the tap
    row, 8 channels of tap kx = t / (cb / 8), and its bytes e the channels
    8 (t % (cb / 8)) + 4 (p // 4) + e of the bundle; zero past the tap row's
    units and where the channel's group is not the output channel's (the
    block-diagonal zeros of a bundle of several groups)."""
    co, cg, kh, kw = wq.shape
    cb, units, steps = grouped_bundle(cg)
    dev = wq.device
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    bi = ar(co // cb)[:, None, None, None, None, None]
    ky = ar(kh)[None, :, None, None, None, None]
    s = ar(steps)[None, None, :, None, None, None]
    p = ar(8)[None, None, None, :, None, None]
    e = ar(4)[None, None, None, None, :, None]
    n = ar(cb)[None, None, None, None, None, :]
    t = 4 * s + p % 4
    u = cb // 8
    kx = torch.clamp(t // u, max=kw - 1)
    c = 8 * (t % u) + 4 * (p // 4) + e  # the channel within the bundle
    valid = (t < units) & (c // cg == n // cg)
    vals = torch.where(valid, wq[bi * cb + n, c % cg, ky, kx], 0).to(torch.int8)
    # (bundle, ky, s, p = 4 half + tig, e, n = 8 j + g) -> (bundle, ky, s, j, g, tig, half, e)
    vals = vals.reshape(co // cb, kh, steps, 2, 4, 4, cb // 8, 8)
    return vals.permute(0, 1, 2, 6, 7, 4, 3, 5).reshape(co // cb, kh, steps, cb // 8, 32, 8) \
        .contiguous()


# the grouped kernel's instances: compiled for these channels a group at
# stride 1 or 2 (pad 1, dilation 1), with their warps a block and blocks an
# SM (its register bound); the general one takes every other 3x3
GROUPED_FAST_CG = (4, 8, 16, 32)
GROUPED_SLAB = 128          # channels a block of a fast instance
GROUPED_MAX_DEPTH = 8
GROUPED_ITEM_TILES = {4: 2, 8: 2, 16: 2}  # 16-pixel tiles an item of a fast instance (else 1)
SMEM_BYTES = 227 * 1024     # shared memory a block may have on an H100


@dataclass(frozen=True)
class GroupedPlan:
    """One launch of the grouped kernel: the C entry point's ``instance``,
    ``slab`` (channels a block), ``band`` (output rows a block), ``depth``
    (output rows of input staged ahead) and ``rows_step`` (output rows a
    step), and its shared-memory layout (:func:`grouped_layout`: ``seg``,
    ``cols``, ``ring``, ``slot_bytes``, ``smem``), which the entry point
    takes as it is; with the threads and blocks an SM of the instance and
    the grid."""

    instance: int
    slab: int
    band: int
    depth: int
    rows_step: int
    seg: int
    cols: int
    ring: int
    slot_bytes: int
    smem: int
    threads: int
    blocks_per_sm: int
    grid: int

    def entry_args(self) -> tuple:
        """The entry point's arguments after the stream."""
        return (self.instance, self.slab, self.band, self.depth, self.rows_step, self.seg,
                self.cols, self.ring, self.slot_bytes, self.smem)


def grouped_segment(wo: int, stride: int) -> int:
    """Output columns a block of the grouped kernel takes: at most 16 x
    max(1, 8 // stride) (a staged row within a TMA box's 256 columns)."""
    most = 16 * max(1, 8 // stride)
    return -(-wo // 16) * 16 if wo < most else most


def grouped_layout(wo: int, stride: int, dil: int, slab: int, fast: bool, depth: int,
                   rows_step: int = 1) -> tuple[int, int, int, int, int]:
    """(segment, staged columns, ring rows, slot bytes, shared memory bytes)
    of a block of the grouped kernel, the one place they are computed (the
    C entry point takes them): a segment's 16-pixel tiles rounded up to
    pairs; a slot a TMA box of the columns rounded up to 8 by 128 bytes
    (fast) or chunk-major with an odd chunk stride; the ring, two
    (rows_step, segment, slab) output tiles, a barrier a slot and 1024
    bytes of alignment."""
    seg = grouped_segment(wo, stride)
    mt = seg // 16
    cols = (16 * (mt + mt % 2) - 1) * stride + 2 * dil + 1
    ring = (depth + rows_step - 1) * stride + 2 * dil + 1
    slot = -(-cols // 8) * 8 * 128 if fast else slab // 16 * (cols | 1) * 16
    return seg, cols, ring, slot, 1024 + ring * slot + 2 * rows_step * seg * slab + 8 * ring


@functools.lru_cache(maxsize=256)
def grouped_plan(batch: int, ho: int, wo: int, co: int, groups: int, stride: int = 1,
                 padding: int = 1, dilation: int = 1, sms: int = 132, band: int | None = None,
                 depth: int | None = None, rows_step: int | None = None) -> GroupedPlan:
    """The grouped kernel's launch at a site of ``co`` channels in
    ``groups`` groups and a (batch, ho, wo) output, on a card of ``sms``
    SMs. The instance: a fast one where cg is 4, 8, 16 or 32 at stride 1 or
    2 with padding 1 and dilation 1, else the general one (slab: as many
    whole bundles as 128 channels hold, in 16-byte lines). The depth: about
    24 KB of a block's input in flight, within its share of shared memory.
    The rows a step (fast instances): 4 items of tiles a step (4, 2 or 1
    rows), fewer where shared memory would not hold a copy depth of 2. The
    band: the fewest waves x (band + halo rows + depth), among 4 ... ho
    rows, where a wave is sms x blocks an SM (the longest band on a tie).
    ``band``, ``depth`` and ``rows_step`` given are taken as they are."""
    cg = co // groups
    cb = math.lcm(cg, 8)
    fast = cg in GROUPED_FAST_CG and stride in (1, 2) and padding == 1 and dilation == 1
    if fast:
        instance = 1 + 2 * GROUPED_FAST_CG.index(cg) + stride - 1
        slab, threads, per_sm = GROUPED_SLAB, 128 if cg == 32 else 256, 3 if cg == 32 else 2
    else:
        line = math.lcm(cb, 16)
        instance, slab, threads, per_sm = 0, max(line, GROUPED_SLAB // line * line), 256, 2

    def fits(d: int, r: int) -> bool:
        return grouped_layout(wo, stride, dilation, slab, fast, d, r)[4] <= SMEM_BYTES // per_sm

    if rows_step is None:
        tiles = grouped_segment(wo, stride) // 16
        rows_step = max(1, 4 // -(-tiles // GROUPED_ITEM_TILES.get(cg, 1))) if fast else 1
        while rows_step > 1 and not fits(2, rows_step):
            rows_step //= 2
    if depth is None:
        slot_bytes = grouped_layout(wo, stride, dilation, slab, fast, 1)[3]
        depth = min(GROUPED_MAX_DEPTH, max(1, -(-24 * 1024 // (stride * slot_bytes))))
        while depth > 1 and not fits(depth, rows_step):
            depth -= 1
    layout = grouped_layout(wo, stride, dilation, slab, fast, depth, rows_step)
    seg, smem = layout[0], layout[4]
    per_sm = max(1, min(per_sm, SMEM_BYTES // max(smem, 1)))
    parts = -(-co // slab) * -(-wo // seg)  # slabs x segments
    halo = -(-2 * dilation // stride)

    def cost(band: int) -> tuple:
        blocks = parts * -(-ho // band) * batch
        return -(-blocks // (sms * per_sm)) * (band + halo + depth), -band

    if band is None:
        bands = sorted({min(b, max(ho, 1)) for b in (4, 8, 16, 32, 64, 128, max(ho, 1))})
        band = min(bands, key=cost)
    return GroupedPlan(instance, slab, band, depth, rows_step, *layout, threads, per_sm,
                       parts * -(-ho // band) * batch)


def fma_f32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """float32 x * y + z rounded once (an FMA), for float32 tensors that
    broadcast. The product is exact in float64 and the sum is rounded to
    float64 first; where that lands on a float32 rounding midpoint, the
    sum's own rounding error (TwoSum) decides the side, so the result is
    the FMA's in every case."""
    p = x.double() * y.double()
    zd = z.double().expand_as(p)
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    mid = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    s = torch.where(mid & (err != 0), torch.nextafter(s, s + err), s)
    return s.float()


TMA_ROWS = (128, 64)  # bytes of channels a pixel in an im2col TMA box: a stage of K
_LOAD_CODES = {8: 0, 16: 1, 128: 4, 64: 5}


def kernel_instance(cp: int, co: int, k: int = 1, stride: int = 1, padding: int = 0,
                    dilation: int = 1) -> tuple[int, int]:
    """(output columns a tile, bytes a row of A loads in one go) of the
    kernel instance for a site of ``cp`` input and ``co`` output channels
    and a ``k`` x ``k`` kernel: 64 columns where ``co <= 64`` (the stem and
    the 64-channel sites), else 128; A by im2col TMA in rows of 128 or 64
    bytes (``TMA_ROWS``) where a stage of K of that many bytes lies in one
    tap (``cp`` a multiple of it) and the box corners fit the map's signed
    8 bits, else by 16-byte cp.async gathers where ``cp % 16 == 0`` (a
    group then never crosses a tap), else by 8-byte ones (the stem's 8
    padded channels)."""
    corners_fit = padding <= 127 and dilation * (k - 1) - padding <= 128 and stride <= 8
    rows = [r for r in TMA_ROWS if cp % r == 0] if corners_fit else []
    load = rows[0] if rows else 16 if cp % 16 == 0 else 8
    return (64 if co <= 64 else 128), load


def instance_code(block_n: int, load: int) -> int:
    """The C entry point's ``instance`` argument for :func:`kernel_instance`'s pair."""
    return 2 * (block_n == 128) + _LOAD_CODES[load]


def _out_hw(size: int, k: int, stride: int, padding: int, dilation: int) -> int:
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def int8_conv_acc_plain(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
                        dilation: int = 1) -> torch.Tensor:
    """The int32 sums: x (B, Cp, H, W) int8 -> (B, Co, Ho, Wo) int32 (each
    group's output channels over its input channels)."""
    w = p.wq.double()
    if x.shape[1] != w.shape[1] * p.groups:  # channels padded to 8: their weights are 0
        w = F.pad(w, (0, 0, 0, 0, 0, x.shape[1] - w.shape[1]))
    acc = F.conv2d(x.double(), w, None, stride, padding, dilation, p.groups)
    return acc.to(torch.int32).contiguous(memory_format=torch.channels_last)


def int8_conv_plain(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
                    dilation: int = 1, residual: torch.Tensor | None = None, relu: bool = True,
                    keep_f32: bool = True, out_sx: float | None = None):
    """x (B, Cp, H, W) int8 -> (float32 (B, Co, Ho, Wo) or None, int8 of
    ``out_sx`` or None), both channels_last."""
    acc = int8_conv_acc_plain(x, p, stride, padding, dilation)
    v = fma_f32(acc.float(), p.deq[:, None, None], p.b[:, None, None])
    if residual is not None:
        v = v + residual
    if relu:
        v = torch.relu(v)
    v = v.contiguous(memory_format=torch.channels_last)
    q = None
    if out_sx is not None:
        q = quantize_values(v, out_sx).contiguous(memory_format=torch.channels_last)
    return (v if keep_f32 else None), q


def _check(x: torch.Tensor, p: Int8ConvParams, residual, out_shape: tuple,
           keep_f32: bool, out_sx) -> None:
    if x.dtype != torch.int8 or x.dim() != 4 or x.shape[1] != p.in_channels:
        raise ValueError(f"int8_conv: x must be a (B, {p.in_channels}, H, W) int8 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("int8_conv: x must be channels_last")
    if p.groups > 1 and x.shape[1] % 16:
        raise ValueError(f"int8_conv: a grouped site's {x.shape[1]} channels (a multiple of "
                         "16: the kernel stages 16-byte lines)")
    align = 16 if p.in_channels % 16 == 0 else 8  # TMA and 16-byte copies, or 8-byte gathers
    if x.data_ptr() % align:
        raise ValueError(f"int8_conv: x must be {align}-byte aligned for its loads")
    if p.packed.data_ptr() % 16:
        raise ValueError("int8_conv: the packed weights must be 16-byte aligned (TMA)")
    if p.wq.shape[0] % 8:
        raise ValueError(f"int8_conv: {p.wq.shape[0]} output channels (a multiple of 8)")
    for name, t in (("weights", p.packed), ("deq", p.deq), ("b", p.b)):
        if t.device != x.device:
            raise ValueError(f"int8_conv: {name} must be on {x.device}")
    if p.groups > 1 and any(t.dtype != torch.float32 or not t.is_contiguous()
                            or t.data_ptr() % 8 for t in (p.deq, p.b)):
        raise ValueError("int8_conv: a grouped site's deq and b must be contiguous, "
                         "8-byte aligned float32 (the kernel's 8-byte loads)")
    if residual is not None and (
            residual.dtype != torch.float32 or tuple(residual.shape) != out_shape
            or residual.device != x.device
            or not residual.is_contiguous(memory_format=torch.channels_last)
            or residual.data_ptr() % 16):
        raise ValueError(f"int8_conv: residual must be a channels_last, 16-byte aligned "
                         f"float32 tensor of shape {out_shape} on {x.device}")
    if not keep_f32 and out_sx is None:
        raise ValueError("int8_conv: no output asked for (keep_f32 or out_sx)")


def _outputs(x: torch.Tensor, shape: tuple, keep_f32: bool, out_sx):
    out32 = outq = None
    if keep_f32:
        out32 = torch.empty(shape, dtype=torch.float32, device=x.device,
                            memory_format=torch.channels_last)
    if out_sx is not None:
        outq = torch.empty(shape, dtype=torch.int8, device=x.device,
                           memory_format=torch.channels_last)
    return out32, outq


def _ptr(t):
    return None if t is None else t.data_ptr()


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    """The card's SMs (once a device)."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def int8_conv_grouped(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
                      dilation: int = 1, residual: torch.Tensor | None = None,
                      relu: bool = True, keep_f32: bool = True, out_sx: float | None = None,
                      plan: GroupedPlan | None = None):
    """:func:`int8_conv` at a grouped site (``p.groups`` > 1), as
    :func:`int8_conv_plain`. CPU tensors: the plain version. CUDA tensors:
    the grouped kernel at :func:`grouped_plan`'s launch (``plan`` overrides
    it), or an error."""
    global grouped_launches
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"int8_conv_grouped: unsupported device {x.device}")
    if p.groups < 2:
        raise ValueError("int8_conv_grouped: an ungrouped site (int8_conv takes it)")
    B, _, H, W = x.shape
    co, _, kh, kw = p.wq.shape
    ho, wo = (_out_hw(H, kh, stride, padding, dilation), _out_hw(W, kw, stride, padding,
                                                                 dilation))
    _check(x, p, residual, (B, co, ho, wo), keep_f32, out_sx)
    if x.device.type == "cpu":
        return int8_conv_plain(x, p, stride, padding, dilation, residual, relu, keep_f32,
                               out_sx)
    out32, outq = _outputs(x, (B, co, ho, wo), keep_f32, out_sx)
    plan = plan or grouped_plan(B, ho, wo, co, p.groups, stride, padding, dilation,
                                _sm_count(x.device))
    err = _build.entry("int8_conv", GROUPED_ARGTYPES, "int8_conv_grouped")(
        _ptr(x), _ptr(p.packed), _ptr(p.deq), _ptr(p.b), _ptr(residual), _ptr(out32),
        _ptr(outq), inverse_scale(out_sx) if out_sx is not None else 0.0, B, H, W,
        p.in_channels, ho, wo, co, stride, padding, dilation, p.groups, int(relu),
        _build.stream_handle(x), *plan.entry_args())
    _build.check(err, "int8_conv_grouped")
    grouped_launches += 1
    return out32, outq


def int8_conv(x: torch.Tensor, p: Int8ConvParams, stride: int, padding: int,
              dilation: int = 1, residual: torch.Tensor | None = None, relu: bool = True,
              keep_f32: bool = True, out_sx: float | None = None):
    """As :func:`int8_conv_plain`. CPU tensors: the plain version. CUDA
    tensors: the kernel (the grouped one for a grouped site), or an error."""
    global launches
    if p.groups > 1:
        return int8_conv_grouped(x, p, stride, padding, dilation, residual, relu, keep_f32,
                                 out_sx)
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"int8_conv: unsupported device {x.device}")
    B, _, H, W = x.shape
    co, _, kh, kw = p.wq.shape
    ho, wo = (_out_hw(H, kh, stride, padding, dilation), _out_hw(W, kw, stride, padding,
                                                                 dilation))
    _check(x, p, residual, (B, co, ho, wo), keep_f32, out_sx)
    if x.device.type == "cpu":
        return int8_conv_plain(x, p, stride, padding, dilation, residual, relu, keep_f32,
                               out_sx)
    out32, outq = _outputs(x, (B, co, ho, wo), keep_f32, out_sx)
    err = _build.entry("int8_conv", ARGTYPES)(
        _ptr(x), _ptr(p.packed), _ptr(p.deq), _ptr(p.b), _ptr(residual), _ptr(out32),
        _ptr(outq),
        inverse_scale(out_sx) if out_sx is not None else 0.0, B, H, W, p.in_channels, ho, wo,
        co, kh, kw, stride, padding, dilation, p.packed.shape[1], int(relu),
        _build.stream_handle(x),
        instance_code(*kernel_instance(p.in_channels, co, kh, stride, padding, dilation)))
    _build.check(err, "int8_conv")
    launches += 1
    return out32, outq
