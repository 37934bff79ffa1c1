"""Where the time of the bn_train kernels goes, on the card.

    python -m flairtpu_torch.ops.bn_train_phases [--effnet] [--baseline OLD_SOURCE]
                                                 [--variants NAME,...]

Default: times bn_stats and bn_backward at the 43 BatchNorm sites (46
BatchNorms) of one train step of resnet34-unet at batch 16 and 512² (each
site's shape and kind as the port's model gives them; random operands).
``--effnet``: times bn_backward at efficientnet-b4-unet's 88 train sites of
the lean instances at batch 16 and 512² (31 SiLU sites: the stem and the
expand convs; 32 depthwise sites with the gate affine and the SiLU; 25
project sites with the drop-connect's affine), summed by mode (``silu``,
``affine``), and holds one SiLU and one depthwise site, with operands scaled
so that z spans about ±90, to the plain version (finite, dy within DY_TOL of
the largest |dy|). Site by site, by device time: a sleep kernel longer than
the host's calls runs ahead of the start event, so the events bracket the
card's work and not the host's dispatch. Builds variants of
``csrc/bn_train.cu`` and times them in turns (the variants, then the same
reversed):

- ``full``: the kernels as built;
- ``apply_forward``: the backward's apply walks the tiles in the reduce's
  order rather than the reverse (what the L2 order gains);
- ``stats_forward``: the statistics walk forward (what their reverse walk
  gains or costs, in the statistics and in the forward's conv_epilogue that
  reads the same map after them: the ``pair`` times);
- ``one_combiner``, ``combiners_quarter``: the last block alone, or a
  quarter of the combiners, combine every sum (what one round of loads a
  combiner gains);
- ``combine_loads_1``: one load a sum in flight in the combine, not 8;
- ``stats_unroll8``, ``backward_unroll4``: more loads in flight a thread
  (U = 8 in the statistics, 4 at the ReLU and branch sites);
- ``backward_unroll2``: U = 2 at the lean sites (kLeanUnroll 4);
- ``min_blocks_1``, ``min_blocks_3``: the lean backward's registers capped
  for 1 (not capped) or 3 blocks an SM, not 2;
- ``accurate_sigmoid``: the SiLU's sigmoid by the IEEE expf and division
  (what the special-function units save);
- ``div64``: the sample index by a 64-bit division and the affine's gmul and
  gadd loaded again at every pixel;
- ``copy_only``: the backward reads g (and g32) and y in both launches and
  writes dy from their bits with no arithmetic (its sums are g's): the
  floor of its data movement, two reads of the inputs;
- ``stream_stores``: dy stored with the evict-first hint (``__stcs``);
- ``min_block_32k``, ``min_block_128k``: the wrapper's plan with another
  least share of a block (``launch_plan``'s MIN_BLOCK_BYTES, 64 KB);
  ``lean_block_64k``: the same of a lean backward
  (MIN_LEAN_BLOCK_BYTES, 16 KB); ``lean_grid_any``: a lean backward's grid
  not rounded to a multiple of the SMs;
- ``no_tile_loads``, ``no_combine``: without the walk over the site's
  tiles, or without the combine (their outputs are wrong; only their time
  is read: a call's fixed cost, and what the combine costs).

``apply_forward``, ``one_combiner``, ``combiners_quarter`` and ``div64``
must give ``full``'s bits (checked); the others sum in another order (or
over another grid, as ``min_blocks_1`` where the occupancy moves) or
compute otherwise. ``--baseline`` also times an earlier source with
the C interface of ``a5736fb`` (``git show
a5736fb:flairtpu_torch/csrc/bn_train.cu``: the backward's modes tested at
run time, U = 2 everywhere, the accurate sigmoid, a 64-bit division a
pixel) through that interface, and in the default mode checks that its
outputs are ``full``'s bits. The profiler's kernel sums split ``full``'s
(and the baseline's) backward into its two launches. Prints one JSON line:
each variant's totals (device ms; by mode with ``--effnet``), ``full``'s
and the baseline's call ms (events around the host's calls), the sites
one by one (each variant's ms, ``full``'s grid, U, instance and bounds:
bytes at 3.35 TB/s), ptxas's registers of each instance, and the card's
name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops.epilogue import conv_epilogue

BATCH, SIZE, CLASSES = 16, 512, 19
EFFNET = "efficientnet-b4"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SLEEP_CYCLES_PER_S = 2e9  # at least the card's clock: a sleep lasts as long as asked
DY_TOL = 2.0 ** -6  # of the largest |dy| (chip_smoke.py's BN_DY_TOL)
Z_SPAN = 90.0  # the z of the scaled check's operands spans about ±Z_SPAN
ENTRIES = {"bn_train_stats": bt.STATS_ARGTYPES, "bn_train_backward": bt.BACKWARD_ARGTYPES,
           "bn_train_occupancy": bt.OCCUPANCY_ARGTYPES}
# a5736fb's C interface: the backward without (unroll, sample_magic,
# sample_shift), the occupancy's third argument the branch flag
OLD_BACKWARD_ARGTYPES = bt.BACKWARD_ARGTYPES[:-4] + bt.BACKWARD_ARGTYPES[-1:]

APPLY_WALK = ("    const long long p0 = tiles.first(k, true) + t.row;\n    Pixel px",
              "    const long long p0 = tiles.first(k, false) + t.row;\n    Pixel px")
COMBINERS_WANT = "  const int want = (channels * combine_warps(blocks) + kWarps - 1) / kWarps;"
STATS_WALK = ("      const long long p0 = tiles.first(k, true) + t.row;\n      uint4 w",
              "      const long long p0 = tiles.first(k, false) + t.row;\n      uint4 w")
SFU_SIGMOID = ("  const float s = rcp_approx(__fadd_rn(1.f, ex2_approx(__fmul_rn(z, kNegLog2e))));",
               "  const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-z)));")
# div64: the sample by a 64-bit division and the affine's values loaded at
# every pixel
DIV64 = [("    return (int)(((unsigned long long)(unsigned)p * a.sample_magic) >> a.sample_shift);",
          "    return (int)(p / a.hw);"),
         ("    if (s == b) return;\n", ""),
         ("    return sample(a, p1) == b;", "    return false;")]
# copy_only: the reduce sums g's bits and y's (no affine, no SiLU, no
# normalization), the apply writes their XOR as dy
COPY_ONLY = [
    ("        site_grad<M>(a, scale, shift, af, whole, px[u].y, p0 + (long long)u * t.rows, "
     "c0, gr,\n                     gz);",
     "        for (int i = 0; i < 8; ++i) gz[i] = gr[i];"),
    ("          cy.centered(px[u].y, xh);", "          unpack8(px[u].y, xh);"),
    ("          cy.normalized(px[u].y, xh);", "          unpack8(px[u].y, xh);"),
    ("      site_grad<M>(a, fy.k, shift, af, whole, px[u].y, p, c0, gr, gz);\n"
     "      *reinterpret_cast<uint4*>(a.dy + off) = fy(px[u].y, gz, inv_m);",
     "      *reinterpret_cast<uint4*>(a.dy + off) = make_uint4(\n"
     "          px[u].g.x ^ px[u].y.x, px[u].g.y ^ px[u].y.y, px[u].g.z ^ px[u].y.z,\n"
     "          px[u].g.w ^ px[u].y.w);"),
]
# name -> (source edits, plan overrides: bn_train attributes)
VARIANTS = {
    "full": ([], {}),
    "apply_forward": ([APPLY_WALK], {}),
    "stats_forward": ([STATS_WALK], {}),
    "one_combiner": ([("  return blocks < want ? blocks : want;", "  return 1;")], {}),
    "combiners_quarter": ([(COMBINERS_WANT, COMBINERS_WANT.replace(
        "(channels * combine_warps(blocks) + kWarps - 1) / kWarps",
        "((channels * combine_warps(blocks) + kWarps - 1) / kWarps + 3) / 4"))], {}),
    "combine_loads_1": ([("kCombineLoads = 8;", "kCombineLoads = 1;")], {}),
    "stats_unroll8": ([("kStatsUnroll = 4;", "kStatsUnroll = 8;")],
                      {"UNROLL": {**bt.UNROLL, "stats": 8}}),
    "backward_unroll4": ([("kBackUnroll = 2;", "kBackUnroll = 4;")],
                         {"UNROLL": {**bt.UNROLL, "backward": 4}}),
    "backward_unroll2": ([("kLeanUnroll = 4;", "kLeanUnroll = 2;")],
                         {"UNROLL": {**bt.UNROLL, "lean": 2}}),
    "min_blocks_1": ([("kLeanMinBlocks = 2;", "kLeanMinBlocks = 1;")], {}),
    "min_blocks_3": ([("kLeanMinBlocks = 2;", "kLeanMinBlocks = 3;")], {}),
    "accurate_sigmoid": ([SFU_SIGMOID], {}),
    "div64": (DIV64, {}),
    "copy_only": (COPY_ONLY, {}),
    "stream_stores": ([("      *reinterpret_cast<uint4*>(a.dy + off) = fy(px[u].y, gz, inv_m);",
                        "      __stcs(reinterpret_cast<uint4*>(a.dy + off), "
                        "fy(px[u].y, gz, inv_m));")], {}),
    "min_block_32k": ([], {"MIN_BLOCK_BYTES": 32 * 1024}),
    "min_block_128k": ([], {"MIN_BLOCK_BYTES": 128 * 1024}),
    "lean_grid_any": ([], {"_sms": lambda device: 0}),
    "lean_block_64k": ([], {"MIN_LEAN_BLOCK_BYTES": 64 * 1024}),
    "no_tile_loads": ([("    last = bi < tiles ? (tiles - 1 - bi) / nb : -1;",
                        "    last = -1;")], {}),
    "no_combine": ([("  for (int c0 = rank * teams; c0 < channels; c0 += combiners * teams) {",
                     "  for (int c0 = rank * teams; c0 < 0; c0 += combiners * teams) {")], {}),
}
# the variants each mode runs by default
RESNET_VARIANTS = ("full", "apply_forward", "stats_forward", "one_combiner", "combiners_quarter",
                   "combine_loads_1", "stats_unroll8", "backward_unroll4", "min_block_32k",
                   "min_block_128k", "no_tile_loads", "no_combine")
EFFNET_VARIANTS = ("full", "accurate_sigmoid", "div64", "backward_unroll2", "min_blocks_1",
                   "min_blocks_3", "copy_only", "stream_stores", "lean_block_64k",
                   "lean_grid_any")
SAME_BITS = ("full", "apply_forward", "one_combiner", "combiners_quarter", "div64")
# the baseline's plan: U = 2 and a least share of 64 KB at every site, its
# own interface
BASELINE_PLAN = {"UNROLL": {**bt.UNROLL, "lean": bt.UNROLL["backward"]},
                 "MIN_LEAN_BLOCK_BYTES": bt.MIN_BLOCK_BYTES}


def device_ms(fn, reps: int = 5) -> float:
    """Mean device time of fn() over reps calls: CUDA events with the queue
    filled first. A sleep kernel longer than the host's reps calls runs
    ahead of the start event, so the events bracket the card's work back to
    back, not the host's dispatch between small kernels (which events
    around the calls alone include). The sleep is lengthened until the card
    is still in it when the host has queued the end event."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for tries in range(4):
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (2 * host_s + 1e-3) * 4 ** tries))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        end.synchronize()
        if covered:
            return start.elapsed_time(end) / reps
    raise RuntimeError("bn_train_phases: the sleep never outlasted the host's calls")


def call_ms(fn, reps: int = 5) -> float:
    """Mean time of fn() over reps calls by CUDA events around the host's
    calls, no sleep ahead: the host's dispatch between launches counts."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _scaled(y: torch.Tensor) -> tuple:
    return (BATCH, y.shape[1], y.shape[2] * SIZE // 64, y.shape[3] * SIZE // 64)


def record_sites() -> list[dict]:
    """Each train-mode site of resnet34-unet at BATCH x SIZE², in forward
    order: (C, H, W), residual, branch, keep_f32 (recorded at 64² on the
    CPU and scaled)."""

    class Recorder(bt.TrainSites):
        def __init__(self):
            self.sites = []

        def site(self, y, bn, residual=None, branch=None, act="relu", keep_f32=False,
                 drop=None):
            self.sites.append(dict(shape=_scaled(y), residual=residual is not None,
                                   branch=branch is not None, keep_f32=keep_f32))
            return super().site(y, bn, residual, branch, act, keep_f32, drop)

    rec = Recorder()
    with torch.no_grad():
        FlairSegmentationModel("resnet34", CLASSES, 5)(torch.rand(1, 64, 64, 5), epilogue=rec)
    return rec.sites


def record_effnet_sites() -> list[dict]:
    """Each train site of EFFNET-unet at BATCH x SIZE² that takes a lean
    backward instance with the SiLU or the affine, in forward order (recorded
    at 64² on the CPU, a drop-connect mask at every block that has one, and
    scaled): ``mode`` "silu" (the stem, each expand), "depthwise" (the gate
    affine and the SiLU) or "drop" (the project site's drop-connect: the
    affine alone, the identity's gradient written), ``hw`` the pixels of a
    sample, ``keep_f32`` (a float32 gradient comes back) and ``keep`` (the
    drop-connect's keep probability)."""

    class Recorder(bt.TrainSites):
        def __init__(self):
            self.sites = []

        def site(self, y, bn, residual=None, branch=None, act="relu", keep_f32=False,
                 drop=None):
            mode = "silu" if act == "silu" else "drop" if drop is not None else None
            if mode:
                shape = _scaled(y)
                self.sites.append(dict(mode=mode, shape=shape, hw=shape[2] * shape[3],
                                       residual=residual is not None, keep_f32=keep_f32,
                                       keep=drop[1] if drop is not None else None))
            return super().site(y, bn, residual, branch, act, keep_f32, drop)

        def se_site(self, y, bn, reduce, expand):
            shape = _scaled(y)
            self.sites.append(dict(mode="depthwise", shape=shape, hw=shape[2] * shape[3],
                                   residual=False, keep_f32=False, keep=None))
            return super().se_site(y, bn, reduce, expand)

    rec = Recorder()
    with torch.no_grad():
        FlairSegmentationModel(EFFNET, CLASSES, 5)(torch.rand(1, 64, 64, 5), epilogue=rec,
                                                   dropout=torch.Generator().manual_seed(0))
    return rec.sites


def _rand(shape, gen, dtype=torch.bfloat16):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype).contiguous(
        memory_format=torch.channels_last)


def operands(site: dict, gen) -> dict:
    """Random bf16 maps (and a float32 gradient where the site keeps one) of
    the site's shape, channels_last, with statistics and vectors; at an
    EfficientNet site the SiLU's shift and the affine's (B, C) operands."""
    B, C, H, W = site["shape"]

    def vecs(n):
        return [torch.rand(C, device="cuda", generator=gen) + 0.5 for _ in range(n)]

    y = _rand(site["shape"], gen)
    # v: gamma, beta, running mean and var (updated by each call); s: the
    # backward's mean and invstd
    v = vecs(4)
    ops = dict(y=y, g=_rand(site["shape"], gen), v=v, running0=[t.clone() for t in v[2:]],
               s=vecs(2), kw={},
               g32=_rand(site["shape"], gen, torch.float32) if site["keep_f32"] else None,
               residual=_rand(site["shape"], gen, torch.float32) if site["residual"] else None)
    mode = site.get("mode")
    if mode is None:
        d = _rand(site["shape"], gen) if site["branch"] else None
        ops.update(d=d, out=torch.relu(_rand(site["shape"], gen)),
                   vd=vecs(4) if d is not None else None, sd=vecs(2) if d is not None else None)
        return ops
    ops.update(d=None, out=None, vd=None, sd=None)
    if mode in ("silu", "depthwise"):
        ops["kw"]["shift"] = torch.randn(C, device="cuda", generator=gen)
    if mode == "depthwise":
        ops["kw"]["gmul"] = torch.rand((B, C), device="cuda", generator=gen)
        ops["kw"]["gadd"] = torch.randn((B, C), device="cuda", generator=gen) * 1e-3
    if mode == "drop":
        mask = (torch.rand(B, device="cuda", generator=gen) < site["keep"]).float()
        ops["kw"]["gmul"] = (mask / site["keep"])[:, None].expand(B, C).contiguous()
    return ops


def backward_args(ops: dict) -> tuple:
    """bn_backward's positional arguments of the operands (the ReLU at a
    resnet site, none at an EfficientNet site)."""
    v, d = ops["v"], ops["d"]
    branch = None if d is None else (d, *ops["sd"], ops["vd"][0])
    return (ops["g"], ops["g32"], ops["out"], ops["y"], *ops["s"], v[0], branch,
            ops["out"] is not None, ops["residual"] is not None)


def calls(ops: dict) -> dict:
    """The site's statistics (each BatchNorm), the statistics with the
    forward's conv_epilogue after them, and the backward."""
    v, vd = ops["v"], ops["vd"]

    def stats():
        r = bt.bn_stats(ops["y"], *v)
        if ops["d"] is not None:
            bt.bn_stats(ops["d"], *vd)
        return r

    def pair():
        _, _, scale, shift = stats()
        conv_epilogue(ops["y"], scale, shift, residual=ops["residual"])

    def backward():
        return bt.bn_backward(*backward_args(ops), **ops["kw"])

    return {"stats": stats, "pair": pair, "backward": backward}


def outputs(ops: dict, fns: dict) -> tuple:
    """Every output of one statistics call (from the operands' first running
    statistics) and one backward call."""
    for t, t0 in zip(ops["v"][2:], ops["running0"]):
        t.copy_(t0)
    r = fns["stats"]()
    return tuple(t.clone() for t in r + tuple(ops["v"][2:])), fns["backward"]()


def site_bytes(site: dict) -> dict:
    """Each input read once, each output written once (an EfficientNet
    site's affine operands: gmul and gadd, (B, C) float32 each)."""
    B, C, H, W = site["shape"]
    n = B * C * H * W
    if site.get("mode") is not None:
        affine = 2 * 4 * B * C * (site["mode"] != "silu")
        return {"backward": 6 * n + 4 * n * site["keep_f32"] + 4 * n * site["residual"]
                + affine}
    n_bn = 1 + site["branch"]
    back = 8 * n + 4 * n * site["keep_f32"] + 4 * n * site["residual"] + 4 * n * site["branch"]
    return {"stats": 2 * n * n_bn, "backward": back}


def dy_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|"""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def wide_z_check(site: dict, gen) -> dict:
    """The site's backward on operands scaled so that z = y scale + shift
    spans about ±Z_SPAN (scale Z_SPAN / max |y|): finite, and dy within
    DY_TOL of the plain version's largest |dy|."""
    ops = operands(site, gen)
    y = ops["y"]
    gamma = ops["v"][0]
    ops["s"][1] = (Z_SPAN / y.float().abs().max() / gamma).float().contiguous()
    args = backward_args(ops)
    got = bt.bn_backward(*args, **ops["kw"])
    want = bt.bn_backward_plain(*args, **ops["kw"])
    z = y.float() * (gamma * ops["s"][1])[:, None, None] + ops["kw"]["shift"][:, None, None]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in got[:3])
    err = dy_err(got[0], want[0])
    return {"mode": site["mode"], "shape": site["shape"], "z_min": z.min().item(),
            "z_max": z.max().item(), "finite": finite, "dy_err": err,
            "held": finite and err <= DY_TOL}


def ptxas_registers(log: str) -> dict:
    """Each kernel's registers from ``-Xptxas -v``, by its name and template
    argument (``backward_apply<3>``), with its spills where it has any."""
    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
        if m:
            n, rest = int(m.group(1)), m.group(2)
            t = re.match(r"IL[bi](\d+)E", rest[n:])
            fn = rest[:n] + (f"<{t.group(1)}>" if t else "")
        elif fn and "Used" in line and "registers" in line:
            regs[fn] = int(line.split("Used ")[1].split()[0])
        elif fn and "spill stores" in line and not line.strip().startswith("0 bytes stack"):
            regs[f"{fn} spills"] = line.strip()
    return regs


def build_variants(out: Path, names: list[str], baseline: Path | None) -> dict:
    base = (_build.CSRC / "bn_train.cu").read_text()
    jobs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name][0]:
            if src.count(old) != 1:
                raise RuntimeError(f"bn_train.cu no longer has the anchor {old[:40]!r}")
            src = src.replace(old, new)
        jobs[name] = src
    if baseline is not None:
        jobs["baseline"] = baseline.read_text()

    def one(item):
        name, src = item
        path = out / f"{name}.cu"
        path.write_text(src)
        lib = out / f"lib{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(lib), str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stdout}{proc.stderr}")
        return name, (ctypes.CDLL(str(lib)), ptxas_registers(proc.stdout + proc.stderr))

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


def _old_entries(lib: ctypes.CDLL) -> dict:
    """a5736fb's entry points in the current interface: the backward drops
    (unroll, sample_magic, sample_shift), the occupancy takes the branch
    flag for the instance (kind 1 the branch)."""
    back = _build.bind(lib, "bn_train_backward", OLD_BACKWARD_ARGTYPES)
    occ = _build.bind(lib, "bn_train_occupancy", bt.OCCUPANCY_ARGTYPES)
    return {"bn_train_stats": _build.bind(lib, "bn_train_stats", bt.STATS_ARGTYPES),
            "bn_train_backward": lambda *a: back(*a[:-4], a[-1]),
            "bn_train_occupancy": lambda mode, c, kind, out: occ(mode, c, int(kind == 1), out)}


@contextmanager
def variant(lib: ctypes.CDLL, plan: dict, co_resident: dict, old: bool = False):
    """bn_train's wrappers bound to ``lib`` (``old``: through a5736fb's
    interface) and its occupancy cache, with the plan's ``plan`` overrides
    (bn_train attributes) in force."""
    saved = (dict(_build._ENTRIES), {k: getattr(bt, k) for k in plan}, bt._CO_RESIDENT)
    entries = _old_entries(lib) if old else {
        symbol: _build.bind(lib, symbol, argtypes) for symbol, argtypes in ENTRIES.items()}
    _build._ENTRIES.update(entries)
    for k, v in plan.items():
        setattr(bt, k, v)
    bt._CO_RESIDENT = co_resident
    try:
        yield
    finally:
        _build._ENTRIES.clear()
        _build._ENTRIES.update(saved[0])
        for k, v in saved[1].items():
            setattr(bt, k, v)
        bt._CO_RESIDENT = saved[2]


def same_bits(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all((x is None and y is None) or (x is not None and y is not None and
                                             (same_bits(x, y) if isinstance(x, (tuple, list))
                                              else torch.equal(x, y))) for x, y in zip(a, b))


def plan_row(site: dict, ops: dict, modes) -> dict:
    """The grids the wrapper's plan gives the site's calls."""
    dev = torch.device("cuda")
    C, m = site["shape"][1], ops["y"].numel() // site["shape"][1]
    row = {}
    if "stats" in modes:
        row["stats_grid"] = bt.launch_plan(m, C, "stats", bt._co_resident(dev, "stats", C)).grid
    args, kw = backward_args(ops), ops["kw"]
    relu, branch = args[8], args[7] is not None
    kind = bt.backward_kind(relu, branch, "shift" in kw, "gmul" in kw, args[1] is not None)
    plan = bt.launch_plan(m, C, "backward", bt._co_resident(dev, "backward", C, kind), branch,
                          not relu, site["shape"][2] * site["shape"][3], args[1] is not None,
                          bt._sms(dev))
    row.update(backward_grid=plan.grid, backward_unroll=plan.unroll, kind=kind)
    return row


def split_launches(sites, gen, lib, plan, cache, old: bool) -> dict:
    """The backward's two launches apart over every site, by the profiler's
    kernel sums (ms)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with variant(lib, plan, cache, old), torch.inference_mode():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for site in sites:
                ops = operands(site, gen)
                calls(ops)["backward"]()
                torch.cuda.synchronize()
                del ops
        for e in prof.key_averages():
            for kernel in ("backward_reduce", "backward_apply"):
                if kernel in e.key:
                    out[kernel] = out.get(kernel, 0.0) + e.self_device_time_total / 1e3
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--effnet", action="store_true",
                    help=f"{EFFNET}-unet's SiLU and affine sites, the backward alone")
    ap.add_argument("--baseline", type=Path, help="an earlier bn_train.cu with a5736fb's C "
                    "interface, timed beside the variants")
    ap.add_argument("--variants", help="comma-separated variants (default: the mode's set)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bn_train_phases: needs a CUDA card")
    sites = record_effnet_sites() if args.effnet else record_sites()
    names = (args.variants.split(",") if args.variants
             else list(EFFNET_VARIANTS if args.effnet else RESNET_VARIANTS))
    if "full" not in names or any(n not in VARIANTS for n in names):
        raise SystemExit(f"bn_train_phases: variants must include full and be of {list(VARIANTS)}")
    modes = ("backward",) if args.effnet else ("stats", "pair", "backward")
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="bn_train_phases_") as tmp:
        built = build_variants(Path(tmp), names, args.baseline)
        caches = {name: {} for name in built}
        names = names + (["baseline"] if args.baseline else [])
        plans = {name: BASELINE_PLAN if name == "baseline" else VARIANTS[name][1]
                 for name in names}
        order = names + names[::-1]
        groups = sorted({s.get("mode") or "resnet" for s in sites})
        totals = {name: {g: {m: 0.0 for m in modes} for g in groups} for name in names}
        calls_ms = {name: {g: {m: 0.0 for m in modes} for g in groups}
                    for name in ("full", "baseline") if name in names}
        by_site, differ, checks = [], [], []
        with torch.inference_mode():
            for k, site in enumerate(sites):
                ops = operands(site, gen)
                group = site.get("mode") or "resnet"
                row = {"site": k, **{key: site[key] for key in site},
                       **{f"{m}_bound_ms": b / PEAK_BYTES_PER_S * 1e3
                          for m, b in site_bytes(site).items()}}
                want = None
                for turn, name in enumerate(order):
                    with variant(built[name][0], plans[name], caches[name], name == "baseline"):
                        fns = {m: f for m, f in calls(ops).items() if m in modes}
                        if turn < len(names) and (name in SAME_BITS or name == "baseline"):
                            got = (outputs(ops, fns) if "stats" in modes
                                   else ((), fns["backward"]()))
                            if name == "full":
                                want = got
                                if args.effnet:
                                    plain = bt.bn_backward_plain(*backward_args(ops),
                                                                 **ops["kw"])
                                    row["dy_err"] = dy_err(got[1][0], plain[0])
                                    if row["dy_err"] > DY_TOL:
                                        differ.append(("plain", k))
                            elif not (args.effnet and name == "baseline") and \
                                    not same_bits(got, want):
                                differ.append((name, k))
                        for m, fn in fns.items():
                            ms = device_ms(fn)
                            totals[name][group][m] += ms / 2
                            if name in calls_ms:
                                calls_ms[name][group][m] += call_ms(fn) / 2
                            key = f"{m}_ms" if name == "full" else f"{name}_{m}_ms"
                            row[key] = row.get(key, 0.0) + ms / 2
                        if name == "full" and turn < len(names):
                            row.update(plan_row(site, ops, modes))
                by_site.append(row)
                del ops
            if args.effnet:
                for mode in ("silu", "depthwise"):
                    site = max((s for s in sites if s["mode"] == mode),
                               key=lambda s: s["shape"][1])
                    with variant(built["full"][0], {}, caches["full"]):
                        checks.append(wide_z_check(site, gen))
        launches = {name: split_launches(sites, gen, built[name][0], plans[name], caches[name],
                                         name == "baseline")
                    for name in ("full", "baseline") if name in built}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    bounds = {g: {m: sum(r.get(f"{m}_bound_ms", 0.0) for r in by_site
                         if (r.get("mode") or "resnet") == g) for m in modes} for g in groups}
    # the kernel table's rows: the SiLU sites, the affine ones (--effnet)
    rows = {"silu": ("silu",), "affine": ("depthwise", "drop")}

    def by_row(t: dict) -> dict:
        if not args.effnet:
            return {m: sum(t[g][m] for g in t) for m in modes}
        return {row: sum(t[g]["backward"] for g in gs if g in t) for row, gs in rows.items()}

    if args.effnet:
        bounds.update({row: {"backward": sum(bounds[g]["backward"] for g in gs if g in bounds)}
                       for row, gs in rows.items()})
    print(json.dumps({"bn_train_phases_ms": {name: by_row(t) for name, t in totals.items()},
                      "call_ms": {name: by_row(t) for name, t in calls_ms.items()},
                      "by_group_ms": totals, "bound_ms": bounds,
                      "sites": len(sites), "full_by_site": by_site,
                      "backward_launches_ms": launches, "z_checks": checks,
                      "registers": {name: regs for name, (_, regs) in built.items()},
                      "differ": differ, "card": card}))
    if differ or not all(c["held"] for c in checks):
        raise SystemExit(f"bn_train_phases: outputs that should agree differ: {differ}; "
                         f"z checks {checks}")


if __name__ == "__main__":
    main()
