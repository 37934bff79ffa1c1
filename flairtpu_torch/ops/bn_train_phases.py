"""Where the time of the bn_train kernels goes, on the card.

    python -m flairtpu_torch.ops.bn_train_phases [--baseline OLD_SOURCE]

Times bn_stats and bn_backward at the 43 BatchNorm sites (46 BatchNorms) of
one train step of resnet34-unet at batch 16 and 512² (each site's shape and
kind as the port's model gives them; random operands), site by site, by
device time: a sleep kernel longer than the host's calls runs ahead of the
start event, so the events bracket the card's work and not the host's
dispatch. Builds variants of ``csrc/bn_train.cu`` and times them in turns
(the variants, then the same reversed):

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
- ``stats_unroll8``, ``backward_unroll4``: more loads in flight a thread;
- ``min_block_32k``, ``min_block_128k``: the wrapper's plan with another
  least share of a block (``launch_plan``'s MIN_BLOCK_BYTES, 64 KB);
- ``no_tile_loads``, ``no_combine``: without the walk over the site's
  tiles, or without the combine (their outputs are wrong; only their time
  is read: a call's fixed cost, and what the combine costs).

``apply_forward``, ``one_combiner`` and ``combiners_quarter`` must give
``full``'s bits (checked); the others sum in another order. ``--baseline`` also times an
earlier source with the C interface of ``3646155`` (a grid-stride walk over
at most 528 blocks, a one-thread-a-channel finalize launch, a forward
apply: ``git show 3646155:flairtpu_torch/csrc/bn_train.cu``) through that
interface. The profiler's kernel sums split ``full``'s backward into its
two launches. Prints one JSON line: each variant's step totals (ms), the
``full`` kernels site by site with their grids and bounds (bytes at 3.35
TB/s), ptxas's registers, and the card's name and power limit. Needs a
CUDA card and nvcc.
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
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SLEEP_CYCLES_PER_S = 2e9  # at least the card's clock: a sleep lasts as long as asked
ENTRIES = {"bn_train_stats": bt.STATS_ARGTYPES, "bn_train_backward": bt.BACKWARD_ARGTYPES,
           "bn_train_occupancy": bt.OCCUPANCY_ARGTYPES}
# 3646155's C interface: no counters, the partials' size implied by blocks
OLD_STATS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
OLD_BACKWARD_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
OLD_MAX_BLOCKS = 528

APPLY_WALK = ("    const long long p0 = tiles.first(k, true) + t.row;\n    Pixel px",
              "    const long long p0 = tiles.first(k, false) + t.row;\n    Pixel px")
COMBINERS_WANT = "  const int want = (channels * combine_warps(blocks) + kWarps - 1) / kWarps;"
STATS_WALK = ("      const long long p0 = tiles.first(k, true) + t.row;\n      uint4 w",
              "      const long long p0 = tiles.first(k, false) + t.row;\n      uint4 w")
# (source edits, launch_plan's MIN_BLOCK_BYTES) of each variant
VARIANTS = {
    "full": ([], None),
    "apply_forward": ([APPLY_WALK], None),
    "stats_forward": ([STATS_WALK], None),
    "one_combiner": ([("  return blocks < want ? blocks : want;", "  return 1;")], None),
    "combiners_quarter": ([(COMBINERS_WANT, COMBINERS_WANT.replace(
        "(channels * combine_warps(blocks) + kWarps - 1) / kWarps",
        "((channels * combine_warps(blocks) + kWarps - 1) / kWarps + 3) / 4"))], None),
    "combine_loads_1": ([("kCombineLoads = 8;", "kCombineLoads = 1;")], None),
    "stats_unroll8": ([("kStatsUnroll = 4;", "kStatsUnroll = 8;")], None),
    "backward_unroll4": ([("kBackUnroll = 2;", "kBackUnroll = 4;")], None),
    "min_block_32k": ([], 32 * 1024),
    "min_block_128k": ([], 128 * 1024),
    "no_tile_loads": ([("    last = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x : -1;",
                        "    last = -1;")], None),
    "no_combine": ([("  for (int c0 = rank * teams; c0 < channels; c0 += combiners * teams) {",
                     "  for (int c0 = rank * teams; c0 < 0; c0 += combiners * teams) {")], None),
}
SAME_BITS = ("full", "apply_forward", "one_combiner", "combiners_quarter")


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


def record_sites() -> list[dict]:
    """Each train-mode site of resnet34-unet at BATCH x SIZE², in forward
    order: (C, H, W), residual, branch, keep_f32 (recorded at 64² on the
    CPU and scaled)."""

    class Recorder(bt.TrainSites):
        def __init__(self):
            self.sites = []

        def site(self, y, bn, residual=None, branch=None, relu=True, keep_f32=False):
            self.sites.append(dict(shape=(BATCH, y.shape[1], y.shape[2] * SIZE // 64,
                                          y.shape[3] * SIZE // 64),
                                   residual=residual is not None, branch=branch is not None,
                                   keep_f32=keep_f32))
            return super().site(y, bn, residual, branch, relu, keep_f32)

    rec = Recorder()
    with torch.no_grad():
        FlairSegmentationModel("resnet34", CLASSES, 5)(torch.rand(1, 64, 64, 5), epilogue=rec)
    return rec.sites


def operands(site: dict, gen) -> dict:
    """Random bf16 maps (and a float32 gradient where the site keeps one) of
    the site's shape, channels_last, with statistics and vectors."""
    B, C, H, W = site["shape"]

    def rand(dtype=torch.bfloat16):
        return torch.randn((B, C, H, W), device="cuda", generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)

    def vecs(n):
        return [torch.rand(C, device="cuda", generator=gen) + 0.5 for _ in range(n)]

    y = rand()
    d = rand() if site["branch"] else None
    # v: gamma, beta, running mean and var (updated by each call); s: the
    # backward's mean and invstd
    v = vecs(4)
    return dict(y=y, d=d, g=rand(), g32=rand(torch.float32) if site["keep_f32"] else None,
                out=torch.relu(rand()), v=v, running0=[t.clone() for t in v[2:]], s=vecs(2),
                vd=vecs(4) if d is not None else None, sd=vecs(2) if d is not None else None,
                residual=rand(torch.float32) if site["residual"] else None)


def calls(ops: dict) -> dict:
    """The site's statistics (each BatchNorm), the statistics with the
    forward's conv_epilogue after them, and the backward."""
    v, vd = ops["v"], ops["vd"]
    branch = None if ops["d"] is None else (ops["d"], *ops["sd"], vd[0])

    def stats():
        r = bt.bn_stats(ops["y"], *v)
        if ops["d"] is not None:
            bt.bn_stats(ops["d"], *vd)
        return r

    def pair():
        _, _, scale, shift = stats()
        conv_epilogue(ops["y"], scale, shift, residual=ops["residual"])

    def backward():
        return bt.bn_backward(ops["g"], ops["g32"], ops["out"], ops["y"], *ops["s"], v[0],
                              branch, True, ops["residual"] is not None)

    return {"stats": stats, "pair": pair, "backward": backward}


def outputs(ops: dict, fns: dict) -> tuple:
    """Every output of one statistics call (from the operands' first running
    statistics) and one backward call."""
    for t, t0 in zip(ops["v"][2:], ops["running0"]):
        t.copy_(t0)
    r = fns["stats"]()
    return tuple(t.clone() for t in r + tuple(ops["v"][2:])), fns["backward"]()


def site_bytes(site: dict) -> dict:
    """Each input read once, each output written once."""
    B, C, H, W = site["shape"]
    n = B * C * H * W
    n_bn = 1 + site["branch"]
    back = 8 * n + 4 * n * site["keep_f32"] + 4 * n * site["residual"] + 4 * n * site["branch"]
    return {"stats": 2 * n * n_bn, "backward": back}


def build_variants(out: Path, baseline: Path | None) -> dict:
    base = (_build.CSRC / "bn_train.cu").read_text()
    jobs = {}
    for name, (edits, _) in VARIANTS.items():
        src = base
        for old, new in edits:
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
        regs = {}
        fn = None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '\w*?(stats_\w+?|backward_\w+?)"
                          r"(ILb[01]E)?E", line)
            if m:
                fn = m.group(1) + ("<branch>" if m.group(2) == "ILb1E" else "")
            elif fn and "Used" in line and "registers" in line:
                regs[fn] = int(line.split("Used ")[1].split()[0])
        return name, (ctypes.CDLL(str(lib)), regs)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


@contextmanager
def variant(lib: ctypes.CDLL, min_block: int | None, co_resident: dict):
    """bn_train's wrappers bound to ``lib`` (and its occupancy cache), with
    the plan's least share of a block set to ``min_block``."""
    saved = (dict(_build._ENTRIES), bt.MIN_BLOCK_BYTES, bt._CO_RESIDENT)
    for symbol, argtypes in ENTRIES.items():
        _build._ENTRIES[symbol] = _build.bind(lib, symbol, argtypes)
    bt.MIN_BLOCK_BYTES = min_block or saved[1]
    bt._CO_RESIDENT = co_resident
    try:
        yield
    finally:
        _build._ENTRIES.clear()
        _build._ENTRIES.update(saved[0])
        bt.MIN_BLOCK_BYTES, bt._CO_RESIDENT = saved[1], saved[2]


def baseline_calls(lib: ctypes.CDLL, ops: dict) -> dict:
    """The site's statistics and backward through 3646155's C interface."""
    stats_fn = _build.bind(lib, "bn_train_stats", OLD_STATS_ARGTYPES)
    back_fn = _build.bind(lib, "bn_train_backward", OLD_BACKWARD_ARGTYPES)
    y = ops["y"]
    C = y.shape[1]
    m = y.numel() // C
    blocks = max(1, min(-(-m // (bt.THREADS // (C // 8))), OLD_MAX_BLOCKS))
    stream = _build.stream_handle(y)

    def one_stats(x, v):
        partials = torch.empty((blocks, 2, C), dtype=torch.float32, device="cuda")
        out = torch.empty((4, C), dtype=torch.float32, device="cuda")
        _build.check(stats_fn(*(t.data_ptr() for t in (x, *v, partials)), blocks,
                              *(o.data_ptr() for o in out), m, C, bt.EPS, bt.MOMENTUM,
                              stream), "baseline stats")

    def stats():
        one_stats(y, ops["v"])
        if ops["d"] is not None:
            one_stats(ops["d"], ops["vd"])

    def ptr(t):
        return None if t is None else t.data_ptr()

    def backward():
        v, d = ops["v"], ops["d"]
        partials = torch.empty((blocks, 3, C), dtype=torch.float32, device="cuda")
        sums = torch.empty((3, C), dtype=torch.float32, device="cuda")
        dy = torch.empty_like(y)
        dres = torch.empty_like(y, dtype=torch.float32) if ops["residual"] is not None else None
        dd = torch.empty_like(d) if d is not None else None
        branch = (*ops["sd"], ops["vd"][0]) if d is not None else (None,) * 3
        _build.check(back_fn(ptr(ops["g"]), ptr(ops["g32"]), ptr(ops["out"]), ptr(y),
                             *(ptr(t) for t in ops["s"]), ptr(v[0]), ptr(d),
                             *(ptr(t) for t in branch), ptr(partials), blocks, ptr(sums),
                             ptr(dy), ptr(dres), ptr(dd), m, C, stream), "baseline backward")

    return {"stats": stats, "backward": backward}


def same_bits(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all((x is None and y is None) or (x is not None and y is not None and
                                             (same_bits(x, y) if isinstance(x, (tuple, list))
                                              else torch.equal(x, y))) for x, y in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier bn_train.cu with 3646155's C "
                    "interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bn_train_phases: needs a CUDA card")
    sites = record_sites()
    gen = torch.Generator("cuda").manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="bn_train_phases_") as tmp:
        built = build_variants(Path(tmp), args.baseline)
        caches = {name: {} for name in built}
        names = list(VARIANTS) + (["baseline"] if args.baseline else [])
        order = names + names[::-1]
        totals = {name: {"stats": 0.0, "pair": 0.0, "backward": 0.0} for name in names}
        by_site, differ = [], []
        with torch.inference_mode():
            for k, site in enumerate(sites):
                ops = operands(site, gen)
                row = {"site": k, "shape": site["shape"], "residual": site["residual"],
                       "branch": site["branch"], "keep_f32": site["keep_f32"],
                       **{f"{m}_bound_ms": b / PEAK_BYTES_PER_S * 1e3
                          for m, b in site_bytes(site).items()}}
                want = None
                for turn, name in enumerate(order):
                    if name == "baseline":
                        fns = baseline_calls(built[name][0], ops)
                        for mode, fn in fns.items():
                            totals[name][mode] += device_ms(fn) / 2
                        continue
                    with variant(built[name][0], VARIANTS[name][1], caches[name]):
                        fns = calls(ops)
                        if name in SAME_BITS and turn < len(names):
                            got = outputs(ops, fns)
                            if name == "full":
                                want = got
                            elif name in SAME_BITS and not same_bits(got, want):
                                differ.append((name, k))
                        t = {mode: device_ms(fn) for mode, fn in fns.items()}
                        for mode, ms in t.items():
                            totals[name][mode] += ms / 2
                        if name == "full":
                            for mode, ms in t.items():
                                row[f"{mode}_ms"] = row.get(f"{mode}_ms", 0.0) + ms / 2
                            C, m = site["shape"][1], ops["y"].numel() // site["shape"][1]
                            dev = torch.device("cuda")
                            row["stats_grid"] = bt.launch_plan(
                                m, C, "stats", bt._co_resident(dev, "stats", C)).grid
                            row["backward_grid"] = bt.launch_plan(
                                m, C, "backward",
                                bt._co_resident(dev, "backward", C, site["branch"]),
                                site["branch"]).grid
                by_site.append(row)
                del ops
        # the backward's two launches apart, by the profiler's kernel sums
        from torch.profiler import ProfilerActivity, profile
        launches = {}
        with variant(built["full"][0], None, caches["full"]), torch.inference_mode():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for site in sites:
                    ops = operands(site, gen)
                    calls(ops)["backward"]()
                    torch.cuda.synchronize()
                    del ops
            for e in prof.key_averages():
                for kernel in ("backward_reduce", "backward_apply", "stats_kernel"):
                    if kernel in e.key:
                        launches[kernel] = launches.get(kernel, 0.0) + \
                            e.self_device_time_total / 1e3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"bn_train_phases_ms": totals,
                      "bound_ms": {m: sum(r[f"{m}_bound_ms"] for r in by_site)
                                   for m in ("stats", "backward")},
                      "full_by_site": by_site, "full_backward_launches_ms": launches,
                      "registers": {name: regs for name, (_, regs) in built.items()},
                      "differ_from_full": differ, "card": card}))
    if differ:
        raise SystemExit(f"bn_train_phases: variants that should give full's bits differ: "
                         f"{differ}")


if __name__ == "__main__":
    main()
