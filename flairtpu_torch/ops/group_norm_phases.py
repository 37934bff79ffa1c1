"""Where the time of group_norm_relu's backward goes, on the card.

    python -m flairtpu_torch.ops.group_norm_phases [--baseline OLD_SOURCE]

Times the backward at FPN's seven Conv3x3GNReLU sites of one train step
(``SITES``: batch 16 at 512², y bf16 (16, 128, s, s), g float32 at 2s where
the site upsamples; random operands), site by site:

- device time (``device_ms``: a sleep kernel longer than the host's calls
  runs ahead of the start event, so the events bracket the card's work)
  and call time (``call_ms``: events around the host's calls, which
  include its checks, allocations and ctypes call at the small sites);
- the site's plan (``ops/group_norm.py:launch_plan``: route, item pixels,
  items a sample, samples in flight, grid, blocks a SM, shared memory), the
  HBM bytes its design moves (x, g and dy once; x and g twice where the
  re-read route's samples in flight exceed its L2 share) and the bound (x
  and g read once, dy written once, at 3.35 TB/s);
- launches a call, from the profiler's kernel count.

Variants, timed in turns with the default (``full``): the plan forced,
``reread`` (the re-read route at every site) and ``on_chip`` (the on-chip
route wherever a sample fits, the 128² site included), or its L2 share
raised to 0.75 or all of it (``l2_share_75``, ``l2_share_100``: more
samples in flight on the re-read route, fewer rounds); the source edited
and built apart, ``bounds_1`` (launch bounds of one block a SM: registers
past 128, no spills, the plan on the occupancy that follows), and three
that leave out a part (their outputs are wrong; only their time is read):
``no_apply`` (no dy: the reduce, the barriers and the fold), ``no_wait``
(no block waits at its sample's barrier) and ``no_fold`` (no dgamma /
dbeta fold at the end). ``full``, the routes and ``bounds_1`` are held to
the plain version on every call (dy within DY_TOL of the largest |dy|,
dgamma and dbeta within GRAD_TOL of 1 + the largest |value|), and two
calls of ``full`` to each other bit for bit. ``--baseline`` builds an
earlier source with the three-launch C interface of commit ``0510a73``
(``git show 0510a73:flairtpu_torch/csrc/group_norm.cu``) and times its
backward in the same turns (default, variants, baseline, then reversed).
ptxas's registers and spills of each kernel. Prints one JSON line ending
with the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import group_norm as gn
from flairtpu_torch.ops.bn_train_phases import device_ms

BATCH, C, G = 16, 128, 32
# FPN's seven Conv3x3GNReLU sites at 512 tiles: (label, input side, upsample)
SITES = (("seg0_c0 (p5)", 16, True), ("seg0_c1", 32, True), ("seg0_c2", 64, True),
         ("seg1_c0 (p4)", 32, True), ("seg1_c1", 64, True), ("seg2_c0 (p3)", 64, True),
         ("seg3_c0 (p2)", 128, False))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
DY_TOL = 2.0 ** -6  # two bf16 ulps of the largest |dy|
GRAD_TOL = 1e-4  # float32 sums over up to 262144 values in other orders
# (source edits, forced route, the plan's L2 share) of each variant
VARIANTS = {
    "full": ([], None, None),
    "reread": ([], "reread", None),
    "on_chip": ([], "on_chip", None),
    "l2_share_75": ([], None, 0.75),
    "l2_share_100": ([], None, 1.0),
    "bounds_1": ([("__launch_bounds__(kThreads, 2) backward_kernel",
                   "__launch_bounds__(kThreads, 1) backward_kernel")], None, None),
    "no_apply": ([("    // 3. the apply\n", "    continue;\n")], None, None),
    "no_wait": ([("        while (*t <= a.parts) {", "        while (false) {")], None, None),
    "no_fold": ([("    if (flag[1]) fold_params(", "    if (false) fold_params(")], None, None),
}
CHECKED = ("full", "reread", "on_chip", "l2_share_75", "l2_share_100", "bounds_1")
ENTRIES = {"group_norm_backward": gn.BACKWARD_ARGTYPES,
           "group_norm_backward_occupancy": gn.OCCUPANCY_ARGTYPES,
           "group_norm_device_limits": gn.LIMITS_ARGTYPES}
# the earlier source's C interface: 11 pointers, (batch, h, w, C, G, chunks,
# upsample), the stream; scratch (B, chunks, C) and (B, chunks, G) float2
OLD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
OLD_CHUNK = 512


def call_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean time of fn() over reps calls by events around the host's calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def site_operands(side: int, up: bool, gen, batch: int = BATCH, channels: int = C,
                  groups: int = G) -> dict:
    """y (bf16 channels_last), g, gamma, beta, and the forward's statistics."""
    y = (torch.randn((batch, side, side, channels), generator=gen, device="cuda") * 1.5
         + 0.3).to(torch.bfloat16).permute(0, 3, 1, 2)
    gamma = torch.rand(channels, generator=gen, device="cuda") + 0.5
    beta = torch.randn(channels, generator=gen, device="cuda") * 0.2
    u = 2 if up else 1
    g = torch.randn((batch, u * side, u * side, channels), generator=gen,
                    device="cuda").permute(0, 3, 1, 2)
    _, mean, rstd = gn.group_norm_relu_plain(y, gamma, beta, groups, upsample=up, stats=True)
    return dict(g=g, y=y, mean=mean, rstd=rstd, gamma=gamma, beta=beta, groups=groups,
                upsample=up)


def backward(ops: dict):
    return gn.group_norm_relu_backward(**ops)


def errors(got, want) -> tuple[float, float]:
    """(dy's largest |diff| over its largest |value|, dgamma's and dbeta's
    over 1 + theirs)."""
    dy = ((got[0].float() - want[0].float()).abs().max()
          / want[0].float().abs().max().clamp_min(1e-30)).item()
    grad = max(((a - b).abs().max() / (1 + b.abs().max())).item()
               for a, b in zip(got[1:], want[1:]))
    return dy, grad


def site_bytes(side: int, up: bool, batch: int = BATCH, channels: int = C) -> int:
    """x and g read once, dy written once."""
    n = batch * side * side * channels
    return n * (2 + 4 * (4 if up else 1) + 2)


_PLAN = gn.launch_plan


def build(name: str, src: str, out: Path) -> tuple[ctypes.CDLL, dict]:
    """Builds a source with ptxas's report: the library, and each kernel's
    registers and spill stores."""
    path = out / f"{name}.cu"
    path.write_text(src)
    lib = out / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    info, fn = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            k = re.search(r"(stats_kernel|apply_kernel|backward_kernel|back_\w+?_kernel)"
                          r"(ILb([01])ELb([01])E|ILb([01])E)?", mangled)
            fn = mangled if k is None else k.group(1) + (
                f"<up={k.group(3)}, on_chip={k.group(4)}>" if k.group(3) else
                f"<up={k.group(5)}>" if k.group(5) else "")
            info[fn] = {}
        elif fn and "Used" in line and "registers" in line:
            info[fn]["registers"] = int(line.split("Used ")[1].split()[0])
        elif fn and "spill stores" in line:
            info[fn]["spill_stores"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
    return ctypes.CDLL(str(lib)), info


def build_variants(out: Path, baseline: Path | None) -> dict:
    """Each source variant's (library, ptxas report), built in parallel; the
    forced routes share full's."""
    base = (_build.CSRC / "group_norm.cu").read_text()
    jobs = {}
    for name, (edits, _, _) in VARIANTS.items():
        if not edits and name != "full":
            continue
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"group_norm.cu no longer has the anchor {old[:40]!r}")
            src = src.replace(old, new)
        jobs[name] = src
    if baseline is not None:
        jobs["baseline"] = baseline.read_text()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(*kv, out), jobs.items())))
    for name, (edits, _, _) in VARIANTS.items():
        if not edits:
            built[name] = built["full"]
    return built


@contextmanager
def variant(lib: ctypes.CDLL, route: str | None, counters: dict, l2_share: float | None = None):
    """group_norm's backward bound to ``lib`` (its limits and plans queried
    anew, its tickets ``counters``: a variant that leaves a part out may
    leave them off 0), with ``route`` forced and the plan's L2 share."""
    saved = dict(_build._ENTRIES), gn._COUNTERS, gn.L2_SHARE
    for symbol, argtypes in ENTRIES.items():
        _build._ENTRIES[symbol] = _build.bind(lib, symbol, argtypes)
    gn._LIMITS.clear()
    gn._PLANS.clear()
    gn._COUNTERS = counters
    gn.L2_SHARE = l2_share or saved[2]
    gn.launch_plan = functools.partial(_PLAN, route=route) if route else _PLAN
    try:
        yield
    finally:
        _build._ENTRIES.clear()
        _build._ENTRIES.update(saved[0])
        gn._LIMITS.clear()
        gn._PLANS.clear()
        gn._COUNTERS, gn.L2_SHARE = saved[1], saved[2]
        gn.launch_plan = _PLAN


def baseline_call(lib: ctypes.CDLL, ops: dict):
    """The site's backward through the earlier source's three launches."""
    fn = _build.bind(lib, "group_norm_backward", OLD_ARGTYPES)
    y, g = ops["y"], ops["g"]
    B, Cn, H, W = y.shape
    chunks = -(-H * W // OLD_CHUNK)
    stream = _build.stream_handle(y)

    def run():
        chan = torch.empty((B, chunks, Cn, 2), dtype=torch.float32, device="cuda")
        grp = torch.empty((B, chunks, ops["groups"], 2), dtype=torch.float32, device="cuda")
        dy = torch.empty_like(y)
        dgamma = torch.empty(Cn, dtype=torch.float32, device="cuda")
        dbeta = torch.empty(Cn, dtype=torch.float32, device="cuda")
        _build.check(fn(y.data_ptr(), g.data_ptr(), ops["mean"].data_ptr(),
                        ops["rstd"].data_ptr(), ops["gamma"].data_ptr(), ops["beta"].data_ptr(),
                        chan.data_ptr(), grp.data_ptr(), dy.data_ptr(), dgamma.data_ptr(),
                        dbeta.data_ptr(), B, H, W, Cn, ops["groups"], chunks,
                        int(ops["upsample"]), stream), "baseline group_norm_backward")
        return dy, dgamma, dbeta

    return run


def launches_a_call(ops: dict) -> float:
    """Kernels the card ran for one call of the backward, by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    backward(ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            backward(ops)
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages() if "backward_kernel" in e.key)
    return n / 4


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier group_norm.cu with the "
                    "three-launch C interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("group_norm_phases: needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    names = list(VARIANTS) + (["baseline"] if args.baseline else [])
    order = names + names[::-1]
    rows, failed = [], []
    with tempfile.TemporaryDirectory(prefix="group_norm_phases_") as tmp:
        built = build_variants(Path(tmp), args.baseline)
        counters = {name: {} for name in names}
        with variant(built["full"][0], None, counters["full"]):
            limits = gn.device_limits(torch.device("cuda"))
            fits = {(side, up): _fits_on_chip(side, up, limits) for _, side, up in SITES}
        with torch.inference_mode():
            for label, side, up in SITES:
                ops = site_operands(side, up, gen)
                want = gn.group_norm_relu_backward_plain(**ops)
                nbytes = site_bytes(side, up)
                row = {"site": label, "side": side, "upsample": up, "bytes": nbytes,
                       "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
                for turn, name in enumerate(order):
                    if name == "on_chip" and not fits[(side, up)]:
                        continue
                    with contextlib.ExitStack() as stack:
                        if name == "baseline":
                            fn = baseline_call(built[name][0], ops)
                        else:
                            stack.enter_context(variant(built[name][0], VARIANTS[name][1],
                                                        counters[name], VARIANTS[name][2]))
                            fn = functools.partial(backward, ops)
                        if turn < len(names) and name in CHECKED + ("baseline",):
                            got = fn()
                            dy_err, grad_err = errors(got, want)
                            row[f"{name}_err"] = [dy_err, grad_err]
                            if dy_err > DY_TOL or grad_err > GRAD_TOL:
                                failed.append((label, name, dy_err, grad_err))
                            if name == "full" and not all(torch.equal(a, b)
                                                          for a, b in zip(got, fn())):
                                failed.append((label, "full: two calls differ"))
                        if turn < len(names) and name in VARIANTS:
                            B, Cn, H, W = ops["y"].shape
                            row.setdefault("plans", {})[name] = gn.launch_plan(
                                B, H, W, Cn, G, up, gn.device_limits(torch.device("cuda"))
                            )._asdict()
                        for key, timer in (("device_ms", device_ms), ("call_ms", call_ms)):
                            row.setdefault(name, {}).setdefault(key, 0.0)
                            row[name][key] += timer(fn) / 2
                with variant(built["full"][0], None, counters["full"]):
                    row["launches_a_call"] = launches_a_call(ops)
                rows.append(row)
                del ops, want
                torch.cuda.empty_cache()
    totals = {name: {key: sum(r[name][key] for r in rows if name in r)
                     for key in ("device_ms", "call_ms")} for name in names}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"group_norm_phases_ms": totals,
                      "bound_ms": sum(r["bound_ms"] for r in rows),
                      "hbm_bytes": sum(r["plans"]["full"]["hbm_bytes"] for r in rows),
                      "sites": rows, "kernels": {name: info for name, (_, info) in built.items()},
                      "failed": failed, "card": card}))
    if failed:
        raise SystemExit(f"group_norm_phases: calls outside their tolerance: {failed}")


def _fits_on_chip(side: int, up: bool, limits: gn.Limits) -> bool:
    try:
        _PLAN(BATCH, side, side, C, G, up, limits, route="on_chip")
    except ValueError:
        return False
    return True


if __name__ == "__main__":
    main()
