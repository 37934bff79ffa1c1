"""Where the time of the strided_tail kernel goes, on the card.

    python -m flairtpu_torch.ops.strided_tail_phases [--baseline OLD_SOURCE]

Times strided_tail at the main path's shapes of chip_smoke's STRIDED_CASES
(batch 128, 512-pixel tiles, 19 classes; head logits (128, 128, 128, 19)
at U = 4, (128, 64, 64, 19) at U = 8, (128, 512, 512, 19) at U = 1, float32):
argmax and probs at margin 128 into whole-tile windows, logits at margin 0.
Device time (``bn_train_phases.device_ms``: the queue filled behind a sleep
kernel first); for each call the variants in turns, then the same reversed.
Builds variants of ``csrc/strided_tail.cu``:

- ``full``: the kernel as built, with ``launch_plan``'s launch;
- ``copy_only``: the same staging, reads and stores with no arithmetic (each
  pass XORs its two values' bits, and the epilogue stores bits of the
  values in place of the softmax): the ceiling of the kernel's data
  movement;
- ``exp_only``: no upsample: the pixel reads one staged source value a
  class (the identity path) and runs the softmax epilogue (``expf``, the
  division) on it: the epilogue's floor beside the special-function units'
  (``sfu_floor_ms``: one expf a value at 16 a clock an SM, at the card's
  largest SM clock);
- ``rows_4``, ``rows_16``: bands of 4 or 16 window rows; ``cols_128``:
  chunks of 128 window columns; ``plain_stores``: the logits chunks stored
  without ``__stcs``.

The band and chunk variants and ``plain_stores`` must give ``full``'s bits
(checked). ``--baseline`` also times an earlier source with the entry
point's earlier interface (``OLD_ARGTYPES``: no plan, the taps as
``taps`` gives them), fe34f71's one-thread-a-pixel kernel (``git show
fe34f71:flairtpu_torch/csrc/strided_tail.cu``), with its own ``copy_only``
and ``exp_only`` edits (``BASELINE_SOURCES``: the four taps' bits XORed;
one tap, no upsample), and checks that ``full`` gives its values on every
call: classes, prob and probs bytes equal, logits equal under ``==``.
Prints one JSON line: each variant's ms on each call, the bounds (the
separable function's operations at 67 TFLOP/s float32 or its bytes at 3.35
TB/s, as ``ops/strided_tail.py:strided_cost`` counts them), the floors,
ptxas's registers, shared memory and spills of the 19-class kernels, the
opcode counts of ``full``'s 19-class kernels (``cuobjdump -sass``; MUFU is
the exponential's special-function instruction; FSETP, FSEL, SEL, FMNMX
and LOP3 the compares and selects), the plans and grids, and the card's
name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import strided_tail as sp
from flairtpu_torch.ops.bn_train_phases import device_ms
from flairtpu_torch.ops.fused_tail import full_windows

BATCH, SIZE, MARGIN, CLASSES = 128, 512, 128, 19
UPS = (4, 8, 1)
MODES = ("argmax", "probs", "logits")
PEAK_FP32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SFU_PER_SM_CLOCK = 16  # special-function results an SM gives a clock
# the entry point before its plan arguments
OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

LERP = "  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));"
EPILOGUE = "                                            uint8_t* o) {\n"
NO_ARITHMETIC = [
    (LERP, "  return __int_as_float(__float_as_int(a) ^ __float_as_int(b));"),
    (EPILOGUE, EPILOGUE + """  unsigned bits = 0;  // no softmax: the values' bits
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    if (j < k) {
      bits ^= __float_as_uint(v[j]);
      if (MODE == kProbs) o[j] = (uint8_t)__float_as_uint(v[j]);
    }
  }
  if (MODE == kArgmax) {
    *cls = (uint8_t)bits;
    *prob = (uint8_t)(bits >> 8);
  }
  if (k > 0) return;
"""),
]
SOURCES = {
    "full": [],
    "copy_only": NO_ARITHMETIC,
    "exp_only": [("  const bool identity = a.identity;", "  const bool identity = true;")],
    "plain_stores": [("      __stcs(reinterpret_cast<uint4*>(dst + head + per * i), chunk);",
                      "      *reinterpret_cast<uint4*>(dst + head + per * i) = chunk;")],
}
# fe34f71's source: its four taps' arithmetic, exponential and division
OLD_TAPS = """          const float t0 =
              __fadd_rn(__fmul_rn(wlr, __ldg(p00 + j)), __fmul_rn(whr, __ldg(p10 + j)));
          const float t1 =
              __fadd_rn(__fmul_rn(wlr, __ldg(p01 + j)), __fmul_rn(whr, __ldg(p11 + j)));
          v[j] = __fadd_rn(__fmul_rn(wlc, t0), __fmul_rn(whc, t1));"""
BASELINE_SOURCES = {
    "baseline": [],
    "baseline_copy_only": [
        (OLD_TAPS, "          v[j] = __int_as_float((__float_as_int(__ldg(p00 + j)) ^ "
                   "__float_as_int(__ldg(p10 + j)) ^ __float_as_int(__ldg(p01 + j)) ^ "
                   "__float_as_int(__ldg(p11 + j))) & 0x3f7fffff);"),
        ("        v[j] = expf(v[j] - mx);", "        v[j] = v[j];"),
        ("rintf(__fmul_rn(__fdiv_rn(v[j], sum), 255.0f));", "__float_as_int(v[j]);")],
    "baseline_exp_only": [(OLD_TAPS, "          v[j] = __ldg(p00 + j);")],
}
# variant -> (source, plan overrides)
VARIANTS = {
    "full": ("full", {}),
    "copy_only": ("copy_only", {}),
    "exp_only": ("exp_only", {}),
    "rows_4": ("full", {"rows": 4}),
    "rows_16": ("full", {"rows": 16}),
    "cols_128": ("full", {"cols": 128}),
    "plain_stores": ("plain_stores", {}),
}
SAME_BITS = ("rows_4", "rows_16", "cols_128", "plain_stores")


def calls(gen: torch.Generator) -> dict:
    """call name -> (x, geometry, mode) on the card: each mode at each U."""
    out = {}
    for up in UPS:
        n = SIZE // up
        x = torch.randn((BATCH, n, n, CLASSES), generator=gen, device="cuda") * 2.0
        for mode in MODES:
            g = sp.strided_geometry(SIZE, 0 if mode == "logits" else MARGIN, up)
            out[f"{mode} U={up}"] = (x, g, mode)
    return out


def outputs(g, mode: str) -> tuple:
    """(windows, out0, out1, pitch) of a call into whole-tile windows."""
    s, dev = g.out_extent, torch.device("cuda")
    win = full_windows(BATCH, s, dev)
    if mode == "argmax":
        planes = torch.empty((2, BATCH * s, s), dtype=torch.uint8, device=dev)
        return win, planes[0], planes[1], s
    dtype = torch.uint8 if mode == "probs" else torch.float32
    return win, torch.empty((BATCH * s, s, CLASSES), dtype=dtype, device=dev), None, s


def call_cost(g, mode: str) -> tuple[int, int]:
    win = full_windows(BATCH, g.out_extent, torch.device("cpu")).numpy()
    return sp.strided_cost(g, win, CLASSES, mode)


def edited(base: str, edits: list, what: str) -> str:
    for old, new in edits:
        if base.count(old) != 1:
            raise RuntimeError(f"{what} no longer has the anchor {old[:50]!r}")
        base = base.replace(old, new)
    return base


def build(out: Path, baseline: Path | None) -> dict:
    """source name -> (ctypes library, ptxas's numbers by kernel)."""
    base = (_build.CSRC / "strided_tail.cu").read_text()
    jobs = {name: edited(base, edits, "strided_tail.cu") for name, edits in SOURCES.items()}
    if baseline is not None:
        old = baseline.read_text()
        jobs.update({name: edited(old, edits, str(baseline))
                     for name, edits in BASELINE_SOURCES.items()})

    def one(item):
        name, src = item
        path = out / f"{name}.cu"
        path.write_text(src)
        lib = out / f"lib{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(lib), str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} source:\n{proc.stdout}{proc.stderr}")
        info = ptxas_info(proc.stdout + proc.stderr)
        if name == "full":
            info["sass"] = sass_counts(lib)
        return name, (ctypes.CDLL(str(lib)), info)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


def sass_counts(lib: Path) -> dict | None:
    """Opcode counts of each 19-class kernel in the library's SASS (static:
    every instruction once, however often it runs), or None without
    cuobjdump."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            fn = m.group(1) if f"ILi{CLASSES}E" in m.group(1) else None
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if fn and m:
            counts = out.setdefault(fn, {})
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return {fn: dict(sorted(c.items(), key=lambda kv: -kv[1])) for fn, c in out.items()}


def ptxas_info(log: str) -> dict:
    """Registers, static shared memory and spill bytes of the kernels that
    run 19 classes (fe34f71's: its 24-class bound), by mangled name."""
    info, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1) if re.search(r"ILi(19|24)E", m.group(1)) else None
        elif fn and "Used" in line and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            info.setdefault(fn, {}).update(
                registers=int(line.split("Used ")[1].split()[0]),
                static_smem=int(smem.group(1)) if smem else 0)
        elif fn and "spill" in line:
            info.setdefault(fn, {})["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
    return info


def runner(lib: ctypes.CDLL, call: tuple, outs: tuple, plan: sp.Plan | None):
    """A function that launches ``lib``'s entry point once on ``call`` into
    ``outs`` (windows, out0, out1, pitch): through the plan's interface, or
    with ``plan`` None through the earlier one."""
    x, g, mode = call
    win, out0, out1, pitch = outs
    argv = [x.data_ptr(), None, None, win.data_ptr(), out0.data_ptr(),
            None if out1 is None else out1.data_ptr(), pitch, BATCH, g.n_in, g.out_extent,
            CLASSES, MODES.index(mode)]
    if plan is None:
        fn = _build.bind(lib, "strided_tail", OLD_ARGTYPES)
        idx, wts = (torch.from_numpy(a).cuda() for a in sp.taps(g))
    else:
        fn = _build.bind(lib, "strided_tail", sp.ARGTYPES)
        idx, wts = sp.device_taps(g, x.device)
        argv += [plan.rows, plan.cols, plan.src_rows, plan.src_cols, int(g.up == 1),
                 plan.smem_bytes]
    argv[1:3] = idx.data_ptr(), wts.data_ptr()
    argv.append(_build.stream_handle(x))

    def run():
        _build.check(fn(*argv), "strided_tail")

    run.keep = (idx, wts)  # the taps live as long as the launch
    return run


def equal(a: tuple, b: tuple) -> bool:
    """Outputs equal: bytes, or float32 values under == (-0.0 == 0.0)."""
    return all(u is None or bool((u == v).all()) for u, v in zip(a[1:3], b[1:3]))


def card(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier strided_tail.cu with the entry "
                    "point's earlier interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("strided_tail_phases: needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    inputs = calls(gen)
    bounds, plans = {}, {}
    for name, (x, g, mode) in inputs.items():
        ops, nbytes = call_cost(g, mode)
        bounds[name] = max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        plans[name] = {v: sp.launch_plan(g, CLASSES, MODES.index(mode), BATCH, **over)
                       for v, (_, over) in VARIANTS.items()}
    sm_clock_hz = float(card("clocks.max.sm").split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # one expf a class at each window pixel of the argmax and probs calls
    sfu_floor_ms = (BATCH * (SIZE - 2 * MARGIN) ** 2 * CLASSES
                    / (sms * SFU_PER_SM_CLOCK * sm_clock_hz) * 1e3)
    ms, differ, baseline_equal = {}, [], {}
    with tempfile.TemporaryDirectory(prefix="strided_tail_phases_") as tmp:
        built = build(Path(tmp), args.baseline)
        for call, (x, g, mode) in inputs.items():
            ref, other = outputs(g, mode), outputs(g, mode)
            runs = {v: runner(built[src][0], inputs[call], other, plans[call][v])
                    for v, (src, _) in VARIANTS.items()}
            runs.update({v: runner(built[v][0], inputs[call], other, None)
                         for v in BASELINE_SOURCES if v in built})
            runner(built["full"][0], inputs[call], ref, plans[call]["full"])()
            for v in (*SAME_BITS, "baseline"):
                if v in runs:
                    runs[v]()
                    torch.cuda.synchronize()
                    if v == "baseline":
                        baseline_equal[call] = equal(ref, other)
                    elif not equal(ref, other):
                        differ.append(f"{v} {call}")
            names = list(runs)
            for v in names + names[::-1]:
                ms.setdefault(v, {}).setdefault(call, 0.0)
                ms[v][call] += device_ms(runs[v]) / 2
            del ref, other, runs
            torch.cuda.empty_cache()
        ptxas = {name: info for name, (_, info) in built.items()}
    grids = {call: {v: vars(p) for v, p in pv.items() if v in ("full", *SAME_BITS[:3])}
             for call, pv in plans.items()}
    print(json.dumps({"strided_tail_phases_ms": ms, "bound_ms": bounds,
                      "sfu_floor_ms": sfu_floor_ms, "sm_clock_mhz": sm_clock_hz / 1e6,
                      "ptxas": ptxas, "plans": grids, "baseline_equal": baseline_equal,
                      "differ_from_full": differ, "card": card("name,power.limit")}))
    if differ or not all(baseline_equal.values()):
        raise SystemExit(f"strided_tail_phases: variants that should give full's bits differ: "
                         f"{differ}; calls where full differs from the baseline: "
                         f"{[c for c, ok in baseline_equal.items() if not ok]}")


if __name__ == "__main__":
    main()
