"""Where the time of the grouped int8 kernel goes, on the card.

    python -m flairtpu_torch.ops.int8_grouped_phases [--baseline OLD.cu]

1. Rates: one loop kernel each for ``dp4a`` and the s8 MMA the kernel
   uses (``mma.sync`` m16n8k32), every SM busy with independent chains;
   prints each one's int8 rate (operations: 2 a multiply-add) beside the
   card's int8 peak (``PEAK_INT8_OPS``) and what the 16 grouped sites'
   multiply-adds (the kernel's, with its block-diagonal zeros) would take
   at it. The kernel's bound stays ``PEAK_INT8_OPS`` and HBM bytes.
2. The kernel (``csrc/int8_conv.cu:int8_conv_grouped``) at resnext50_32x4d's
   16 grouped 3x3 sites of one batch of 128 tiles of 512 (32 groups of 4,
   8, 16, 32 channels; int8 out, ReLU, random operands), by geometry, in
   turns: full, variants, variants reversed, full. Source variants leave
   out one part: the input rows' copies (``no_copies``: the TMA boxes, the
   slot's barrier arrived on instead; the general instance's cp.async), the MMAs
   (``no_mma``: an xor of the operands instead, so the loads stay), the
   epilogue and its stores (``no_epilogue``); their outputs are wrong,
   only their times are read. ``convert_unit`` puts the epilogue's
   conversions back on the conversion unit (__int2float_rn, quantize's
   rintf and float-to-int): the same bits, held to the full kernel.
   ``timing`` adds clock64 reads around a fast block's row phases (the
   wait, the MMAs and epilogue, the barrier, the stores): its warps' mean
   cycles a row, and a block's from start to end. Launch
   variants change the plan and must match the full kernel bit for bit:
   bands halved and doubled, copy depth 1 and 8 (where shared memory
   allows), one output row a step.
3. ptxas's registers and spills of each instance, and the count of some
   SASS opcodes in them (IMMA: the s8 MMA; LDGSTS: cp.async; LDS; IDP:
   dp4a; the conversions I2F, F2I, FRND; local memory LDL / STL).

With ``--baseline OLD.cu`` an earlier source's ``int8_conv_grouped``
through PR 20's 23-argument interface and its (kh * kw, cg / 4, Co, 4)
weights (``git show 2e6c683:flairtpu_torch/csrc/int8_conv.cu``) is timed
at the same sites and held to the full kernel bit for bit. Times are
device times (``bn_train_phases.device_ms``). Prints one JSON line with
the card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops.bn_train_phases import device_ms
from flairtpu_torch.ops.quantize_act import inverse_scale

PEAK_INT8_OPS = 1979e12      # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BATCH = 128
# resnext50_32x4d's grouped sites at 512 tiles: (sites, input side, channels, stride)
SITES = ((3, 128, 128, 1), (1, 128, 256, 2), (3, 64, 256, 1), (1, 64, 512, 2),
         (5, 32, 512, 1), (1, 32, 1024, 2), (2, 16, 1024, 1))
GROUPS = 32

# (text in the kernel source, text that replaces it, times it occurs)
_GUARDS = [
    ("          mbar_expect_tx(bar, slot_bytes);\n"
     "          tma_load_4d(ring0 + slot * slot_bytes, &xmap, bar, c0, ix0, iy0 + issued, (int)b);\n",
     "          if (GROUPED_NO_COPIES) {\n            mbar_arrive(bar);\n          } else {\n"
     "          mbar_expect_tx(bar, slot_bytes);\n"
     "          tma_load_4d(ring0 + slot * slot_bytes, &xmap, bar, c0, ix0, iy0 + issued, (int)b);\n"
     "          }\n", 1),
    ("            cp_async<16>(dst + col * 16, ok ? src_row + (long long)ix * a.Cp : a.x,\n",
     "            if (!GROUPED_NO_COPIES)\n"
     "            cp_async<16>(dst + col * 16, ok ? src_row + (long long)ix * a.Cp : a.x,\n", 1),
    ("                                       uint32_t b1) {\n  asm(\"mma.sync",
     "                                       uint32_t b1) {\n"
     "  if (GROUPED_NO_MMA) {\n    d[0] ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1;\n    return;\n"
     "  }\n  asm(\"mma.sync", 1),
    ("                                                 int end, int n, int cl, uint8_t* out_tile) {\n",
     "                                                 int end, int n, int cl, uint8_t* out_tile) {\n"
     "  if (GROUPED_NO_EPILOGUE) {\n"
     "    if ((d[0] ^ d[1] ^ d[2] ^ d[3]) == 0x7fffffff) a.outq[0] = 1;\n    return;\n  }\n", 1),
    ("  const float f0 = kSmall ? small_int_to_float(d0) : __int2float_rn(d0);\n",
     "  if (GROUPED_NO_EPILOGUE) {\n    if ((d0 ^ d1) == 0x7fffffff) *dst = 1;\n    return;\n  }\n"
     "  const float f0 = kSmall ? small_int_to_float(d0) : __int2float_rn(d0);\n", 1),
    ("    if (a.outq && opx0 < ostep)\n",
     "    if (a.outq && opx0 < ostep && !GROUPED_NO_EPILOGUE)\n", 1),
    ("  return __fsub_rn(__int_as_float(biased), 12582912.f);\n",
     "  if (GROUPED_CVT_UNIT) return __int2float_rn(biased - kSmallBias);\n"
     "  return __fsub_rn(__int_as_float(biased), 12582912.f);\n", 1),
    ("  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);\n",
     "  if (GROUPED_CVT_UNIT) return static_cast<uint8_t>(quantize(v, inv));\n"
     "  const float c = fminf(fmaxf(__fmul_rn(v, inv), -127.f), 127.f);\n", 1),
    # timing: clock64 sums of a fast block's row phases, per warp (lane 0)
    ("  extern __shared__ uint8_t gsm_raw[];\n",
     "  extern __shared__ uint8_t gsm_raw[];\n"
     "#if GROUPED_TIMING\n  const long long gt_start = clock64();\n"
     "  long long gt_acc[4] = {0, 0, 0, 0};\n#endif\n", 1),
    ("      const int nr = min(a.rows_step, rows - i);\n",
     "      const int nr = min(a.rows_step, rows - i);\n"
     "#if GROUPED_TIMING\n      const long long gt0 = clock64();\n#endif\n", 1),
    ("      wait_rows(i + nr - 1);\n",
     "      wait_rows(i + nr - 1);\n"
     "#if GROUPED_TIMING\n      const long long gt1 = clock64();\n      gt_acc[0] += gt1 - gt0;\n"
     "#endif\n", 1),
    ("      // the output tile is whole (its writes ordered before the bulk\n"
     "      // stores' reads)",
     "#if GROUPED_TIMING\n      const long long gt2 = clock64();\n      gt_acc[1] += gt2 - gt1;\n"
     "#endif\n"
     "      // the output tile is whole (its writes ordered before the bulk\n"
     "      // stores' reads)", 1),
    ("      __syncthreads();\n      if (a.outq && tid == 0)\n        for (int r = 0; r < nr; ++r)\n"
     "          tma_store_4d(&ymap, smem_u32(out_tile + r * row_bytes), c0, ox0, oy0 + i + r, (int)b);\n"
     "    }\n",
     "#if GROUPED_TIMING\n      const long long gt2b = clock64();\n#endif\n"
     "      __syncthreads();\n"
     "#if GROUPED_TIMING\n      const long long gt3 = clock64();\n      gt_acc[2] += gt3 - gt2b;\n"
     "      gt_acc[3] += gt2b - gt2;\n#endif\n"
     "      if (a.outq && tid == 0 && !GROUPED_NO_EPILOGUE)\n        for (int r = 0; r < nr; ++r)\n"
     "          tma_store_4d(&ymap, smem_u32(out_tile + r * row_bytes), c0, ox0, oy0 + i + r, (int)b);\n"
     "#if GROUPED_TIMING\n      gt_acc[3] += clock64() - gt3;\n#endif\n"
     "    }\n"
     "#if GROUPED_TIMING\n    if (lane == 0) {\n"
     "      for (int k = 0; k < 4; ++k) atomicAdd(&g_grouped_timing[k], (unsigned long long)gt_acc[k]);\n"
     "      atomicAdd(&g_grouped_timing[4], (unsigned long long)rows);\n"
     "      atomicAdd(&g_grouped_timing[5], 1ull);\n"
     "      if (tid == 0) atomicAdd(&g_grouped_timing[6], (unsigned long long)(clock64() - gt_start));\n"
     "    }\n#endif\n", 1),
]
# the counters and their reader, after the source (timing variant only)
TIMING_TAIL = r"""
#if GROUPED_TIMING
// summed over warps: row cycles in the wait, the MMAs and epilogue, the
// barrier, the stores; rows; warps; and block cycles summed over blocks
extern "C" int grouped_timing(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_grouped_timing, 8 * sizeof(unsigned long long));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero[8] = {};
    err = cudaMemcpyToSymbol(g_grouped_timing, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
"""
TIMING_HEAD = "#if GROUPED_TIMING\n__device__ unsigned long long g_grouped_timing[8];\n#endif\n"
_DEFAULTS = {"GROUPED_NO_COPIES": "0", "GROUPED_NO_MMA": "0", "GROUPED_NO_EPILOGUE": "0",
             "GROUPED_CVT_UNIT": "0", "GROUPED_TIMING": "0"}
VARIANTS = {"full": [], "no_copies": ["-DGROUPED_NO_COPIES=1"],
            "no_mma": ["-DGROUPED_NO_MMA=1"], "no_epilogue": ["-DGROUPED_NO_EPILOGUE=1"],
            "convert_unit": ["-DGROUPED_CVT_UNIT=1"], "timing": ["-DGROUPED_TIMING=1"]}
SASS_OPCODES = ("IMMA", "LDGSTS", "LDS", "IDP", "BAR.SYNC", "I2F", "F2I", "FRND", "LDL", "STL")

RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// 8 independent dp4a chains a thread
__global__ void dp4a_loop(int* out, int iters, int seed) {
  int acc[8], av[8];
  const int b = seed * 3 + 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = threadIdx.x + k, av[k] = seed ^ (threadIdx.x * 7 + k);
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = __dp4a(av[k], b, acc[k]);
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s += acc[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// 4 independent m16n8k32 s8 accumulators a warp
__global__ void mma_loop(int* out, int iters, int seed) {
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = seed + threadIdx.x, b1 = b0 * 11;
  int d[4][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+r"(d[k][0]), "+r"(d[k][1]), "+r"(d[k][2]), "+r"(d[k][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  int s = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += d[k][0] + d[k][1] + d[k][2] + d[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int rate_loop(int which, int blocks, int threads, int iters, int* out, void* stream) {
  if (which == 0)
    dp4a_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 12345);
  else
    mma_loop<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters, 12345);
  return (int)cudaGetLastError();
}
"""
RATE_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
# PR 20's entry point: x, w, deq, bias, res, out32, outq, inv_sx, batch, H, W, cp, ho,
# wo, co, kh, kw, stride, pad, dil, groups, relu, stream
BASELINE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 14 + \
    [ctypes.c_void_p]


def guarded_source() -> str:
    src = (_build.CSRC / "int8_conv.cu").read_text()
    for old, new, count in _GUARDS:
        if src.count(old) != count:
            raise RuntimeError(f"int8_conv.cu no longer has the anchor {old[:50]!r}")
        src = src.replace(old, new)
    head = "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in _DEFAULTS.items())
    # the counters go before the kernels: after the includes
    at = src.index("namespace {")
    return head + src[:at] + TIMING_HEAD + src[at:] + TIMING_TAIL


def ptxas_summary(log: str) -> dict:
    """{instance: "registers, spill bytes"} of the grouped kernel's
    instances (template arguments CG, STRIDE) from ptxas -v."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"int8_conv_grouped_kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            fn = f"cg{m.group(1)}_s{m.group(2)}" if m else None
        elif fn and "spill stores" in line:
            out[fn] = out.get(fn, "") + line.strip().split(",")[1].strip()
        elif fn and "Used" in line and "registers" in line:
            out[fn] = line.split("Used ")[1].split(",")[0] + ", " + out.get(fn, "")
    return out


def grouped_sass(lib: Path) -> dict | None:
    """{instance: opcode counts} in the grouped kernel's SASS, or None
    without cuobjdump."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.match(r"\S*int8_conv_grouped_kernelILi(\d+)ELi(\d+)E", part)
        if m:
            out[f"cg{m.group(1)}_s{m.group(2)}"] = {
                op: len(re.findall(rf"\b{re.escape(op)}\b", part)) for op in SASS_OPCODES}
    return out


def nvcc(src: Path, lib: Path, flags: list) -> str:
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src.name} {flags}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(out: Path, baseline: Path | None) -> dict:
    """Every variant, the rate loops and the baseline, in parallel."""
    src = out / "int8_grouped_phases.cu"
    src.write_text(guarded_source())
    rate = out / "rate_loops.cu"
    rate.write_text(RATE_SOURCE)
    jobs = {name: (src, flags) for name, flags in VARIANTS.items()}
    jobs["rates"] = (rate, [])
    if baseline:
        jobs["baseline"] = (baseline, [])

    def one(item):
        name, (source, flags) = item
        lib = out / f"lib{name}.so"
        log = nvcc(source, lib, flags)
        return name, (lib, log)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


def rates(lib: Path) -> dict:
    """Each loop's int8 operations a second on this card (2 a multiply-add)."""
    fn = _build.bind(ctypes.CDLL(str(lib)), "rate_loop", RATE_ARGTYPES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 8 * sms, 256, 4096
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for name, which, ops in (("dp4a", 0, blocks * threads * iters * 8 * 8),
                             ("mma_s8", 1, blocks * threads // 32 * iters * 4 * 16 * 8 * 32 * 2)):
        ms = device_ms(lambda w=which: _build.check(
            fn(w, blocks, threads, iters, out.data_ptr(), stream), "rate_loop"), 3)
        res[name] = {"ops_per_s": ops / (ms * 1e-3), "ms": ms}
    return res


def sites() -> list[tuple[int, dict]]:
    """(count, int8_conv_grouped keyword arguments) at the 16 grouped sites:
    random int8 input and weights, the walk's epilogue (ReLU, int8 out)."""
    g = torch.Generator("cuda").manual_seed(0)
    out = []
    for n, side, c, stride in SITES:
        cg = c // GROUPS
        p = ic.Int8ConvParams(
            torch.randint(-127, 128, (c, cg, 3, 3), generator=g, device="cuda",
                          dtype=torch.int8), 0.05,
            torch.rand(c, generator=g, device="cuda") * 2e-3 + 1e-4,
            torch.randn(c, generator=g, device="cuda"), GROUPS)
        x = torch.randint(-127, 128, (BATCH, side, side, c), generator=g, device="cuda",
                          dtype=torch.int8).permute(0, 3, 1, 2)
        out.append((n, dict(x=x, p=p, stride=stride, padding=1, dilation=1, residual=None,
                            relu=True, keep_f32=False, out_sx=0.04)))
    return out


def cost(site: dict) -> tuple[int, int, int]:
    """(useful operations, the kernel's operations with its zeros, bytes)."""
    x, p = site["x"], site["p"]
    B, c, H, W = x.shape
    ho, wo = (ic._out_hw(n, 3, site["stride"], 1, 1) for n in (H, W))
    cg = p.wq.shape[1]
    cb, _, steps = ic.grouped_bundle(cg)
    m = B * ho * wo
    return 2 * m * c * cg * 9, 2 * m * c * 3 * steps * 32, x.numel() + p.wq.numel() + 8 * c + m * c


def launcher(fn, site: dict, plan: ic.GroupedPlan):
    """A call of a built variant's entry point at ``plan``; its int8 output."""
    x, p = site["x"], site["p"]
    B, c, H, W = x.shape
    ho, wo = (ic._out_hw(n, 3, site["stride"], 1, 1) for n in (H, W))
    outq = torch.empty((B, ho, wo, c), dtype=torch.int8, device="cuda")
    args = (x.data_ptr(), p.packed.data_ptr(), p.deq.data_ptr(), p.b.data_ptr(), None, None,
            outq.data_ptr(), inverse_scale(site["out_sx"]), B, H, W, c, ho, wo, c,
            site["stride"], 1, 1, p.groups, 1, _build.stream_handle(x), *plan.entry_args())
    return (lambda: _build.check(fn(*args), "int8_grouped_phases")), outq


def baseline_launcher(fn, site: dict):
    """PR 20's entry point on its own weight layout; its int8 output."""
    x, p = site["x"], site["p"]
    B, c, H, W = x.shape
    ho, wo = (ic._out_hw(n, 3, site["stride"], 1, 1) for n in (H, W))
    cg = p.wq.shape[1]
    w = p.wq.permute(2, 3, 1, 0).reshape(9, cg // 4, 4, c).permute(0, 1, 3, 2).contiguous()
    outq = torch.empty((B, ho, wo, c), dtype=torch.int8, device="cuda")
    args = (x.data_ptr(), w.data_ptr(), p.deq.data_ptr(), p.b.data_ptr(), None, None,
            outq.data_ptr(), inverse_scale(site["out_sx"]), B, H, W, c, ho, wo, c, 3, 3,
            site["stride"], 1, 1, p.groups, 1, _build.stream_handle(x))
    return (lambda: _build.check(fn(*args), "int8_grouped_phases baseline")), outq, w


def row_phases(lib: Path, call, plan: ic.GroupedPlan) -> dict:
    """One call of the timing variant: its warps' mean clock64 cycles a row
    in the wait for the row's inputs, the MMAs and epilogue, the barrier,
    the stores (the proxy fence, thread 0's wait for the row before's store
    and its store of this row), and a block's mean cycles from its start to
    its end."""
    fn = _build.bind(ctypes.CDLL(str(lib)), "grouped_timing", [ctypes.c_void_p, ctypes.c_int])
    buf = (ctypes.c_ulonglong * 8)()
    _build.check(fn(buf, 1), "grouped_timing")
    call()
    torch.cuda.synchronize()
    _build.check(fn(buf, 1), "grouped_timing")
    c = list(buf)
    if not c[4]:
        return {}
    blocks = c[5] / (plan.threads // 32)
    return {"wait": c[0] / c[4], "mma_epilogue": c[1] / c[4], "barrier": c[2] / c[4],
            "stores": c[3] / c[4], "rows_a_block": c[4] / c[5], "block": c[6] / blocks}


def plan_variants(plan: ic.GroupedPlan, site_plan) -> dict:
    """Launch variants of a plan: bands halved and doubled, depth 1 and 8,
    one row a step (``site_plan(band=..., depth=..., rows_step=...)``: the
    site's plan so forced)."""
    return {"band_half": site_plan(band=max(1, plan.band // 2)),
            "band_double": site_plan(band=2 * plan.band),
            "depth_1": site_plan(depth=1), "depth_8": site_plan(depth=ic.GROUPED_MAX_DEPTH),
            "one_row_a_step": site_plan(rows_step=1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier int8_conv.cu (PR 20's interface)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("int8_grouped_phases: needs a CUDA card")
    result: dict = {}
    with torch.inference_mode(), tempfile.TemporaryDirectory(prefix="grouped_phases_") as tmp:
        built = build(Path(tmp), args.baseline)
        result["ptxas"] = {name: ptxas_summary(log) for name, (_, log) in built.items()
                           if name in VARIANTS}
        result["sass"] = grouped_sass(built["full"][0])
        result["rates"] = rates(built["rates"][0])
        fns = {name: _build.bind(ctypes.CDLL(str(built[name][0])), "int8_conv_grouped",
                                 ic.GROUPED_ARGTYPES) for name in VARIANTS}
        base = (_build.bind(ctypes.CDLL(str(built["baseline"][0])), "int8_conv_grouped",
                            BASELINE_ARGTYPES) if args.baseline else None)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows, useful, done, nbytes = [], 0, 0, 0
        for n, site in sites():
            ops, kops, b = cost(site)
            useful, done, nbytes = useful + n * ops, done + n * kops, nbytes + n * b
            B, c, H, _ = site["x"].shape
            ho = ic._out_hw(H, 3, site["stride"], 1, 1)
            def site_plan(**forced):
                return ic.grouped_plan(B, ho, ho, c, GROUPS, site["stride"], 1, 1, sms, **forced)

            plan = site_plan()
            calls = {}
            full_call, full_out = launcher(fns["full"], site, plan)
            full_call()
            torch.cuda.synchronize()
            ref = full_out.clone()
            same = {}
            for name in VARIANTS:
                calls[name], out = launcher(fns[name], site, plan)
                if name == "convert_unit":
                    calls[name]()
                    torch.cuda.synchronize()
                    same[name] = bool(torch.equal(out, ref))
            for name, pv in plan_variants(plan, site_plan).items():
                try:
                    call, out = launcher(fns["full"], site, pv)
                    call()
                    torch.cuda.synchronize()
                    same[name] = bool(torch.equal(out, ref))
                    calls[name] = call
                except RuntimeError as error:  # shared memory the variant does not fit
                    same[name] = f"refused: {error}"
            if base:
                call, out, _w = baseline_launcher(base, site)
                call()
                torch.cuda.synchronize()
                same["baseline"] = bool(torch.equal(out, ref))
                calls["baseline"] = call
            order = list(calls) + list(calls)[::-1]
            times: dict = {}
            for name in order:
                times.setdefault(name, []).append(device_ms(calls[name], 5))
            timing = row_phases(built["timing"][0], calls["timing"], plan)
            rows.append({"site": f"{n} x ({B}, {c}, {H}, {H}) /{site['stride']}, cg {c // GROUPS}",
                         "count": n, "plan": dataclasses.asdict(plan), "row_cycles": timing,
                         "bound_ms": max(ops / PEAK_INT8_OPS, b / PEAK_BYTES_PER_S) * 1e3,
                         "ms": times, "bit_equal": same})
            del site, calls, ref
            torch.cuda.empty_cache()
    total = {}
    for r in rows:
        for name, ts in r["ms"].items():
            total[name] = total.get(name, 0.0) + r["count"] * min(ts)
    bound_ms = sum(r["count"] * r["bound_ms"] for r in rows)
    rate_ms = {name: {"useful_ms": useful / v["ops_per_s"] * 1e3,
                      "kernel_ops_ms": done / v["ops_per_s"] * 1e3}
               for name, v in result["rates"].items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"int8_grouped_phases": rows, "total_ms_min_of_turns": total,
                      "bound_ms": bound_ms, "useful_ops": useful, "kernel_ops": done,
                      "bytes": nbytes, "peak_int8_ops": PEAK_INT8_OPS,
                      "sites_at_each_rate": rate_ms, **result, "card": card}))


if __name__ == "__main__":
    main()
