"""Where the time of the fused-tail kernel goes, on the card.

    python -m flairtpu_torch.ops.fused_tail_phases

Builds variants of ``csrc/fused_tail.cu`` that each leave out one phase (a
conv's tensor-core loop, or the head's softmax/argmax epilogue and plane
writes), and one that asks for a single block per SM instead of two (more
registers a thread), and times them against the full kernel at the main path's shapes
(512/128 tiles, batch 128, 19 classes), in turns: full, variants, variants
reversed, full. A variant's output is wrong; only its time is read, and the
difference to the full kernel is what the phase costs with the others
running. Prints one JSON line with the times in ms, each variant's
registers a thread for K = 19 (ptxas), and the card's name and power limit.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import fused_tail as ft

SIZE, MARGIN, BATCH, K = 512, 128, 128, 19

# (text in the kernel source, text that replaces it) for each guard
_GUARDS = [
    ("#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n        uint32_t arow_addr[2];",
     "#ifndef SKIP_CONV1\n#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n"
     "        uint32_t arow_addr[2];"),
    ("      block_epilogue<kW1, kP1>", "#endif\n      block_epilogue<kW1, kP1>"),
    ("#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n        uint32_t bf[4];\n"
     "        ldsm_x4(w2b",
     "#ifndef SKIP_CONV2\n#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n"
     "        uint32_t bf[4];\n        ldsm_x4(w2b"),
    ("      block_epilogue<kW2, kP2>", "#endif\n      block_epilogue<kW2, kP2>"),
    ("#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n        uint32_t a[2][4];",
     "#ifndef SKIP_HEAD\n#pragma unroll\n      for (int tap = 0; tap < 9; ++tap) {\n"
     "        uint32_t a[2][4];"),
    ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, MIN_BLOCKS)"),
    ("      // rows gr and gr + 8 of each m-tile",
     "#endif\n#ifdef SKIP_EPILOGUE\n      if (acc[0][0][0] == 1234.5f) cls[0] = 1;\n      continue;\n"
     "#endif\n      // rows gr and gr + 8 of each m-tile"),
]
VARIANTS = {"full": [], "no_conv1_mma": ["-DSKIP_CONV1"], "no_conv2_mma": ["-DSKIP_CONV2"],
            "no_head_mma": ["-DSKIP_HEAD"], "no_head_epilogue": ["-DSKIP_EPILOGUE"],
            "one_block_per_sm": ["-DMIN_BLOCKS=1"]}


def guarded_source() -> str:
    src = "#ifndef MIN_BLOCKS\n#define MIN_BLOCKS 2\n#endif\n" + (
        _build.CSRC / "fused_tail.cu").read_text()
    for old, new in _GUARDS:
        if src.count(old) != 1:
            raise RuntimeError(f"fused_tail.cu no longer has the anchor {old[:40]!r}")
        src = src.replace(old, new)
    return src


def build_variants(out: Path) -> dict:
    src = out / "fused_tail_phases.cu"
    src.write_text(guarded_source())

    def one(item):
        name, flags = item
        lib = out / f"lib{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                               "-o", str(lib), str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stdout}{proc.stderr}")
        return name, (_build.bind(ctypes.CDLL(str(lib)), "fused_tail", ft.ARGTYPES), k19_registers(proc.stdout + proc.stderr))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS.items()))


def k19_registers(ptxas_log: str) -> int | None:
    """Registers a thread of the instance for K = 19 (three head n-tiles)."""
    fn = None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line
        elif "registers" in line and fn and "ILi3E" in fn:
            return int(line.split("Used ")[1].split()[0])
    return None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fused_tail_phases: needs a CUDA card")
    rng = np.random.default_rng(0)
    g = ft.tail_geometry(SIZE, MARGIN)
    s = g.out_extent

    def t(shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                                ).to(torch.bfloat16).float().cuda()

    p = ft.TailParams(t((16, 32, 3, 3)), 1 + t(16), t(16), t((16, 16, 3, 3)), 1 + t(16),
                      t(16), t((K, 16, 3, 3)), t(K))
    x3 = t((BATCH, g.x3_extent, g.x3_extent, 32), 1.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    planes = torch.empty((2, BATCH * s, s), dtype=torch.uint8, device="cuda")
    windows = ft.full_windows(BATCH, s, x3.device)
    args = [ctypes.c_void_p(a.data_ptr()) for a in (x3, p.packed, p.epi, windows, planes[0],
                                                    planes[1])]
    dims = (s, BATCH, g.x3_extent, g.up_crop, g.b4_extent, g.head_crop, s, K)

    def call(fn):
        _build.check(fn(*args, *dims, _build.stream_handle(x3)), "fused_tail_phases")

    def ms(fn, reps: int = 20) -> float:
        for _ in range(3):
            call(fn)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            call(fn)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    with tempfile.TemporaryDirectory(prefix="fused_tail_phases_") as tmp:
        built = build_variants(Path(tmp))
        order = list(built) + list(built)[::-1]
        times: dict[str, list[float]] = {}
        for name in order:
            times.setdefault(name, []).append(ms(built[name][0]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"fused_tail_phases_ms": times,
                      "registers_k19": {name: regs for name, (_, regs) in built.items()},
                      "card": card}))


if __name__ == "__main__":
    main()
