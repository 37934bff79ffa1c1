"""Where the time of the accumulate_probs kernel goes, on the card.

    python -m flairtpu_torch.ops.accumulate_probs_phases

Builds variants of ``csrc/accumulate_probs.cu`` and times them against the
full kernel on one batch of the main path's average_weights program (128
full 512 tiles of a 4096² zone at stride 256, 19 classes, random logits),
in turns: full, variants, variants reversed, full. The variants:
``no_softmax`` adds only ``w * valid`` to the accumulators (the compiler
then drops the logits' reads and the softmax: what is left is the
accumulator pass), ``reciprocal`` multiplies by 1 / sum in place of the
division, ``four_blocks_per_sm`` asks for at most 64 registers a thread. A
variant's output is wrong; only its time is read. Prints one JSON line with
the times in ms, the registers a thread of each variant for K = 19 (ptxas),
and the card's name and power limit. Needs a CUDA card and nvcc.
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
from flairtpu_torch.ops import stitch as st
from flairtpu_torch.zone.grid import slice_grid
from flairtpu_torch.zone.weights import patch_weights

SIZE, MARGIN, BATCH, K, ZONE = 512, 128, 128, 19, 4096

# (text in the kernel source, text that replaces it) for each variant
_EDITS = {
    "full": [],
    "no_softmax": [("__fmul_rn(__fdiv_rn(e[c], sum), wv)", "wv")],
    "reciprocal": [("__fdiv_rn(e[c], sum)", "__fmul_rn(e[c], __frcp_rn(sum))")],
    "four_blocks_per_sm": [("__launch_bounds__(kThreads) accumulate_kernel",
                            "__launch_bounds__(kThreads, 4) accumulate_kernel")],
}


def variant_source(name: str) -> str:
    src = (_build.CSRC / "accumulate_probs.cu").read_text()
    for old, new in _EDITS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"accumulate_probs.cu no longer has the anchor {old[:40]!r}")
        src = src.replace(old, new)
    return src


def build_variants(out: Path) -> dict:
    def one(name):
        src, lib = out / f"{name}.cu", out / f"lib{name}.so"
        src.write_text(variant_source(name))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-o", str(lib), str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stdout}{proc.stderr}")
        fn = _build.bind(ctypes.CDLL(str(lib)), "accumulate_probs", st.ACCUMULATE_ARGTYPES)
        return name, (fn, k19_registers(proc.stdout + proc.stderr))

    with ThreadPoolExecutor(len(_EDITS)) as pool:
        return dict(pool.map(one, _EDITS))


def k19_registers(ptxas_log: str) -> int | None:
    """Registers a thread of the instance for K = 19 (KP = 24)."""
    fn = None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line
        elif "registers" in line and fn and "ILi24E" in fn:
            return int(line.split("Used ")[1].split()[0])
    return None


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("accumulate_probs_phases: needs a CUDA card")
    tiles = slice_grid(ZONE, ZONE, SIZE, MARGIN).tiles[:BATCH]
    org_np = np.array([(t.row0 + MARGIN, t.col0 + MARGIN) for t in tiles], np.int32)
    fp = st.footprint(org_np, np.ones(BATCH), SIZE)
    hp = ZONE + 2 * MARGIN
    gen = torch.Generator("cuda").manual_seed(0)
    logits = torch.randn((BATCH, SIZE, SIZE, K), generator=gen, device="cuda") * 3
    org = torch.from_numpy(org_np).cuda()
    val = torch.ones(BATCH, device="cuda")
    w = torch.from_numpy(patch_weights(SIZE).astype(np.float32)).cuda()
    acc = torch.zeros((hp, hp, K), device="cuda")
    div = torch.zeros((hp, hp), device="cuda")

    def ms(fn, reps: int = 20) -> float:
        def call():
            _build.check(fn(logits.data_ptr(), org.data_ptr(), val.data_ptr(), w.data_ptr(),
                            acc.data_ptr(), div.data_ptr(), BATCH, SIZE, K, hp, *fp,
                            _build.stream_handle(logits)), "accumulate_probs_phases")
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    with tempfile.TemporaryDirectory(prefix="accumulate_probs_phases_") as tmp:
        built = build_variants(Path(tmp))
        times: dict[str, list[float]] = {}
        for name in list(built) + list(built)[::-1]:
            times.setdefault(name, []).append(ms(built[name][0]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"accumulate_probs_phases_ms": times,
                      "registers_k19": {name: regs for name, (_, regs) in built.items()},
                      "card": card}))


if __name__ == "__main__":
    main()
