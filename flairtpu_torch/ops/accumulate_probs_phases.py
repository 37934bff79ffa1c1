"""Where the time of the accumulate_probs kernel goes, on the card.

    python -m flairtpu_torch.ops.accumulate_probs_phases [--baseline OLD_SOURCE]

Builds variants of ``csrc/accumulate_probs.cu`` and times them on one batch
of the main path's average_weights program (128 full 512 tiles of a 4096²
zone at stride 256, 19 classes, random logits), in turns: the variants,
then the same reversed. The variants split the pass over the accumulators:

- ``full``: the kernel as built;
- ``no_softmax`` adds only ``w * valid`` to the accumulators (the compiler
  then drops the logits' reads and the softmax): the accumulator pass;
- ``loads_only``: ``no_softmax`` without the accumulators' stores;
- ``div_only``: ``no_softmax`` without the accumulators' loads and stores:
  the tile listing and the ``div`` pass.

So ``no_softmax - loads_only`` is what the accumulators' stores cost and
``loads_only - div_only`` what their loads cost. Variants of the layout,
which compute the same result: ``persistent`` (as many blocks as the card
holds at once, walking the strips), ``strip_1x256`` and ``strip_4x64`` (the
strip's shape), ``six_blocks_per_sm`` (at most 40 registers a thread),
``streaming_stores`` (``__stcs`` write-back). ``--baseline`` also builds
the four split variants of the earlier design, which kept a pixel's
accumulators in registers and loaded and stored them in place at stride K
(``git show c725b76:flairtpu_torch/csrc/accumulate_probs.cu``), timed in
the same turns, so the two designs compare pass for pass. Every variant
that computes the whole result is first checked bit for bit against the
plain version on fresh planes; the split variants' output is wrong, and
only their time is read. Prints one JSON line with the times in ms, the
registers a thread of each variant for K = 19 (ptxas), and the card's
name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
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

NO_SOFTMAX = ("__fmul_rn(__fdiv_rn(e[c], sum), wv)", "wv")
# as many blocks as the card holds at once, each walking strips
RESIDENT = """template <int KP>
int resident_blocks(int strips, size_t shared) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, accumulate_kernel<KP>, kThreads, shared);
  return per_sm * sms < strips ? per_sm * sms : strips;
}

"""
# (text in the kernel source, text that replaces it) for each variant, per design
EDITS = {
    # csrc/accumulate_probs.cu: strips copied through shared memory
    "strip": {
        "full": [],
        "no_softmax": [NO_SOFTMAX],
        "loads_only": [NO_SOFTMAX, ("dst[i] = src[p * ks + c];", "")],
        "div_only": [NO_SOFTMAX, ("dst[i] = src[p * ks + c];", ""),
                     ("copy4_async(dst + p * ks + c, src + i);", "")],
        "persistent": [("<<<strips, kThreads, shared, stream>>>",
                        "<<<resident_blocks<KP>(strips, shared), kThreads, shared, stream>>>"),
                       ("template <int KP>\ncudaError_t launch(", RESIDENT + "template <int KP>\n"
                        "cudaError_t launch(")],
        "strip_1x256": [("kRows = 2, kCols = 128", "kRows = 1, kCols = 256")],
        "strip_4x64": [("kRows = 2, kCols = 128", "kRows = 4, kCols = 64")],
        "six_blocks_per_sm": [("__launch_bounds__(kThreads) accumulate_kernel",
                               "__launch_bounds__(kThreads, 6) accumulate_kernel")],
        "streaming_stores": [("dst[i] = src[p * ks + c];", "__stcs(dst + i, src[p * ks + c]);")],
    },
    # the earlier design (--baseline): accumulators in registers; its loads
    # are folded into div where its stores are dropped, so the compiler keeps them
    "registers": {
        "full": [],
        "no_softmax": [NO_SOFTMAX],
        "loads_only": [NO_SOFTMAX, ("a.acc[pix * a.k + c] = acc[c];",
                                    "div = __fadd_rn(div, acc[c]);")],
        "div_only": [NO_SOFTMAX, ("c < a.k ? a.acc[pix * a.k + c] : 0.f", "0.f"),
                     ("if (c < a.k) a.acc[pix * a.k + c] = acc[c];", "")],
    },
}


# the variants that leave work out; every other one must equal the plain version
PARTIAL = ("no_softmax", "loads_only", "div_only")


def variant_source(src: str, design: str, name: str) -> str:
    """``src`` with the edits of variant ``name`` of ``design``."""
    for old, new in EDITS[design][name]:
        if src.count(old) != 1:
            raise RuntimeError(f"the {design} kernel no longer has the anchor {old[:40]!r}")
        src = src.replace(old, new)
    return src


def build_variants(sources: dict[str, str], out: Path) -> dict:
    """{"design/variant": (bound entry point, registers for K = 19)}."""
    def one(item):
        design, name = item
        src, lib = out / f"{design}_{name}.cu", out / f"lib{design}_{name}.so"
        src.write_text(variant_source(sources[design], design, name))
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                               "-o", str(lib), str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {design}/{name}:\n{proc.stdout}{proc.stderr}")
        fn = _build.bind(ctypes.CDLL(str(lib)), "accumulate_probs", st.ACCUMULATE_ARGTYPES)
        return f"{design}/{name}", (fn, k19_registers(proc.stdout + proc.stderr))

    items = [(d, n) for d in sources for n in EDITS[d]]
    with ThreadPoolExecutor(len(items)) as pool:
        return dict(pool.map(one, items))


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path,
                    help="an accumulate_probs.cu of the earlier design, to time beside "
                         "this tree's kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("accumulate_probs_phases: needs a CUDA card")
    sources = {"strip": (_build.CSRC / "accumulate_probs.cu").read_text()}
    if args.baseline:
        sources["registers"] = args.baseline.read_text()

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

    def call(fn):
        _build.check(fn(logits.data_ptr(), org.data_ptr(), val.data_ptr(), w.data_ptr(),
                        acc.data_ptr(), div.data_ptr(), BATCH, SIZE, K, hp, *fp,
                        _build.stream_handle(logits)), "accumulate_probs_phases")

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

    with tempfile.TemporaryDirectory(prefix="accumulate_probs_phases_") as tmp:
        built = build_variants(sources, Path(tmp))
        acc_p, div_p = torch.zeros_like(acc), torch.zeros_like(div)
        st.accumulate_probs_plain(logits, org, val, w, acc_p, div_p)
        exact = [name for name in built if name.split("/")[1] not in PARTIAL]
        for name in exact:
            acc.zero_()
            div.zero_()
            call(built[name][0])
            torch.cuda.synchronize()
            if not (torch.equal(acc, acc_p) and torch.equal(div, div_p)):
                raise SystemExit(f"accumulate_probs_phases: {name} differs from the plain "
                                 "version")
        del acc_p, div_p
        times: dict[str, list[float]] = {}
        for name in list(built) + list(built)[::-1]:
            times.setdefault(name, []).append(ms(built[name][0]))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"accumulate_probs_phases_ms": times, "bit_equal_to_plain": exact,
                      "registers_k19": {name: regs for name, (_, regs) in built.items()},
                      "card": card}))


if __name__ == "__main__":
    main()
