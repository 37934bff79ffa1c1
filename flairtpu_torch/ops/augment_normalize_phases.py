"""Where the time of the augment_normalize kernel goes, on the card.

    python -m flairtpu_torch.ops.augment_normalize_phases [--baseline OLD_SOURCE]

Times augment_normalize at one train batch (16 x 512 x 512 x 5 uint8, a
uint8 mask, 19 classes, the custom normalization of
``configs/flair-1-config.yaml``) by device time (``bn_train_phases.
device_ms``: the queue filled behind a sleep kernel first). Builds variants
of ``csrc/augment_normalize.cu`` and times them in turns (the variants,
then the same reversed):

- ``full``: the kernel as built, on the train call (the 16 D4 choices in
  turn, as chip_smoke's ``choices_all``: half of the samples at an odd k;
  bfloat16 output and targets);
- ``identity``: the same without choices (eval's call); ``no_mask``: the
  identity without a mask (predict's call); ``f32``: the train call with
  float32 output; ``k0`` ... ``k3``: every sample at that k (the flips in
  turn), which shows what the rotated read costs;
- ``general``: the general instance forced on the train call;
- ``unpadded``: staged rows without their pad (64 C bytes, an even number
  of words: the rotated read's lanes fall on a few banks);
  ``copy16``: 16-byte ``cp.async.cg`` copies, rows padded by 16 bytes (an
  odd number of 16-byte chunks);
- ``copy_only``: the same staging, reads and 16-byte stores with no
  transform and no normalization (each output row read forward from the
  staged row of the same index, each byte written as 2^23 + byte): the
  ceiling of the kernel's data movement. Its bits differ from ``full``'s;
- ``min_blocks_8``: the tiled kernel held to 32 registers (8 blocks an SM,
  one wave of the batch's 1024 tiles; it spills), and
  ``copy_only_min_blocks_8`` the copy so; ``stream_stores``: the chunks
  stored with ``st.global.cs`` (evict first);
- ``library_copy``: ``Tensor.copy_`` of a uint8 tensor half the train
  call's bytes, so as many bytes read and written: what the card's own copy
  kernel makes of them.

Every other variant must give ``full``'s bits on its call, and ``full``
the plain version's on every call (checked). ``--baseline`` also times an
earlier source with the entry point's earlier interface (no instance
argument: ``git show d4bdc59:flairtpu_torch/csrc/augment_normalize.cu``)
on the train, identity, no_mask and f32 calls. Prints one JSON line: each
variant's ms, the bounds (bytes at 3.35 TB/s), ptxas's registers, shared
memory and spills for each kernel, the grids, and the card's name and power
limit. Needs a CUDA card and nvcc.
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
import yaml

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import augment as au
from flairtpu_torch.ops.bn_train_phases import device_ms

BATCH, SIZE, CHANNELS, CLASSES = 16, 512, 5, 19
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
CONFIG = Path(__file__).resolve().parents[2] / "configs" / "flair-1-config.yaml"
# the entry point before its instance argument
OLD_ARGTYPES = au.ARGTYPES[:-1]

PAD = "constexpr int kPadBytes = 4;"
COPY = "constexpr int kCopyBytes = 4;"
COPY_ONLY = [
    ("  const bool forward = sj == C;", "  const bool forward = true;"),
    ("    const uint8_t* src = s_row + ii * si;", "    const uint8_t* src = s_img + ii * pitch;"),
    ("  return __fmul_rn(__fsub_rn(__fsub_rn(magic, 8388608.0f), mean), mul);",
     "  return magic;"),
    ("      const uint8_t* src = m_row + ii * mi + 4 * tq * mj;",
     "      const uint8_t* src = s_msk + ii * kMaskPitch + 4 * tq;"),
    ("      if (mj == 1) {", "      if (true) {"),
]
BOUNDS = "__global__ void __launch_bounds__(kBigThreads) tiled_kernel(Args a) {"
STORE = "    *reinterpret_cast<uint4*>(out + (long long)ii * n * C) = chunk;"
SOURCES = {
    "full": [],
    "min_blocks_8": [(BOUNDS, BOUNDS.replace("(kBigThreads)", "(kBigThreads, 8)"))],
    "stream_stores": [(STORE, "    __stcs(reinterpret_cast<uint4*>(out + (long long)ii * n * C), "
                              "chunk);")],
    "unpadded": [(PAD, PAD.replace("4;", "0;"))],
    "copy16": [(PAD, PAD.replace("4;", "16;")), (COPY, COPY.replace("4;", "16;"))],
    "copy_only": COPY_ONLY,
    "copy_only_min_blocks_8": COPY_ONLY + [(BOUNDS, BOUNDS.replace("(kBigThreads)",
                                                                  "(kBigThreads, 8)"))],
}
# variant -> (source, call, instance)
VARIANTS = {
    "full": ("full", "train", "tiled"),
    "identity": ("full", "identity", "tiled"),
    "no_mask": ("full", "no_mask", "tiled"),
    "f32": ("full", "f32", "tiled"),
    **{f"k{k}": ("full", f"k{k}", "tiled") for k in range(4)},
    "general": ("full", "train", "general"),
    "unpadded": ("unpadded", "train", "tiled"),
    "copy16": ("copy16", "train", "tiled"),
    "copy_only": ("copy_only", "train", "tiled"),
    "min_blocks_8": ("min_blocks_8", "train", "tiled"),
    "stream_stores": ("stream_stores", "train", "tiled"),
    "copy_only_min_blocks_8": ("copy_only_min_blocks_8", "train", "tiled"),
}
BASELINE_CALLS = ("train", "identity", "no_mask", "f32")


def choices(kind: str, batch: int = BATCH) -> torch.Tensor | None:
    """(batch, 3) int32 on the card: ``all`` the 16 (v, h, k) in turn,
    ``k<n>`` every sample at k = n with the 4 flips in turn; None for the
    identity."""
    if kind == "identity":
        return None
    if kind == "all":
        rows = [(v, h, k) for v in (0, 1) for h in (0, 1) for k in range(4)]
    else:
        rows = [(v, h, int(kind[1])) for v in (0, 1) for h in (0, 1)]
    return torch.tensor([rows[i % len(rows)] for i in range(batch)], dtype=torch.int32,
                        device="cuda")


def calls(gen: torch.Generator) -> dict:
    """call name -> (img, mask, choices, mean, mul, dtype) on the card."""
    img = torch.randint(0, 256, (BATCH, SIZE, SIZE, CHANNELS), dtype=torch.uint8,
                        device="cuda", generator=gen)
    msk = torch.randint(0, CLASSES + 7, (BATCH, SIZE, SIZE), dtype=torch.uint8, device="cuda",
                        generator=gen)
    cfg = yaml.safe_load(CONFIG.read_text())
    mean, mul = (torch.from_numpy(a).cuda() for a in au.norm_constants(
        "custom", cfg["norm_means"], cfg["norm_stds"], CHANNELS))
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"train": (img, msk, choices("all"), mean, mul, bf16),
           "identity": (img, msk, None, mean, mul, bf16),
           "no_mask": (img, None, None, mean, mul, bf16),
           "f32": (img, msk, choices("all"), mean, mul, f32)}
    out.update({f"k{k}": (img, msk, choices(f"k{k}"), mean, mul, bf16) for k in range(4)})
    return out


def call_bytes(img, mask, dtype) -> int:
    """Each input read once and each output written once."""
    out = img.numel() * (4 if dtype == torch.float32 else 2)
    return img.numel() + out + (5 * mask.numel() if mask is not None else 0)


def build(out: Path, baseline: Path | None) -> dict:
    """source name -> (ctypes library, ptxas's numbers by kernel)."""
    base = (_build.CSRC / "augment_normalize.cu").read_text()
    jobs = {}
    for name, edits in SOURCES.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"augment_normalize.cu no longer has the anchor {old[:40]!r}")
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
            raise RuntimeError(f"nvcc failed for the {name} source:\n{proc.stdout}{proc.stderr}")
        info, fn = {}, None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '\w*?((?:tiled|general|augment_normalize)"
                          r"_kernel)ILb([01])E", line)
            if m:
                fn = f"{m.group(1)}<{'f32' if m.group(2) == '1' else 'bf16'}>"
            elif fn and "Used" in line and "registers" in line:
                smem = re.search(r"(\d+) bytes smem", line)
                info.setdefault(fn, {}).update(
                    registers=int(line.split("Used ")[1].split()[0]),
                    static_smem=int(smem.group(1)) if smem else 0)
            elif fn and "spill" in line:
                spills = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
                info.setdefault(fn, {})["spill_bytes"] = sum(spills)
        return name, (ctypes.CDLL(str(lib)), info)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


def runner(lib: ctypes.CDLL, args: tuple, instance: str | None):
    """A function that launches ``lib``'s entry point once on ``args`` into
    preallocated outputs (``instance`` None: the earlier interface), and the
    outputs."""
    img, mask, ch, mean, mul, dtype = args
    fn = _build.bind(lib, "augment_normalize", OLD_ARGTYPES if instance is None else au.ARGTYPES)
    B, H, W, C = img.shape
    x = torch.empty((B, H, W, C), dtype=dtype, device="cuda")
    tgt = torch.empty((B, H, W), dtype=torch.int32, device="cuda") if mask is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    argv = [ptr(img), ptr(mask), ptr(ch), ptr(mean), ptr(mul), ptr(x), ptr(tgt), B, H, W, C,
            CLASSES, int(dtype == torch.float32), _build.stream_handle(img)]
    if instance is not None:
        argv.append(au.INSTANCES[instance])

    def run():
        _build.check(fn(*argv), "augment_normalize")

    return run, (x, tgt)


def reference(call: str) -> str:
    """The variant that runs the full source's tiled instance on ``call``."""
    return "full" if call == "train" else call


def same(a: tuple, b: tuple) -> bool:
    return all((u is None and v is None) or (u is not None and v is not None
                                             and torch.equal(u, v)) for u, v in zip(a, b))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier augment_normalize.cu with the "
                    "entry point's earlier interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("augment_normalize_phases: needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    inputs = calls(gen)
    bound_ms = {name: call_bytes(a[0], a[1], a[5]) / PEAK_BYTES_PER_S * 1e3
                for name, a in inputs.items()}
    with tempfile.TemporaryDirectory(prefix="augment_normalize_phases_") as tmp:
        built = build(Path(tmp), args.baseline)
        runs = {name: runner(built[src][0], inputs[call], instance)
                for name, (src, call, instance) in VARIANTS.items()}
        if args.baseline:
            runs.update({f"baseline {call}": runner(built["baseline"][0], inputs[call], None)
                         for call in BASELINE_CALLS})
        for run, _ in runs.values():
            run()
        torch.cuda.synchronize()
        differ = [name for name, (_, call, _) in VARIANTS.items()
                  if not name.startswith("copy_only")
                  and not same(runs[name][1], runs[reference(call)][1])]
        plain_differ = [reference(call) for call, a in inputs.items() if not same(
            runs[reference(call)][1], au.augment_normalize_plain(*a[:5], CLASSES, a[5]))]
        baseline_equal = {name: same(runs[name][1], runs[reference(name.split()[1])][1])
                          for name in runs if name.startswith("baseline")}
        # the card's own device-to-device copy of as many bytes read and written
        nbytes = call_bytes(*[inputs["train"][i] for i in (0, 1, 5)])
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        runs["library_copy"] = (lambda: dst.copy_(src), None)
        names = list(runs)
        ms = dict.fromkeys(names, 0.0)
        for name in names + names[::-1]:
            ms[name] += device_ms(runs[name][0]) / 2
        ptxas = {name: info for name, (_, info) in built.items()}
    grids = {}
    for name, (_, call, instance) in VARIANTS.items():
        img, mask, _, _, _, dtype = inputs[call]
        plan = au.launch_plan(*img.shape, dtype, mask is not None, True)
        if instance == "general":
            plan = au.launch_plan(*img.shape, dtype, mask is not None, False)
        grids[name] = {"instance": plan.instance, "grid": plan.grid, "threads": plan.threads,
                       "smem_bytes": plan.smem_bytes}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"augment_normalize_phases_ms": ms, "bound_ms": bound_ms,
                      "variant_call": {n: v[1] for n, v in VARIANTS.items()}, "grids": grids,
                      "ptxas": ptxas, "baseline_equal": baseline_equal,
                      "differ_from_full": differ, "full_differs_from_plain": plain_differ,
                      "card": card}))
    if differ or plain_differ:
        raise SystemExit(f"augment_normalize_phases: variants that should give full's bits "
                         f"differ: {differ}; calls where full differs from plain: "
                         f"{plain_differ}")


if __name__ == "__main__":
    main()
