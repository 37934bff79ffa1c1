"""Where the time of the weighted_ce kernels goes, on the card.

    python -m flairtpu_torch.ops.weighted_ce_phases [--baseline OLD_SOURCE]

Times weighted_ce's forward (with the confusion matrix, and without it:
``forward_no_counts``) and backward at one train step's logits (batch 16,
512 x 512, 19 classes, float32) by device time (``bn_train_phases.
device_ms``: the queue filled behind a sleep kernel first), on two inputs
(:func:`inputs`): uniform random logits and targets, and coherent ones
(64 x 64 one-class target blocks and logits whose first maximum is the
target on about 90% of pixels, like a trained model's). Builds variants of
``csrc/weighted_ce.cu`` and times them in turns (the variants, then the
same reversed):

- ``full``: the kernels as built;
- ``no_ring``: a ring of one stage, so no copy is in flight while a tile
  is computed (what the ring's overlap gains);
- ``warp_uniform``: the confusion counts aggregated where a warp's 32
  pixels share one key (one shared atomic adds 32; other warps one a
  pixel); ``match_any``: the lanes of every warp grouped by key with
  ``__match_any_sync``, a shared atomic a distinct key (``full`` adds one
  a pixel);
- ``forward_stages_2``, ``forward_stages_4``, ``backward_stages_4``: rings
  of another depth (a stage more is fewer blocks an SM).

Every variant must give ``full``'s bits (loss, weight sum, confusion
matrix and gradient; checked). ``--baseline`` also times an earlier source
with the same C interface, given its own scratch and grid (a grid-stride
walk over at most 1056 blocks and a finalize launch: ``git show
c3e6018:flairtpu_torch/csrc/weighted_ce.cu``). Prints one JSON line: each
variant's ms by input and entry point, the bounds (bytes at 3.35 TB/s),
ptxas's registers and shared memory for each kernel, the grids, and the
card's name and power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

from flairtpu_torch.ops import _build
from flairtpu_torch.ops import weighted_ce as wc
from flairtpu_torch.ops.bn_train_phases import device_ms, same_bits

BATCH, SIZE, CLASSES = 16, 512, 19
BLOCK = 64  # side of the coherent input's one-class target blocks
HIT_SHARE = 0.9  # pixels whose logits favour their target in the coherent input
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
ENTRIES = {"weighted_ce_forward": wc.FORWARD_ARGTYPES,
           "weighted_ce_backward": wc.BACKWARD_ARGTYPES,
           "weighted_ce_occupancy": wc.OCCUPANCY_ARGTYPES}
OLD_MAX_BLOCKS = 1056  # the earlier wrapper's cap: 8 blocks of 256 on each of 132 SMs

COUNTS = "  if (key >= 0) atomicAdd(&s_cm[key], 1);\n"
WARP_UNIFORM_COUNTS = (
    "  const int first = __shfl_sync(0xffffffffu, key, 0);\n"
    "  if (__all_sync(0xffffffffu, key == first)) {\n"
    "    if ((threadIdx.x & 31) == 0 && first >= 0) atomicAdd(&s_cm[first], 32);\n"
    "  } else if (key >= 0) {\n"
    "    atomicAdd(&s_cm[key], 1);\n"
    "  }\n")
MATCH_ANY_COUNTS = (
    "  const unsigned peers = __match_any_sync(0xffffffffu, key);\n"
    "  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)\n"
    "    atomicAdd(&s_cm[key], __popc(peers));\n")
FORWARD_STAGES = "constexpr int kForwardStages = 3;"
BACKWARD_STAGES = "constexpr int kBackwardStages = 3;"


def stages(anchor: str, n: int) -> tuple[str, str]:
    return anchor, anchor.replace("3;", f"{n};")


VARIANTS = {
    "full": [],
    "no_ring": [stages(FORWARD_STAGES, 1), stages(BACKWARD_STAGES, 1)],
    "warp_uniform": [(COUNTS, WARP_UNIFORM_COUNTS)],
    "match_any": [(COUNTS, MATCH_ANY_COUNTS)],
    "forward_stages_2": [stages(FORWARD_STAGES, 2)],
    "forward_stages_4": [stages(FORWARD_STAGES, 4)],
    "backward_stages_4": [stages(BACKWARD_STAGES, 4)],
}


def inputs(kind: str, gen: torch.Generator, batch: int = BATCH, size: int = SIZE,
           k: int = CLASSES) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits (B, S, S, K) float32, targets (B, S, S) int32) on the card:
    ``random``: logits N(0, 9) and uniform, independent targets;
    ``coherent``: targets constant over BLOCK x BLOCK blocks (as chip_smoke's
    phase 4 writes its masks) and N(0, 1) logits with 6 added to the
    target's on HIT_SHARE of the pixels, so the first maximum is the target
    on about 90% of them."""
    dev = "cuda"
    if kind == "random":
        logits = torch.randn((batch, size, size, k), device=dev, generator=gen) * 3
        tgt = torch.randint(0, k, (batch, size, size), dtype=torch.int32, device=dev,
                            generator=gen)
        return logits, tgt
    if kind != "coherent":
        raise ValueError(f"weighted_ce_phases: no input {kind!r}")
    blocks = torch.randint(0, k, (batch, size // BLOCK, size // BLOCK), dtype=torch.int32,
                           device=dev, generator=gen)
    tgt = blocks.repeat_interleave(BLOCK, 1).repeat_interleave(BLOCK, 2).contiguous()
    logits = torch.randn((batch, size, size, k), device=dev, generator=gen)
    hit = torch.rand((batch, size, size), device=dev, generator=gen) < HIT_SHARE
    logits.scatter_add_(-1, tgt.long()[..., None], 6.0 * hit[..., None].float())
    return logits, tgt


def class_weights(k: int = CLASSES) -> torch.Tensor:
    """configs/flair-1-config.yaml's: 0 for classes 15-17 and 19 (1-based)."""
    return torch.tensor([0.0 if c in (14, 15, 16, 18) else 1.0 for c in range(k)],
                        device="cuda")


def calls(logits, tgt, w, fns=None) -> dict:
    """The forward with and without the confusion matrix and the backward
    (through ``fns`` = (forward, backward), default the port's wrappers)."""
    forward, backward = fns or (wc.weighted_ce, wc.weighted_ce_grad)
    k = logits.shape[-1]
    cm = torch.zeros((k, k), dtype=torch.int32, device=logits.device)
    _, ws = forward(logits, tgt, w, cm)
    g = torch.tensor(0.5, device=logits.device)
    return {"forward": lambda: forward(logits, tgt, w, cm),
            "forward_no_counts": lambda: forward(logits, tgt, w, None),
            "backward": lambda: backward(logits, tgt, w, ws, g)}


def outputs(logits, tgt, w, fns=None) -> tuple:
    """Loss, weight sum, a fresh confusion matrix and the gradient of one
    forward and one backward call."""
    forward, backward = fns or (wc.weighted_ce, wc.weighted_ce_grad)
    k = logits.shape[-1]
    cm = torch.zeros((k, k), dtype=torch.int32, device=logits.device)
    loss, ws = forward(logits, tgt, w, cm)
    d = backward(logits, tgt, w, ws, torch.tensor(0.5, device=logits.device))
    return loss.clone(), ws.clone(), cm, d


def compare(got: tuple, want: tuple) -> dict:
    """An earlier source's outputs against ``full``'s."""
    return {"loss_rel": abs(got[0].item() - want[0].item()) / abs(want[0].item()),
            "weight_sum_equal": got[1].item() == want[1].item(),
            "confmat_equal": torch.equal(got[2], want[2]),
            "dlogits_max_abs": (got[3] - want[3]).abs().max().item()}


def build_variants(out: Path, baseline: Path | None) -> dict:
    base = (_build.CSRC / "weighted_ce.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"weighted_ce.cu no longer has the anchor {old[:40]!r}")
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
        info, fn = {}, None
        for line in (proc.stdout + proc.stderr).splitlines():
            m = re.search(r"Compiling entry function '\w*?(weighted_ce_\w+?)(?:ILb([01])E)?E", line)
            if m:
                fn = {"0": "forward", "1": "backward"}.get(m.group(2), m.group(1))
            elif fn and "Used" in line and "registers" in line:
                smem = re.search(r"(\d+) bytes smem", line)
                info[fn] = {"registers": int(line.split("Used ")[1].split()[0]),
                            "static_smem": int(smem.group(1)) if smem else 0}
        return name, (ctypes.CDLL(str(lib)), info)

    with ThreadPoolExecutor(len(jobs)) as pool:
        return dict(pool.map(one, jobs.items()))


@contextmanager
def variant(lib: ctypes.CDLL, co_resident: dict):
    """weighted_ce's wrappers bound to ``lib`` and its occupancy cache."""
    saved = (dict(_build._ENTRIES), wc._CO_RESIDENT)
    for symbol, argtypes in ENTRIES.items():
        _build._ENTRIES[symbol] = _build.bind(lib, symbol, argtypes)
    wc._CO_RESIDENT = co_resident
    try:
        yield
    finally:
        _build._ENTRIES.clear()
        _build._ENTRIES.update(saved[0])
        wc._CO_RESIDENT = saved[1]


def baseline_fns(lib: ctypes.CDLL) -> tuple:
    """(forward, backward) through the earlier source's C interface: its own
    float32 partials and grid (ceil(n / 256), at most OLD_MAX_BLOCKS)."""
    fwd = _build.bind(lib, "weighted_ce_forward", wc.FORWARD_ARGTYPES)
    bwd = _build.bind(lib, "weighted_ce_backward", wc.BACKWARD_ARGTYPES)

    def blocks(n):
        return max(1, min(-(-n // wc.THREADS), OLD_MAX_BLOCKS))

    def forward(logits, tgt, w, cm):
        n, k = tgt.numel(), logits.shape[-1]
        partials = torch.empty(2 * blocks(n), dtype=torch.float32, device=logits.device)
        out = torch.empty(2, dtype=torch.float32, device=logits.device)
        _build.check(fwd(logits.data_ptr(), tgt.data_ptr(), w.data_ptr(),
                         None if cm is None else cm.data_ptr(), partials.data_ptr(), blocks(n),
                         out.data_ptr(), n, k, _build.stream_handle(logits)), "baseline forward")
        return out[0], out[1]

    def backward(logits, tgt, w, ws, g):
        n, k = tgt.numel(), logits.shape[-1]
        d = torch.empty_like(logits)
        g = g.float().reshape(1).contiguous()
        _build.check(bwd(logits.data_ptr(), tgt.data_ptr(), w.data_ptr(), ws.data_ptr(),
                         g.data_ptr(), d.data_ptr(), blocks(n), n, k,
                         _build.stream_handle(logits)), "baseline backward")
        return d

    return forward, backward


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", type=Path, help="an earlier weighted_ce.cu with the same C "
                    "interface, timed beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("weighted_ce_phases: needs a CUDA card")
    gen = torch.Generator("cuda").manual_seed(0)
    w = class_weights()
    n = BATCH * SIZE * SIZE
    bound_ms = {"forward": (4 * n * CLASSES + 4 * n) / PEAK_BYTES_PER_S * 1e3,
                "backward": (8 * n * CLASSES + 4 * n) / PEAK_BYTES_PER_S * 1e3}
    with tempfile.TemporaryDirectory(prefix="weighted_ce_phases_") as tmp:
        built = build_variants(Path(tmp), args.baseline)
        caches = {name: {} for name in built}
        names = list(VARIANTS) + (["baseline"] if args.baseline else [])
        order = names + names[::-1]
        ms = {name: {} for name in names}
        grids, differ, baseline_err = {}, [], {}
        with torch.inference_mode():
            for kind in ("random", "coherent"):
                logits, tgt = inputs(kind, gen)
                want = None
                for turn, name in enumerate(order):
                    lib = built[name][0]
                    with (nullcontext() if name == "baseline" else variant(lib, caches[name])):
                        fns = baseline_fns(lib) if name == "baseline" else None
                        if turn < len(names):
                            got = outputs(logits, tgt, w, fns)
                            if name == "full":
                                want = got
                            elif name == "baseline":
                                baseline_err[kind] = compare(got, want)
                            elif not same_bits(got, want):
                                differ.append((name, kind))
                            if name != "baseline":
                                grids[name] = {m: wc.launch_plan(n, CLASSES, m, wc._co_resident(
                                    logits.device, m, CLASSES)).grid
                                    for m in ("forward", "backward")}
                        for mode, fn in calls(logits, tgt, w, fns).items():
                            key = f"{kind} {mode}"
                            ms[name][key] = ms[name].get(key, 0.0) + device_ms(fn) / 2
                del logits, tgt
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(json.dumps({"weighted_ce_phases_ms": ms, "bound_ms": bound_ms, "grids": grids,
                      "ptxas": {name: info for name, (_, info) in built.items()},
                      "baseline_vs_full": baseline_err, "differ_from_full": differ,
                      "card": card}))
    if differ:
        raise SystemExit(f"weighted_ce_phases: variants that should give full's bits differ: "
                         f"{differ}")


if __name__ == "__main__":
    main()
