"""Where the time of the squeeze-excite kernels goes, on the card.

    python -m flairtpu_torch.ops.se_gate_phases [--encoder efficientnet-b4] [--batch 128]
        [--baseline OLD.cu]

Builds variants of ``csrc/se_gate.cu`` and times ``se_squeeze`` at every
squeeze-excite site of the encoder on 512 tiles (the depthwise output of
each block: random bf16 maps, the batch's shapes), in turns: the variants,
then the same reversed, at each site. The variants:

- ``full``: the kernel as built (4 loads in flight a thread, the sigmoid on
  the special-function units with half its reciprocals by Newton steps,
  the grid of the card's co-resident blocks, registers for 3 blocks an
  SM, the loads marked as read once, not kept in L1);
- ``unroll_1``, ``unroll_2``, ``unroll_8``: 1, 2 or 8 loads in flight a
  thread (``kSqueezeUnroll``; at 8, registers for 2 blocks an SM);
- ``min_blocks_4``: registers capped for 4 blocks an SM
  (``kSqueezeMinBlocks``; the kernel spills there);
- ``l2_256b``, ``ldg``: the loads with the L2 also asked to fetch the
  256 bytes around each, or without the read-once mark;
- ``sfu_only``, ``newton_2``, ``newton_6``, ``newton_8``: of each 8
  channels, 0, 2, 6 or 8 (``full``: 4) take the sigmoid's reciprocal by
  Newton steps on the FMA pipe (``kNewtonRcp``), so the SFU does 2 to 1
  operations an element (``full``: 1.5);
- ``blocks_x2``, ``blocks_half``: the grid twice or half the co-resident
  blocks (a thread sums half or twice the pixels);
- ``no_sigmoid``: the BatchNorm's value in place of the SiLU (a wrong
  result): what the sigmoid costs;
- ``copy_only``: the bf16 value itself (a wrong result): the loads and the
  reduction alone;
- ``baseline``, with ``--baseline``: an earlier source through the same C
  interface, at the grid of the first squeeze design (two waves at an
  assumed 8 blocks an SM), e.g. ``git show
  69ad6d3:flairtpu_torch/csrc/se_gate.cu``.

Every variant that computes the whole result is held to the plain version
(within 1e-5 of the largest mean), ``full`` also to itself (two runs, the
same bits). ``se_excite`` (not redesigned) and ``torch.mean`` over each map
are timed beside. Prints one JSON line: each variant's ms summed over the
sites, by the map's side and at the largest site, its registers a thread
(ptxas) and blocks an SM (the CUDA runtime's occupancy); the bytes bound (each input read once,
each output written once, at 3.35 TB/s); the SFU floor (``full``'s 1.5
SFU operations an element, and 2 without the Newton reciprocals, at 16 a
clock an SM, at the SM clock measured by a spin of ``torch.cuda._sleep``);
the card's name and power limit. Needs a CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import tempfile
from pathlib import Path

import torch

from flairtpu_torch.models.efficientnet import efficientnet_plan
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import se_gate as sg

PEAK_BYTES_PER_S = 3.35e12
SFU_PER_CLOCK = 16  # results a clock an SM (sm_90: ex2, rcp)
SFU_PER_ELEMENT = {"full": 1.5, "sfu_only": 2.0}
REL_TOL = 1e-5
UNROLL = "constexpr int kSqueezeUnroll = 4;"
MIN_BLOCKS = "constexpr int kSqueezeMinBlocks = 3;"
NEWTON = "constexpr int kNewtonRcp = 4;"
FAST = "  return fmaf(v, rcp_approx(1.f + ex2_approx(v * kNegLog2e)), acc);"
LOAD = "ld.global.nc.L1::no_allocate.v4.u32"
EDITS = {
    "full": [],
    "unroll_1": [(UNROLL, "constexpr int kSqueezeUnroll = 1;")],
    "unroll_2": [(UNROLL, "constexpr int kSqueezeUnroll = 2;")],
    "unroll_8": [(UNROLL, "constexpr int kSqueezeUnroll = 8;"),
                 (MIN_BLOCKS, "constexpr int kSqueezeMinBlocks = 2;")],
    "min_blocks_4": [(MIN_BLOCKS, "constexpr int kSqueezeMinBlocks = 4;")],
    "l2_256b": [(LOAD, "ld.global.nc.L1::no_allocate.L2::256B.v4.u32")],
    "ldg": [(LOAD, "ld.global.nc.v4.u32")],
    "sfu_only": [(NEWTON, "constexpr int kNewtonRcp = 0;")],
    "newton_2": [(NEWTON, "constexpr int kNewtonRcp = 2;")],
    "newton_6": [(NEWTON, "constexpr int kNewtonRcp = 6;")],
    "newton_8": [(NEWTON, "constexpr int kNewtonRcp = 8;")],
    "no_sigmoid": [(FAST, "  return acc + v;")],
    "copy_only": [(FAST, "  return acc + y;")],
}
# variants of the grid on the full build: the factor on the co-resident blocks
GRIDS = {"blocks_x2": 2.0, "blocks_half": 0.5}
WRONG = ("no_sigmoid", "copy_only")
# appended to a baseline source that lacks the entry point
OCCUPANCY = """
extern "C" int se_squeeze_occupancy(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, se_squeeze_kernel, 256, 0);
}
"""


def sites(encoder: str, batch: int, size: int = 512) -> list[tuple]:
    """(B, C, H, W) of each squeeze-excite site of ``encoder`` on size² tiles."""
    side, out = size // 2, []
    for b in efficientnet_plan(encoder)["blocks"]:
        side //= b["stride"]
        out.append((batch, b["cin"] * b["expand"], side, side))
    return out


def baseline_plan(batch: int, hw: int, channels: int, sms: int) -> tuple[int, int, int]:
    """The first squeeze design's grid: (group_tile, tiles, n_split), two
    waves at an assumed 8 blocks an SM."""
    c8 = channels // 8
    gt = max(d for d in range(1, 33) if c8 % d == 0)
    tiles = c8 // gt
    want = -(-2 * sms * 8 // (tiles * batch))
    return gt, tiles, max(1, min(want, hw // (sg.THREADS // gt * sg.MIN_PIXELS), 65535))


def sources(baseline: Path | None) -> dict[str, str]:
    """Each variant's source text."""
    src = (_build.CSRC / "se_gate.cu").read_text()
    out = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"se_gate_phases: {name}: {old!r} is not once in se_gate.cu")
            text = text.replace(old, new)
        out[name] = text
    if baseline is not None:
        text = baseline.read_text()
        out["baseline"] = text if "se_squeeze_occupancy" in text else text + OCCUPANCY
    return out


def squeeze_registers(log: str) -> str | None:
    """ptxas's spill and register lines for the squeeze kernel, from
    ``-v``'s log."""
    m = re.search(r"se_squeeze_kernel.*\n(?:.*\n)*?\s*(\d+ bytes stack.*)\n.*?(Used \d+ "
                  r"registers)", log)
    return f"{m.group(2)}; {m.group(1)}" if m else None


def build(tmp: Path, texts: dict[str, str]) -> tuple[dict, dict, dict]:
    """Each variant's (squeeze, excite) C entry points, its squeeze's
    registers and its blocks an SM."""
    procs = {}
    for name, text in texts.items():
        cu, so = tmp / f"se_gate_{name}.cu", tmp / f"libse_gate_{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs, per_sm = {}, {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        regs[name] = squeeze_registers(log)
        lib = ctypes.CDLL(str(so))
        fns[name] = (_build.bind(lib, "se_squeeze", sg.SQUEEZE_ARGTYPES),
                     _build.bind(lib, "se_excite", sg.EXCITE_ARGTYPES))
        n = ctypes.c_int(0)
        _build.check(_build.bind(lib, "se_squeeze_occupancy", sg.OCCUPANCY_ARGTYPES)(
            ctypes.byref(n)), f"{name} occupancy")
        per_sm[name] = n.value
    return fns, regs, per_sm


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_hz() -> float:
    """The SM clock, from a spin of 2e7 cycles timed by events."""
    cycles = 20_000_000
    torch.cuda._sleep(cycles // 10)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / (start.elapsed_time(end) * 1e-3)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="efficientnet-b4")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--baseline", type=Path, help="an earlier se_gate.cu, timed as 'baseline'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("se_gate_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="se_gate_phases_") as tmp:
        fns, regs, per_sm = build(Path(tmp), sources(args.baseline))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator("cuda").manual_seed(23)
        names = [*EDITS, *GRIDS, *(["baseline"] if "baseline" in fns else [])]
        order = names + names[::-1]
        ms = dict.fromkeys(names, 0.0)
        largest = dict.fromkeys(names, 0.0)
        worst = dict.fromkeys(names, 0.0)
        extra = {"excite_ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0}
        # ms by the map's side: each variant's, torch.mean's and the bound's
        by_side = {name: {} for name in [*names, "library", "bound"]}
        bound = {"squeeze": 0.0, "excite": 0.0}
        elements, deterministic = 0, True
        shapes = sites(args.encoder, args.batch)
        big = max(shapes, key=lambda s: s[1] * s[2] * s[3])
        for shape in shapes:
            B, C, H, W = shape
            hw = H * W
            y = (torch.randn(shape, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            y = y.contiguous(memory_format=torch.channels_last)
            scale = torch.rand(C, generator=gen, device="cuda") + 0.5
            shift = torch.randn(C, generator=gen, device="cuda") * 0.5
            gate = torch.sigmoid(torch.randn((B, C), generator=gen, device="cuda"))
            stream = _build.stream_handle(y)
            want = sg.se_squeeze_plain(y, scale, shift)
            out = torch.empty_like(y)
            n = y.numel()
            elements += n
            bound["squeeze"] += (2 * n + 8 * C + 4 * B * C) / PEAK_BYTES_PER_S * 1e3
            bound["excite"] += (4 * n + 8 * C + 4 * B * C) / PEAK_BYTES_PER_S * 1e3
            launch = {}
            for name in names:
                squeeze = fns["full" if name in GRIDS else name][0]
                if name == "baseline":
                    gt, tiles, blocks = baseline_plan(B, hw, C, sms)
                    size = B * blocks * C
                else:
                    co = sms * per_sm["full" if name in GRIDS else name]
                    co = max(1, int(co * GRIDS.get(name, 1.0)))
                    gt, tiles, blocks, size = sg.squeeze_plan(B, hw, C, co)
                partial = torch.empty(size, device="cuda")
                tickets = torch.zeros(B * tiles, dtype=torch.int32, device="cuda")
                mean = torch.empty((B, C), device="cuda")

                def run(squeeze=squeeze, partial=partial, tickets=tickets, mean=mean, gt=gt,
                        blocks=blocks):
                    _build.check(squeeze(y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                         partial.data_ptr(), tickets.data_ptr(), mean.data_ptr(),
                                         B, hw, C, gt, blocks, stream), "se_squeeze")
                    return mean

                launch[name] = run
                if name not in WRONG:
                    got = run().clone()
                    rel = ((got - want).abs().max() / want.abs().max()).item()
                    worst[name] = max(worst[name], rel)
                    if rel > REL_TOL:
                        raise SystemExit(f"se_gate_phases: {name} at {shape}: squeeze {rel:.2e}")
                    if name == "full":
                        deterministic &= torch.equal(run(), got)
            excite = fns["full"][1]

            def run_excite():
                _build.check(excite(y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                    gate.data_ptr(), out.data_ptr(), B, hw, C, stream),
                             "se_excite")

            run_excite()
            if not torch.equal(out, sg.se_excite_plain(y, scale, shift, gate)):
                raise SystemExit(f"se_gate_phases: se_excite at {shape} is not bit for bit")
            for name in order:
                t = device_ms(launch[name]) / 2
                ms[name] += t
                by_side[name][H] = by_side[name].get(H, 0.0) + t
                if shape == big:
                    largest[name] += t
            extra["excite_ms"] += device_ms(run_excite)
            t = device_ms(lambda: torch.mean(y, dim=(2, 3)))
            extra["library_ms"] += t
            by_side["library"][H] = by_side["library"].get(H, 0.0) + t
            by_side["bound"][H] = by_side["bound"].get(H, 0.0) + (
                2 * n + 8 * C + 4 * B * C) / PEAK_BYTES_PER_S * 1e3
            extra["plain_ms"] += device_ms(lambda: sg.se_squeeze_plain(y, scale, shift), 3, 1)
            del y, out, want, launch
            torch.cuda.empty_cache()
        clock = sm_clock_hz()
    sfu_ms = {name: k * elements / (SFU_PER_CLOCK * sms * clock) * 1e3
              for name, k in SFU_PER_ELEMENT.items()}
    variants = {}
    for name in names:
        build_of = "full" if name in GRIDS else name
        variants[name] = {
            "ms": ms[name], "largest_site_ms": largest[name],
            "share_of_bound": bound["squeeze"] / ms[name], "ptxas": regs[build_of],
            "blocks_per_sm": per_sm[build_of],
            # the blocks an SM the plan launches at a large map
            "plan_blocks_per_sm": 2 * 8 if name == "baseline" else per_sm[build_of] * GRIDS.get(
                name, 1.0),
            "max_rel_err": None if name in WRONG else worst[name]}
    print(json.dumps({"encoder": args.encoder, "batch": args.batch, "sites": len(shapes),
                      "largest_site": big, "squeeze": variants, "ms_by_side": by_side,
                      "full_deterministic":
                      deterministic, "bound_ms": bound, "sfu_floor_ms": sfu_ms,
                      "sm_clock_mhz": clock / 1e6, **extra, "card": card}))


if __name__ == "__main__":
    main()
