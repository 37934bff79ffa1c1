"""Where the time of the squeeze-excite kernels goes, on the card.

    python -m flairtpu_torch.ops.se_gate_phases [--encoder efficientnet-b4] [--batch 128]

Builds variants of ``csrc/se_gate.cu`` and times ``se_squeeze`` and
``se_excite`` at every squeeze-excite site of the encoder on 512 tiles (the
depthwise output of each block: random bf16 maps, the batch's shapes), in
turns: the variants, then the same reversed, at each site. The variants:

- ``full``: the kernels as built;
- ``unroll_1``, ``unroll_4``: 1 or 4 loads in flight a thread (``kUnroll``);
- ``reciprocal``: the sigmoid's ``1 / x`` as ``__frcp_rn`` (the same bits
  as the rounded divide);
- ``no_sigmoid``: the BatchNorm's value in place of the SiLU (a wrong
  result): what the accurate ``expf`` and divide cost;
- ``copy_only``: the bf16 value itself (a wrong result): the loads, the
  stores and the reduction alone.

Every variant that computes the whole result is held to the plain version
(the excite bit for bit, the squeeze within 1e-5 of the largest mean).
Prints one JSON line: each variant's ms summed over the sites, the largest
site's, the bytes bound (each input read once, each output written once,
at 3.35 TB/s), the registers a thread (ptxas), and the card's name and
power limit. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from flairtpu_torch.models.efficientnet import efficientnet_plan
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import se_gate as sg

PEAK_BYTES_PER_S = 3.35e12
SILU = "return __fmul_rn(v, __fdiv_rn(1.f, __fadd_rn(1.f, expf(-v))));"
UNROLL = "constexpr int kUnroll = 2;"
EDITS = {
    "full": [],
    "unroll_1": [(UNROLL, "constexpr int kUnroll = 1;")],
    "unroll_4": [(UNROLL, "constexpr int kUnroll = 4;")],
    "reciprocal": [(SILU, "return __fmul_rn(v, __frcp_rn(__fadd_rn(1.f, expf(-v))));")],
    "no_sigmoid": [(SILU, "return v;")],
    "copy_only": [(SILU, "return y;")],
}
EXACT = ("full", "unroll_1", "unroll_4", "reciprocal")


def sites(encoder: str, batch: int, size: int = 512) -> list[tuple]:
    """(B, C, H, W) of each squeeze-excite site of ``encoder`` on size² tiles."""
    side, out = size // 2, []
    for b in efficientnet_plan(encoder)["blocks"]:
        side //= b["stride"]
        out.append((batch, b["cin"] * b["expand"], side, side))
    return out


def build(tmp: Path) -> tuple[dict, dict]:
    """Each variant's (squeeze, excite) C entry points, and ptxas's lines."""
    src = (_build.CSRC / "se_gate.cu").read_text()
    procs = {}
    for name, edits in EDITS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"se_gate_phases: {name}: {old!r} is not in se_gate.cu")
            text = text.replace(old, new)
        cu, so = tmp / f"se_gate_{name}.cu", tmp / f"libse_gate_{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, regs = {}, {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        regs[name] = [line.split("Used", 1)[1].strip() for line in log.splitlines()
                      if "Used" in line]
        lib = ctypes.CDLL(str(so))
        fns[name] = (_build.bind(lib, "se_squeeze", sg.SQUEEZE_ARGTYPES),
                     _build.bind(lib, "se_excite", sg.EXCITE_ARGTYPES))
    return fns, regs


def device_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--encoder", default="efficientnet-b4")
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("se_gate_phases: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory(prefix="se_gate_phases_") as tmp:
        fns, regs = build(Path(tmp))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        gen = torch.Generator("cuda").manual_seed(22)
        order = list(EDITS) + list(reversed(EDITS))
        ms = {name: {"squeeze": 0.0, "excite": 0.0} for name in EDITS}
        largest = {}
        bound = {"squeeze": 0.0, "excite": 0.0}
        shapes = sites(args.encoder, args.batch)
        big = max(shapes, key=lambda s: s[1] * s[2] * s[3])
        for shape in shapes:
            B, C, H, W = shape
            y = (torch.randn(shape, generator=gen, device="cuda") * 3).to(torch.bfloat16)
            y = y.contiguous(memory_format=torch.channels_last)
            scale = torch.rand(C, generator=gen, device="cuda") + 0.5
            shift = torch.randn(C, generator=gen, device="cuda") * 0.5
            gate = torch.sigmoid(torch.randn((B, C), generator=gen, device="cuda"))
            plan = sg.squeeze_plan(B, H * W, C, sms)
            partial = torch.empty((B, plan.n_split, C), device="cuda")
            tickets = torch.empty((B, plan.tiles), dtype=torch.int32, device="cuda")
            mean, out = torch.empty((B, C), device="cuda"), torch.empty_like(y)
            stream = _build.stream_handle(y)
            want_mean = sg.se_squeeze_plain(y, scale, shift)
            want = sg.se_excite_plain(y, scale, shift, gate)
            n = y.numel()
            bound["squeeze"] += (2 * n + 8 * C + 4 * B * C) / PEAK_BYTES_PER_S * 1e3
            bound["excite"] += (4 * n + 8 * C + 4 * B * C) / PEAK_BYTES_PER_S * 1e3
            for k, name in enumerate(order):
                squeeze, excite = fns[name]

                def run_squeeze():
                    _build.check(squeeze(y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                         partial.data_ptr(), tickets.data_ptr(),
                                         mean.data_ptr(), B, H * W, C, plan.group_tile,
                                         plan.n_split, stream), "se_squeeze")

                def run_excite():
                    _build.check(excite(y.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                                        gate.data_ptr(), out.data_ptr(), B, H * W, C, stream),
                                 "se_excite")

                if k < len(EDITS) and name in EXACT:
                    run_squeeze()
                    run_excite()
                    torch.cuda.synchronize()
                    rel = ((mean - want_mean).abs().max() / want_mean.abs().max()).item()
                    if rel > 1e-5 or not torch.equal(out, want):
                        raise SystemExit(f"se_gate_phases: {name} at {shape}: squeeze {rel:.2e}"
                                         f", excite equal {torch.equal(out, want)}")
                t_sq, t_ex = device_ms(run_squeeze) / 2, device_ms(run_excite) / 2
                ms[name]["squeeze"] += t_sq
                ms[name]["excite"] += t_ex
                if shape == big:
                    entry = largest.setdefault(name, {"squeeze": 0.0, "excite": 0.0})
                    entry["squeeze"] += t_sq
                    entry["excite"] += t_ex
            del y, out, want, partial
            torch.cuda.empty_cache()
    print(json.dumps({"encoder": args.encoder, "batch": args.batch, "sites": len(shapes),
                      "ms": ms, "largest_site": {"shape": big, "ms": largest},
                      "bound_ms": bound, "registers": regs, "card": card}))


if __name__ == "__main__":
    main()
