"""Where the time of the int8 convolution kernel goes, on the card.

    python -m flairtpu_torch.ops.int8_conv_phases

Builds variants of ``csrc/int8_conv.cu`` that each leave out one part (the
global epilogue, the wgmma, the gathers' loads, the gathers whole, the
weights' TMA loads, the consumers' proxy fence) or change one setting (the
epilogue's register cap; the tile order, with the row tiles of a column
tile side by side; one tile a block instead of the persistent grid), and
times them against the full kernel at the
40 int8 sites of one batch of 128 tiles of resnet34-unet (512 tiles,
``int8_decoder: 2``, ``bn_fold``; random weights, calibrated on random
tiles), in turns: full, variants, variants reversed, full. A variant that
leaves a part out gives wrong outputs; only its time is read, and its
difference to the full kernel is what the part costs with the others
running. Prints one JSON line with each variant's time a batch, by site
group (stem, layer1-4, decoder), ptxas's registers and spills, the count
of some opcodes in the full kernel's SASS (``cuobjdump -sass``: IGMMA is
integer wgmma, UTMALDG a TMA load, LDGSTS a cp.async), and the card's
name and power limit. Needs a CUDA card and nvcc. The gathers' variants
(``no_gather``, ``no_gather_loads``, ``no_weight_tma``) change only the
cp.async instances (in the walk, the stem's); the im2col TMA instances
run whole in them.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops.quantize_act import inverse_scale

SIZE, MARGIN, BATCH, CLASSES = 512, 128, 128, 19

# (text in the kernel source, text that replaces it[, times it occurs]) for
# each guard
_GUARDS = [
    ("    if (n < a.Co) {  // Co is", "    if (n < a.Co && !SKIP_EPILOGUE) {  // Co is"),
    ("        wgmma<BN>(acc, smem_desc<kBK>(",
     "        if (!SKIP_MMA)\n        wgmma<BN>(acc, smem_desc<kBK>("),
    ("ok ? px + e.x : a.x, ok ? VEC : 0);", "ok ? px + e.x : a.x, ok && !SKIP_LOADS ? VEC : 0);"),
    ("      asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");",
     "      if (!SKIP_FENCE) asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: \"memory\");"),
    ("      for (int g = 0; g < kGroups; ++g) {",
     "      for (int g = 0; g < (SKIP_GATHER ? 0 : kGroups); ++g) {"),
    ("        mbar_expect_tx(full, T::kBStage);\n"
     "        tma_load_2d(sb + s * T::kBStage, map, full, kc * kBK, nt * BN);",
     "        if (SKIP_TMA) {\n          mbar_arrive(full);\n        } else {\n"
     "        mbar_expect_tx(full, T::kBStage);\n"
     "        tma_load_2d(sb + s * T::kBStage, map, full, kc * kBK, nt * BN);\n        }"),
    ("    const int mt = tile / a.n_col_tiles, nt = tile - mt * a.n_col_tiles;",
     "    const int n_row_tiles = a.n_tiles / a.n_col_tiles;\n"
     "    const int mt = COLUMN_TILES_OUTER ? tile % n_row_tiles : tile / a.n_col_tiles;\n"
     "    const int nt = COLUMN_TILES_OUTER ? tile / n_row_tiles : tile - mt * a.n_col_tiles;", 3),
    ("  const int grid = (int)(tiles < sms ? tiles : sms);",
     "  const int grid = (int)(tiles < sms || ONE_TILE_A_BLOCK ? tiles : sms);"),
    ("constexpr int kProducerRegs = 40, kDrainRegs = 80, kConsumerRegs = 160, "
     "kConsumerRegsTma = 136;",
     "constexpr int kProducerRegs = PRODUCER_REGS, kDrainRegs = DRAIN_REGS,\n"
     "              kConsumerRegs = CONSUMER_REGS, kConsumerRegsTma = CONSUMER_REGS_TMA;"),
]
_DEFAULTS = {"SKIP_EPILOGUE": "0", "SKIP_MMA": "0", "SKIP_LOADS": "0", "SKIP_GATHER": "0",
             "SKIP_TMA": "0", "SKIP_FENCE": "0",
             "PRODUCER_REGS": "40", "DRAIN_REGS": "80", "CONSUMER_REGS": "160",
             "CONSUMER_REGS_TMA": "136", "COLUMN_TILES_OUTER": "0", "ONE_TILE_A_BLOCK": "0"}
VARIANTS = {
    "full": [],
    "no_epilogue": ["-DSKIP_EPILOGUE=1"],
    "no_mma": ["-DSKIP_MMA=1"],
    "no_gather_loads": ["-DSKIP_LOADS=1"],
    "no_gather": ["-DSKIP_GATHER=1"],
    "no_weight_tma": ["-DSKIP_TMA=1"],
    "no_proxy_fence": ["-DSKIP_FENCE=1"],
    "drain_64_registers": ["-DDRAIN_REGS=64", "-DCONSUMER_REGS_TMA=152"],
    "column_tiles_outer": ["-DCOLUMN_TILES_OUTER=1"],
    "one_tile_a_block": ["-DONE_TILE_A_BLOCK=1"],
}


def guarded_source() -> str:
    src = (_build.CSRC / "int8_conv.cu").read_text()
    for old, new, *count in _GUARDS:
        if src.count(old) != (count[0] if count else 1):
            raise RuntimeError(f"int8_conv.cu no longer has the anchor {old[:40]!r}")
        src = src.replace(old, new)
    head = "".join(f"#ifndef {k}\n#define {k} {v}\n#endif\n" for k, v in _DEFAULTS.items())
    return head + src


def ptxas_summary(log: str) -> dict:
    """{instance: "registers/spill bytes"} from ptxas -v, by template arguments."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"int8_conv_kernelILi(\d+)ELi(\d+)E", line)
        if m and "Compiling entry function" in line:
            fn = f"{m.group(1)}x{m.group(2)}"
        elif fn and "spill stores" in line:
            out[fn] = line.strip().split(",")[1].strip()
        elif fn and "Used" in line and "registers" in line:
            out[fn] = line.split("Used ")[1].split(",")[0] + ", " + out.get(fn, "")
    return out


SASS_OPCODES = ("IGMMA", "UTMALDG", "LDGSTS", "BAR.SYNC", "USETMAXREG")


def sass_counts(lib: Path) -> dict | None:
    """Opcode counts in the library's SASS, or None without cuobjdump."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True).stdout
    return {op: sass.count(op) for op in SASS_OPCODES}


def build_variants(out: Path) -> dict:
    src = out / "int8_conv_phases.cu"
    src.write_text(guarded_source())

    def one(item):
        name, flags = item
        lib = out / f"lib{name}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                               "-o", str(lib), str(src)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{proc.stdout}{proc.stderr}")
        info = ptxas_summary(proc.stdout + proc.stderr)
        if name == "full":
            info["sass"] = sass_counts(lib)
        return name, (_build.bind(ctypes.CDLL(str(lib)), "int8_conv", ic.ARGTYPES), info)

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS.items()))


def site_group(name: str) -> str:
    head = name.split("/")[0].split("_")[0]
    return "decoder" if head.startswith("block") else head


def record_sites(device: str = "cuda", size: int = SIZE, margin: int = MARGIN,
                 batch: int = BATCH, dtype=torch.bfloat16) -> list[tuple[str, dict]]:
    """(group, int8_conv keyword arguments) of every int8 site of one batch;
    the float sites run in ``dtype``, as on the main path."""
    torch.manual_seed(0)
    model = FlairSegmentationModel("resnet34", CLASSES, 5, dtype=dtype).eval().to(device)
    rng = np.random.default_rng(0)
    calib = [rng.integers(0, 256, (4, size, size, 5), dtype=np.uint8) for _ in range(2)]
    qmodel = pq.quantize_model({"int8_decoder": 2, "bn_fold": True,
                                "norma_task": [{"norm_type": "scaling"}]}, model, calib)
    names = {id(p): n for qp in (qmodel.qparams, qmodel.dec_qparams) for n, p in qp.items()}
    sites = []

    def conv(x, p, stride, padding, dilation=1, **kw):
        sites.append((site_group(names[id(p)]),
                      dict(x=x, p=p, stride=stride, padding=padding, dilation=dilation, **kw)))
        return ic.int8_conv(x, p, stride, padding, dilation, **kw)

    x = torch.rand((batch, size, size, 5), generator=torch.Generator(device).manual_seed(1),
                   device=device)
    qmodel.tail_input(x, margin, conv=conv)
    return sites


def launcher(fn, site: dict):
    """A call of ``fn`` (a built variant's entry point) on the site's operands."""
    x, p, res = site["x"], site["p"], site["residual"]
    B, _, H, W = x.shape
    co, _, kh, kw = p.wq.shape
    ho, wo = (ic._out_hw(n, k, site["stride"], site["padding"], site["dilation"])
              for n, k in ((H, kh), (W, kw)))
    out32 = torch.empty((B * ho * wo * co,), dtype=torch.float32, device="cuda") \
        if site["keep_f32"] else None
    outq = torch.empty((B * ho * wo * co,), dtype=torch.int8, device="cuda") \
        if site["out_sx"] is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = (ptr(x), ptr(p.packed), ptr(p.deq), ptr(p.b), ptr(res), ptr(out32), ptr(outq),
            inverse_scale(site["out_sx"]) if site["out_sx"] is not None else 0.0, B, H, W,
            p.in_channels, ho, wo, co, kh, kw, site["stride"], site["padding"],
            site["dilation"], p.packed.shape[1], int(site["relu"]), _build.stream_handle(x),
            ic.instance_code(*ic.kernel_instance(p.in_channels, co, kh, site["stride"],
                                                 site["padding"], site["dilation"])))
    return lambda: _build.check(fn(*args), "int8_conv_phases")


def ms(call, reps: int = 10) -> float:
    for _ in range(2):
        call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("int8_conv_phases: needs a CUDA card")
    with torch.inference_mode():
        sites = record_sites()
        groups = list(dict.fromkeys(g for g, _ in sites))
        with tempfile.TemporaryDirectory(prefix="int8_conv_phases_") as tmp:
            built = build_variants(Path(tmp))
            order = list(built) + list(built)[::-1]
            times: dict[str, list[dict]] = {}
            for name in order:
                by_group = dict.fromkeys(groups, 0.0)
                for g, site in sites:
                    by_group[g] += ms(launcher(built[name][0], site))
                times.setdefault(name, []).append(
                    {"total": sum(by_group.values()), **by_group})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"int8_conv_phases_ms": times,
                      "ptxas": {name: info for name, (_, info) in built.items()},
                      "card": card}))


if __name__ == "__main__":
    main()
