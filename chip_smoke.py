#!/usr/bin/env python3
"""On-card check of the flairtpu_torch port: builds its CUDA kernels, holds
each against its plain PyTorch version, and drives the main path.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero otherwise

Phases (any failure exits non-zero):
1. device and build: the card's name and power limit; nvcc builds
   flairtpu_torch/csrc/*.cu (all sources in parallel).
2. kernels against their plain versions on the card, at the main path's
   shapes (512/128 tiles, batch 128, 19 classes) and at small geometries:
   fused_tail in bfloat16 (argmax agreement >= 0.999, prob |diff| <= 1) and
   float32 with TF32 off (argmax equal except near-ties, top-2 gap < 1e-4;
   prob |diff| <= 1); gather_normalize exactly equal in float32 and equal
   to the bfloat16 cast of the float32 result in bfloat16. Each kernel and
   its plain version are timed with CUDA events.
3. main path: ``flairtpu_torch.cli.detect_main`` on a synthetic 4096 x 4096 x
   5 GeoTIFF zone with a random resnet34-unet (19 classes) smp-keyed .pth,
   at the flair-detect production configuration (batch 128, 512 tiles, 128
   margin, scaling, argmax, exact-clipping). Checks the raster's shape and
   georeferencing, that every pixel is written (prob > 0), and that each
   kernel launched once per batch. Then the same zone again through the
   plain versions on the card: class agreement >= 0.999, prob |diff| <= 1.
4. the kernels line, the card line, and last the JSON result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from flairtpu_torch import cli
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import DeviceZoneRunner
from flairtpu_torch.zone.grid import slice_grid

SEED = 2022
S, M, BATCH, K, C = 512, 128, 128, 19, 5
ZONE = 4096  # synthetic zone side, pixels: 256 tiles, 2 batches
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def check(ok: bool, msg: str) -> None:
    print(("  ok   " if ok else "  FAIL ") + msg, flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def random_tail(rng, k: int, dtype, device):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def w(shape):  # conv weights rounded to the compute dtype
        return t(rng.standard_normal(shape) * 0.1).to(dtype).float()

    return ft.TailParams(
        w((16, 32, 3, 3)), t(rng.uniform(0.5, 1.5, 16)), t(rng.normal(0, 0.1, 16)),
        w((16, 16, 3, 3)), t(rng.uniform(0.5, 1.5, 16)), t(rng.normal(0, 0.1, 16)),
        w((k, 16, 3, 3)), t(rng.normal(0, 0.1, k)))


def near_tie(logits):
    """(B, K, s, s) float32 -> pixels whose top-2 logits differ by < 1e-4."""
    top2 = logits.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) < 1e-4


def check_fused_tail(rng, size: int, margin: int, batch: int, k: int, dtype,
                     timed: bool = False) -> dict:
    g = ft.tail_geometry(size, margin)
    p = random_tail(rng, k, dtype, "cuda")
    x3 = torch.from_numpy(rng.standard_normal(
        (batch, g.x3_extent, g.x3_extent, 32)).astype(np.float32)).to("cuda")
    x3 = x3.to(dtype).permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
    cls_k, prob_k = ft.fused_tail(x3, p, g)
    cls_p, prob_p = ft.fused_tail_plain(x3, p, g)
    torch.cuda.synchronize()
    name = f"fused_tail {size}/{margin} B={batch} K={k} {str(dtype).split('.')[-1]}"
    agree = (cls_k == cls_p).float().mean().item()
    dprob = (prob_k.int() - prob_p.int()).abs().max().item()
    if dtype == torch.bfloat16:
        check(agree >= 0.999, f"{name}: argmax agreement {agree:.6f} >= 0.999")
    else:
        ties = near_tie(ft.tail_logits_plain(x3, p, g))
        bad = ((cls_k != cls_p) & ~ties).sum().item()
        check(bad == 0, f"{name}: argmax equal except near-ties "
              f"({bad} off, agreement {agree:.6f})")
    check(dprob <= 1, f"{name}: prob |diff| {dprob} <= 1")
    out = {"agree": agree, "max_abs_err": dprob}
    if timed:
        out["ms"] = cuda_ms(lambda: ft.fused_tail(x3, p, g))
        out["plain_ms"] = cuda_ms(lambda: ft.fused_tail_plain(x3, p, g))
        # the plain version's convolutions are cuDNN: it is also the library yardstick
        out["library_ms"] = out["plain_ms"]
        c1, c2 = min(g.b4_extent, g.out_extent + 4), min(g.b4_extent, g.out_extent + 2)
        flops = 2 * 9 * batch * (c1 * c1 * 32 * 16 + c2 * c2 * 16 * 16
                                 + g.out_extent ** 2 * 16 * k)
        nbytes = x3.numel() * x3.element_size() + 2 * batch * g.out_extent ** 2
        out.update(bound(flops, nbytes), flops=flops, bytes=nbytes)
    return out


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time for the work: ops at ``peak`` or bytes at HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_gather(rng, zone_hw: int, timed: bool = False) -> dict:
    Hp = zone_hw + 2 * M
    zone = torch.from_numpy(rng.integers(0, 256, (Hp, Hp, C), dtype=np.uint8)).to("cuda")
    grid = slice_grid(zone_hw, zone_hw, S, M)
    org_np = np.array([(t.row0 + M, t.col0 + M) for t in grid.tiles[:BATCH]], np.int32)
    org = torch.from_numpy(org_np).to("cuda")
    means, stds = [105.0, 110.5, 97.25, 120.0, 18.5], [52.0, 45.5, 44.0, 39.75, 27.0]
    worst = 0.0
    for norm in (dict(norm_type="scaling"),
                 dict(norm_type="custom", means=means, stds=stds)):
        ref = ga.gather_normalize_plain(zone, org, S, out_dtype=torch.float32, **norm)
        got = ga.gather_normalize(zone, org, S, out_dtype=torch.float32, **norm)
        got16 = ga.gather_normalize(zone, org, S, out_dtype=torch.bfloat16, **norm)
        torch.cuda.synchronize()
        worst = max(worst, (got - ref).abs().max().item())
        check(torch.equal(got, ref),
              f"gather_normalize {norm['norm_type']} B={len(org_np)} fp32: exactly equal")
        check(torch.equal(got16, ref.to(torch.bfloat16)),
              f"gather_normalize {norm['norm_type']} bf16: equal to the cast fp32 result")
    out = {"max_abs_err": worst}
    if timed:
        out["ms"] = cuda_ms(lambda: ga.gather_normalize(
            zone, org, S, "scaling", out_dtype=torch.bfloat16))
        out["plain_ms"] = cuda_ms(lambda: ga.gather_normalize_plain(
            zone, org, S, "scaling", out_dtype=torch.bfloat16))
        covered = np.zeros((Hp, Hp), bool)  # each zone byte read once
        for r, c in org_np:
            covered[r:r + S, c:c + S] = True
        nbytes = int(covered.sum()) * C + org_np.nbytes + len(org_np) * S * S * C * 2
        # one float32 multiply per element
        out.update(bound(len(org_np) * S * S * C, nbytes, PEAK_FP32_FLOPS), bytes=nbytes)
    return out


def synth_inputs(tmp: Path, zone_hw: int, rng) -> tuple[Path, Path]:
    img = rng.integers(0, 256, (C, zone_hw, zone_hw), dtype=np.uint8)
    zone = tmp / "zone.tif"
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, compress="deflate")
    model = FlairSegmentationModel("resnet34", K, C)
    sd = {}
    for key, v in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = v
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif key.endswith(("running_mean", ".bias")):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
        elif v.dim() == 1:  # BatchNorm gamma
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.0, v.shape).astype(np.float32))
        else:  # conv weights, He-scaled
            fan_in = v[0].numel()
            sd[key] = torch.from_numpy(
                (rng.standard_normal(v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
    weights = tmp / "resnet34_unet_19cl.pth"
    torch.save(sd, weights)
    return zone, weights


def detect_config(tmp: Path, zone: Path, weights: Path) -> dict:
    return {
        "output_path": str(tmp / "out"), "output_name": "zone-ARGMAX",
        "input_img_path": str(zone), "channels": [1, 2, 3, 4, 5],
        "img_pixels_detection": S, "margin": M, "output_type": "argmax",
        "n_classes": K, "model_weights": str(weights),
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet34_unet"}},
        "batch_size": BATCH, "use_gpu": True, "num_worker": 2, "write_dataframe": False,
        "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
    }


class PlainRunner(DeviceZoneRunner):
    """The zone program with the kernels' plain versions, on the same card."""

    def _forward_tiles(self, zone_p, origins):
        x = ga.gather_normalize_plain(zone_p, origins, self.size,
                                      out_dtype=self.model.dtype, **self.norm)
        return ft.fused_tail_plain(self.model.tail_input(x, self.margin),
                                   self.tail, self.geometry)


def run_plain(cfg: dict) -> dict:
    cfg = eng.setup_out_path(dict(cfg))
    device = eng.resolve_device(cfg)
    model, tail = eng.prepare_model(cfg, device)
    with TiffReader(cfg["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, S, M, S - 2 * M,
                          reader.transform, reader.crs)
    return PlainRunner(cfg, model, tail).run(grid, "exact-clipping",
                                             eng.stage_zone(cfg, device))


def run_main_path(tmp: Path, zone_hw: int, rng, card: str) -> dict:
    t0 = time.perf_counter()
    zone, weights = synth_inputs(tmp, zone_hw, rng)
    cfg = detect_config(tmp, zone, weights)
    conf = tmp / "detect.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    print(f"  synthesized {zone_hw}x{zone_hw}x{C} zone and weights in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # the plain versions first: their run also warms cuDNN up for the encoder
    plain = run_plain(cfg)
    print(f"  plain-version run: compute {plain['compute_seconds']:.4f} s, "
          f"{plain['patches_per_sec']:.2f} patches/s", flush=True)

    ft.launches = ga.launches = 0
    t0 = time.perf_counter()
    stats = cli.detect_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    launches = {"fused_tail": ft.launches, "gather_normalize": ga.launches}

    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    out = Path(cfg["output_path"]) / "zone-ARGMAX.tif"
    with TiffReader(zone) as src, TiffReader(out) as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, 2),
              f"output raster {r.width}x{r.height}x{r.count}")
        check(r.transform == src.transform and r.crs == src.crs,
              f"georeferencing kept (crs {r.crs})")
        cls, prob = r.read(1), r.read(2)
    check(bool((prob > 0).all()), "every pixel written (prob > 0)")
    check(int(cls.max()) < K, f"classes in [0, {K})")
    for name, n in launches.items():
        check(n == n_batches, f"{name} launched {n} times for {n_batches} batches")
    print(f"  main path on {card}: {stats['tiles']} tiles, read {stats['read_seconds']:.4f} s, "
          f"h2d {stats['h2d_seconds']:.4f} s, compute {stats['compute_seconds']:.4f} s, "
          f"d2h {stats['d2h_seconds']:.4f} s, {stats['patches_per_sec']:.2f} patches/s, "
          f"detect_main wall {wall:.2f} s", flush=True)

    agree = float((plain["cls"] == cls).mean())
    dprob = int(np.abs(plain["prob"].astype(int) - prob.astype(int)).max())
    check(agree >= 0.999, f"main path vs plain versions: class agreement {agree:.6f} >= 0.999")
    check(dprob <= 1, f"main path vs plain versions: prob |diff| {dprob} <= 1")
    return {"stats": stats, "launches": launches, "plain_compute_seconds":
            plain["compute_seconds"], "agree_plain": agree, "prob_diff_plain": dprob}


def stage_breakdown(cfg: dict, zone_hw: int, rng) -> dict:
    """Device time of each stage of one main-path batch (CUDA events), and the
    profiler's kernel table for one batch."""
    device = eng.resolve_device(cfg)
    model, tail = eng.prepare_model(cfg, device)
    runner = DeviceZoneRunner(cfg, model, tail)
    zone = torch.from_numpy(rng.integers(0, 256, (zone_hw + 2 * M, zone_hw + 2 * M, C),
                                         dtype=np.uint8)).to(device)
    grid = slice_grid(zone_hw, zone_hw, S, M)
    org = torch.tensor([(t.row0 + M, t.col0 + M) for t in grid.tiles[:BATCH]],
                       dtype=torch.int32, device=device)
    s = S - 2 * M
    planes = torch.zeros((2, zone_hw, zone_hw), dtype=torch.uint8, device=device)
    x = ga.gather_normalize(zone, org, S, out_dtype=model.dtype, **runner.norm)
    feats = model.features(x)
    x3 = model.tail_input(x, M)
    cls, prob = ft.fused_tail(x3, tail, runner.geometry)

    def write():
        for i, t in enumerate(grid.tiles[:BATCH]):
            r0, c0 = min(t.irow0, zone_hw - s), min(t.icol0, zone_hw - s)
            planes[0, r0:r0 + s, c0:c0 + s] = cls[i]
            planes[1, r0:r0 + s, c0:c0 + s] = prob[i]

    stages = {
        "gather_normalize": lambda: ga.gather_normalize(zone, org, S, out_dtype=model.dtype,
                                                        **runner.norm),
        "encoder": lambda: model.features(x),
        "decoder_blocks_0_3": lambda: model.decoder.inner(feats, M, 4),
        "fused_tail": lambda: ft.fused_tail(x3, tail, runner.geometry),
        "plane_writes": write,
        "whole_batch": lambda: runner._forward_tiles(zone, org),
    }
    ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner._forward_tiles(zone, org)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15)
    return {"stage_ms": ms, "kernel_table": table}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time one main-path batch stage by stage and print "
                         "the profiler's kernel table")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"    built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}", flush=True)

    rng = np.random.default_rng(SEED)
    print("[2] kernels against their plain versions", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        tail = check_fused_tail(rng, S, M, BATCH, K, torch.bfloat16, timed=True)
        check_fused_tail(rng, S, M, 16, K, torch.float32)
        for size, margin, k in ((64, 16, K), (32, 1, 4), (96, 8, 32)):
            for dt in (torch.bfloat16, torch.float32):
                check_fused_tail(rng, size, margin, 4, k, dt)
        gather = check_gather(rng, ZONE, timed=True)
    print(f"    fused_tail: {tail['ms']:.4f} ms, plain {tail['plain_ms']:.4f} ms, "
          f"bound {tail['bound_ms']:.4f} ms ({tail['bound_by']})", flush=True)
    print(f"    gather_normalize: {gather['ms']:.4f} ms, plain {gather['plain_ms']:.4f} ms, "
          f"bound {gather['bound_ms']:.4f} ms ({gather['bound_by']})", flush=True)

    print("[3] main path: flair-detect on the card", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        main_path = run_main_path(Path(tmp), ZONE, rng, card)
        if args.profile:
            with torch.inference_mode():
                prof = stage_breakdown(detect_config(Path(tmp), Path(tmp) / "zone.tif",
                                                     Path(tmp) / "resnet34_unet_19cl.pth"),
                                       ZONE, rng)
            print(prof["kernel_table"])
            print(json.dumps({"stage_ms": prof["stage_ms"], "card": card}), flush=True)

    src = "flairtpu_torch/csrc"
    kernels = [
        {"name": "fused_tail", "route": "cuda", "source": f"{src}/fused_tail.cu",
         "replaces": "benchmarks/pallas_fused_tail.py:229",
         "launches": main_path["launches"]["fused_tail"],
         "max_abs_err": tail["max_abs_err"], "ms": tail["ms"],
         "plain_ms": tail["plain_ms"], "bound_ms": tail["bound_ms"],
         "bound_by": tail["bound_by"], "library_ms": tail["library_ms"]},
        {"name": "gather_normalize", "route": "cuda", "source": f"{src}/gather_normalize.cu",
         "replaces": "flairtpu/zone/device_engine.py:124",
         "launches": main_path["launches"]["gather_normalize"],
         "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
         "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
         "bound_by": gather["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"main_path": main_path["stats"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
