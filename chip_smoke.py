#!/usr/bin/env python3
"""On-card check of the flairtpu_torch port: builds its CUDA kernels, holds
each against its plain PyTorch version, and drives the main path.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero otherwise

Phases (any failure exits non-zero):
1. device and build: the card's name and power limit; nvcc builds
   flairtpu_torch/csrc/*.cu (all sources in parallel).
2. kernels against their plain versions on the card, at the main path's
   shapes (512/128 tiles, batch 128, 19 classes) and at small geometries:
   fused_tail in bfloat16 (class agreement >= 0.999, every class mismatch
   where the plain logits' top-2 gap is below GAP_TOL, prob |diff| <= 1),
   also into the planes of a 1000 x 1100 zone whose last row and column of
   tiles realign, against plain tiles written by the tile-order loop;
   gather_normalize exactly equal in float32 and equal to the bfloat16 cast
   of the float32 result in bfloat16, at the main path's shapes, on a zone
   with an odd row pitch and odd origin columns, and at S = 36, C = 3
   (S*C not a multiple of 8); conv_epilogue exactly equal (torch.equal, bf16
   and float32 outputs) at each of the 41 BatchNorm sites of one main-path
   batch, on the operands that batch gives it, plus ReLU off and a C that is
   not a multiple of 8. Each kernel and its plain version are timed with CUDA
   events; conv_epilogue at every site, summed over the batch.
3. main path: ``flairtpu_torch.cli.detect_main`` on a synthetic 4096 x 4096 x
   5 GeoTIFF zone with a random resnet34-unet (19 classes) smp-keyed .pth,
   at the flair-detect production configuration (batch 128, 512 tiles, 128
   margin, scaling, argmax, exact-clipping). Checks the raster's shape and
   georeferencing, that every pixel is written (prob > 0), and that
   fused_tail and gather_normalize launched once per batch and
   conv_epilogue once per BatchNorm site per batch. Then the same zone again
   through the three plain versions on the card: class agreement >= 0.999,
   prob |diff| <= 1.
4. the kernels line, the card line, and last the JSON result line.

    python3 chip_smoke.py --profile  # also one batch stage by stage, and the profiler table
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
import torch.nn as nn
import yaml

from flairtpu_torch import cli
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import epilogue as ep
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import DeviceZoneRunner, exact_windows
from flairtpu_torch.zone.grid import slice_grid

SEED = 2022
S, M, BATCH, K, C = 512, 128, 128, 19, 5
ZONE = 4096  # synthetic zone side, pixels: 256 tiles, 2 batches
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fused_tail vs its plain version in bf16: the kernel's and cuDNN's float32
# sums differ in order, so a conv1/conv2 value can round to the neighbouring
# bf16 and move a logit by about a weight times a bf16 ulp (~1e-3 here); a
# class may differ only where the plain logits' top-2 gap is below GAP_TOL.
# Measured on an H100 (700 W): 1 mismatch in 8.4M pixels at 512/128, at a gap
# below 5e-6; the check prints the largest gap at a mismatch beside it.
GAP_TOL = 0.05
# conv_epilogue sites of resnet34-unet: the stem, 2 per basic block (16
# blocks; a downsample's BatchNorm is folded into its block's last site) and
# 2 per decoder block 0-3
EPILOGUE_SITES = 1 + 2 * 16 + 2 * 4


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


def random_tail(rng, k: int):
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to("cuda")

    def w(shape):  # conv weights rounded to the compute dtype
        return t(rng.standard_normal(shape) * 0.1).to(torch.bfloat16).float()

    return ft.TailParams(
        w((16, 32, 3, 3)), t(rng.uniform(0.5, 1.5, 16)), t(rng.normal(0, 0.1, 16)),
        w((16, 16, 3, 3)), t(rng.uniform(0.5, 1.5, 16)), t(rng.normal(0, 0.1, 16)),
        w((k, 16, 3, 3)), t(rng.normal(0, 0.1, k)))


def top2_gap(logits):
    """(B, K, s, s) float32 -> (B, s, s) gap between the two largest logits."""
    top2 = logits.topk(2, dim=1).values
    return top2[:, 0] - top2[:, 1]


def random_x3(rng, g, batch: int) -> torch.Tensor:
    x3 = torch.from_numpy(rng.standard_normal(
        (batch, g.x3_extent, g.x3_extent, 32)).astype(np.float32)).to("cuda")
    return x3.to(torch.bfloat16).permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last


def compare_tail(name: str, cls_k, prob_k, cls_p, prob_p, gap) -> dict:
    """Kernel vs plain class and prob (any matching shapes), with the plain
    logits' top-2 gap at each pixel."""
    off = cls_k != cls_p
    agree = 1.0 - off.float().mean().item()
    worst_gap = gap[off].max().item() if off.any() else 0.0
    dprob = (prob_k.int() - prob_p.int()).abs().max().item()
    check(agree >= 0.999, f"{name}: class agreement {agree:.6f} >= 0.999")
    check(worst_gap < GAP_TOL, f"{name}: {int(off.sum())} class mismatches, largest "
          f"top-2 gap there {worst_gap:.2e} < {GAP_TOL}")
    check(dprob <= 1, f"{name}: prob |diff| {dprob} <= 1")
    return {"agree": agree, "max_abs_err": dprob, "mismatch_gap": worst_gap}


def check_fused_tail(rng, size: int, margin: int, batch: int, k: int,
                     timed: bool = False) -> dict:
    g = ft.tail_geometry(size, margin)
    p = random_tail(rng, k)
    x3 = random_x3(rng, g, batch)
    cls_k, prob_k = ft.fused_tail(x3, p, g)
    cls_p, prob_p = ft.fused_tail_plain(x3, p, g)
    gap = top2_gap(ft.tail_logits_plain(x3, p, g))
    torch.cuda.synchronize()
    out = compare_tail(f"fused_tail {size}/{margin} B={batch} K={k} bf16",
                       cls_k, prob_k, cls_p, prob_p, gap)
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


def check_fused_tail_planes(rng, height: int, width: int, batch: int) -> dict:
    """The kernel into the planes of a zone with realigned tiles, batch by
    batch with the owned windows, against plain tiles written in tile order."""
    g = ft.tail_geometry(S, M)
    s = g.out_extent
    p = random_tail(rng, K)
    tiles = slice_grid(width, height, S, M).tiles
    n = len(tiles)
    n_total = n + (-n) % batch
    x3 = random_x3(rng, g, n)
    x3 = torch.cat([x3, x3[-1:].expand(n_total - n, -1, -1, -1)]).contiguous(
        memory_format=torch.channels_last)
    windows = torch.from_numpy(exact_windows(tiles, height, width, s, n_total)).to("cuda")
    Ho, Wo = max(height, s), max(width, s)
    planes = torch.zeros((2, Ho, Wo), dtype=torch.uint8, device="cuda")
    for b0 in range(0, n_total, batch):
        ft.fused_tail(x3[b0:b0 + batch], p, g, planes, windows[b0:b0 + batch])
    cls_p, prob_p = ft.fused_tail_plain(x3[:n], p, g)
    gap_p = top2_gap(ft.tail_logits_plain(x3[:n], p, g))
    ref = torch.zeros((3, Ho, Wo), dtype=torch.float32, device="cuda")
    for i, t in enumerate(tiles):  # the reference's tile-order writes, last wins
        r0, c0 = min(t.irow0, Ho - s), min(t.icol0, Wo - s)
        ref[:, r0:r0 + s, c0:c0 + s] = torch.stack([cls_p[i].float(), prob_p[i].float(),
                                                    gap_p[i]])
    torch.cuda.synchronize()
    return compare_tail(f"fused_tail into planes, {height}x{width} zone, {n} tiles, "
                        f"B={batch}", planes[0], planes[1], ref[0].to(torch.uint8),
                        ref[1].to(torch.uint8), ref[2])


def bound(ops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> dict:
    """The least time for the work: ops at ``peak`` or bytes at HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def compare_gather(zone, org, size: int, label: str) -> float:
    """Kernel vs plain at both normalizations: exactly equal in float32, and
    the bfloat16 output equal to the cast float32 result."""
    c = zone.shape[2]
    means = [105.0, 110.5, 97.25, 120.0, 18.5][:c]
    stds = [52.0, 45.5, 44.0, 39.75, 27.0][:c]
    worst = 0.0
    for norm in (dict(norm_type="scaling"),
                 dict(norm_type="custom", means=means, stds=stds)):
        ref = ga.gather_normalize_plain(zone, org, size, out_dtype=torch.float32, **norm)
        got = ga.gather_normalize(zone, org, size, out_dtype=torch.float32, **norm)
        got16 = ga.gather_normalize(zone, org, size, out_dtype=torch.bfloat16, **norm)
        torch.cuda.synchronize()
        worst = max(worst, (got - ref).abs().max().item())
        check(torch.equal(got, ref),
              f"gather_normalize {label} {norm['norm_type']} fp32: exactly equal")
        check(torch.equal(got16, ref.to(torch.bfloat16)),
              f"gather_normalize {label} {norm['norm_type']} bf16: equal to the cast fp32 result")
    return worst


def check_gather_unaligned(rng, hp: int, wp: int, c: int, size: int, n: int) -> float:
    """A zone whose row pitch wp * c is odd where c is, at origins with odd
    columns: every tile row starts at an unaligned zone byte."""
    zone = torch.from_numpy(rng.integers(0, 256, (hp, wp, c), dtype=np.uint8)).to("cuda")
    cols = np.minimum(rng.integers(0, wp - size + 1, n) | 1, wp - size)
    org = np.stack([rng.integers(0, hp - size + 1, n), cols], axis=1).astype(np.int32)
    return compare_gather(zone, torch.from_numpy(org).to("cuda"), size,
                          f"S={size} C={c} pitch {wp * c} B={n} odd columns")


def check_gather(rng, zone_hw: int, timed: bool = False) -> dict:
    Hp = zone_hw + 2 * M
    zone = torch.from_numpy(rng.integers(0, 256, (Hp, Hp, C), dtype=np.uint8)).to("cuda")
    grid = slice_grid(zone_hw, zone_hw, S, M)
    org_np = np.array([(t.row0 + M, t.col0 + M) for t in grid.tiles[:BATCH]], np.int32)
    org = torch.from_numpy(org_np).to("cuda")
    worst = compare_gather(zone, org, S, f"main path B={len(org_np)}")
    worst = max(worst, check_gather_unaligned(rng, 600, 601, C, S, 8),
                check_gather_unaligned(rng, 100, 101, 3, 36, 16))
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


class SiteRecorder:
    """An epilogue that launches the kernel and keeps each call's operands:
    the main path's BatchNorm sites, at their shapes and on their data."""

    def __init__(self):
        self.sites: list[dict] = []

    def __call__(self, y, scale, shift, residual=None, branch=None, relu=True,
                 keep_f32=False):
        site = dict(y=y, scale=scale, shift=shift, residual=residual, branch=branch,
                    relu=relu, keep_f32=keep_f32)
        self.sites.append(site)
        return ep.conv_epilogue(**site)


def epilogue_sites(model) -> int:
    """conv_epilogue launches per batch, from the model's structure: every
    encoder BatchNorm but the downsamples' (folded into their block's last
    site), and two per decoder block but the last (fused_tail's)."""
    mods = list(model.encoder.modules())
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in mods)
    n_ds = sum(getattr(m, "downsample", None) is not None for m in mods)
    return n_bn - n_ds + 2 * (len(model.decoder.blocks) - 1)


def site_label(k: int, site: dict) -> str:
    kind = ("downsample branch" if site["branch"] is not None else
            "fp32 residual" if site["residual"] is not None else "no residual")
    relu = "" if site["relu"] else ", no ReLU"
    return (f"site {k} {tuple(site['y'].shape)} {kind}{relu}"
            f"{', fp32 out' if site['keep_f32'] else ''}")


def site_cost(site: dict) -> tuple[int, int]:
    """(operations, bytes) of one site: each operand read once, each output
    written once."""
    y = site["y"]
    n, c = y.numel(), y.shape[1]
    ops, nbytes = 2 * n, 2 * n + 2 * 4 * c + 2 * n  # y, scale and shift in; bf16 out
    if site["residual"] is not None:
        ops, nbytes = ops + n, nbytes + 4 * n
    if site["branch"] is not None:
        ops, nbytes = ops + 3 * n, nbytes + 2 * n + 2 * 4 * c
    if site["relu"]:
        ops += n
    if site["keep_f32"]:
        nbytes += 4 * n
    return ops, nbytes


def compare_epilogue(label: str, site: dict) -> float:
    """Kernel vs plain, both outputs asked for: equal bit for bit."""
    args = dict(site, keep_f32=True)
    out, out32 = ep.conv_epilogue(**args)
    ref, ref32 = ep.conv_epilogue_plain(**args)
    torch.cuda.synchronize()
    check(torch.equal(out, ref) and torch.equal(out32, ref32),
          f"conv_epilogue {label}: bf16 and fp32 outputs exactly equal")
    return (out32 - ref32).abs().max().item()


def random_site(gen, shape: tuple, kind: str) -> dict:
    """Operands of a site with random values, channels_last on the card."""
    def t(dtype=torch.float32):
        v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return v.contiguous(memory_format=torch.channels_last)

    def vec(lo=-1.0, hi=1.0):
        return torch.rand(shape[1], generator=gen, device="cuda") * (hi - lo) + lo

    return dict(y=t(torch.bfloat16), scale=vec(0.5, 1.5), shift=vec(),
                residual=t() if kind == "residual" else None,
                branch=(t(torch.bfloat16), vec(0.5, 1.5), vec()) if kind == "branch" else None,
                relu=True, keep_f32=False)


def check_conv_epilogue(model, x: torch.Tensor, timed: bool = False) -> dict:
    """The kernel at every BatchNorm site of one main-path batch of tiles x,
    on the operands that batch gives it; ReLU off, and C not a multiple of 8."""
    rec = SiteRecorder()
    model.tail_input(x, M, epilogue=rec)
    n_sites = epilogue_sites(model)
    check(len(rec.sites) == n_sites == EPILOGUE_SITES,
          f"conv_epilogue: {len(rec.sites)} sites in one batch, {n_sites} from the "
          f"model's structure, {EPILOGUE_SITES} expected for resnet34-unet")
    worst = max(compare_epilogue(site_label(k, site), site)
                for k, site in enumerate(rec.sites))
    largest = max(rec.sites, key=lambda site: site["y"].numel())
    worst = max(worst, compare_epilogue("ReLU off, " + site_label(0, largest),
                                        dict(largest, relu=False)))
    gen = torch.Generator("cuda").manual_seed(SEED)
    for kind in ("none", "residual", "branch"):  # the one-element-a-thread kernel
        worst = max(worst, compare_epilogue(f"C = 20 (not a multiple of 8), {kind}",
                                            random_site(gen, (3, 20, 17, 19), kind)))
    out = {"max_abs_err": worst, "n_sites": n_sites}
    if timed:
        rows = []
        for k, site in enumerate(rec.sites):
            ops, nbytes = site_cost(site)
            rows.append({"site": site_label(k, site),
                         "ms": cuda_ms(lambda a=site: ep.conv_epilogue(**a), 10, 2),
                         "plain_ms": cuda_ms(lambda a=site: ep.conv_epilogue_plain(**a), 5, 1),
                         "bytes": nbytes, **bound(ops, nbytes, PEAK_FP32_FLOPS)})
        n_dec = 2 * (len(model.decoder.blocks) - 1)
        out.update(
            sites=rows, ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows), bytes=sum(r["bytes"] for r in rows),
            bound_by=("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                      else "operations"),
            encoder_ms=sum(r["ms"] for r in rows[:-n_dec]),
            decoder_ms=sum(r["ms"] for r in rows[-n_dec:]),
            largest=max(rows, key=lambda r: r["bytes"]))
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
    """The zone program with the three kernels' plain versions, on the same
    card."""

    def _forward_tiles(self, zone_p, origins, planes, windows):
        x = ga.gather_normalize_plain(zone_p, origins, self.size,
                                      out_dtype=self.model.dtype, **self.norm)
        x3 = self.model.tail_input(x, self.margin, epilogue=ep.conv_epilogue_plain)
        ft.fused_tail_plain(x3, self.tail, self.geometry, planes, windows)


def run_plain(cfg: dict) -> dict:
    cfg = eng.setup_out_path(dict(cfg))
    device = eng.resolve_device(cfg)
    model, tail = eng.prepare_model(cfg, device)
    with TiffReader(cfg["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, S, M, S - 2 * M,
                          reader.transform, reader.crs)
    return PlainRunner(cfg, model, tail).run(grid, "exact-clipping",
                                             eng.stage_zone(cfg, device))


def run_main_path(cfg: dict, conf: Path, zone_hw: int, card: str) -> dict:
    # the plain versions first: their run also warms cuDNN up for the encoder
    plain = run_plain(cfg)
    print(f"  plain-version run: compute {plain['compute_seconds']:.4f} s, "
          f"{plain['patches_per_sec']:.2f} patches/s", flush=True)

    ft.launches = ga.launches = ep.launches = 0
    t0 = time.perf_counter()
    stats = cli.detect_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    launches = {"fused_tail": ft.launches, "gather_normalize": ga.launches,
                "conv_epilogue": ep.launches}

    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    expected = {"fused_tail": n_batches, "gather_normalize": n_batches,
                "conv_epilogue": EPILOGUE_SITES * n_batches}
    out = Path(cfg["output_path"]) / "zone-ARGMAX.tif"
    with TiffReader(cfg["input_img_path"]) as src, TiffReader(out) as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, 2),
              f"output raster {r.width}x{r.height}x{r.count}")
        check(r.transform == src.transform and r.crs == src.crs,
              f"georeferencing kept (crs {r.crs})")
        cls, prob = r.read(1), r.read(2)
    check(bool((prob > 0).all()), "every pixel written (prob > 0)")
    check(int(cls.max()) < K, f"classes in [0, {K})")
    for name, n in launches.items():
        check(n == expected[name], f"{name} launched {n} times for {n_batches} batches "
              f"({expected[name]} expected)")
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


def stage_breakdown(cfg: dict, zone_hw: int, rng, epi: dict) -> dict:
    """Device time of each stage of one main-path batch (CUDA events), and the
    profiler's kernel table for one batch. The encoder and decoder stages are
    split into their conv_epilogue launches (``epi``: phase 2's per-site
    times, summed) and the rest (convolutions, max-pool, upsample, concat)."""
    device = eng.resolve_device(cfg)
    model, tail = eng.prepare_model(cfg, device)
    runner = DeviceZoneRunner(cfg, model, tail)
    zone = torch.from_numpy(rng.integers(0, 256, (zone_hw + 2 * M, zone_hw + 2 * M, C),
                                         dtype=np.uint8)).to(device)
    grid = slice_grid(zone_hw, zone_hw, S, M)
    org = torch.tensor([(t.row0 + M, t.col0 + M) for t in grid.tiles[:BATCH]],
                       dtype=torch.int32, device=device)
    planes = torch.zeros((2, zone_hw, zone_hw), dtype=torch.uint8, device=device)
    win = torch.from_numpy(exact_windows(grid.tiles, zone_hw, zone_hw, S - 2 * M,
                                         len(grid.tiles))[:BATCH]).to(device)
    x = ga.gather_normalize(zone, org, S, out_dtype=model.dtype, **runner.norm)
    feats = model.features(x)
    x3 = model.tail_input(x, M)

    stages = {
        "gather_normalize": lambda: ga.gather_normalize(zone, org, S, out_dtype=model.dtype,
                                                        **runner.norm),
        "encoder": lambda: model.features(x),
        "decoder_blocks_0_3": lambda: model.decoder.inner(feats, M, 4),
        "fused_tail": lambda: ft.fused_tail(x3, tail, runner.geometry, planes, win),
        "whole_batch": lambda: runner._forward_tiles(zone, org, planes, win),
    }
    ms = {name: cuda_ms(fn, reps=5, warmup=1) for name, fn in stages.items()}
    ms["encoder_epilogues"] = epi["encoder_ms"]
    ms["encoder_rest"] = ms["encoder"] - epi["encoder_ms"]
    ms["decoder_blocks_0_3_epilogues"] = epi["decoder_ms"]
    ms["decoder_blocks_0_3_rest"] = ms["decoder_blocks_0_3"] - epi["decoder_ms"]
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner._forward_tiles(zone, org, planes, win)
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        zone, weights = synth_inputs(tmp, ZONE, rng)
        cfg = detect_config(tmp, zone, weights)
        conf = tmp / "detect.yaml"
        conf.write_text(yaml.safe_dump(cfg))
        print(f"    synthesized a {ZONE}x{ZONE}x{C} zone and resnet34-unet weights in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        print("[2] kernels against their plain versions", flush=True)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.inference_mode():
            tail = check_fused_tail(rng, S, M, BATCH, K, timed=True)
            for size, margin, k in ((64, 16, K), (32, 1, 4), (96, 8, 32)):
                check_fused_tail(rng, size, margin, 4, k)
            check_fused_tail_planes(rng, 1000, 1100, 8)
            gather = check_gather(rng, ZONE, timed=True)
            model, _ = eng.prepare_model(cfg, torch.device("cuda"))
            gen = torch.Generator("cuda").manual_seed(SEED)
            x = torch.rand((BATCH, S, S, C), generator=gen, device="cuda").to(torch.bfloat16)
            epi = check_conv_epilogue(model, x, timed=True)
            del model, x
            torch.cuda.empty_cache()
        print(f"    fused_tail: {tail['ms']:.4f} ms, plain {tail['plain_ms']:.4f} ms, "
              f"bound {tail['bound_ms']:.4f} ms ({tail['bound_by']})", flush=True)
        print(f"    gather_normalize: {gather['ms']:.4f} ms, plain {gather['plain_ms']:.4f} ms, "
              f"bound {gather['bound_ms']:.4f} ms ({gather['bound_by']})", flush=True)
        for r in epi["sites"]:
            print(f"    conv_epilogue {r['site']}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        big = epi["largest"]
        print(f"    conv_epilogue, largest site ({big['site']}): {big['ms']:.4f} ms, plain "
              f"{big['plain_ms']:.4f} ms, bound {big['bound_ms']:.4f} ms", flush=True)
        print(f"    conv_epilogue, {epi['n_sites']} sites of one batch: {epi['ms']:.4f} ms "
              f"(encoder {epi['encoder_ms']:.4f}, decoder blocks 0-3 {epi['decoder_ms']:.4f}), "
              f"plain {epi['plain_ms']:.4f} ms, bound {epi['bound_ms']:.4f} ms "
              f"({epi['bytes'] / 1e9:.2f} GB, {epi['bound_by']})", flush=True)

        print("[3] main path: flair-detect on the card", flush=True)
        main_path = run_main_path(cfg, conf, ZONE, card)
        if args.profile:
            with torch.inference_mode():
                prof = stage_breakdown(cfg, ZONE, rng, epi)
            print(prof["kernel_table"])
            print(json.dumps({"stage_ms": prof["stage_ms"], "card": card}), flush=True)

    src = "flairtpu_torch/csrc"
    kernels = [
        {"name": "fused_tail", "route": "cuda", "source": f"{src}/fused_tail.cu",
         "replaces": "benchmarks/pallas_fused_tail.py:229 and the plane writes "
                     "flairtpu/zone/device_engine.py:148-156",
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
        # times summed over the 41 sites (launches) of one batch
        {"name": "conv_epilogue", "route": "cuda", "source": f"{src}/conv_epilogue.cu",
         "replaces": "flairtpu/models/resnet.py:177-189, :208-222, :269-273 and "
                     "flairtpu/models/unet.py:71-76 (XLA-fused BatchNorm, residual, ReLU)",
         "launches": main_path["launches"]["conv_epilogue"],
         "max_abs_err": epi["max_abs_err"], "ms": epi["ms"], "plain_ms": epi["plain_ms"],
         "bound_ms": epi["bound_ms"], "bound_by": epi["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"main_path": main_path["stats"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
