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
   (S*C not a multiple of 8), for uint8 zones and, through its typed
   instance, uint16, int16 and float32 zones, each timed with its byte
   bound (input and output bytes at 3.35 TB/s); conv_epilogue exactly equal (torch.equal, bf16
   and float32 outputs) at each of the 41 BatchNorm sites of one main-path
   batch, on the operands that batch gives it, plus ReLU off and a C that is
   not a multiple of 8. The fused tail's probs mode (bytes within 1 of the
   plain version, into tiles and into the (H, W, K) plane of the realigning
   zone) and logits mode at margin 0 (within GAP_TOL of the plain logits);
   accumulate_probs and merge_max on the same logits as their plain versions
   (one batch of 128 full 512 tiles of the 4096² zone at stride 256, and
   every batch of the realigning zone at batch 8 with padding duplicates):
   acc and div bit for bit equal (torch.equal; also at K = 16, which pads
   the kernel's shared stride, on the main batch's shapes) and, after
   stitch_finalize, classes equal except where the mean's top-2 gap is
   below 1e-5; merge_max class
   agreement >= 0.999 with every mismatch where kernel and plain best
   probabilities agree to 1e-6 (two tiles tie), prob |diff| <= 1;
   stitch_finalize exactly equal on the same planes. tile_softmax (the
   streaming route's full-tile payloads) on the fused tail's logits of a
   batch of 128 whole 512 tiles and on random logits at K = 13, 16 and 32:
   probs and prob within ACC_REL_TOL, classes equal except where the top-2
   gap is below MEAN_GAP_TOL. conv_epilogue also at every site of one batch
   of the BatchNorm-folded walk (scale 1, the identity in bf16), exactly.
   int8_conv and quantize_act (the int8 model of INT8_KNOBS, calibrated on
   the main zone) exactly equal to their plain versions at every distinct
   site geometry of one batch of 4 tiles (float32 and int8 outputs;
   quantize_act also on bf16 inputs and at 20 -> 24 channels), and
   int8_conv at the edge geometries of INT8_EDGES, which the main path does
   not reach (batch 1 with M not a multiple of 128, Co 8 and 72, Kp not a
   multiple of 128, stride 2, dilation 2, Cp 8 and 24 through the 8-byte
   gathers, Cp 32 and 96 through the 16-byte ones, im2col TMA at stride 2,
   dilation 2 and 1x1/2, a residual without ReLU). Each kernel and its plain version
   are timed with CUDA events; conv_epilogue at every site, summed over the
   batch, and so int8_conv (its 40 sites of one batch of 128, with
   torch._int_mm on each site's im2col operand as the library yardstick;
   also summed by group: stem, layer1-4, decoder, with the largest kernel /
   _int_mm ratio over the sites) and quantize_act (its 4 sites).
   The train step's kernels (flair, slice 4): fused_tail's argmax mode at
   margin 0 on whole 512 tiles at batch 16 (flair predict), as above;
   augment_normalize bit for bit (torch.equal) for all 16 D4 choices, the
   three norm types, labels 0 and > K on disk, bf16 and float32, the identity
   and no mask at the train batch (its tiled instance), and at the edge
   geometries of AUG_EDGES (500², C = 1, 3, 8 and 12, batch 1, pointers one
   byte off alignment, a 384 x 512 identity: the general instance; C = 1, 3
   and 8 and batch 1 at 512²: the tiled one), each with the instance
   launch_plan chose and the wrapper launched; timed by device time and
   call time on the train, eval, predict and float32 calls; weighted_ce's forward (loss within CE_LOSS_RTOL, weight sum
   and confusion matrix exact) and backward (within CE_GRAD_TOL of the
   largest |dlogit|), two calls bit-identical, on batch-16 logits (random,
   and coherent: 64 x 64 one-class targets, argmax = target on about 90%),
   at a pixel count that is not a multiple of a tile (K = 19 and 32) and
   through pointers off 16-byte alignment; timed by device time and call
   time beside F.cross_entropy(weight=w) (the forward) and its VJP alone
   (the backward); bn_train's statistics (within BN_STAT_TOL, the
   running statistics too) and backward (dy within BN_DY_TOL of the largest,
   dgamma and dbeta within BN_STAT_TOL, the residual's gradient exact) at
   every BatchNorm site geometry of resnet34-unet at batch 2 and at every
   site of a batch-16 step; two calls of each entry point at every batch-16
   site give the same bits; the batch-16 sites are timed by device time
   (device_ms: the queue filled behind a sleep kernel first) and by call
   time (cuda_ms), beside torch.var_mean(correction=0) (statistics) and
   aten's native_batch_norm_backward on the masked bf16 gradient
   (backward), with the backward's sites and times by route.
3. main path: ``flairtpu_torch.cli.detect_main`` on a synthetic 4096 x 4096 x
   5 GeoTIFF zone (``<dpt>/<zone>/zone.tif``, with a synthetic truth raster
   at ``truth/<dpt>/<zone>/truth.tif``) with a random resnet34-unet (19
   classes) smp-keyed .pth, at the flair-detect production configuration
   (batch 128, 512 tiles, 128 margin, scaling, argmax, exact-clipping).
   Checks the raster's shape and georeferencing, that every pixel is
   written (prob > 0), and that fused_tail and gather_normalize launched
   once per batch and conv_epilogue once per BatchNorm site per batch. Then
   the same zone again through the plain versions on the card: class
   agreement >= 0.999, prob |diff| <= 1. Then, each with the counts set to 0
   just before it:
   - ``output_type: class_prob``: a 19-band raster, the probs mode of
     fused_tail once per batch, every band within 1 of the all-plain run;
   - ``detect_main -c -m`` with the strategies, batch size and custom
     normalization of ``configs/flair-1-config-detect-compare.yaml``
     (sizes 256/512/1024, stride 0.75, margin 0.25, the four stitching
     methods: 12 runs): 12 rasters named by method string, the per-patch
     metrics JSON, each run's launches, and the 4 size-512 runs against the
     all-plain runs (class agreement >= 0.999, prob |diff| <= 1).
3b. the streaming route through detect_main, each run with the counts set
   to 0 just before it: the main configuration routed there by a device
   budget below its estimate (and no zone upload), class_prob, and
   average_weights and max at the sweep's size-512 geometry (``-c``), the
   last three with FLAIRTPU_STREAMING_ZONE=1. Each run's launches (no stitch
   kernel; tile_softmax once a batch for the full-tile payloads), raster
   shape, georeferencing and coverage, and agreement with the device
   route's raster of the same configuration from this call (class
   agreement >= 0.999, prob |diff| <= 1, the bit-equal share printed), with
   where its seconds went.
3c. the banded route (FLAIRTPU_ZONE_BANDS = 2 and 4) on the main
   configuration, beside an unbanded run: each raster bit-equal to the main
   path's, no whole-zone upload, the launches (a band's last batch padded
   with duplicates: 2 and 4 batches), and the card's span sums of the three streams
   (slab uploads, band compute, owned rows back), the wall time and the
   overlap share 1 - wall / spans.
3d. ``detect_main -b -m`` over a department of three 4096 x 4096 zones with
   truth rasters, each from its own numpy seed: the three rasters with the
   -ARGMAX-S_ names, each bit-equal to a single-zone device-route run of
   the same zone, the metrics JSON (one record), each zone's launches;
   zones/s, each zone's read (and the part the prefetch hid), h2d residual,
   compute, d2h and write seconds, and whether zone i + 1's upload (events
   on its H2D stream) lies inside zone i's run.
3e. a 4096 x 4096 uint16 zone (12-bit values, ``custom``) on the device
   and the streaming routes (the typed gather once a batch), each against
   its all-plain run: class agreement >= 0.999, prob |diff| <= 1.
3f. ``bn_fold: true`` on the main configuration; 3g. ``quantize: int8``,
   ``int8_decoder: 2``, ``bn_fold: true`` on it, then int8_decoder 0 and 4
   and int8 without bn_fold on a 1024 x 1024 zone. Each run: its launches
   with the counts set to 0 just before it (3g on the main zone: int8_conv
   80, quantize_act 8, conv_epilogue 8, fused_tail 2), against its all-plain
   run on the same model (class agreement >= 0.999, prob |diff| <= 1), its
   class agreement with the float path's raster of the zone (>= FOLD_FLOOR
   or INT8_FLOOR), patches/s and the calibration's seconds.
4. ``flair`` on the card: a FLAIR-like set (512 x 512 x 5 uint8 patches with
   learnable blocky 19-class masks; 64 train, 16 val, 16 test) written with
   flairtpu_torch.io, and ``cli.flair_main`` with train, predict and metrics
   at configs/flair-1-config.yaml's values (resnet34-unet, batch 16, custom
   normalization, augmentation, SGD at 0.02, accelerator tpu = the card) for
   3 epochs (12 steps), with PyTorch's default precision flags (cuDNN may
   use TF32), as a user's run has them. Checks each kernel's launches against steps x sites
   (the counts set to 0 just before; every augment_normalize launch through
   its tiled instance), finite losses, every artifact and
   metrics.json's schema; prints train patches/s from epoch 2 and eval
   patches/s with their step and batch counts, the loader's wait, and
   predict patches/s over four warm batches beside flair_main's first call.
   Then one train step from the best checkpoint's weights, on one batch with
   fixed choices: the kernels' step with every kernel also run plain on the
   same operands, each site's incoming gradient included (augment,
   statistics, epilogue, backward, loss and its gradient within the phase 2
   tolerances and BN_GRAD_TOL); then free-running against the plain step
   (loss within STEP_LOSS_RTOL, each gradient's and running statistic's
   relative L2 within STEP_SLACK of the plain step on the samples reversed,
   the confusion matrix's moved pixels within STEP_CM_SHARE), beside the
   plain step repeated and both orders in float32, which measure that
   drift.
5. the kernels line, the card line, and last the JSON result line.

    python3 chip_smoke.py --profile  # also one batch per program by stage, the profiler
                                     # table, and the same for one flair train step
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import yaml

from flairtpu_torch import cli
from flairtpu_torch.config import gen_param_combination, validate_detect_config
from flairtpu_torch.data.manifest import gather_paths
from flairtpu_torch.data.patches import PatchDataset, PatchLoader
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.factory import FlairSegmentationModel, init_weights
from flairtpu_torch.predict.runner import predict
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import augment as au
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops.bn_train_phases import device_ms
from flairtpu_torch.ops.weighted_ce_phases import inputs as ce_inputs
from flairtpu_torch.ops import epilogue as ep
from flairtpu_torch.ops import weighted_ce as wc
from flairtpu_torch.ops.bn_train import TrainSites
from flairtpu_torch.ops.weighted_ce import WeightedCE
from flairtpu_torch.train import checkpoints as ckpt_lib
from flairtpu_torch.train.loop import SegmentationTrainer
from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.fold import FoldedZoneModel
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops import quantize_act as qa
from flairtpu_torch.ops import stitch as st
from flairtpu_torch.ops import tile_softmax as ts
from flairtpu_torch.zone import device_engine as de
from flairtpu_torch.zone import engine as eng
from flairtpu_torch.zone.device_engine import DeviceZoneRunner, exact_windows
from flairtpu_torch.zone.grid import slice_grid
from flairtpu_torch.zone.naming import method_string
from flairtpu_torch.zone.weights import patch_weights

SEED = 2022
S, M, BATCH, K, C = 512, 128, 128, 19, 5
ZONE = 4096  # synthetic zone side, pixels: 256 tiles, 2 batches
DPT, ZONE_NAME = "D000_2024", "Z_SMOKE"  # the zone's <dpt>/<zone> folders
COMPARE_CONFIG = Path(__file__).resolve().parent / "configs" / "flair-1-config-detect-compare.yaml"
# the stitch kernels against their plain versions on the same logits: same
# operations in the same order, so only the exponential's last bit may
# differ between expf and torch.exp
ACC_REL_TOL = 1e-6
MEAN_GAP_TOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, float32
# outside the tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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
# the documented int8 configuration (bench.py:283-287): phase 3g and
# phase 2's int8 checks. Its int8 sites of resnet34-unet: the stem, 32 block
# convs and 3 downsamples (ENCODER_INT8_SITES), and the 4 convs of decoder
# blocks 0-1; quantize_act a batch: the stem's input, the pooled stem output
# and the inputs of the int8 decoder blocks
INT8_KNOBS = {"quantize": "int8", "int8_decoder": 2, "bn_fold": True}
ENCODER_INT8_SITES = 1 + 32 + 3
INT8_SITES = ENCODER_INT8_SITES + 2 * 2
QUANTIZE_SITES = 2 + 2
ZONE_SMALL = 1024  # phase 3g's other int8 configurations run on a zone of this side
# int8_conv at geometries the main path does not reach: (label, B, H, W,
# Ci, Co, k, stride, pad, dilation, residual, ReLU); each with both outputs
INT8_EDGES = (
    ("one tile: M 128, Co 64, K 128, one tap", 1, 8, 16, 128, 64, 1, 1, 0, 1, False, True),
    ("batch 1, M 255 (not a multiple of 128)", 1, 15, 17, 64, 64, 3, 1, 1, 1, True, True),
    ("Co 8", 2, 20, 23, 64, 8, 3, 1, 1, 1, False, True),
    ("Co 72", 2, 20, 23, 64, 72, 3, 1, 1, 1, True, True),
    ("Kp 448 (K 432, not a multiple of 128)", 2, 19, 21, 48, 128, 3, 1, 1, 1, False, True),
    ("Kp 32 (1x1 over 32 channels)", 2, 19, 21, 32, 136, 1, 1, 0, 1, True, False),
    ("stride 2", 2, 33, 30, 64, 128, 3, 2, 1, 1, False, True),
    ("dilation 2", 2, 21, 24, 64, 64, 3, 1, 2, 2, True, True),
    ("Cp 8 (5 channels), 7x7/2, 8-byte gathers", 2, 40, 38, 5, 64, 7, 2, 3, 1, False, True),
    ("Cp 24 (20 channels), 8-byte gathers, Co 72", 2, 18, 19, 20, 72, 3, 1, 1, 1, True, True),
    ("residual without ReLU", 3, 32, 32, 64, 64, 3, 1, 1, 1, True, False),
    ("many tiles a block: M 32768, Co 256", 2, 128, 128, 128, 256, 3, 1, 1, 1, True, True),
    ("im2col TMA: stride 2, batch 1, M 132", 1, 23, 21, 128, 136, 3, 2, 1, 1, True, True),
    ("im2col TMA: dilation 2, Cp 256, Co 64", 2, 13, 17, 256, 64, 3, 1, 2, 2, False, True),
    ("im2col TMA: 1x1/2, Cp 384, no ReLU", 3, 15, 14, 384, 128, 1, 2, 0, 1, True, False),
    ("16-byte gathers: Cp 32, Co 64, ragged M", 1, 19, 23, 32, 64, 3, 1, 1, 1, True, True),
    ("16-byte gathers: Cp 96, Co 200, stride 2", 2, 21, 22, 96, 200, 3, 2, 1, 1, False, True),
)
# class agreement of the knobs' rasters with the float main path's
# (random weights): bn_fold rounds in bf16 in other places, int8 quantizes
# (tests/test_quantize.py:315)
FOLD_FLOOR, INT8_FLOOR = 0.95, 0.8
# zone dtypes of the typed gather instance (the first is phase 3e's zone)
TYPED_ZONES = ("uint16", "int16", "float32")
# phase 3e: custom normalization of a 12-bit zone
U16_MEANS, U16_STDS = [2000.0, 2100.5, 1900.25, 2500.0, 300.5], [800.0, 750.5, 820.0, 900.25, 120.0]


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
        # no single PyTorch call computes the tail (three convolutions, their
        # BatchNorm and ReLU, the softmax): the plain version is many calls
        out["library_ms"] = None
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


def tail_flops(g, batch: int, k: int) -> int:
    """Operations of the tail's three convolutions (with conv1's and conv2's
    halos) for a batch."""
    c1, c2 = min(g.b4_extent, g.out_extent + 4), min(g.b4_extent, g.out_extent + 2)
    return 2 * 9 * batch * (c1 * c1 * 32 * 16 + c2 * c2 * 16 * 16 + g.out_extent ** 2 * 16 * k)


def check_tail_probs(rng, size: int, margin: int, batch: int, k: int,
                     timed: bool = False) -> dict:
    """The probs mode (class_prob) into whole-tile windows: bytes within 1."""
    g = ft.tail_geometry(size, margin)
    s = g.out_extent
    p = random_tail(rng, k)
    x3 = random_x3(rng, g, batch)
    win = ft.full_windows(batch, s, x3.device)
    got = torch.zeros((batch * s, s, k), dtype=torch.uint8, device="cuda")
    want = torch.zeros_like(got)
    ft.fused_tail_probs(x3, p, g, got, win)
    ft.fused_tail_probs_plain(x3, p, g, want, win)
    torch.cuda.synchronize()
    d = (got.int() - want.int()).abs().max().item()
    check(d <= 1, f"fused_tail probs {size}/{margin} B={batch} K={k} bf16: |diff| {d} <= 1, "
          f"{(got != want).float().mean().item():.2e} of bytes differ")
    out = {"max_abs_err": d}
    if timed:
        out["ms"] = cuda_ms(lambda: ft.fused_tail_probs(x3, p, g, got, win))
        out["plain_ms"] = cuda_ms(lambda: ft.fused_tail_probs_plain(x3, p, g, want, win), 5, 1)
        out["library_ms"] = None  # as the argmax mode's
        nbytes = x3.numel() * x3.element_size() + batch * s * s * k
        out.update(bound(tail_flops(g, batch, k), nbytes), bytes=nbytes)
    return out


def check_tail_probs_planes(rng, height: int, width: int, batch: int) -> int:
    """The probs mode through the owned windows into the (H, W, K) plane of a
    zone with realigned tiles, against plain tiles written in tile order."""
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
    plane = torch.zeros((Ho, Wo, K), dtype=torch.uint8, device="cuda")
    for b0 in range(0, n_total, batch):
        ft.fused_tail_probs(x3[b0:b0 + batch], p, g, plane, windows[b0:b0 + batch])
    tiles_p = torch.zeros((n * s, s, K), dtype=torch.uint8, device="cuda")
    ft.fused_tail_probs_plain(x3[:n], p, g, tiles_p, ft.full_windows(n, s, x3.device))
    ref = torch.zeros_like(plane)
    for i, t in enumerate(tiles):  # the reference's tile-order writes, last wins
        r0, c0 = min(t.irow0, Ho - s), min(t.icol0, Wo - s)
        ref[r0:r0 + s, c0:c0 + s] = tiles_p[i * s:(i + 1) * s]
    torch.cuda.synchronize()
    d = (plane.int() - ref.int()).abs().max().item()
    check(d <= 1, f"fused_tail probs into the plane, {height}x{width} zone, {n} tiles, "
          f"B={batch}: |diff| {d} <= 1")
    return d


def check_tail_logits(rng, size: int, batch: int, k: int, timed: bool = False) -> dict:
    """The logits mode at margin 0 (the whole tile): within GAP_TOL of the
    plain logits."""
    g = ft.tail_geometry(size, 0)
    p = random_tail(rng, k)
    x3 = random_x3(rng, g, batch)
    got = ft.fused_tail_logits(x3, p, g)
    d = (got - ft.fused_tail_logits_plain(x3, p, g)).abs().max().item()
    torch.cuda.synchronize()
    check(d < GAP_TOL, f"fused_tail logits {size}/0 B={batch} K={k} bf16: largest |diff| "
          f"{d:.2e} < {GAP_TOL}")
    out = {"max_abs_err": d}
    if timed:
        out["ms"] = cuda_ms(lambda: ft.fused_tail_logits(x3, p, g, got))
        out["plain_ms"] = cuda_ms(lambda: ft.fused_tail_logits_plain(x3, p, g), 5, 1)
        out["library_ms"] = None  # as the argmax mode's
        nbytes = x3.numel() * x3.element_size() + got.numel() * 4
        out.update(bound(tail_flops(g, batch, k), nbytes), bytes=nbytes)
    return out


def top2_gap_last(x: torch.Tensor) -> torch.Tensor:
    top2 = x.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def compare_tile_softmax(label: str, logits: torch.Tensor) -> dict:
    """tile_probs and tile_argmax against their plain versions on the same
    logits: probs and prob within ACC_REL_TOL (relative), classes equal
    except where the logits' top-2 gap is below MEAN_GAP_TOL."""
    probs_k, probs_p = ts.tile_probs(logits), ts.tile_probs_plain(logits)
    rel = ((probs_k - probs_p).abs() / probs_p.abs().clamp_min(1e-30)).max().item()
    d_probs = (probs_k - probs_p).abs().max().item()
    del probs_k, probs_p
    (cls_k, prob_k), (cls_p, prob_p) = ts.tile_argmax(logits), ts.tile_argmax_plain(logits)
    off = cls_k != cls_p
    worst_gap = top2_gap_last(logits)[off].max().item() if off.any() else 0.0
    rel_prob = ((prob_k - prob_p).abs() / prob_p).max().item()
    torch.cuda.synchronize()
    check(rel <= ACC_REL_TOL, f"tile_probs {label}: relative diff {rel:.2e} <= {ACC_REL_TOL} "
          f"(|diff| {d_probs:.2e})")
    check(worst_gap < MEAN_GAP_TOL, f"tile_argmax {label}: {int(off.sum())} class mismatches, "
          f"largest top-2 gap there {worst_gap:.2e} < {MEAN_GAP_TOL}")
    check(rel_prob <= ACC_REL_TOL, f"tile_argmax {label}: prob relative diff {rel_prob:.2e} "
          f"<= {ACC_REL_TOL}")
    return {"probs": {"max_abs_err": d_probs},
            "argmax": {"max_abs_err": (prob_k - prob_p).abs().max().item(),
                       "mismatches": int(off.sum())}}


def check_tile_softmax(rng) -> dict:
    """The full-tile softmax kernel (streaming payloads) against its plain
    version: on the main path's logits (the fused tail's logits mode on a
    batch of 128 whole 512 tiles, K = 19), timed with its byte bounds, and on
    random logits at small geometries whose pixel counts are not multiples
    of a block (K = 13, 16 and 32)."""
    g = ft.tail_geometry(S, 0)
    logits = ft.fused_tail_logits(random_x3(rng, g, BATCH), random_tail(rng, K), g)
    out = compare_tile_softmax(f"({BATCH}, {S}, {S}, {K}), fused_tail logits", logits)
    gen = torch.Generator("cuda").manual_seed(SEED)
    for shape in ((3, 37, 37, 13), (2, 40, 40, 16), (2, 23, 23, 32)):
        small = compare_tile_softmax(str(shape), torch.randn(shape, generator=gen,
                                                             device="cuda") * 3)
        for mode in ("probs", "argmax"):
            out[mode]["max_abs_err"] = max(out[mode]["max_abs_err"], small[mode]["max_abs_err"])
    px = logits.numel() // K
    in_bytes = logits.numel() * 4
    # operations a pixel: K compares, subtractions, exponentials and adds,
    # and K divisions (probs) or one (argmax)
    out["probs"].update(
        ms=cuda_ms(lambda: ts.tile_probs(logits), 10, 2),
        plain_ms=cuda_ms(lambda: ts.tile_probs_plain(logits), 3, 1),
        library_ms=None, bytes=2 * in_bytes,
        **bound(px * 5 * K, 2 * in_bytes, PEAK_FP32_FLOPS))
    out["argmax"].update(
        ms=cuda_ms(lambda: ts.tile_argmax(logits), 10, 2),
        plain_ms=cuda_ms(lambda: ts.tile_argmax_plain(logits), 3, 1),
        library_ms=None, bytes=in_bytes + px * 5,
        **bound(px * (4 * K + 1), in_bytes + px * 5, PEAK_FP32_FLOPS))
    return out


def compare_mean(label: str, acc_k, div_k, acc_p, div_p, crop) -> dict:
    """Accumulators of kernel and plain version on the same logits, then
    stitch_finalize of each."""
    rel = ((acc_k - acc_p).abs() / acc_p.abs().clamp_min(1e-30)).max().item()
    rel_div = ((div_k - div_p).abs() / div_p.abs().clamp_min(1e-30)).max().item()
    check(rel <= ACC_REL_TOL and rel_div <= ACC_REL_TOL,
          f"accumulate_probs {label}: acc relative diff {rel:.2e}, div {rel_div:.2e} "
          f"<= {ACC_REL_TOL}")
    check(torch.equal(acc_k, acc_p) and torch.equal(div_k, div_p),
          f"accumulate_probs {label}: acc and div bit for bit equal to the plain version")
    fin_k = st.stitch_finalize_mean(acc_k, div_k, crop)
    fin_p = st.stitch_finalize_mean_plain(acc_p, div_p, crop)
    oy, ox, h, w = crop
    mean = acc_p[oy:oy + h, ox:ox + w] / div_p[oy:oy + h, ox:ox + w].clamp_min(1e-8)[..., None]
    off = fin_k[0] != fin_p[0]
    worst = top2_gap_last(mean)[off].max().item() if off.any() else 0.0
    dprob = (fin_k[1].int() - fin_p[1].int()).abs().max().item()
    torch.cuda.synchronize()
    check(worst < MEAN_GAP_TOL, f"accumulate_probs + stitch_finalize {label}: {int(off.sum())} "
          f"class mismatches, largest top-2 gap of the mean there {worst:.2e} < {MEAN_GAP_TOL}")
    check(dprob <= 1, f"accumulate_probs + stitch_finalize {label}: prob |diff| {dprob} <= 1")
    return {"acc_rel": rel, "mismatches": int(off.sum()),
            "max_abs_err": (acc_k - acc_p).abs().max().item()}


def compare_best(label: str, bp_k, bc_k, bp_p, bc_p, crop) -> dict:
    """merge_max planes of kernel and plain version on the same logits."""
    oy, ox, h, w = crop
    fin_k = st.stitch_finalize_max(bp_k, bc_k, crop)
    fin_p = st.stitch_finalize_max_plain(bp_p, bc_p, crop)
    off = fin_k[0] != fin_p[0]
    agree = 1.0 - off.float().mean().item()
    pk, pp = bp_k[oy:oy + h, ox:ox + w][off], bp_p[oy:oy + h, ox:ox + w][off]
    worst = ((pk - pp).abs() / pp).max().item() if off.any() else 0.0
    dprob = (fin_k[1].int() - fin_p[1].int()).abs().max().item()
    torch.cuda.synchronize()
    check(agree >= 0.999, f"merge_max {label}: class agreement {agree:.6f} >= 0.999")
    check(worst <= ACC_REL_TOL, f"merge_max {label}: {int(off.sum())} class mismatches, each "
          f"where two tiles tie (best prob relative diff there {worst:.2e} <= {ACC_REL_TOL})")
    check(dprob <= 1, f"merge_max {label}: prob |diff| {dprob} <= 1")
    return {"agree": agree, "mismatches": int(off.sum()), "max_abs_err": dprob}


def stitch_batches(height: int, width: int, size: int, stride: int, batch: int):
    """Padded origins, valid flags and footprints of a zone's batches, as
    DeviceZoneRunner.run forms them, with the padded planes' shape and crop."""
    margin = M
    tiles = slice_grid(width, height, size, margin, stride).tiles
    n = len(tiles)
    all_tiles = tiles + [tiles[-1]] * ((-n) % batch)
    org = np.array([(t.row0 + margin, t.col0 + margin) for t in all_tiles], np.int32)
    val = np.array([1.0] * n + [0.0] * (len(all_tiles) - n), np.float32)
    hp = height + margin + max(margin, size - height - margin)
    wp = width + margin + max(margin, size - width - margin)
    batches = [(torch.from_numpy(o).to("cuda"), torch.from_numpy(v).to("cuda"),
                st.footprint(o, v, size))
               for o, v in zip(org.reshape(-1, batch, 2), val.reshape(-1, batch))]
    return batches, (hp, wp), (margin, margin, height, width)


def check_stitch(timed: bool = False) -> dict:
    """accumulate_probs, merge_max and stitch_finalize against their plain
    versions on the same random logits: one main-path batch of the 4096²
    zone at stride 256 (128 full 512 tiles), and every batch of a 1000 x
    1100 zone at batch 8, whose last tiles realign and whose last batch has
    padding duplicates."""
    gen = torch.Generator("cuda").manual_seed(SEED)
    w = torch.from_numpy(patch_weights(S).astype(np.float32)).to("cuda")
    out = {}
    for label, (height, width, batch) in (("4096x4096 zone, first batch", (ZONE, ZONE, BATCH)),
                                          ("1000x1100 zone, every batch", (1000, 1100, 8))):
        batches, hw, crop = stitch_batches(height, width, S, S - 2 * M, batch)
        if batch == BATCH:
            batches = batches[:1]
        logits = [torch.randn((batch, S, S, K), generator=gen, device="cuda") * 3
                  for _ in batches]
        for lg, (_, val, _) in zip(logits, batches):  # duplicates repeat the last tile
            n_real = int(val.count_nonzero())
            lg[n_real:] = lg[n_real - 1]
        for weights in (w, None):
            planes = [torch.zeros((*hw, K), device="cuda"), torch.zeros(hw, device="cuda")]
            planes_p = [torch.zeros_like(a) for a in planes]
            for lg, (org, val, fp) in zip(logits, batches):
                st.accumulate_probs(lg, org, val, weights, *planes, fp)
                st.accumulate_probs_plain(lg, org, val, weights, *planes_p)
            name = f"{label}, {'average_weights' if weights is not None else 'average'}"
            res = compare_mean(name, *planes, *planes_p, crop)
            fin_k = st.stitch_finalize_mean(*planes_p, crop)
            fin_p = st.stitch_finalize_mean_plain(*planes_p, crop)
            torch.cuda.synchronize()
            check(torch.equal(fin_k, fin_p), f"stitch_finalize mean {name}: exactly equal "
                  "on the same planes")
            out.setdefault("accumulate", []).append(res)
        best = [torch.zeros(hw, device="cuda"), torch.zeros(hw, dtype=torch.uint8, device="cuda")]
        best_p = [torch.zeros_like(a) for a in best]
        for lg, (org, val, fp) in zip(logits, batches):
            st.merge_max(lg, org, val, *best, fp)
            st.merge_max_plain(lg, org, *best_p)
        out.setdefault("merge", []).append(compare_best(label, *best, *best_p, crop))
        fin_k = st.stitch_finalize_max(*best_p, crop)
        torch.cuda.synchronize()
        check(torch.equal(fin_k, st.stitch_finalize_max_plain(*best_p, crop)),
              f"stitch_finalize max {label}: exactly equal on the same planes")
        if timed and batch == BATCH:
            out["timed"] = time_stitch(logits[0], batches[0], w, planes, best, crop)
    out["accumulate"].append(check_accumulate_even_k(gen, w))
    return out


def check_accumulate_even_k(gen, w, k: int = 16) -> dict:
    """accumulate_probs at an even K (the kernel pads its shared stride to
    K + 1) on the main batch's shapes: 128 full 512 tiles of the 4096² zone
    at stride 256, with and without weights."""
    batches, hw, crop = stitch_batches(ZONE, ZONE, S, S - 2 * M, BATCH)
    org, val, fp = batches[0]
    logits = torch.randn((BATCH, S, S, k), generator=gen, device="cuda") * 3
    worst = 0.0
    for weights in (w, None):
        acc, div = torch.zeros((*hw, k), device="cuda"), torch.zeros(hw, device="cuda")
        acc_p, div_p = torch.zeros_like(acc), torch.zeros_like(div)
        st.accumulate_probs(logits, org, val, weights, acc, div, fp)
        st.accumulate_probs_plain(logits, org, val, weights, acc_p, div_p)
        torch.cuda.synchronize()
        name = "average_weights" if weights is not None else "average"
        check(torch.equal(acc, acc_p) and torch.equal(div, div_p),
              f"accumulate_probs K={k}, 4096x4096 zone, first batch, {name}: acc and div bit "
              "for bit equal to the plain version")
        worst = max(worst, (acc - acc_p).abs().max().item())
    return {"max_abs_err": worst}


def time_stitch(logits, batch, w, planes, best, crop) -> dict:
    """Times of the three kernels and their plain versions at the main path's
    shapes, with their bounds: each input read once, each output written
    once (the accumulators over the batch's footprint both)."""
    org, val, fp = batch
    n_valid = int(val.count_nonzero())
    B, S_, _, K_ = logits.shape
    px = n_valid * S_ * S_  # (tile, pixel) pairs the batch adds
    fh, fw = fp[2], fp[3]
    oy, ox, h, w_ = crop
    rows = {}
    rows["accumulate_probs"] = dict(
        ms=cuda_ms(lambda: st.accumulate_probs(logits, org, val, w, *planes, fp), 10, 2),
        plain_ms=cuda_ms(lambda: st.accumulate_probs_plain(logits, org, val, w, *planes), 3, 1),
        **bound(px * (6 * K_ + 3), px * K_ * 4 + fh * fw * (K_ + 1) * 4 * 2 + S_ * S_ * 4,
                PEAK_FP32_FLOPS))
    rows["merge_max"] = dict(
        ms=cuda_ms(lambda: st.merge_max(logits, org, val, *best, fp), 10, 2),
        plain_ms=cuda_ms(lambda: st.merge_max_plain(logits, org, *best), 3, 1),
        **bound(px * (4 * K_ + 2), px * K_ * 4 + fh * fw * 5 * 2, PEAK_FP32_FLOPS))
    rows["stitch_finalize"] = dict(
        ms=cuda_ms(lambda: st.stitch_finalize_mean(*planes, crop)),
        plain_ms=cuda_ms(lambda: st.stitch_finalize_mean_plain(*planes, crop), 5, 1),
        **bound(h * w_ * (2 * K_ + 2), h * w_ * ((K_ + 1) * 4 + 2), PEAK_FP32_FLOPS))
    rows["stitch_finalize_max"] = dict(
        ms=cuda_ms(lambda: st.stitch_finalize_max(*best, crop)),
        plain_ms=cuda_ms(lambda: st.stitch_finalize_max_plain(*best, crop), 5, 1),
        **bound(h * w_ * 2, h * w_ * 7, PEAK_FP32_FLOPS))
    return rows


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


def random_zone(rng, shape: tuple, dtype: str = "uint8") -> np.ndarray:
    """Zone values of the dtype: bytes, 12-bit imagery, an elevation with
    negative values, a float elevation."""
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    if dtype == "uint16":
        return rng.integers(0, 4096, shape).astype(np.uint16)
    if dtype == "int16":
        return rng.integers(-1000, 3000, shape).astype(np.int16)
    return (rng.standard_normal(shape) * 80.0 + 200.0).astype(np.float32)


def check_gather_unaligned(rng, hp: int, wp: int, c: int, size: int, n: int,
                           dtype: str = "uint8") -> float:
    """A zone whose row pitch wp * c is odd where c is, at origins with odd
    columns: every tile row starts at an unaligned zone byte (uint8) or at
    an odd element."""
    zone = torch.from_numpy(random_zone(rng, (hp, wp, c), dtype)).to("cuda")
    cols = np.minimum(rng.integers(0, wp - size + 1, n) | 1, wp - size)
    org = np.stack([rng.integers(0, hp - size + 1, n), cols], axis=1).astype(np.int32)
    return compare_gather(zone, torch.from_numpy(org).to("cuda"), size,
                          f"{dtype} S={size} C={c} pitch {wp * c} B={n} odd columns")


def check_gather(rng, zone_hw: int, timed: bool = False, dtype: str = "uint8") -> dict:
    """The instance of ``dtype`` at the main path's shapes, on a zone with an
    odd row pitch and odd origin columns, and at S = 36, C = 3 (S*C not a
    multiple of 8); timed at the main path's shapes with its byte bound."""
    Hp = zone_hw + 2 * M
    zone = torch.from_numpy(random_zone(rng, (Hp, Hp, C), dtype)).to("cuda")
    grid = slice_grid(zone_hw, zone_hw, S, M)
    org_np = np.array([(t.row0 + M, t.col0 + M) for t in grid.tiles[:BATCH]], np.int32)
    org = torch.from_numpy(org_np).to("cuda")
    worst = compare_gather(zone, org, S, f"{dtype} main path B={len(org_np)}")
    worst = max(worst, check_gather_unaligned(rng, 600, 601, C, S, 8, dtype),
                check_gather_unaligned(rng, 100, 101, 3, 36, 16, dtype))
    out = {"max_abs_err": worst}
    if timed:
        out["ms"] = cuda_ms(lambda: ga.gather_normalize(
            zone, org, S, "scaling", out_dtype=torch.bfloat16))
        out["plain_ms"] = cuda_ms(lambda: ga.gather_normalize_plain(
            zone, org, S, "scaling", out_dtype=torch.bfloat16))
        covered = np.zeros((Hp, Hp), bool)  # each zone element read once
        for r, c in org_np:
            covered[r:r + S, c:c + S] = True
        nbytes = (int(covered.sum()) * C * zone.element_size() + org_np.nbytes
                  + len(org_np) * S * S * C * 2)
        # one float32 multiply per element
        out.update(bound(len(org_np) * S * S * C, nbytes, PEAK_FP32_FLOPS), bytes=nbytes)
    return out


def check_gather_typed(rng, zone_hw: int) -> dict:
    """The typed instance on uint16, int16 and float32 zones, each timed:
    the uint16 numbers, and each dtype's under ``modes``."""
    modes = []
    for dtype in TYPED_ZONES:
        r = check_gather(rng, zone_hw, timed=True, dtype=dtype)
        modes.append(dict(mode=dtype, **r))
        torch.cuda.empty_cache()
    return dict(modes[0], modes=modes, max_abs_err=max(m["max_abs_err"] for m in modes))


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


def check_fold_epilogue(model: FoldedZoneModel, x: torch.Tensor) -> float:
    """conv_epilogue at every site of one batch of the folded walk (scale 1,
    shift = bias, the identity in bf16), on the operands that batch gives
    it: equal bit for bit."""
    rec = SiteRecorder()
    model.tail_input(x, M, epilogue=rec)
    check(len(rec.sites) == EPILOGUE_SITES,
          f"conv_epilogue, folded: {len(rec.sites)} sites in one batch ({EPILOGUE_SITES})")
    check(any(s["residual"] is not None and s["residual"].dtype == torch.bfloat16
              for s in rec.sites), "conv_epilogue, folded: bf16 identities")
    return max(compare_epilogue("folded " + site_label(k, site), site)
               for k, site in enumerate(rec.sites))


class Int8Recorder:
    """int8_conv and quantize_act wrappers that launch the kernels and keep
    each call's operands: the int8 sites of a batch, at their shapes and on
    their data."""

    def __init__(self, model: pq.QuantizedZoneModel | None = None):
        self.convs: list[dict] = []
        self.quants: list[dict] = []
        self.names: list[str] = []  # each conv's site name, with a model
        self._names = {} if model is None else {
            id(p): name for qp in (model.qparams, model.dec_qparams or {})
            for name, p in qp.items()}

    def conv(self, x, p, stride, padding, dilation=1, **kw):
        site = dict(x=x, p=p, stride=stride, padding=padding, dilation=dilation, **kw)
        self.convs.append(site)
        self.names.append(self._names.get(id(p), "?"))
        return ic.int8_conv(**site)

    def quantize(self, x, sx, channels=None):
        self.quants.append(dict(x=x, sx=sx, channels=channels))
        return qa.quantize_act(x, sx, channels)


def int8_shape(site: dict) -> tuple[int, int, int, int, int, int]:
    """(B, Co, Ho, Wo, kh, kw) of an int8 site."""
    x, p = site["x"], site["p"]
    co, _, kh, kw = p.wq.shape
    ho, wo = (ic._out_hw(n, k, site["stride"], site["padding"], site["dilation"])
              for n, k in ((x.shape[2], kh), (x.shape[3], kw)))
    return x.shape[0], co, ho, wo, kh, kw


def int8_label(k: int, site: dict) -> str:
    B, co, ho, wo, kh, _ = int8_shape(site)
    outs = ("f32 " if site["keep_f32"] else "") + ("int8" if site["out_sx"] is not None else "")
    return (f"site {k} {tuple(site['x'].shape)} -> ({B}, {co}, {ho}, {wo}) {kh}x{kh}/"
            f"{site['stride']}{', residual' if site['residual'] is not None else ''}"
            f"{'' if site['relu'] else ', no ReLU'}, out {outs.strip()}")


def int8_cost(site: dict) -> tuple[int, int]:
    """(operations, bytes): 2 per int8 MAC over the real channels; each input
    read once (activations, weights, deq and b, the residual), each output
    written once."""
    B, co, ho, wo, kh, kw = int8_shape(site)
    m, ci = B * ho * wo, site["p"].wq.shape[1]
    out_bytes = 4 * (site["residual"] is not None) + 4 * site["keep_f32"] + (
        site["out_sx"] is not None)
    return 2 * m * co * ci * kh * kw, site["x"].numel() + site["p"].wq.numel() + 8 * co + \
        m * co * out_bytes


def int_mm_ms(site: dict) -> float | None:
    """torch._int_mm (cuBLASLt) on the site's im2col operand, GEMM only: the
    library yardstick. None where the call refuses the shapes."""
    x, p = site["x"], site["p"]
    co, ci, kh, kw = p.wq.shape
    cols = torch.nn.functional.unfold(x.to(torch.bfloat16), (kh, kw), site["dilation"],
                                      site["padding"], site["stride"])
    a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
    del cols
    w = torch.nn.functional.pad(p.wq, (0, 0, 0, 0, 0, x.shape[1] - ci)).reshape(co, -1)
    try:
        return cuda_ms(lambda: torch._int_mm(a, w.t()), 5, 1)
    except RuntimeError as error:
        print(f"    torch._int_mm refused {tuple(a.shape)} x {tuple(w.t().shape)}: {error}")
        return None


def compare_int8(label: str, site: dict) -> None:
    """Kernel vs plain at one site: float32 and int8 outputs equal bit for
    bit (the int32 sums are exact, and both round fma, add, multiply)."""
    got, want = ic.int8_conv(**site), ic.int8_conv_plain(**site)
    torch.cuda.synchronize()
    same = all((a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
               for a, b in zip(got, want))
    check(same, f"int8_conv {label}: float32 and int8 outputs exactly equal")


def check_int8_edges(device: str = "cuda") -> int:
    """int8_conv exactly equal to its plain version at INT8_EDGES, on random
    int8 operands (zeros in padded channels, as quantize_act writes them),
    float32 and int8 outputs: ragged M and Co, Kp not a multiple of the
    128-byte stage, stride and dilation, every instance of the kernel, a
    residual without ReLU, and several tiles a block."""
    gen = torch.Generator(device).manual_seed(SEED + 9)

    def randint8(shape):
        return torch.randint(-127, 128, shape, generator=gen, device=device, dtype=torch.int8)

    for label, B, H, W, ci, co, k, stride, pad, dil, res, relu in INT8_EDGES:
        p = ic.Int8ConvParams(randint8((co, ci, k, k)), 0.05,
                              torch.rand(co, generator=gen, device=device) * 2e-3 + 1e-4,
                              torch.randn(co, generator=gen, device=device))
        x = torch.zeros((B, H, W, p.in_channels), dtype=torch.int8, device=device)
        x[..., :ci] = randint8((B, H, W, ci))
        x = x.permute(0, 3, 1, 2)  # channels_last
        ho, wo = (ic._out_hw(n, k, stride, pad, dil) for n in (H, W))
        r = (torch.randn((B, ho, wo, co), generator=gen, device=device).permute(0, 3, 1, 2)
             if res else None)
        bn, load = ic.kernel_instance(p.in_channels, co, k, stride, pad, dil)
        how = f"im2col TMA, {load}-byte rows" if load in ic.TMA_ROWS else f"{load}-byte gathers"
        compare_int8(f"{label}: x {tuple(x.shape)} -> ({B}, {co}, {ho}, {wo}), Kp "
                     f"{p.packed.shape[1]}, instance {bn} columns / {how}",
                     dict(x=x, p=p, stride=stride, padding=pad, dilation=dil, residual=r,
                          relu=relu, keep_f32=True, out_sx=0.04))
    return len(INT8_EDGES)


def int8_group(name: str) -> str:
    """The timing group of an int8 site name: stem, layer1-4 or decoder."""
    head = name.split("/")[0].split("_")[0]
    return "decoder" if head.startswith("block") else head


def compare_quantize(label: str, x: torch.Tensor, sx: float, channels: int | None) -> None:
    got, want = qa.quantize_act(x, sx, channels), qa.quantize_act_plain(x, sx, channels)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"quantize_act {label}: exactly equal")


def check_int8(model: pq.QuantizedZoneModel, x: torch.Tensor, timed: bool = False) -> dict:
    """int8_conv and quantize_act against their plain versions, exactly, at
    every distinct site geometry of one batch of 4 tiles of x (and
    quantize_act on a bf16 input and at 20 -> 24 channels); timed with
    bounds, plain and library times at every site of one batch of x."""
    rec = Int8Recorder()
    model.tail_input(x[:4], M, conv=rec.conv, quantize=rec.quantize)
    check(len(rec.convs) == INT8_SITES and len(rec.quants) == QUANTIZE_SITES,
          f"int8 sites of one batch: {len(rec.convs)} int8_conv ({INT8_SITES}), "
          f"{len(rec.quants)} quantize_act ({QUANTIZE_SITES})")
    seen = set()
    for k, site in enumerate(rec.convs):
        key = (tuple(site["x"].shape), tuple(site["p"].wq.shape), site["stride"],
               site["residual"] is not None, site["keep_f32"], site["out_sx"] is not None)
        if key not in seen:
            seen.add(key)
            compare_int8(int8_label(k, site) + " B=4", site)
    for k, q in enumerate(rec.quants):
        compare_quantize(f"site {k} {tuple(q['x'].shape)} {q['x'].dtype} -> {q['channels']} "
                         "channels", q["x"], q["sx"], q["channels"])
        compare_quantize(f"site {k} as bf16", q["x"].to(torch.bfloat16), q["sx"], q["channels"])
    gen = torch.Generator("cuda").manual_seed(SEED)
    odd = (torch.randn((3, 20, 17, 19), generator=gen, device="cuda") * 3).contiguous(
        memory_format=torch.channels_last)
    compare_quantize("(3, 20, 17, 19) -> 24 channels", odd, 0.02, 24)
    out = {"max_abs_err": 0, "distinct_sites": len(seen), "edge_cases": check_int8_edges()}
    del rec
    if not timed:
        return out
    rec = Int8Recorder(model)
    model.tail_input(x, M, conv=rec.conv, quantize=rec.quantize)
    rows = []
    for k, site in enumerate(rec.convs):
        ops, nbytes = int8_cost(site)
        rows.append({"site": int8_label(k, site), "group": int8_group(rec.names[k]),
                     "ms": cuda_ms(lambda a=site: ic.int8_conv(**a), 5, 1),
                     "plain_ms": cuda_ms(lambda a=site: ic.int8_conv_plain(**a), 1, 1),
                     "library_ms": int_mm_ms(site), "ops": ops, "bytes": nbytes,
                     **bound(ops, nbytes, PEAK_INT8_OPS)})
        torch.cuda.empty_cache()
    quants = []
    for k, q in enumerate(rec.quants):
        n = q["x"].numel()
        nbytes = n * q["x"].element_size() + n // q["x"].shape[1] * (q["channels"] or 0)
        quants.append({"site": f"site {k} {tuple(q['x'].shape)} -> {q['channels']} channels",
                       "ms": cuda_ms(lambda a=q: qa.quantize_act(**a), 10, 2),
                       "plain_ms": cuda_ms(lambda a=q: qa.quantize_act_plain(**a), 3, 1),
                       "bytes": nbytes, **bound(3 * n, nbytes, PEAK_FP32_FLOPS)})
    del rec

    def total(rs: list[dict]) -> dict:
        lib = [r.get("library_ms") for r in rs]
        return {"ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": max(("bytes", "operations"), key=lambda b: sum(
                    r["bound_ms"] for r in rs if r["bound_by"] == b)),
                "library_ms": None if None in lib else sum(lib), "bytes": sum(r["bytes"] for r in rs)}

    groups = {g: total([r for r in rows if r["group"] == g])
              for g in dict.fromkeys(r["group"] for r in rows)}
    ratios = [(r["ms"] / r["library_ms"], r["site"]) for r in rows if r["library_ms"]]
    out.update(conv=dict(total(rows), sites=rows, ops=sum(r["ops"] for r in rows),
                         groups=groups, worst_library_ratio=max(ratios) if ratios else None),
               quantize=dict(total(quants), library_ms=None, sites=quants))
    return out


def synth_inputs(tmp: Path, zone_hw: int, rng) -> tuple[Path, Path, Path]:
    """The zone at <dpt>/<zone>/zone.tif, a truth raster (classes 1..K) at
    truth/<dpt>/<zone>/truth.tif, and the weights."""
    img = rng.integers(0, 256, (C, zone_hw, zone_hw), dtype=np.uint8)
    transform = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    zone = tmp / DPT / ZONE_NAME / "zone.tif"
    truth = tmp / "truth" / DPT / ZONE_NAME / "truth.tif"
    zone.parent.mkdir(parents=True)
    truth.parent.mkdir(parents=True)
    write_array(zone, img, transform=transform, crs=2154, compress="deflate")
    write_array(truth, rng.integers(1, K + 1, (zone_hw, zone_hw), dtype=np.uint8),
                transform=transform, crs=2154, compress="deflate")
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
    return zone, truth, weights


def detect_config(tmp: Path, zone: Path, truth: Path, weights: Path) -> dict:
    return {
        "output_path": str(tmp / "out"), "output_name": "zone-ARGMAX",
        "input_img_path": str(zone), "truth_path": str(truth), "channels": [1, 2, 3, 4, 5],
        "img_pixels_detection": S, "margin": M, "output_type": "argmax",
        "n_classes": K, "model_weights": str(weights),
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet34_unet"}},
        "batch_size": BATCH, "use_gpu": True, "num_worker": 2, "write_dataframe": False,
        "norma_task": [{"norm_type": "scaling", "norm_means": [], "norm_stds": []}],
    }


class PlainStitch:
    """The stitch kernels' plain versions under the wrappers' names and
    arguments."""

    @staticmethod
    def accumulate_probs(logits, origins, valid, weights, acc, div, fp):
        st.accumulate_probs_plain(logits, origins, valid, weights, acc, div)

    @staticmethod
    def merge_max(logits, origins, valid, best_p, best_c, fp):
        st.merge_max_plain(logits, origins, best_p, best_c)

    stitch_finalize_mean = staticmethod(st.stitch_finalize_mean_plain)
    stitch_finalize_max = staticmethod(st.stitch_finalize_max_plain)


class PlainTileOps:
    """The full-tile softmax kernels' plain versions under the wrappers'
    names."""

    tile_probs = staticmethod(ts.tile_probs_plain)
    tile_argmax = staticmethod(ts.tile_argmax_plain)


class PlainRunner(DeviceZoneRunner):
    """The zone programs with every kernel's plain version, on the same
    card."""

    stitch_ops = PlainStitch
    tile_ops = PlainTileOps

    def _tail_input(self, zone_p, origins, margin):
        x = ga.gather_normalize_plain(zone_p, origins, self.size,
                                      out_dtype=self.model.dtype, **self.norm)
        plain = dict(epilogue=ep.conv_epilogue_plain)
        if isinstance(self.model, pq.QuantizedZoneModel):
            plain.update(conv=ic.int8_conv_plain, quantize=qa.quantize_act_plain)
        return self.model.tail_input(x, margin, **plain)

    def _forward_tiles(self, zone_p, origins, planes, windows):
        ft.fused_tail_plain(self._tail_input(zone_p, origins, self.margin), self.tail,
                            self.geometry, planes, windows)

    def _forward_probs(self, zone_p, origins, plane, windows):
        ft.fused_tail_probs_plain(self._tail_input(zone_p, origins, self.margin), self.tail,
                                  self.geometry, plane, windows)

    def _forward_logits(self, zone_p, origins, out):
        return ft.fused_tail_logits_plain(self._tail_input(zone_p, origins, 0), self.tail,
                                          self.full_geometry)


def run_plain(cfg: dict, method: str = "exact-clipping", stride: int | None = None,
              staged: dict | None = None, prepared: tuple | None = None) -> dict:
    """One zone run of ``cfg`` through PlainRunner (stride: the tile interior
    by default), on ``prepared`` (model, tail) when given."""
    cfg = eng.setup_out_path(dict(cfg, compare=False))
    device = eng.resolve_device(cfg)
    model, tail = prepared or eng.prepare_model(cfg, device)
    size, margin = cfg["img_pixels_detection"], cfg["margin"]
    stride = stride or size - 2 * margin
    with TiffReader(cfg["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, size, margin, stride,
                          reader.transform, reader.crs)
    return PlainRunner(cfg, model, tail).run(grid, method,
                                             staged or eng.stage_zone(cfg, device))


def reset_launches() -> None:
    ft.launches = ft.probs_launches = ft.logits_launches = ga.launches = ep.launches = 0
    ga.typed_launches = ic.launches = qa.launches = 0
    au.launches = au.tiled_launches = 0
    wc.launches = wc.backward_launches = bt.launches = bt.backward_launches = 0
    for counts in (st.launches, ts.launches):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    return {"fused_tail": ft.launches, "fused_tail_probs": ft.probs_launches,
            "fused_tail_logits": ft.logits_launches, "gather_normalize": ga.launches,
            "gather_normalize_typed": ga.typed_launches, "conv_epilogue": ep.launches,
            "int8_conv": ic.launches, "quantize_act": qa.launches,
            "augment_normalize": au.launches, "weighted_ce": wc.launches,
            "weighted_ce_backward": wc.backward_launches, "bn_stats": bt.launches,
            "bn_backward": bt.backward_launches, **st.launches, **ts.launches}


def expected_launches(method: str, output_type: str, n_batches: int,
                      streaming: bool = False, typed: bool = False,
                      int8_blocks: int | None = None) -> dict:
    """Each kernel's launches for one zone run of ``n_batches`` batches, on
    the device route or the streaming route (whose stitches run on the
    host, after the full-tile softmax kernel); ``typed``: a zone that is
    not uint8; ``int8_blocks``: the int8 model with that many int8 decoder
    blocks (the others' two convs each an epilogue)."""
    out = dict.fromkeys(read_launches(), 0)
    out["gather_normalize_typed" if typed else "gather_normalize"] = n_batches
    out["conv_epilogue"] = EPILOGUE_SITES * n_batches
    if int8_blocks is not None:
        out.update(int8_conv=(ENCODER_INT8_SITES + 2 * int8_blocks) * n_batches,
                   quantize_act=(2 + int8_blocks) * n_batches,
                   conv_epilogue=2 * (4 - int8_blocks) * n_batches)
    if output_type == "class_prob":
        out["fused_tail_probs"] = n_batches
    elif method == "exact-clipping":
        out["fused_tail"] = n_batches
    elif streaming:
        out.update(fused_tail_logits=n_batches)
        out["tile_argmax" if method == "max" else "tile_probs"] = n_batches
    else:
        out.update(fused_tail_logits=n_batches, stitch_finalize=1)
        out["merge_max" if method == "max" else "accumulate_probs"] = n_batches
    return out


def check_launches(label: str, got: dict, want: dict) -> None:
    check(got == want, f"{label}: launches {got} == expected {want}")


def run_main_path(cfg: dict, conf: Path, zone_hw: int, card: str) -> dict:
    # the plain versions first: their run also warms cuDNN up for the encoder
    plain = run_plain(cfg)
    print(f"  plain-version run: compute {plain['compute_seconds']:.4f} s, "
          f"{plain['patches_per_sec']:.2f} patches/s", flush=True)

    reset_launches()
    t0 = time.perf_counter()
    stats = cli.detect_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    launches = read_launches()

    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    expected = expected_launches("exact-clipping", "argmax", n_batches)
    out = Path(cfg["output_path"]) / "zone-ARGMAX.tif"
    with TiffReader(cfg["input_img_path"]) as src, TiffReader(out) as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, 2),
              f"output raster {r.width}x{r.height}x{r.count}")
        check(r.transform == src.transform and r.crs == src.crs,
              f"georeferencing kept (crs {r.crs})")
        cls, prob = r.read(1), r.read(2)
    check(bool((prob > 0).all()), "every pixel written (prob > 0)")
    check(int(cls.max()) < K, f"classes in [0, {K})")
    check_launches(f"main path, {n_batches} batches", launches, expected)
    print(f"  main path on {card}: {stats['tiles']} tiles, read {stats['read_seconds']:.4f} s, "
          f"h2d {stats['h2d_seconds']:.4f} s, compute {stats['compute_seconds']:.4f} s, "
          f"d2h {stats['d2h_seconds']:.4f} s, {stats['patches_per_sec']:.2f} patches/s, "
          f"detect_main wall {wall:.2f} s", flush=True)

    agree = float((plain["cls"] == cls).mean())
    dprob = int(np.abs(plain["prob"].astype(int) - prob.astype(int)).max())
    check(agree >= 0.999, f"main path vs plain versions: class agreement {agree:.6f} >= 0.999")
    check(dprob <= 1, f"main path vs plain versions: prob |diff| {dprob} <= 1")
    stats = {k: v for k, v in stats.items() if k != "patch_times_ms"}
    return {"stats": stats, "launches": launches, "plain_compute_seconds":
            plain["compute_seconds"], "agree_plain": agree, "prob_diff_plain": dprob}


def write_conf(cfg: dict, name: str) -> Path:
    conf = Path(cfg["output_path"]).parent / f"{name}.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    return conf


def run_class_prob(cfg: dict, zone_hw: int) -> dict:
    """``output_type: class_prob`` through detect_main, against the all-plain
    run: a K-band raster, every band within 1."""
    cp = dict(cfg, output_type="class_prob", output_name="zone-PROBS",
              output_path=str(Path(cfg["output_path"]).parent / "out_class_prob"))
    conf = write_conf(cp, "class_prob")
    reset_launches()
    stats = cli.detect_main([f"--conf={conf}"])
    launches = read_launches()
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    check_launches(f"class_prob, {n_batches} batches", launches,
                   expected_launches("exact-clipping", "class_prob", n_batches))
    with TiffReader(cp["input_img_path"]) as src, TiffReader(
            Path(cp["output_path"]) / "zone-PROBS.tif") as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, K),
              f"class_prob raster {r.width}x{r.height}x{r.count}")
        check(r.transform == src.transform and r.crs == src.crs,
              f"class_prob georeferencing kept (crs {r.crs})")
        probs = r.read()
    plain = run_plain(cp)["probs"]
    dprob = int(np.abs(plain.astype(np.int16) - probs.astype(np.int16)).max())
    same = float((plain == probs).mean())
    check(dprob <= 1, f"class_prob vs plain versions: every band |diff| {dprob} <= 1 "
          f"({same:.6f} of bytes equal)")
    print(f"  class_prob: {stats['tiles']} tiles, h2d {stats['h2d_seconds']:.4f} s, compute "
          f"{stats['compute_seconds']:.4f} s, d2h {stats['d2h_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s", flush=True)
    stats = {k: v for k, v in stats.items() if k != "patch_times_ms"}
    return {"stats": stats, "launches": launches, "max_abs_err": dprob}


def sweep_config(cfg: dict) -> dict:
    """The main zone under the compare config's strategies, batch size,
    normalization and classes."""
    ref = yaml.safe_load(COMPARE_CONFIG.read_text())
    keep = ("strategies", "overlap_strat", "batch_size", "norma_task", "classes",
            "img_pixels_detection", "margin")
    return dict(cfg, output_name="zone-ARGMAX-S",
                output_path=str(Path(cfg["output_path"]).parent / "out_sweep"),
                **{k: ref[k] for k in keep})


@contextlib.contextmanager
def counted_runs():
    """Within the body, each run of a sweep or of batch mode
    (``run_single``) sets the counts to 0 just before it and reads them just
    after: yields {method string, or output name: launches}."""
    per_run: dict[str, dict] = {}
    run_single = eng.run_single

    def counted(config, model, tail, device, stride, method, identifier="", staged=None):
        reset_launches()
        out = run_single(config, model, tail, device, stride, method, identifier, staged)
        per_run[identifier[1:] or config["output_name"]] = read_launches()
        return out

    eng.run_single = counted
    try:
        yield per_run
    finally:
        eng.run_single = run_single


def run_sweep(cfg: dict, zone_hw: int) -> dict:
    """``detect_main -c -m`` over the compare config's 12 combinations:
    rasters, metrics JSON, launches per run, and the size-512 runs against
    the all-plain runs."""
    sw = sweep_config(cfg)
    conf = write_conf(sw, "sweep")
    with counted_runs() as per_run:
        results = cli.detect_main([f"--conf={conf}", "-c", "-m"])
    combos = [(c["img_pixels_detection"], c["margin"], c["stride"], c["stitching"])
              for c in gen_param_combination(validate_detect_config(dict(sw, compare=True)))]
    check(len(combos) == 12, f"compare sweep: {len(combos)} combinations (12 expected)")
    stamped = [p for p in Path(sw["output_path"]).iterdir() if p.is_dir()]
    check(len(stamped) == 1, "compare sweep: one timestamped output directory")
    names = {f"zone-ARGMAX-S_{method_string(sz, sd, mg, 'no-padding', m)}.tif"
             for sz, mg, sd, m in combos}
    check({p.name for p in stamped[0].glob("*.tif")} == names,
          f"compare sweep: the {len(names)} rasters named by method string")
    metrics = list(stamped[0].glob("metrics_per-patch_*.json"))
    check([p.name for p in metrics] == [f"metrics_per-patch_{DPT}_{ZONE_NAME}.json"],
          "compare sweep: one per-patch metrics JSON")
    recs = json.loads(metrics[0].read_text())
    keys = ["Avg_metrics_name", "Avg_metrics", "classes", "per_class_iou", "per_class_fscore"]
    check(bool(recs) and all(len(r) == 1 and list(next(iter(r.values()))) == keys
                             and len(next(iter(r.values()))["classes"]) == K for r in recs),
          f"compare sweep: {len(recs)} per-patch records of the reference's shape")
    for sz, mg, sd, m in combos:
        method = method_string(sz, sd, mg, "no-padding", m)
        n_batches = -(-len(slice_grid(zone_hw, zone_hw, sz, mg, sd).tiles) // sw["batch_size"])
        check_launches(f"compare sweep {method}", per_run[method],
                       expected_launches(m, "argmax", n_batches))
        st_ = results[method]
        print(f"  {method}: {st_['tiles']} tiles, compute {st_['compute_seconds']:.4f} s, "
              f"{st_['patches_per_sec']:.2f} patches/s", flush=True)

    device = eng.resolve_device(sw)
    staged = eng.stage_zone(sw, device)
    for sz, mg, sd, m in combos:
        if sz != S:
            continue
        method = method_string(sz, sd, mg, "no-padding", m)
        plain = run_plain(dict(sw, img_pixels_detection=sz, margin=mg), m, sd, staged)
        with TiffReader(stamped[0] / f"zone-ARGMAX-S_{method}.tif") as r:
            cls, prob = r.read(1), r.read(2)
        agree = float((plain["cls"] == cls).mean())
        dprob = int(np.abs(plain["prob"].astype(int) - prob.astype(int)).max())
        check(agree >= 0.999, f"{method} vs plain versions: class agreement {agree:.6f} >= 0.999")
        check(dprob <= 1, f"{method} vs plain versions: prob |diff| {dprob} <= 1")
    return {"results": {k: {f: v[f] for f in ("tiles", "compute_seconds", "patches_per_sec")}
                        for k, v in results.items()}, "launches": per_run, "dir": stamped[0]}


@contextlib.contextmanager
def environ(**values: str):
    """Set environment variables for the body, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def counted_uploads():
    """Within the body, each whole-zone upload (``upload_zone``) adds its
    element count to the list yielded."""
    uploads: list[int] = []
    upload_zone = de.upload_zone

    def counted(host, device):
        uploads.append(host.numel())
        return upload_zone(host, device)

    de.upload_zone = counted
    try:
        yield uploads
    finally:
        de.upload_zone = upload_zone


def compare_to_device(label: str, got: Path, want: Path, src: Path, bands: int) -> dict:
    """A streaming raster against the device route's raster of the same
    configuration: shape and georeferencing; argmax: every pixel written,
    class agreement >= 0.999, prob |diff| <= 1; class_prob: every band
    |diff| <= 1. Returns the share of bit-equal bytes."""
    with TiffReader(src) as s, TiffReader(got) as r, TiffReader(want) as w:
        check((r.width, r.height, r.count) == (w.width, w.height, bands),
              f"{label}: raster {r.width}x{r.height}x{r.count}")
        check(r.transform == s.transform and r.crs == s.crs,
              f"{label}: georeferencing kept (crs {r.crs})")
        have, ref = r.read(), w.read()
    same = float((have == ref).mean())
    diff = np.abs(have.astype(np.int16) - ref.astype(np.int16))
    dprob = int((diff[1] if bands == 2 else diff).max())
    if bands == 2:
        check(bool((have[1] > 0).all()), f"{label}: every pixel written (prob > 0)")
        agree = float((have[0] == ref[0]).mean())
        check(agree >= 0.999, f"{label} vs the device route: class agreement {agree:.6f} "
              ">= 0.999")
    check(dprob <= 1, f"{label} vs the device route: prob |diff| {dprob} <= 1, "
          f"{same:.6f} of bytes bit-equal")
    return {"bit_equal": same, "prob_diff": dprob}


def stream_line(label: str, stats: dict) -> dict:
    """Print where a streaming run's seconds went; returns its numbers."""
    keys = [f"{k}_seconds" for k in eng.STREAM_TIMERS]
    busy = sum(stats[k] for k in ("device_h2d_seconds", "device_compute_seconds",
                                  "device_d2h_seconds"))
    out = {k: stats[k] for k in ("tiles", "seconds", "patches_per_sec", "d2h_bytes", *keys)}
    out["d2h_gb_per_s"] = stats["d2h_bytes"] / stats["device_d2h_seconds"] / 1e9
    out["device_busy_share"] = busy / stats["seconds"]
    print(f"  {label}: {stats['tiles']} tiles in {stats['seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s; " + ", ".join(
              f"{k} {stats[f'{k}_seconds']:.4f} s" for k in eng.STREAM_TIMERS)
          + f"; d2h {stats['d2h_bytes'] / 1e9:.3f} GB at {out['d2h_gb_per_s']:.2f} GB/s; "
          f"device busy {out['device_busy_share']:.3f} of the run", flush=True)
    return out


def run_streaming(cfg: dict, zone_hw: int, sweep_dir: Path) -> dict:
    """The streaming route through detect_main, each run with the counts set
    to 0 just before it, against the device route's raster of the same
    configuration from this call: the main configuration routed by a budget
    below its estimate (no zone upload), class_prob, and average_weights and
    max at the sweep's size-512 geometry (``-c``), the last three forced by
    FLAIRTPU_STREAMING_ZONE."""
    parent = Path(cfg["output_path"]).parent
    out: dict[str, dict] = {}
    n_main = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)

    # the main configuration, routed by its estimate against the budget
    grid = slice_grid(zone_hw, zone_hw, S, M)
    need = de.estimate_bytes(grid, C, K, "exact-clipping", "argmax", BATCH)
    budget = min(need, zone_hw * zone_hw * C * 4) // 2
    main = dict(cfg, output_path=str(parent / "out_stream"))
    conf = write_conf(main, "stream")
    with counted_uploads() as uploads, environ(FLAIRTPU_DEVICE_ZONE_BYTES=str(budget)):
        reset_launches()
        stats = cli.detect_main([f"--conf={conf}"])
        launches = read_launches()
    check("stitch_seconds" in stats, f"main configuration, budget {budget} below its estimate "
          f"{need}: the streaming route")
    check(not uploads, f"main configuration streamed: no zone upload ({uploads})")
    check_launches(f"streaming main configuration, {n_main} batches", launches,
                   expected_launches("exact-clipping", "argmax", n_main, streaming=True))
    out["argmax"] = dict(
        stream_line("streaming main configuration", stats), launches=launches,
        **compare_to_device("streaming main configuration", Path(main["output_path"]) /
                            "zone-ARGMAX.tif", Path(cfg["output_path"]) / "zone-ARGMAX.tif",
                            Path(cfg["input_img_path"]), 2))

    # class_prob
    cp = dict(cfg, output_type="class_prob", output_name="zone-PROBS",
              output_path=str(parent / "out_stream_class_prob"))
    conf = write_conf(cp, "stream_class_prob")
    with environ(FLAIRTPU_STREAMING_ZONE="1"):
        reset_launches()
        stats = cli.detect_main([f"--conf={conf}"])
        launches = read_launches()
    check_launches(f"streaming class_prob, {n_main} batches", launches,
                   expected_launches("exact-clipping", "class_prob", n_main, streaming=True))
    out["class_prob"] = dict(
        stream_line("streaming class_prob", stats), launches=launches,
        **compare_to_device("streaming class_prob", Path(cp["output_path"]) / "zone-PROBS.tif",
                            parent / "out_class_prob" / "zone-PROBS.tif",
                            Path(cfg["input_img_path"]), K))

    # average_weights and max at the sweep's size-512 geometry
    sw = sweep_config(cfg)
    methods = ["average_weights", "max"]
    strategies = json.loads(json.dumps(sw["strategies"]))
    strategies["tiling"]["size_range"] = [S]
    strategies["stitching"]["methods"] = methods
    sw.update(strategies=strategies, output_path=str(parent / "out_stream_sweep"))
    conf = write_conf(sw, "stream_sweep")
    with environ(FLAIRTPU_STREAMING_ZONE="1"), counted_runs() as per_run:
        results = cli.detect_main([f"--conf={conf}", "-c"])
    stamped = [p for p in Path(sw["output_path"]).iterdir() if p.is_dir()]
    check(len(stamped) == 1 and len(per_run) == len(methods),
          f"streaming sweep: {len(per_run)} runs in one timestamped directory")
    for name, launches in per_run.items():
        method, stats = name.rsplit("stitching=", 1)[1], results[name]
        n = -(-stats["tiles"] // sw["batch_size"])
        check_launches(f"streaming {name}, {n} batches", launches,
                       expected_launches(method, "argmax", n, streaming=True))
        raster = f"zone-ARGMAX-S_{name}.tif"
        out[method] = dict(
            stream_line(f"streaming {name}", stats), launches=launches,
            **compare_to_device(f"streaming {name}", stamped[0] / raster, sweep_dir / raster,
                                Path(cfg["input_img_path"]), 2))
    return out


def read_raster(path: Path) -> np.ndarray:
    with TiffReader(path) as r:
        return r.read()


def run_banded(cfg: dict, zone_hw: int) -> dict:
    """The main configuration through detect_main with FLAIRTPU_ZONE_BANDS =
    1 (unbanded, for its numbers), 2 and 4, each with the counts set to 0
    just before it: the raster bit-equal to the main path's from this call;
    banded, the band count, no zone upload, the launches (a band's last
    batch padded with duplicates), and the lanes' span sums, wall time and overlap share
    1 - wall / (h2d + compute + d2h spans)."""
    parent = Path(cfg["output_path"]).parent
    grid = slice_grid(zone_hw, zone_hw, S, M)
    want = read_raster(Path(cfg["output_path"]) / "zone-ARGMAX.tif")
    out = {}
    for n in (1, 2, 4):
        label = f"banded, FLAIRTPU_ZONE_BANDS={n}"
        bc = dict(cfg, output_path=str(parent / f"out_banded{n}"))
        conf = write_conf(bc, f"banded{n}")
        with counted_uploads() as uploads, environ(FLAIRTPU_ZONE_BANDS=str(n)):
            reset_launches()
            stats = cli.detect_main([f"--conf={conf}"])
            launches = read_launches()
        check(np.array_equal(read_raster(Path(bc["output_path"]) / "zone-ARGMAX.tif"), want),
              f"{label}: raster bit-equal to the main path's")
        keep = {k: stats[k] for k in ("tiles", "seconds", "patches_per_sec", "h2d_seconds",
                                      "compute_seconds", "d2h_seconds", "write_seconds")}
        if n == 1:
            print(f"  {label}: {stats['patches_per_sec']:.2f} patches/s, h2d "
                  f"{stats['h2d_seconds']:.4f} s, compute {stats['compute_seconds']:.4f} s, "
                  f"d2h {stats['d2h_seconds']:.4f} s, run {stats['seconds']:.4f} s", flush=True)
            out["unbanded"] = keep
            continue
        plans = de.band_plans(grid, n, BATCH)
        n_batches = sum(-(-len(p["tiles"]) // BATCH) for p in plans)
        check(stats.get("bands") == len(plans), f"{label}: {stats.get('bands')} bands")
        check(not uploads, f"{label}: no whole-zone upload ({uploads})")
        check_launches(f"{label}, {n_batches} batches", launches,
                       expected_launches("exact-clipping", "argmax", n_batches))
        spans = stats["h2d_seconds"] + stats["compute_seconds"] + stats["d2h_seconds"]
        keep.update(wall_seconds=stats["wall_seconds"], setup_seconds=stats["setup_seconds"],
                    overlap=1.0 - stats["wall_seconds"] / spans, launches=launches)
        print(f"  {label}: {stats['patches_per_sec']:.2f} patches/s; card spans h2d "
              f"{stats['h2d_seconds']:.4f} + compute {stats['compute_seconds']:.4f} + d2h "
              f"{stats['d2h_seconds']:.4f} = {spans:.4f} s, wall {stats['wall_seconds']:.4f} s "
              f"(setup {stats['setup_seconds']:.4f} s), overlap {keep['overlap']:.4f}; run "
              f"{stats['seconds']:.4f} s", flush=True)
        out[f"bands_{n}"] = keep
    return out


BATCH_ZONES = ("Z_B1", "Z_B2", "Z_B3")


def run_batch(cfg: dict, tmp: Path) -> dict:
    """``detect_main -b -m`` over a department of three synthetic zones of
    the main size with truth rasters, each from its own numpy seed, each run
    with the counts set to 0 just before it: the three rasters with the
    -ARGMAX-S_ names, each bit-equal to a single-zone device-route run of
    the same zone, the metrics JSON (one record per method), the launches of
    each zone; zones/s, where each zone's seconds went, and whether zone
    i + 1's upload (its H2D stream's events) lies inside zone i's run."""
    dept, truth_root = tmp / "dept" / DPT, tmp / "dept_truth"
    transform = Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2)
    t0 = time.perf_counter()
    for k, zone in enumerate(BATCH_ZONES):
        rng = np.random.default_rng(SEED + 100 + k)
        (dept / zone).mkdir(parents=True)
        (truth_root / DPT / zone).mkdir(parents=True)
        write_array(dept / zone / f"{DPT}_{zone}_irc.tif",
                    rng.integers(0, 256, (C, ZONE, ZONE), dtype=np.uint8),
                    transform=transform, crs=2154, compress="deflate")
        write_array(truth_root / DPT / zone / "truth.tif",
                    rng.integers(1, K + 1, (ZONE, ZONE), dtype=np.uint8),
                    transform=transform, crs=2154, compress="deflate")
    print(f"  synthesized a department of {len(BATCH_ZONES)} zones in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    bc = dict(cfg, output_path=str(tmp / "out_batch"), output_name="placeholder",
              input_path=str(dept), truth_root=str(truth_root),
              truth_path=str(truth_root / DPT / BATCH_ZONES[0] / "truth.tif"),
              data_type="irc", model_name="resnet34_unet",
              classes={i + 1: [1, f"class_{i}"] for i in range(K)})
    conf = write_conf(bc, "batch")
    with counted_runs() as per_run:
        res = cli.detect_main([f"--conf={conf}", "-b", "-m"])
    method = method_string(S, S - 2 * M, M, "no-padding", "exact-clipping")
    names = [f"{DPT}_{z}_irc-ARGMAX-S_{method}" for z in BATCH_ZONES]
    out_dir = Path(bc["output_path"])
    check(sorted(p.name for p in out_dir.glob("*.tif")) == [f"{n}.tif" for n in names],
          f"batch mode: the {len(names)} rasters named -ARGMAX-S_<method>")
    n_batches = -(-len(slice_grid(ZONE, ZONE, S, M).tiles) // BATCH)
    for name in names:
        check_launches(f"batch mode {name.split('-ARGMAX')[0]}", per_run[name],
                       expected_launches("exact-clipping", "argmax", n_batches))
    metrics = json.loads((out_dir / "metrics.json").read_text())
    keys = ["Method parameters", "Parameters values", "Avg_metrics_name", "Avg_metrics",
            "classes", "per_class_iou", "per_class_fscore"]
    check(len(metrics) == 1 and list(metrics[0]) == keys
          and all(np.isfinite(metrics[0]["Avg_metrics"])),
          f"batch mode: metrics JSON, one record per method ({metrics[0]['Avg_metrics']})")

    device = eng.resolve_device(bc)
    model, tail = eng.prepare_model(bc, device)
    grid = slice_grid(ZONE, ZONE, S, M)
    for zone, name in zip(BATCH_ZONES, names):
        zc = dict(bc, input_img_path=str(dept / zone / f"{DPT}_{zone}_irc.tif"))
        single = DeviceZoneRunner(zc, model, tail).run(grid, "exact-clipping",
                                                       eng.stage_zone(zc, device))
        check(np.array_equal(read_raster(out_dir / f"{name}.tif"),
                             np.stack([single["cls"], single["prob"]])),
              f"batch mode {zone}: raster bit-equal to its single-zone device-route run")
    del model, tail

    zones = res["zones"]
    print(f"  batch mode: {len(zones)} zones in {res['seconds']:.4f} s, "
          f"{len(zones) / res['seconds']:.4f} zones/s", flush=True)
    for i, z in enumerate(zones):
        z["read_hidden_seconds"] = max(z["read_seconds"] - z["prefetch_wait_seconds"], 0.0)
        line = (f"    {z['zone']}: read {z['read_seconds']:.4f} s (hidden by the prefetch "
                f"{z['read_hidden_seconds']:.4f} s), h2d residual {z['h2d_seconds']:.4f} s, "
                f"compute {z['compute_seconds']:.4f} s, d2h {z['d2h_seconds']:.4f} s, write "
                f"{z['write_seconds']:.4f} s; run {z['run_span'][0]:.4f}-{z['run_span'][1]:.4f} s")
        if "h2d_span" in z:  # on the card
            line += f", upload {z['h2d_span'][0]:.4f}-{z['h2d_span'][1]:.4f} s"
        if i + 1 < len(zones) and "h2d_span" in zones[i + 1]:
            up = zones[i + 1]["h2d_span"]
            z["next_upload_inside"] = z["run_span"][0] <= up[0] and up[1] <= z["run_span"][1]
            line += f"; {zones[i + 1]['zone']}'s upload inside this run: {z['next_upload_inside']}"
        print(line, flush=True)
    return {"zones_per_sec": len(zones) / res["seconds"], "seconds": res["seconds"],
            "zones": zones, "launches": per_run}


def run_uint16(cfg: dict, tmp: Path, zone_hw: int) -> dict:
    """A uint16 zone of the main size (12-bit values, ``custom``
    normalization) through detect_main on the device route and the
    streaming route, each with the counts set to 0 just before it (the typed
    gather instance once a batch), against its all-plain run on the card:
    class agreement >= 0.999, prob |diff| <= 1."""
    img = random_zone(np.random.default_rng(SEED + 200), (C, zone_hw, zone_hw), "uint16")
    zone = tmp / DPT / "Z_U16" / "zone.tif"
    zone.parent.mkdir(parents=True)
    write_array(zone, img, transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2),
                crs=2154, compress="deflate")
    uc = dict(cfg, input_img_path=str(zone), output_name="zone-U16",
              norma_task=[{"norm_type": "custom", "norm_means": U16_MEANS,
                           "norm_stds": U16_STDS}])
    plain = run_plain(dict(uc, output_path=str(tmp / "out_u16_plain")))
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    out = {}
    for route in ("device", "streaming"):
        rc = dict(uc, output_path=str(tmp / f"out_u16_{route}"))
        conf = write_conf(rc, f"u16_{route}")
        with environ(FLAIRTPU_STREAMING_ZONE="1" if route == "streaming" else ""):
            reset_launches()
            stats = cli.detect_main([f"--conf={conf}"])
            launches = read_launches()
        label = f"uint16 zone, custom, {route} route"
        check_launches(f"{label}, {n_batches} batches", launches,
                       expected_launches("exact-clipping", "argmax", n_batches,
                                         streaming=route == "streaming", typed=True))
        have = read_raster(Path(rc["output_path"]) / "zone-U16.tif")
        agree = float((plain["cls"] == have[0]).mean())
        dprob = int(np.abs(plain["prob"].astype(int) - have[1].astype(int)).max())
        check(agree >= 0.999, f"{label} vs plain versions: class agreement {agree:.6f} >= 0.999")
        check(dprob <= 1, f"{label} vs plain versions: prob |diff| {dprob} <= 1")
        print(f"  {label}: {stats['tiles']} tiles, {stats['patches_per_sec']:.2f} patches/s, "
              f"run {stats['seconds']:.4f} s", flush=True)
        out[route] = {"patches_per_sec": stats["patches_per_sec"], "seconds": stats["seconds"],
                      "agree_plain": agree, "prob_diff_plain": dprob, "launches": launches}
    return out


@contextlib.contextmanager
def captured_models():
    """Within the body, each (model, tail) that ``prepare_model`` makes for a
    run is appended to the list yielded: the plain run reuses it, with the
    same int8 scales."""
    models: list[tuple] = []
    prepare = eng.prepare_model

    def capture(config, device):
        models.append(prepare(config, device))
        return models[-1]

    eng.prepare_model = capture
    try:
        yield models
    finally:
        eng.prepare_model = prepare


def run_knobs(cfg: dict, label: str, knobs: dict, zone_hw: int, floor: float,
              float_raster: np.ndarray, int8_blocks: int | None = None) -> dict:
    """detect_main with ``knobs`` on the zone of ``cfg``, the counts set to 0
    just before it: its launches, raster shape and coverage; against its
    all-plain run on the same model (class agreement >= 0.999, prob |diff|
    <= 1) and against the float path's raster of the zone (class agreement
    >= ``floor``); patches/s and calibration seconds."""
    kc = dict(cfg, output_path=str(Path(cfg["output_path"]).parent / f"out_{label}"), **knobs)
    conf = write_conf(kc, label)
    with captured_models() as models:
        reset_launches()
        stats = cli.detect_main([f"--conf={conf}"])
        launches = read_launches()
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    check_launches(f"{label}, {n_batches} batches", launches,
                   expected_launches("exact-clipping", "argmax", n_batches,
                                     int8_blocks=int8_blocks))
    have = read_raster(Path(kc["output_path"]) / "zone-ARGMAX.tif")
    check(have.shape == (2, zone_hw, zone_hw) and bool((have[1] > 0).all()),
          f"{label}: raster {have.shape}, every pixel written")
    plain = run_plain(kc, prepared=models[0])
    agree = float((plain["cls"] == have[0]).mean())
    dprob = int(np.abs(plain["prob"].astype(int) - have[1].astype(int)).max())
    check(agree >= 0.999, f"{label} vs plain versions: class agreement {agree:.6f} >= 0.999")
    check(dprob <= 1, f"{label} vs plain versions: prob |diff| {dprob} <= 1")
    agree_float = float((float_raster[0] == have[0]).mean())
    check(agree_float >= floor, f"{label} vs the float path: class agreement "
          f"{agree_float:.6f} >= {floor}")
    calib = stats.get("calibration_seconds")
    print(f"  {label}: {stats['tiles']} tiles, compute {stats['compute_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s"
          + (f", calibration {calib:.4f} s" if calib is not None else ""), flush=True)
    keep = ("tiles", "seconds", "patches_per_sec", "read_seconds", "h2d_seconds",
            "compute_seconds", "d2h_seconds", "write_seconds", "calibration_seconds")
    return {**{k: stats[k] for k in keep if k in stats}, "agree_plain": agree,
            "prob_diff_plain": dprob, "agree_float": agree_float, "launches": launches}


def run_small_int8(cfg: dict, tmp: Path) -> dict:
    """The other int8 configurations on a zone of ZONE_SMALL: int8_decoder 0
    and 4 (with bn_fold) and int8_decoder 2 without bn_fold, each against its
    all-plain run and the float path's raster of that zone."""
    rng = np.random.default_rng(SEED + 300)
    zone = tmp / DPT / "Z_SMALL" / "zone.tif"
    zone.parent.mkdir(parents=True)
    write_array(zone, rng.integers(0, 256, (C, ZONE_SMALL, ZONE_SMALL), dtype=np.uint8),
                transform=Affine.from_origin(700000.0, 6600000.0, 0.2, 0.2), crs=2154,
                compress="deflate")
    sc = dict(cfg, input_img_path=str(zone), output_path=str(tmp / "out_small"))
    conf = write_conf(sc, "small_float")
    cli.detect_main([f"--conf={conf}"])
    float_raster = read_raster(Path(sc["output_path"]) / "zone-ARGMAX.tif")
    out = {}
    for label, knobs in (("int8_decoder0", dict(INT8_KNOBS, int8_decoder=0)),
                         ("int8_decoder4", dict(INT8_KNOBS, int8_decoder=4)),
                         ("int8_no_fold", dict(INT8_KNOBS, bn_fold=False))):
        out[label] = run_knobs(sc, f"small_{label}", knobs, ZONE_SMALL, INT8_FLOOR, float_raster,
                               int8_blocks=knobs["int8_decoder"])
    return out


def stage_breakdown(cfg: dict, zone_hw: int, rng, epi: dict) -> dict:
    """Device time of each stage of one main-path batch (CUDA events), and the
    profiler's kernel table for one batch. The encoder and decoder stages are
    split into their conv_epilogue launches (``epi``: phase 2's per-site
    times, summed) and the rest (convolutions, max-pool, upsample, concat).
    Also the same batch through the class_prob program, and through the
    whole-tile decode of the average_weights and max programs."""
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
    # the class_prob plane and the average / max planes of the same zone
    plane = torch.zeros((zone_hw, zone_hw, K), dtype=torch.uint8, device=device)
    hp = zone_hw + 2 * M
    acc = torch.zeros((hp, hp, K), device=device)
    div = torch.zeros((hp, hp), device=device)
    best_p = torch.zeros((hp, hp), device=device)
    best_c = torch.zeros((hp, hp), dtype=torch.uint8, device=device)
    val = torch.ones(BATCH, device=device)
    fp = st.footprint(org.cpu().numpy(), np.ones(BATCH), S)
    w = torch.from_numpy(patch_weights(S).astype(np.float32)).to(device)
    logits = runner._forward_logits(zone, org, None)
    x3_full = model.tail_input(x, 0)

    stages = {
        "gather_normalize": lambda: ga.gather_normalize(zone, org, S, out_dtype=model.dtype,
                                                        **runner.norm),
        "encoder": lambda: model.features(x),
        "decoder_blocks_0_3": lambda: model.decoder.inner(feats, M, 4),
        "fused_tail": lambda: ft.fused_tail(x3, tail, runner.geometry, planes, win),
        "whole_batch": lambda: runner._forward_tiles(zone, org, planes, win),
        "whole_batch_class_prob": lambda: runner._forward_probs(zone, org, plane, win),
        "decoder_blocks_0_3_full_tile": lambda: model.decoder.inner(feats, 0, 4),
        "fused_tail_logits": lambda: ft.fused_tail_logits(x3_full, tail, runner.full_geometry,
                                                          logits),
        "whole_batch_average_weights": lambda: st.accumulate_probs(
            runner._forward_logits(zone, org, logits), org, val, w, acc, div, fp),
        "whole_batch_max": lambda: st.merge_max(
            runner._forward_logits(zone, org, logits), org, val, best_p, best_c, fp),
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


# ---------------------------------------------------------------------------
# flair train / predict / metrics (slice 4): the train step's kernels and
# phase 4
# ---------------------------------------------------------------------------

TRAIN_BATCH = 16  # configs/flair-1-config.yaml:49
TRAIN_CONFIG = Path(__file__).resolve().parent / "configs" / "flair-1-config.yaml"
# phase 4's dataset (train, val, test patches) and epochs: 4 train steps an epoch
FLAIR_SPLITS = (("train", 64), ("val", 16), ("test", 16))
FLAIR_EPOCHS = 3
# weighted_ce against its plain version on the same logits: both sum float32
# terms, in other orders (a tree of per-thread partials and double across
# blocks, against PyTorch's reduction), over 4.2M pixels
CE_LOSS_RTOL = 1e-5
CE_GRAD_TOL = 1e-5  # of the largest |dlogit|: expf and the division round alike
# bn_train against its plain version: the statistics are float32 sums over
# up to 4.2M (batch 16) values in other orders; the backward's bf16 dy is
# gamma invstd (g - (dbeta + xh dgamma) / M), where the subtraction cancels
# for some elements, so the two float32 results (sums in other orders,
# 1 / M multiplied or divided) round to bf16 values far apart in ulps of
# that small element, but within two bf16 ulps of the largest |dy|
BN_STAT_TOL = 1e-4  # of 1 + the largest |value| of each vector
BN_DY_TOL = 2.0 ** -6  # of the largest |dy|: two bf16 ulps there
# dgamma and dbeta of a train step's own gradients against the plain
# version's on the same operands: float32 sums of up to 4.2M products in two
# orders, each within about log2(M) float32 ulps of the sum of the terms'
# magnitudes, held to a thousandth of the vector's largest value
BN_GRAD_TOL = 1e-3
# One train step is held two ways. (1) Site by site: the kernels' step runs
# each kernel's plain version beside it on the same operands (the batch, each
# site's conv output and the gradient that reaches it in that step) and each
# part is held to the tolerances above; this is the check of the kernels'
# gradients. (2) Free-running: the kernels' step against the plain step from
# the same weights, batch and choices. There a BatchNorm constant one float32
# ulp apart flips bf16 roundings, which the following sites carry on, so the
# two steps' gradients drift apart as two valid summation orders' do; the
# plain step is also run with the batch reversed, again in the same order
# (determinism) and both ways in float32 (TF32 off) to measure that drift.
# The free-running step must stay within STEP_SLACK of the reversed run's
# drift, and its loss within STEP_LOSS_RTOL: a bound on the drift, not a
# test of a kernel's gradient
STEP_LOSS_RTOL = 1e-3
STEP_SLACK = 2.0, 0.02  # rel L2 <= 2 x the reordered run's + 0.02
STEP_CM_SHARE = 0.01  # pixels whose argmax moves, beyond the reordered run's


def choices_all(n: int, device="cuda") -> torch.Tensor:
    """(n, 3) int32: the 16 (v, h, k) D4 choices in turn."""
    rows = [(v, h, k) for v in (0, 1) for h in (0, 1) for k in range(4)]
    return torch.tensor([rows[i % 16] for i in range(n)], dtype=torch.int32, device=device)


# augment_normalize's edge geometries: (batch, height, width, channels,
# choices, mask, the instance launch_plan must choose); "offset" views the
# image and mask one byte past a 16-byte boundary
AUG_EDGES = {
    "500², the 16 choices": (16, 500, 500, C, "all", True, "general"),
    "C = 1 at 100²": (4, 100, 100, 1, "all", True, "general"),
    "C = 3 at 100²": (4, 100, 100, 3, "all", True, "general"),
    "C = 8 at 100²": (4, 100, 100, 8, "all", True, "general"),
    "batch 1 at 500²": (1, 500, 500, C, "all", True, "general"),
    "one byte off alignment, 512²": (4, S, S, C, "offset", True, "general"),
    "384 x 512 identity": (2, 384, 512, C, None, True, "general"),
    "C = 12 at 512²": (2, S, S, 12, "all", True, "general"),
    "C = 1 at 512²": (16, S, S, 1, "all", True, "tiled"),
    "C = 3 at 512²": (16, S, S, 3, "all", True, "tiled"),
    "C = 8 at 512²": (16, S, S, 8, "all", False, "tiled"),
    "batch 1 at 512²": (1, S, S, C, "all", True, "tiled"),
}


def augment_edge(gen, name: str) -> None:
    """augment_normalize at one edge geometry, bf16 and float32, bit for bit
    against its plain version; the instance launch_plan chose and the one the
    wrapper launched are the expected ones."""
    B, H, W, c, kind, has_mask, want = AUG_EDGES[name]
    img = torch.randint(0, 256, (B * H * W * c + 1,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    msk = torch.randint(0, K + 7, (B * H * W + 1,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    lo = 1 if kind == "offset" else 0
    img = img[lo:lo + B * H * W * c].view(B, H, W, c)
    msk = msk[lo:lo + B * H * W].view(B, H, W) if has_mask else None
    ch = None if kind is None else choices_all(B)
    mean = torch.rand(c, device="cuda", generator=gen) * 120
    mul = 1 / (30 + 50 * torch.rand(c, device="cuda", generator=gen))
    aligned = all(t.data_ptr() % au.ALIGN == 0 for t in (img, msk) if t is not None)
    check(aligned == (kind != "offset"), f"augment_normalize {name}: pointers aligned "
          f"{aligned}")
    for dtype in (torch.bfloat16, torch.float32):
        plan = au.launch_plan(B, H, W, c, dtype, has_mask, aligned)
        tiled = au.tiled_launches
        x, t = au.augment_normalize(img, msk, ch, mean, mul, K, dtype)
        took = "tiled" if au.tiled_launches > tiled else "general"
        xp, tp = au.augment_normalize_plain(img, msk, ch, mean, mul, K, dtype)
        torch.cuda.synchronize()
        check(plan.instance == want and took == want, f"augment_normalize {name} "
              f"{str(dtype)[6:]}: launch_plan chose {plan.instance}, the wrapper launched "
              f"{took}, expected {want}")
        check(torch.equal(x, xp) and (t is None and tp is None or torch.equal(t, tp)),
              f"augment_normalize {name} {str(dtype)[6:]} ({want}): equal bit for bit")


def check_augment(gen) -> dict:
    """augment_normalize bit for bit against its plain version: all 16
    choices, the three norm types, labels 0 and > K on disk, bf16 and
    float32, the identity (eval and predict) and no mask, at the train
    batch (the tiled instance), then at the edge geometries of AUG_EDGES
    (both instances); timed at the train batch with the config's custom
    normalization by device time (device_ms) and call time (cuda_ms) on the
    train call (the 16 choices, mask, bf16), eval's (identity, mask),
    predict's (identity, no mask) and the train call in float32."""
    B = TRAIN_BATCH
    img = torch.randint(0, 256, (B, S, S, C), dtype=torch.uint8, device="cuda", generator=gen)
    msk = torch.randint(0, K + 7, (B, S, S), dtype=torch.uint8, device="cuda", generator=gen)
    cfg = yaml.safe_load(TRAIN_CONFIG.read_text())
    norms = {"custom": au.norm_constants("custom", cfg["norm_means"], cfg["norm_stds"], C),
             "scaling": au.norm_constants("scaling", channels=C),
             "without": au.norm_constants("without", channels=C)}
    ch = choices_all(B)
    tiled = au.tiled_launches
    for name, (mean, mul) in norms.items():
        mean, mul = torch.from_numpy(mean).cuda(), torch.from_numpy(mul).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            for choices, mask, what in ((ch, msk, "16 D4 choices"), (None, msk, "identity"),
                                        (None, None, "identity, no mask")):
                x, t = au.augment_normalize(img, mask, choices, mean, mul, K, dtype)
                xp, tp = au.augment_normalize_plain(img, mask, choices, mean, mul, K, dtype)
                torch.cuda.synchronize()
                check(torch.equal(x, xp) and (t is None and tp is None or torch.equal(t, tp)),
                      f"augment_normalize {name} {str(dtype)[6:]} {what}: equal bit for bit")
        if name == "custom":
            custom = mean, mul
    check(au.tiled_launches - tiled == 18, f"augment_normalize: the train batch's 18 calls "
          f"took the tiled instance ({au.tiled_launches - tiled})")
    for name in AUG_EDGES:
        augment_edge(gen, name)

    mean, mul = custom
    calls = {"train": (img, msk, ch, torch.bfloat16), "eval": (img, msk, None, torch.bfloat16),
             "predict": (img, None, None, torch.bfloat16), "f32": (img, msk, ch, torch.float32)}
    rows = {}
    for mode, (x, mask, choices, dtype) in calls.items():
        args = (x, mask, choices, mean, mul, K, dtype)
        nbytes = x.numel() * (1 + dtype.itemsize) + (5 * mask.numel() if mask is not None
                                                     else 0)
        rows[mode] = {"mode": mode, "ms": device_ms(lambda: au.augment_normalize(*args)),
                      "call_ms": cuda_ms(lambda: au.augment_normalize(*args)),
                      "plain_ms": cuda_ms(lambda: au.augment_normalize_plain(*args), 5, 1),
                      "bytes": nbytes, **bound(0, nbytes)}
    # no single PyTorch call flips, rotates per sample, normalizes and cleans
    # the labels
    return {"max_abs_err": 0, **rows["train"], "library_ms": None, "calls": rows}


def ce_weights(k: int) -> torch.Tensor:
    """configs/flair-1-config.yaml's class weights at K; 0 / 1 weights at
    another k (the weight sum stays an exact integer in any order)."""
    if k == K:
        cfg = yaml.safe_load(TRAIN_CONFIG.read_text())
        return torch.tensor([float(v[0]) for v in cfg["classes"].values()], device="cuda")
    return torch.tensor([float(c % 5 != 3) for c in range(k)], device="cuda")


def check_ce_case(logits, tgt, w, what: str) -> dict:
    """weighted_ce's forward (loss, weight sum, confusion matrix) and
    backward against the plain versions on one input, and two calls of each
    entry point giving the same bits."""
    k = logits.shape[-1]
    cm, cmp, cm2 = (torch.zeros((k, k), dtype=torch.int32, device="cuda") for _ in range(3))
    g = torch.tensor(0.5, device="cuda")
    loss, ws = wc.weighted_ce(logits, tgt, w, cm)
    lossp, wsp = wc.weighted_ce_plain(logits, tgt, w, cmp)
    d, dp = wc.weighted_ce_grad(logits, tgt, w, ws, g), wc.weighted_ce_grad_plain(logits, tgt, w,
                                                                                 wsp, g)
    loss2, ws2 = wc.weighted_ce(logits, tgt, w, cm2)
    d2 = wc.weighted_ce_grad(logits, tgt, w, ws2, g)
    torch.cuda.synchronize()
    rel = abs(loss.item() - lossp.item()) / abs(lossp.item())
    check(rel <= CE_LOSS_RTOL, f"weighted_ce {what}: loss {loss.item():.7f} vs plain "
          f"{lossp.item():.7f}: relative {rel:.2e} <= {CE_LOSS_RTOL}")
    check(ws.item() == wsp.item(), f"weighted_ce {what}: weight sum {ws.item()} == plain")
    check(torch.equal(cm, cmp), f"weighted_ce {what}: confusion matrix exact "
          f"({int(cm.sum())} pixels, {float(cm.diagonal().sum()) / cm.sum().item():.3f} on "
          "the diagonal)")
    derr = (d - dp).abs().max().item()
    scale = dp.abs().max().item()
    check(derr <= CE_GRAD_TOL * scale, f"weighted_ce {what}: dlogits |diff| {derr:.2e} <= "
          f"{CE_GRAD_TOL} x {scale:.2e}")
    check(torch.equal(loss, loss2) and torch.equal(ws, ws2) and torch.equal(cm, cm2)
          and torch.equal(d, d2), f"weighted_ce {what}: two calls give the same bits (loss, "
          "weight sum, confusion matrix, dlogits)")
    return {"loss_err": abs(loss.item() - lossp.item()), "grad_err": derr, "w_sum": ws, "g": g}


def ce_library_backward(logits, tgt, w):
    """The VJP alone of F.cross_entropy(weight=w) on the same logits: aten's
    nll_loss2d_backward and _log_softmax_backward_data, the graph retained;
    a function to time."""
    with torch.inference_mode(False), torch.enable_grad():
        lg = logits.clone().requires_grad_(True)
        out = F.cross_entropy(lg.permute(0, 3, 1, 2), tgt.long(), weight=w.clone())

    def run():
        with torch.inference_mode(False), torch.enable_grad():
            torch.autograd.grad(out, lg, retain_graph=True)

    return run


def check_weighted_ce(gen) -> dict:
    """weighted_ce forward (loss, weight sum, confusion matrix) and backward
    against the plain versions and two calls' bits, at the train batch on a
    random and a coherent input (ce_inputs), at a pixel count that is not a
    multiple of a tile (K = 19 and 32) and through pointers one pixel off
    16-byte alignment; each entry point timed on both train-batch inputs by
    device time (device_ms) and call time (cuda_ms), beside F.cross_entropy
    (weight=w): its forward, and its backward alone."""
    w = ce_weights(K)
    ragged = torch.Generator("cuda").manual_seed(SEED + 1)
    for k in (K, 32):
        logits = torch.randn((3, 37, 41, k), device="cuda", generator=ragged) * 3
        tgt = torch.randint(0, k, (3, 37, 41), dtype=torch.int32, device="cuda",
                            generator=ragged)
        check_ce_case(logits, tgt, ce_weights(k), f"ragged, {tgt.numel()} pixels, K = {k}")
    n = 2 * S * S
    base = torch.randn((n + 1, K), device="cuda", generator=ragged) * 3
    base_t = torch.randint(0, K, (n + 1,), dtype=torch.int32, device="cuda", generator=ragged)
    logits, tgt = base[1:], base_t[1:]
    check(logits.data_ptr() % 16 != 0 and tgt.data_ptr() % 16 != 0,
          "weighted_ce: the unaligned case's pointers are not 16-byte aligned")
    check_ce_case(logits, tgt, w, f"unaligned, {n} pixels at an offset of one pixel")
    del base, base_t, logits, tgt

    n = TRAIN_BATCH * S * S
    fwd_bytes, bwd_bytes = 4 * n * K + 4 * n, 8 * n * K + 4 * n
    rows = {}
    for kind in ("random", "coherent"):
        logits, tgt = ce_inputs(kind, gen, TRAIN_BATCH, S, K)
        r = check_ce_case(logits, tgt, w, f"{kind}, batch {TRAIN_BATCH}")
        ws, g = r["w_sum"], r["g"]
        cm = torch.zeros((K, K), dtype=torch.int32, device="cuda")

        def lib():
            return F.cross_entropy(logits.permute(0, 3, 1, 2), tgt.long(), weight=w)

        rows[f"forward {kind}"] = {
            "mode": f"forward, {kind} input", "max_abs_err": r["loss_err"],
            "ms": device_ms(lambda: wc.weighted_ce(logits, tgt, w, cm)),
            "call_ms": cuda_ms(lambda: wc.weighted_ce(logits, tgt, w, cm)),
            "plain_ms": cuda_ms(lambda: wc.weighted_ce_plain(logits, tgt, w, cm), 5, 1),
            "library_ms": device_ms(lib), "bytes": fwd_bytes,
            **bound(6 * n * K, fwd_bytes, PEAK_FP32_FLOPS)}
        rows[f"backward {kind}"] = {
            "mode": f"backward, {kind} input", "max_abs_err": r["grad_err"],
            "ms": device_ms(lambda: wc.weighted_ce_grad(logits, tgt, w, ws, g)),
            "call_ms": cuda_ms(lambda: wc.weighted_ce_grad(logits, tgt, w, ws, g)),
            "plain_ms": cuda_ms(lambda: wc.weighted_ce_grad_plain(logits, tgt, w, ws, g), 5, 1),
            "library_ms": device_ms(ce_library_backward(logits, tgt, w)), "bytes": bwd_bytes,
            **bound(8 * n * K, bwd_bytes, PEAK_FP32_FLOPS)}
        del logits, tgt
        torch.cuda.empty_cache()
    return rows


class TrainSiteRecorder(TrainSites):
    """Train-mode sites that keep each call's operands (the conv output, its
    BatchNorm, the residual or branch) as the model's forward gives them."""

    def __init__(self):
        super().__init__()
        self.sites: list[dict] = []

    def site(self, y, bn, residual=None, branch=None, relu=True, keep_f32=False):
        self.sites.append(dict(y=y, bn=bn, residual=residual, branch=branch, keep_f32=keep_f32))
        return super().site(y, bn, residual, branch, relu, keep_f32)


def record_train_sites(model, x: torch.Tensor) -> list[dict]:
    rec = TrainSiteRecorder()
    with torch.no_grad():
        model(x, epilogue=rec)
    return rec.sites


def bn_vectors(bn) -> tuple:
    """Copies of a BatchNorm's (gamma, beta, running mean, running var)."""
    return tuple(t.detach().clone() for t in (bn.weight, bn.bias, bn.running_mean,
                                              bn.running_var))


def bn_site_operands(site: dict, gen) -> dict:
    """Everything bn_stats and bn_backward take at a recorded site, the
    incoming gradients random (bf16 and, where the site keeps float32, a
    float32 one)."""
    y = site["y"]
    gamma, beta, rm, rv = bn_vectors(site["bn"])
    mean, invstd, scale, shift = bt.bn_stats_plain(y, gamma, beta, rm.clone(), rv.clone())
    branch, d_stats = None, None
    if site["branch"] is not None:
        d, bn_d = site["branch"]
        gd, bd, rmd, rvd = bn_vectors(bn_d)
        d_stats = bt.bn_stats_plain(d, gd, bd, rmd.clone(), rvd.clone())
        branch = (d, d_stats[0], d_stats[1], gd)
    epi_branch = None if branch is None else (branch[0], d_stats[2], d_stats[3])
    out, _ = ep.conv_epilogue(y, scale, shift, residual=site["residual"], branch=epi_branch)

    def rand(dtype):
        return torch.randn(y.shape, device="cuda", generator=gen).to(dtype).contiguous(
            memory_format=torch.channels_last)

    return dict(g=rand(torch.bfloat16), g32=rand(torch.float32) if site["keep_f32"] else None,
                out=out, y=y, mean=mean, invstd=invstd, gamma=gamma, branch=branch,
                residual=site["residual"] is not None)


def bn_site_label(k: int, site: dict) -> str:
    kind = ("downsample branch" if site["branch"] is not None else
            "fp32 residual" if site["residual"] is not None else "no residual")
    return f"site {k} {tuple(site['y'].shape)} {kind}{', fp32 out' if site['keep_f32'] else ''}"


def vec_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / (1 + max |b|)"""
    return ((a.float() - b.float()).abs().max() / (1 + b.float().abs().max())).item()


def scaled_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b|"""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def compare_bn_site(label: str, site: dict, gen) -> tuple[float, float]:
    """bn_stats (each BatchNorm of the site) and bn_backward against their
    plain versions on the site's operands; returns the statistics' worst
    scaled error and the backward's (dy, dd, dgamma and dbeta)."""
    worst = 0.0
    pairs = [(site["y"], site["bn"])] + ([site["branch"]] if site["branch"] is not None else [])
    for x, bn in pairs:
        gamma, beta, rm, rv = bn_vectors(bn)
        got = bt.bn_stats(x, gamma, beta, rm, rv)
        rmp, rvp = bn_vectors(bn)[2:]
        want = bt.bn_stats_plain(x, gamma, beta, rmp, rvp)
        errs = [vec_err(a, b) for a, b in zip(got + (rm, rv), want + (rmp, rvp))]
        worst = max(worst, *errs)
        check(max(errs) <= BN_STAT_TOL, f"bn_stats {label} {tuple(x.shape)}: mean, invstd, "
              f"scale, shift, running mean and var within {max(errs):.1e} <= {BN_STAT_TOL}")
    ops = bn_site_operands(site, gen)
    got = bt.bn_backward(**ops)
    want = bt.bn_backward_plain(**ops)
    torch.cuda.synchronize()
    dy_err = scaled_err(got[0], want[0])
    errs = [vec_err(got[1], want[1]), vec_err(got[2], want[2])]
    if got[4] is not None:
        dy_err = max(dy_err, scaled_err(got[4][0], want[4][0]))
        errs += [vec_err(got[4][1], want[4][1]), vec_err(got[4][2], want[4][2])]
    exact_res = got[3] is None or torch.equal(got[3], want[3])
    check(dy_err <= BN_DY_TOL and max(errs) <= BN_STAT_TOL and exact_res,
          f"bn_backward {label}: dy{' and dd' if got[4] is not None else ''} within "
          f"{dy_err:.1e} <= {BN_DY_TOL:.1e} of the largest, dgamma and dbeta within "
          f"{max(errs):.1e} <= {BN_STAT_TOL}"
          f"{', residual gradient exact' if got[3] is not None else ''}")
    return worst, max(dy_err, *errs)


def bn_costs(site: dict) -> dict:
    """(operations, bytes) of the site's statistics (each of its
    BatchNorms) and of its backward: each input read once, each output
    written once; and the backward's input bytes alone."""
    y = site["y"]
    n, c = y.numel(), y.shape[1]
    n_bn = 1 + (site["branch"] is not None)
    stats = (3 * n * n_bn, 2 * n * n_bn + 4 * 8 * c * n_bn)
    inputs = 2 * n + 2 * n + 2 * n  # g, out, y
    if site["keep_f32"]:
        inputs += 4 * n
    if site["branch"] is not None:
        inputs += 2 * n
    nbytes = inputs + 2 * n  # dy out
    if site["residual"] is not None:
        nbytes += 4 * n
    if site["branch"] is not None:
        nbytes += 2 * n
    return {"stats": stats, "backward": (12 * n * n_bn, nbytes), "backward_inputs": inputs}


def bn_library_backward(ops: dict):
    """The BatchNorm VJP alone, as PyTorch computes it: aten's
    native_batch_norm_backward on the ReLU-masked bf16 gradient (no float32
    gradient, no residual), once per BatchNorm of the site; a function to
    time, or the error PyTorch raised."""
    g = ops["g"] * (ops["out"] > 0)
    calls = [(ops["y"], ops["mean"], ops["invstd"], ops["gamma"])]
    if ops["branch"] is not None:
        d, mean_d, invstd_d, gamma_d = ops["branch"]
        calls.append((d, mean_d, invstd_d, gamma_d))

    def run():
        for x, mean, invstd, gamma in calls:
            torch.ops.aten.native_batch_norm_backward(g, x, gamma, None, None, mean, invstd,
                                                      True, bt.EPS, [True, True, True])

    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return run


def check_bn_repeat(sites: list[dict], gen) -> None:
    """Two calls of each entry point at every site give the same bits."""
    differ = []
    for k, site in enumerate(sites):
        pairs = [(site["y"], site["bn"])] + ([site["branch"]] if site["branch"] is not None
                                             else [])
        for x, bn in pairs:
            runs = []
            for _ in range(2):
                gamma, beta, rm, rv = bn_vectors(bn)
                runs.append(bt.bn_stats(x, gamma, beta, rm, rv) + (rm, rv))
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                differ.append(f"statistics {bn_site_label(k, site)} {tuple(x.shape)}")
        ops = bn_site_operands(site, gen)
        runs = []
        for _ in range(2):
            dy, dgamma, dbeta, dres, db = bt.bn_backward(**ops)
            runs.append([dy, dgamma, dbeta, dres, *(db or (None,) * 3)])
        if not all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs)):
            differ.append(f"backward {bn_site_label(k, site)}")
        del ops, runs
    check(not differ, f"bn_train: two calls of bn_stats and of bn_backward at each of the "
          f"{len(sites)} batch-{sites[0]['y'].shape[0]} sites give the same bits"
          + (f"; differ: {differ}" if differ else ""))


# backward sites whose inputs (g, out, y, g32, d) are at most this many
# bytes: the apply's second read should come from the 50 MB L2
BN_L2_INPUTS = 40e6


def time_bn_sites(sites: list[dict], gen) -> dict:
    """bn_stats and bn_backward at every site of one train-batch forward,
    summed: device time (device_ms) and the call time seen by the host
    (cuda_ms), against their plain versions, torch.var_mean(correction=0)
    (statistics) and aten's native_batch_norm_backward (backward); the
    backward also by route."""
    rows = {"stats": [], "backward": []}
    library_error = None
    for site in sites:
        cost = bn_costs(site)
        pairs = [(site["y"], site["bn"])] + ([site["branch"]] if site["branch"] is not None
                                             else [])
        vecs = [(x, bn_vectors(bn)) for x, bn in pairs]
        rows["stats"].append({
            "ms": sum(device_ms(lambda x=x, v=v: bt.bn_stats(x, *v)) for x, v in vecs),
            "call_ms": sum(cuda_ms(lambda x=x, v=v: bt.bn_stats(x, *v), 5, 1) for x, v in vecs),
            "plain_ms": sum(cuda_ms(lambda x=x, v=v: bt.bn_stats_plain(x, *v), 3, 1)
                            for x, v in vecs),
            "library_ms": sum(device_ms(lambda x=x: torch.var_mean(x, dim=(0, 2, 3),
                                                                   correction=0))
                              for x, _ in vecs),
            "bytes": cost["stats"][1], **bound(*cost["stats"], PEAK_FP32_FLOPS)})
        ops = bn_site_operands(site, gen)
        lib = bn_library_backward(ops)
        if isinstance(lib, str):
            library_error = lib
        rows["backward"].append({
            "ms": device_ms(lambda: bt.bn_backward(**ops)),
            "call_ms": cuda_ms(lambda: bt.bn_backward(**ops), 5, 1),
            "plain_ms": cuda_ms(lambda: bt.bn_backward_plain(**ops), 3, 1),
            "library_ms": None if isinstance(lib, str) else device_ms(lib),
            "l2": cost["backward_inputs"] <= BN_L2_INPUTS,
            "bytes": cost["backward"][1], **bound(*cost["backward"], PEAK_FP32_FLOPS)})
        del ops, lib

    def total(rs: list[dict]) -> dict:
        return {"sites": len(rs), "ms": sum(r["ms"] for r in rs),
                "call_ms": sum(r["call_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs)}

    out = {}
    for mode, rs in rows.items():
        libs = [r["library_ms"] for r in rs]
        out[mode] = {
            "mode": mode, **total(rs), "plain_ms": sum(r["plain_ms"] for r in rs),
            "bytes": sum(r["bytes"] for r in rs),
            "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rs)
                         else "operations"),
            "library_ms": None if None in libs else sum(libs),
            "largest_ms": max(r["ms"] for r in rs)}
    out["backward"]["library_error"] = library_error
    back = rows["backward"]
    out["backward"]["routes"] = {
        "two-pass, L2-ordered apply": total(back),
        f"  of which inputs <= {BN_L2_INPUTS / 1e6:.0f} MB (the apply's reads fit in L2)":
            total([r for r in back if r["l2"]]),
        f"  of which inputs > {BN_L2_INPUTS / 1e6:.0f} MB (read twice)":
            total([r for r in back if not r["l2"]])}
    out["stats"]["routes"] = {"one launch": total(rows["stats"])}
    return out


def train_model(device="cuda") -> FlairSegmentationModel:
    """resnet34-unet, 5 channels, 19 classes, bf16 convs on float32 params,
    flax's initial distributions."""
    model = FlairSegmentationModel("resnet34", K, C, dtype=torch.bfloat16)
    init_weights(model, SEED)
    return model.to(device, memory_format=torch.channels_last)


def train_site_counts(model) -> dict:
    """From the model's structure: BatchNorms (a statistics launch each a
    step), train-mode sites (a conv_epilogue and a backward launch each, a
    downsample's BatchNorm inside its block's last site) and the inference
    sites of tail_input (encoder and decoder blocks 0-3)."""
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    n_ds = sum(getattr(m, "downsample", None) is not None for m in model.encoder.modules())
    return {"bn": n_bn, "sites": n_bn - n_ds, "tail_sites": epilogue_sites(model)}


def check_bn_train(gen) -> dict:
    """bn_train at every BatchNorm site geometry of resnet34-unet at batch 2
    (operands from a train-mode forward of 512 tiles), then at every site of
    the train batch (16), which is also timed."""
    model = train_model()
    counts = train_site_counts(model)
    x = torch.rand((2, S, S, C), device="cuda", generator=gen).to(torch.bfloat16)
    sites = record_train_sites(model, x)
    check(len(sites) == counts["sites"] and
          sum(s["branch"] is not None for s in sites) + len(sites) == counts["bn"],
          f"bn_train: {len(sites)} sites, {counts['bn']} BatchNorms in one forward, from the "
          "model's structure")
    errs = []
    seen = set()
    for k, site in enumerate(sites):
        key = (tuple(site["y"].shape), site["residual"] is not None, site["branch"] is not None,
               site["keep_f32"])
        if key in seen:
            continue
        seen.add(key)
        errs.append(compare_bn_site(bn_site_label(k, site), site, gen))
    del sites, x
    torch.cuda.empty_cache()
    x = torch.rand((TRAIN_BATCH, S, S, C), device="cuda", generator=gen).to(torch.bfloat16)
    sites = record_train_sites(model, x)
    for k, site in enumerate(sites):
        errs.append(compare_bn_site(bn_site_label(k, site), site, gen))
    check_bn_repeat(sites, gen)
    timed = time_bn_sites(sites, gen)
    del sites, x
    torch.cuda.empty_cache()
    for mode, col in (("stats", 0), ("backward", 1)):
        timed[mode]["max_abs_err"] = max(e[col] for e in errs)
    return {"max_abs_err": max(max(e) for e in errs), "geometries": len(seen),
            "counts": counts, **timed}


# -- phase 4 ---------------------------------------------------------------

def flair_patch(rng, size: int) -> tuple[np.ndarray, np.ndarray]:
    """A learnable FLAIR-like patch: 64 x 64 blocks of one of the 19 classes,
    band 1 encodes the class, the other bands noise; the 1-based mask."""
    cls = np.kron(rng.integers(0, K, (size // 64, size // 64)), np.ones((64, 64), np.int64))
    img = rng.integers(0, 255, (C, size, size)).astype(np.uint8)
    img[0] = np.clip(cls * 12 + 10 + rng.integers(-4, 5, (size, size)), 0, 255).astype(np.uint8)
    return img, (cls + 1).astype(np.uint8)


def write_flair_dataset(root: Path, rng) -> dict:
    """FLAIR-like 512 x 512 x 5 uint8 patches and masks written with
    flairtpu_torch.io, one CSV a split."""
    csvs = {}
    for split, n in FLAIR_SPLITS:
        d = root / split
        d.mkdir(parents=True)
        rows = []
        for i in range(n):
            img, msk = flair_patch(rng, S)
            tr = Affine.from_origin(650000.0 + i * S * 0.2, 6860000.0, 0.2, 0.2)
            ip, mp = d / f"IMG_{i:06d}.tif", d / f"MSK_{i:06d}.tif"
            write_array(ip, img, transform=tr, crs=2154, tiled=False)
            write_array(mp, msk, transform=tr, crs=2154, tiled=False)
            rows.append(f"{ip},{mp}")
        csvs[split] = root / f"{split}.csv"
        csvs[split].write_text("\n".join(rows) + "\n")
    return csvs


def flair_config(root: Path, csvs: dict) -> dict:
    """configs/flair-1-config.yaml with its paths replaced and 3 epochs."""
    cfg = yaml.safe_load(TRAIN_CONFIG.read_text())
    cfg["paths"].update(out_folder=str(root / "out"), train_csv=str(csvs["train"]),
                        val_csv=str(csvs["val"]), test_csv=str(csvs["test"]),
                        ckpt_model_path="")
    cfg["num_epochs"] = FLAIR_EPOCHS
    return cfg


def flair_expected(counts: dict, steps: int, eval_batches: int, predict_batches: int) -> dict:
    """Each kernel's launches for a flair run: per train step one
    augment_normalize, one weighted_ce forward and backward, a statistics
    launch a BatchNorm, a conv_epilogue and a backward launch a site; per
    eval batch one augment_normalize, one weighted_ce and the full model's
    conv_epilogue sites; per predict batch one augment_normalize, the
    encoder's and decoder blocks 0-3's sites and one fused_tail."""
    out = dict.fromkeys(read_launches(), 0)
    out.update(augment_normalize=steps + eval_batches + predict_batches,
               weighted_ce=steps + eval_batches, weighted_ce_backward=steps,
               bn_stats=counts["bn"] * steps, bn_backward=counts["sites"] * steps,
               conv_epilogue=counts["sites"] * (steps + eval_batches)
               + counts["tail_sites"] * predict_batches,
               fused_tail=predict_batches)
    return out


def grad_rel(a: dict, b: dict) -> dict:
    return {n: ((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-30)).item() for n in b}


def all_rel(a: dict, b: dict) -> float:
    """Relative L2 over all tensors of ``b`` together."""
    return (sum((a[n] - b[n]).norm() ** 2 for n in b) ** 0.5 /
            sum(b[n].norm() ** 2 for n in b) ** 0.5).item()


def max_diff(a: torch.Tensor | None, b: torch.Tensor | None) -> float:
    return 0.0 if a is None and b is None else (a.float() - b.float()).abs().max().item()


class PlainSiteFns:
    """A train-mode site's parts as the plain versions."""
    stats = staticmethod(bt.bn_stats_plain)
    epilogue = staticmethod(ep.conv_epilogue_plain)
    backward = staticmethod(bt.bn_backward_plain)


class StepChecker:
    """A train-mode site's parts and the loss as the kernels, each also run
    plain on the same operands; keeps each part's worst disagreement (with
    the shape where it was) and how many calls it checked."""

    def __init__(self):
        self.worst: dict[str, tuple[float, tuple]] = {}
        self.calls = dict.fromkeys(("stats", "epilogue", "backward"), 0)

    def note(self, part: str, err: float, shape) -> None:
        if part not in self.worst or err > self.worst[part][0]:
            self.worst[part] = (err, tuple(shape))

    def stats(self, x, gamma, beta, rm, rv):
        rmp, rvp = rm.clone(), rv.clone()
        got = bt.bn_stats(x, gamma, beta, rm, rv)
        want = bt.bn_stats_plain(x, gamma, beta, rmp, rvp)
        self.note("stats", max(vec_err(a, b) for a, b in zip(got + (rm, rv), want + (rmp, rvp))),
                  x.shape)
        self.calls["stats"] += 1
        return got

    def epilogue(self, y, scale, shift, **kw):
        got = ep.conv_epilogue(y, scale, shift, **kw)
        want = ep.conv_epilogue_plain(y, scale, shift, **kw)
        self.note("epilogue", max(max_diff(a, b) for a, b in zip(got, want)), y.shape)
        self.calls["epilogue"] += 1
        return got

    def backward(self, *args):
        got, want = bt.bn_backward(*args), bt.bn_backward_plain(*args)
        shape = args[3].shape
        pairs = [(got[:3], want[:3])] + ([(got[4], want[4])] if got[4] is not None else [])
        for g, w in pairs:  # (dy, dgamma, dbeta), then the branch's
            self.note("dy", scaled_err(g[0], w[0]), shape)
            self.note("dgamma_dbeta", max(scaled_err(g[1], w[1]), scaled_err(g[2], w[2])), shape)
        self.note("dres", max_diff(got[3], want[3]), shape)
        self.calls["backward"] += 1
        return got


class SiteFunction(torch.autograd.Function):
    """A train-mode site through ``impl``'s stats, epilogue and backward
    (bn_train's site_forward and site_backward, as BNTrainSite runs them)."""

    @staticmethod
    def forward(ctx, impl, *args):
        ctx.impl = impl
        return bt.site_forward(ctx, impl.stats, impl.epilogue, *args)

    @staticmethod
    def backward(ctx, g, g32=None):
        return (None, *bt.site_backward(ctx, ctx.impl.backward, g, g32))


class SitesThrough(TrainSites):
    def __init__(self, impl):
        self.impl = impl

    def apply(self, *args):
        return SiteFunction.apply(self.impl, *args)


class PlainWeightedCE(torch.autograd.Function):
    """WeightedCE through the plain versions."""

    @staticmethod
    def forward(ctx, logits, target, weight, cm):
        loss, w_sum = wc.weighted_ce_plain(logits, target, weight, cm)
        ctx.save_for_backward(logits, target, weight, w_sum)
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, target, weight, w_sum = ctx.saved_tensors
        return wc.weighted_ce_grad_plain(logits, target, weight, w_sum, grad), None, None, None


class CheckedWeightedCE(torch.autograd.Function):
    """WeightedCE through the kernels, each held to its plain version on the
    same logits (and incoming gradient) by ``checker``."""

    @staticmethod
    def forward(ctx, checker, logits, target, weight, cm):
        cm_plain = cm.clone()
        loss, w_sum = wc.weighted_ce(logits, target, weight, cm)
        loss_p, w_sum_p = wc.weighted_ce_plain(logits, target, weight, cm_plain)
        checker.note("ce_loss", (abs(loss - loss_p) / abs(loss_p)).item(), logits.shape)
        checker.note("ce_weight_sum", max_diff(w_sum, w_sum_p), logits.shape)
        checker.note("ce_confmat", max_diff(cm, cm_plain), logits.shape)
        ctx.checker = checker
        ctx.save_for_backward(logits, target, weight, w_sum)
        return loss

    @staticmethod
    def backward(ctx, grad):
        logits, target, weight, w_sum = ctx.saved_tensors
        got = wc.weighted_ce_grad(logits, target, weight, w_sum, grad)
        want = wc.weighted_ce_grad_plain(logits, target, weight, w_sum, grad)
        ctx.checker.note("ce_grad", scaled_err(got, want), logits.shape)
        return None, got, None, None, None


class PlainTrainer(SegmentationTrainer):
    """The train step through the plain versions, its convolutions in
    ``dtype`` (None: the port's, bf16 on the card)."""

    def __init__(self, cfg: dict, dtype: torch.dtype | None = None):
        super().__init__(cfg)
        self.sites = SitesThrough(PlainSiteFns)
        self.dtype = dtype or self.dtype
        for m in self.model.modules():
            if "dtype" in vars(m):
                m.dtype = self.dtype

    def prepare(self, batch, augment=False, choices=None):
        return au.augment_normalize_plain(batch["img"].to(self.device), batch["msk"].to(
            self.device), choices, self.norm_mean, self.norm_mul, self.num_classes, self.dtype)

    def micro_step(self, x, tgt, cm):
        loss = PlainWeightedCE.apply(self.model(x, epilogue=self.sites), tgt,
                                     self.class_weights, cm)
        loss.backward()
        return loss.detach()


class CheckedTrainer(SegmentationTrainer):
    """The port's train step, every kernel also run plain on its operands."""

    def __init__(self, cfg: dict, checker: StepChecker):
        super().__init__(cfg)
        self.checker = checker
        self.sites = SitesThrough(checker)

    def prepare(self, batch, augment=False, choices=None):
        x, tgt = super().prepare(batch, augment, choices)
        xp, tp = au.augment_normalize_plain(batch["img"].to(self.device), batch["msk"].to(
            self.device), choices, self.norm_mean, self.norm_mul, self.num_classes, self.dtype)
        self.checker.note("augment", max(max_diff(x, xp), max_diff(tgt, tp)), x.shape)
        return x, tgt

    def micro_step(self, x, tgt, cm):
        loss = CheckedWeightedCE.apply(self.checker, self.model(x, epilogue=self.sites), tgt,
                                       self.class_weights, cm)
        loss.backward()
        return loss.detach()


def one_step(trainer, batch: dict, choices: torch.Tensor) -> dict:
    """One forward and backward on ``batch`` with ``choices``: the loss,
    the gradients, the running statistics after it and the confusion matrix."""
    cm = trainer.new_confmat()
    x, tgt = trainer.prepare(batch, True, choices)
    loss = trainer.micro_step(x, tgt, cm)
    torch.cuda.synchronize()
    out = {"loss": loss.item(), "cm": cm.clone(),
           "grads": {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()},
           "stats": {n: b.detach().clone() for n, b in trainer.model.named_buffers()
                     if "running" in n}}
    trainer.opt.zero_grad()
    return out


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def check_step_sites(checker: StepChecker, counts: dict) -> dict:
    """The site-by-site check of the kernels' step (StepChecker's records)."""
    calls = checker.calls
    check(calls == {"stats": counts["bn"], "epilogue": counts["sites"],
                    "backward": counts["sites"]},
          f"train step, site by site: {calls} kernel calls each held to its plain version on "
          f"the step's own operands ({counts['bn']} BatchNorms, {counts['sites']} sites)")
    limits = {"augment": 0.0, "stats": BN_STAT_TOL, "epilogue": 0.0, "dy": BN_DY_TOL,
              "dgamma_dbeta": BN_GRAD_TOL, "dres": 0.0, "ce_loss": CE_LOSS_RTOL,
              "ce_weight_sum": 0.0, "ce_confmat": 0.0, "ce_grad": CE_GRAD_TOL}
    for part, limit in limits.items():
        err, shape = checker.worst[part]
        check(err <= limit, f"train step, site by site: {part} within {err:.2e} <= {limit:.2e} "
              f"(worst at {shape})")
    return {part: {"err": e, "shape": list(sh)} for part, (e, sh) in checker.worst.items()}


def compare_train_step(cfg: dict, state: dict, batch: dict, counts: dict) -> dict:
    """One train step, from the same weights, batch and choices: the kernels'
    step held site by site to the plain versions, then against the plain
    step, beside the plain step's own drift (reversed batch, repeated, and
    both orders in float32)."""
    runs = {}
    choices = choices_all(TRAIN_BATCH)
    rev = {k: v.flip(0) for k, v in batch.items() if k != "id"}
    rev_choices = choices.flip(0).contiguous()
    checker = StepChecker()
    for name, make, b, ch in (
            ("kernels", lambda: CheckedTrainer(cfg, checker), batch, choices),
            ("plain", lambda: PlainTrainer(cfg), batch, choices),
            ("plain, reversed", lambda: PlainTrainer(cfg), rev, rev_choices),
            ("plain, again", lambda: PlainTrainer(cfg), batch, choices),
            ("plain float32", lambda: PlainTrainer(cfg, torch.float32), batch, choices),
            ("plain float32, reversed", lambda: PlainTrainer(cfg, torch.float32), rev,
             rev_choices)):
        trainer = make()
        trainer.load_state(state)
        with no_tf32() if "float32" in name else contextlib.nullcontext():
            runs[name] = one_step(trainer, b, ch)
        del trainer
        torch.cuda.empty_cache()
    out = {"sites": check_step_sites(checker, counts)}
    k, p, r = runs["kernels"], runs["plain"], runs["plain, reversed"]
    rel_loss = abs(k["loss"] - p["loss"]) / abs(p["loss"])
    check(rel_loss <= STEP_LOSS_RTOL, f"train step, free-running: loss {k['loss']:.6f} vs "
          f"plain {p['loss']:.6f} (reversed {r['loss']:.6f}): relative {rel_loss:.1e} <= "
          f"{STEP_LOSS_RTOL}")
    a, b0 = STEP_SLACK
    out.update(loss=k["loss"], plain_loss=p["loss"], reversed_loss=r["loss"])
    f, fr = runs["plain float32"], runs["plain float32, reversed"]
    for what in ("grads", "stats"):
        got, floor = grad_rel(k[what], p[what]), grad_rel(r[what], p[what])
        bad = [n for n in got if got[n] > a * floor[n] + b0]
        worst = max(got, key=lambda n: got[n] - a * floor[n])
        check(not bad, f"train step, free-running {what}: every tensor's relative L2 to the "
              f"plain step <= {a} x the reversed run's + {b0} (a bound on the drift; worst "
              f"{worst}: {got[worst]:.3e}, reversed {floor[worst]:.3e}; {len(bad)} over)")
        drift = {"kernels": all_rel(k[what], p[what]), "reversed": all_rel(r[what], p[what]),
                 "again": all_rel(runs["plain, again"][what], p[what]),
                 "float32_reversed": all_rel(fr[what], f[what]),
                 "float32_vs_bf16": all_rel(p[what], f[what])}
        out[what] = {"worst": worst, "worst_rel_l2": got[worst], "reversed": floor[worst],
                     "median_rel_l2": float(np.median(list(got.values()))),
                     "median_rel_l2_reversed": float(np.median(list(floor.values()))),
                     "median_rel_l2_float32_reversed": float(np.median(list(
                         grad_rel(fr[what], f[what]).values()))),
                     "all_rel_l2": drift}
        print(f"    train step {what}, relative L2 over all tensors to the plain bf16 step: "
              f"kernels {drift['kernels']:.3e}, plain reversed {drift['reversed']:.3e}, plain "
              f"again {drift['again']:.3e}; plain float32 reversed to float32 "
              f"{drift['float32_reversed']:.3e}; plain bf16 to float32 "
              f"{drift['float32_vs_bf16']:.3e}; median over tensors {out[what]['median_rel_l2']:.3e} "
              f"(reversed {out[what]['median_rel_l2_reversed']:.3e}, float32 reversed "
              f"{out[what]['median_rel_l2_float32_reversed']:.3e})", flush=True)
    moved_k = int((k["cm"] - p["cm"]).abs().sum()) // 2
    moved_r = int((r["cm"] - p["cm"]).abs().sum()) // 2
    n_pix = int(p["cm"].sum())
    check(moved_k <= moved_r + STEP_CM_SHARE * n_pix,
          f"train step, free-running confusion matrix: {moved_k} of {n_pix} pixels moved "
          f"(reversed run {moved_r}) <= reversed + {STEP_CM_SHARE} of the pixels")
    out.update(cm_moved=moved_k, cm_moved_reversed=moved_r, pixels=n_pix)
    return out


BN_KERNELS = ("stats_kernel", "backward_reduce", "backward_apply")  # csrc/bn_train.cu


def train_breakdown(cfg: dict, state: dict, batch: dict) -> dict:
    """Device time of the train step's stages at batch 16 (CUDA events:
    augment_normalize with the batch's upload, the forward, forward +
    backward, the SGD update, the whole step) and the profiler's kernel
    table of one step, with the share of the step's wall time the card was
    busy and the device time of bn_train's and weighted_ce's kernels in it."""
    from torch.profiler import ProfilerActivity, profile

    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    ch = choices_all(TRAIN_BATCH)
    x, tgt = tr.prepare(batch, True, ch)

    def forward_backward():
        loss = WeightedCE.apply(tr.model(x, epilogue=tr.sites), tgt, tr.class_weights, None)
        loss.backward()

    ms = {"augment_normalize_with_upload": cuda_ms(lambda: tr.prepare(batch, True, ch), 5, 1),
          "forward": cuda_ms(lambda: tr.model(x, epilogue=tr.sites), 5, 1),
          "forward_backward": cuda_ms(forward_backward, 5, 1),
          "sgd": cuda_ms(tr.opt.step, 5, 1)}
    tr.opt.zero_grad()
    ms["backward"] = ms["forward_backward"] - ms["forward"]
    ms["train_step"] = cuda_ms(lambda: tr.train_step(batch, choices=ch), 5, 1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(batch, choices=ch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    # kernels' own device time (the ops that launch them carry it too)
    busy_ms = sum(e.self_device_time_total for e in events
                  if str(e.device_type).endswith("CUDA")) / 1e3
    ms.update(profiled_step_wall=wall_ms, profiled_step_device_busy=busy_ms)
    for kernel in BN_KERNELS:  # bn_train's kernels, summed over the step's launches
        ms[f"profiled_{kernel}"] = sum(e.self_device_time_total for e in events
                                       if f"::{kernel}" in e.key) / 1e3
    # weighted_ce's forward and backward kernels (csrc/weighted_ce.cu)
    ms["profiled_weighted_ce"] = sum(e.self_device_time_total for e in events
                                     if str(e.device_type).endswith("CUDA")
                                     and "weighted_ce" in e.key) / 1e3
    return {"stage_ms": ms, "busy_share": busy_ms / wall_ms,
            "kernel_table": events.table(sort_by="self_cuda_time_total", row_limit=20)}


@contextlib.contextmanager
def torch_defaults():
    """PyTorch's default precision flags, as a user's flair run has them:
    cuDNN may use TF32 (the head's float32 convolution, whose operands are
    bf16 values, and its gradients); phase 2 turns it off for its float32
    comparisons."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def run_flair(tmp: Path, rng, card: str, profile: bool = False) -> dict:
    """Phase 4: flair train / predict / metrics through cli.flair_main at
    the config's full width, then one train step against the plain versions
    (and with ``profile`` the train step's breakdown)."""
    t0 = time.perf_counter()
    csvs = write_flair_dataset(tmp / "flair", rng)
    cfg = flair_config(tmp / "flair", csvs)
    conf = tmp / "flair" / "flair.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    print(f"    wrote {sum(n for _, n in FLAIR_SPLITS)} patches of {S}x{S}x{C} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts = train_site_counts(FlairSegmentationModel("resnet34", K, C))

    reset_launches()
    t0 = time.perf_counter()
    result = cli.flair_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    tiled = au.tiled_launches

    n_train, n_val, n_test = (n for _, n in FLAIR_SPLITS)
    steps = FLAIR_EPOCHS * (n_train // TRAIN_BATCH)
    history = result["train"]["history"]
    eval_batches = (len(history) + 1) * (n_val // TRAIN_BATCH)  # each epoch, and the final validate
    predict_batches = -(-n_test // TRAIN_BATCH)
    check_launches(f"flair: {steps} train steps, {eval_batches} eval and {predict_batches} "
                   "predict batches", launches,
                   flair_expected(counts, steps, eval_batches, predict_batches))
    check(tiled == launches["augment_normalize"], f"flair: all {launches['augment_normalize']} "
          f"augment_normalize launches took the tiled instance ({tiled})")
    check(len(history) == FLAIR_EPOCHS, f"flair: {len(history)} epochs")
    losses = [(h["train_loss"], h["val_loss"]) for h in history]
    check(all(np.isfinite(v) for pair in losses for v in pair),
          "flair: every epoch's train and val loss finite: " +
          ", ".join(f"{a:.4f}/{b:.4f}" for a, b in losses))

    out = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"])
    name = cfg["paths"]["out_model_name"]
    best = Path(result["train"]["best_path"])
    for rel in ("flair-compute.log", "used_csv_and_config", "metrics.jsonl", "history.json",
                "last", "best", f"predictions_{name}", "metrics/confmat.npy",
                "metrics/metrics.json"):
        check((out / rel).exists(), f"flair artifact {rel}")
    check(best.exists() and best.name.startswith("ckpt-") and best.name.endswith(f"_{name}"),
          f"flair best checkpoint {best.name}")
    preds = sorted((out / f"predictions_{name}").glob("PRED_*.tif"))
    check(len(preds) == n_test, f"flair: {len(preds)} PRED files")
    with TiffReader(preds[0]) as r, TiffReader(str(csvs["test"]).replace(".csv", "") +
                                               "/IMG_000000.tif") as src:
        check((r.width, r.height, r.count, r.crs) == (S, S, 1, src.crs) and
              r.transform == src.transform, "flair PRED raster: 512 x 512 x 1, georeferenced")
        check(int(r.read(1).max()) < K, f"flair PRED classes in [0, {K})")
    metrics = json.loads((out / "metrics" / "metrics.json").read_text())
    used = sum(1 for v in cfg["classes"].values() if v[0] != 0)
    check(metrics["Avg_metrics_name"] == ["mIoU", "Overall Accuracy", "Fscore", "Precision",
                                          "Recall"]
          and len(metrics["Avg_metrics"]) == 5 and len(metrics["classes"]) == used
          and all(len(metrics[k]) == used for k in ("per_class_iou", "per_class_fscore",
                                                   "per_class_precision", "per_class_recall")),
          f"flair metrics.json: the reference's schema, {used} classes of weight != 0")
    check(np.load(out / "metrics" / "confmat.npy").shape == (K, K), "flair confmat.npy (19, 19)")

    state = ckpt_lib.CheckpointManager.restore(best)
    # predict once more, warm (flair_main's predict is one batch, its first):
    # the 64 train patches, 4 batches, through the same entry point
    trainer = SegmentationTrainer(cfg)
    trainer.load_state(state)
    warm = predict(cfg, gather_paths(cfg, "train"), tmp / "flair" / "predict_warm", trainer,
                   progress=lambda _: None)
    del trainer
    torch.cuda.empty_cache()

    epochs = result["train"]["epochs"]
    later = epochs[1:]
    train_ps = sum(e["train_patches"] for e in later) / sum(e["train_seconds"] for e in later)
    eval_ps = (sum(e["eval_patches"] for e in epochs) / sum(e["eval_seconds"] for e in epochs))
    pred = result["predict"]
    stats = {
        "train_patches_per_sec_from_epoch_2": train_ps,
        "train_steps_from_epoch_2": steps - n_train // TRAIN_BATCH,
        "train_seconds_by_epoch": [e["train_seconds"] for e in epochs],
        "loader_wait_seconds_by_epoch": [e["loader_wait_seconds"] for e in epochs],
        "eval_patches_per_sec": eval_ps, "eval_batches": eval_batches,
        "predict_first_call_seconds": pred["seconds"],
        "predict_first_call_patches": pred["patches"],
        "predict_warm_patches_per_sec": warm["patches"] / warm["seconds"],
        "predict_warm_patches": warm["patches"], "losses": losses,
        "val_miou": [h["val_miou"] for h in history], "miou": metrics["Avg_metrics"][0],
        "flair_main_wall_seconds": wall, "steps": steps, "card": card}
    print(f"  flair on {card}: train {train_ps:.2f} patches/s over the "
          f"{stats['train_steps_from_epoch_2']} steps from epoch 2 (loader wait "
          f"{', '.join(f'{w:.3f}' for w in stats['loader_wait_seconds_by_epoch'])} s of "
          f"{', '.join(f'{t:.3f}' for t in stats['train_seconds_by_epoch'])} s a epoch), "
          f"eval {eval_ps:.2f} patches/s over {eval_batches} batches, predict warm "
          f"{stats['predict_warm_patches_per_sec']:.2f} patches/s over {warm['patches']} "
          f"patches (flair_main's first call: {pred['patches']} patches in "
          f"{pred['seconds']:.4f} s), test mIoU {stats['miou']:.2f}, flair_main wall "
          f"{wall:.1f} s", flush=True)
    for name_, got in launches.items():
        if got:
            print(f"    launches {name_}: {got}")

    print("  one train step, kernels against plain versions (same weights, batch, choices)",
          flush=True)
    ds = PatchDataset(gather_paths(cfg, "train"), cfg["channels"])
    batches = iter(PatchLoader(ds, TRAIN_BATCH, pin=True))
    batch = next(batches)
    batches.close()
    step = compare_train_step(cfg, state, batch, counts)
    out = {"stats": stats, "launches": launches, "step": step}
    if profile:
        out["breakdown"] = train_breakdown(cfg, state, batch)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time one main-path batch and one flair train step "
                         "stage by stage and print the profiler's kernel tables")
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
        zone, truth, weights = synth_inputs(tmp, ZONE, rng)
        cfg = detect_config(tmp, zone, truth, weights)
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
            typed = check_gather_typed(rng, ZONE)
            model, _ = eng.prepare_model(cfg, torch.device("cuda"))
            gen = torch.Generator("cuda").manual_seed(SEED)
            x = torch.rand((BATCH, S, S, C), generator=gen, device="cuda").to(torch.bfloat16)
            epi = check_conv_epilogue(model, x, timed=True)
            fold_model, _ = eng.prepare_model(dict(cfg, bn_fold=True), torch.device("cuda"))
            epi["max_abs_err"] = max(epi["max_abs_err"], check_fold_epilogue(fold_model, x[:4]))
            del model, x, fold_model
            torch.cuda.empty_cache()
            qmodel, _ = eng.prepare_model(dict(cfg, **INT8_KNOBS), torch.device("cuda"))
            int8 = check_int8(qmodel, torch.rand((BATCH, S, S, C), generator=gen,
                                                 device="cuda"), timed=True)
            del qmodel
            torch.cuda.empty_cache()
            probs = check_tail_probs(rng, S, M, BATCH, K, timed=True)
            for size, margin, k in ((64, 16, K), (32, 1, 4), (96, 8, 32)):
                check_tail_probs(rng, size, margin, 4, k)
            check_tail_probs_planes(rng, 1000, 1100, 8)
            logits = check_tail_logits(rng, S, BATCH, K, timed=True)
            for size, k in ((64, K), (96, 32)):
                check_tail_logits(rng, size, 4, k)
            torch.cuda.empty_cache()
            stitch = check_stitch(timed=True)
            torch.cuda.empty_cache()
            softmax = check_tile_softmax(rng)
            torch.cuda.empty_cache()
            # flair's predict: the tail at margin 0 on whole 512 tiles
            tail0 = check_fused_tail(rng, S, 0, TRAIN_BATCH, K, timed=True)
            augment = check_augment(gen)
            ce = check_weighted_ce(gen)
            torch.cuda.empty_cache()
            bn = check_bn_train(gen)
            torch.cuda.empty_cache()
        print(f"    fused_tail: {tail['ms']:.4f} ms, plain {tail['plain_ms']:.4f} ms, "
              f"bound {tail['bound_ms']:.4f} ms ({tail['bound_by']})", flush=True)
        for name, r in (("gather_normalize", gather),
                        *((f"gather_normalize {m['mode']}", m) for m in typed["modes"])):
            print(f"    {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)",
                  flush=True)
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
        for r in int8["conv"]["sites"]:
            print(f"    int8_conv {r['site']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"_int_mm {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        for g, r in int8["conv"]["groups"].items():
            print(f"    int8_conv, {g} sites: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), _int_mm {r['library_ms']} ms, plain {r['plain_ms']:.4f} ms")
        worst = int8["conv"]["worst_library_ratio"]
        if worst:
            print(f"    int8_conv, largest kernel / _int_mm ratio: {worst[0]:.3f} ({worst[1]})")
        for r in int8["quantize"]["sites"]:
            print(f"    quantize_act {r['site']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        for name, r in (("int8_conv, the 40 sites of one batch", int8["conv"]),
                        ("quantize_act, the 4 sites of one batch", int8["quantize"])):
            print(f"    {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['bytes'] / 1e9:.2f} GB)", flush=True)
        for name, r in (("fused_tail probs", probs), ("fused_tail logits", logits),
                        *stitch["timed"].items(), ("tile_softmax probs", softmax["probs"]),
                        ("tile_softmax argmax", softmax["argmax"])):
            print(f"    {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

        r = tail0
        print(f"    fused_tail argmax, margin 0, batch 16: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        for r in augment["calls"].values():
            print(f"    augment_normalize {r['mode']}, batch 16: device {r['ms']:.4f} ms "
                  f"({r['bound_ms'] / r['ms']:.0%} of its bound), call {r['call_ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library none, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)", flush=True)
        for r in ce.values():
            print(f"    weighted_ce {r['mode']}, batch 16: device {r['ms']:.4f} ms "
                  f"({r['bound_ms'] / r['ms']:.0%} of its bound), call {r['call_ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        for mode, what in (("stats", f"{bn['counts']['bn']} BatchNorms"),
                           ("backward", f"{bn['counts']['sites']} sites")):
            r = bn[mode]
            print(f"    bn_train {mode}, the {what} of one batch-16 step: device "
                  f"{r['ms']:.4f} ms (largest site {r['largest_ms']:.4f}), call "
                  f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{r['bytes'] / 1e9:.2f} GB)", flush=True)
            for route, t in r["routes"].items():
                print(f"      route {route}: {t['sites']} sites, device {t['ms']:.4f} ms, "
                      f"call {t['call_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms", flush=True)
        if bn["backward"]["library_error"]:
            print(f"    bn_train backward library: none ({bn['backward']['library_error']})")

        print("[3] main path: flair-detect on the card", flush=True)
        main_path = run_main_path(cfg, conf, ZONE, card)
        class_prob = run_class_prob(cfg, ZONE)
        sweep = run_sweep(cfg, ZONE)
        print("[3b] the streaming route: flair-detect on the card, stitched on the host",
              flush=True)
        streaming = run_streaming(cfg, ZONE, sweep["dir"])
        print("[3c] the banded route: slabs up, bands computed and rows back on three "
              "CUDA streams", flush=True)
        banded = run_banded(cfg, ZONE)
        print("[3d] department batch mode (-b): one model, the next zone staged ahead",
              flush=True)
        batch = run_batch(cfg, tmp)
        print("[3e] a uint16 zone, custom normalization, device and streaming routes",
              flush=True)
        u16 = run_uint16(cfg, tmp, ZONE)
        float_raster = read_raster(Path(cfg["output_path"]) / "zone-ARGMAX.tif")
        print("[3f] bn_fold on the main configuration", flush=True)
        fold = run_knobs(cfg, "bn_fold", {"bn_fold": True}, ZONE, FOLD_FLOOR, float_raster)
        print("[3g] quantize: int8, int8_decoder: 2, bn_fold on the main configuration; "
              f"int8_decoder 0 and 4, and int8 without bn_fold, on a {ZONE_SMALL}² zone",
              flush=True)
        int8_run = run_knobs(cfg, "int8", INT8_KNOBS, ZONE, INT8_FLOOR, float_raster,
                             int8_blocks=INT8_KNOBS["int8_decoder"])
        int8_small = run_small_int8(cfg, tmp)
        print("[4] flair train / predict / metrics on the card: resnet34-unet, 512 patches, "
              f"batch {TRAIN_BATCH}, {K} classes", flush=True)
        with torch_defaults():
            flair = run_flair(tmp, rng, card, profile=args.profile)
        if args.profile:
            with torch.inference_mode():
                prof = stage_breakdown(cfg, ZONE, rng, epi)
            print(prof["kernel_table"])
            print(json.dumps({"stage_ms": prof["stage_ms"], "card": card}), flush=True)
            print(flair["breakdown"]["kernel_table"])
            print(json.dumps({"train_step_ms": flair["breakdown"]["stage_ms"],
                              "busy_share": flair["breakdown"]["busy_share"], "card": card}),
                  flush=True)

    src = "flairtpu_torch/csrc"
    timed = stitch["timed"]

    def numbers(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    def sweep_launches(name: str) -> int:
        return sum(run[name] for run in sweep["launches"].values())

    def stream_launches(name: str) -> int:
        return sum(run["launches"][name] for run in streaming.values())

    # fused_tail: the argmax mode's numbers on the main path, and each mode's
    # (launches counted on the run of its own path: class_prob, the sweep,
    # and the streaming runs)
    modes = [
        {"mode": "argmax", "launches": main_path["launches"]["fused_tail"]
         + stream_launches("fused_tail"),
         "max_abs_err": tail["max_abs_err"], **numbers(tail), "library_ms": tail["library_ms"]},
        {"mode": "probs", "replaces": "flairtpu/zone/device_engine.py:176-185",
         "launches": class_prob["launches"]["fused_tail_probs"]
         + stream_launches("fused_tail_probs"),
         "max_abs_err": probs["max_abs_err"], **numbers(probs),
         "library_ms": probs["library_ms"]},
        {"mode": "argmax, margin 0 (flair predict)", "replaces": "flairtpu/predict/runner.py:"
         "80-81 with flairtpu/train/loop.py:405-415", "launches": flair["launches"]["fused_tail"],
         "max_abs_err": tail0["max_abs_err"], **numbers(tail0),
         "library_ms": tail0["library_ms"]},
        {"mode": "logits", "replaces": "flairtpu/zone/device_engine.py:206, :519",
         "launches": sweep_launches("fused_tail_logits") + stream_launches("fused_tail_logits"),
         "max_abs_err": logits["max_abs_err"], **numbers(logits),
         "library_ms": logits["library_ms"]},
    ]
    # tile_softmax: the probs mode's numbers, and each mode's (launches on the
    # streaming average_weights and max runs)
    softmax_modes = [
        {"mode": mode, "launches": stream_launches(f"tile_{mode}"),
         "max_abs_err": softmax[mode]["max_abs_err"], **numbers(softmax[mode]),
         "library_ms": None}
        for mode in ("probs", "argmax")]
    kernels = [
        {"name": "fused_tail", "route": "cuda", "source": f"{src}/fused_tail.cu",
         "replaces": "benchmarks/pallas_fused_tail.py:229 and the plane writes "
                     "flairtpu/zone/device_engine.py:148-156",
         "launches": main_path["launches"]["fused_tail"],
         "max_abs_err": tail["max_abs_err"], "ms": tail["ms"],
         "plain_ms": tail["plain_ms"], "bound_ms": tail["bound_ms"],
         "bound_by": tail["bound_by"], "library_ms": tail["library_ms"], "modes": modes},
        {"name": "gather_normalize", "route": "cuda", "source": f"{src}/gather_normalize.cu",
         "replaces": "flairtpu/zone/device_engine.py:124",
         "launches": main_path["launches"]["gather_normalize"],
         "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
         "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
         "bound_by": gather["bound_by"], "library_ms": None},
        # times summed over the 41 sites (launches) of one batch
        # the uint16 zone's numbers (launches on phase 3e's two runs), and
        # each dtype's
        {"name": "gather_normalize_typed", "route": "cuda",
         "source": f"{src}/gather_normalize.cu",
         "replaces": "flairtpu/zone/device_engine.py:124 with flairtpu/data/normalize.py:52 "
                     "on uint16, int16 and float32 zones",
         "launches": sum(r["launches"]["gather_normalize_typed"] for r in u16.values()),
         "max_abs_err": typed["max_abs_err"], **numbers(typed), "library_ms": None,
         "modes": [{"mode": m["mode"], "max_abs_err": m["max_abs_err"], **numbers(m)}
                   for m in typed["modes"]]},
        {"name": "conv_epilogue", "route": "cuda", "source": f"{src}/conv_epilogue.cu",
         "replaces": "flairtpu/models/resnet.py:177-189, :208-222, :269-273 and "
                     "flairtpu/models/unet.py:71-76 (XLA-fused BatchNorm, residual, ReLU)",
         "launches": main_path["launches"]["conv_epilogue"],
         "max_abs_err": epi["max_abs_err"], "ms": epi["ms"], "plain_ms": epi["plain_ms"],
         "bound_ms": epi["bound_ms"], "bound_by": epi["bound_by"], "library_ms": None},
        {"name": "accumulate_probs", "route": "cuda", "source": f"{src}/accumulate_probs.cu",
         "replaces": "flairtpu/ops/fused.py:56-76 with flairtpu/zone/device_engine.py:203-211",
         "launches": sweep_launches("accumulate_probs"),
         "max_abs_err": max(r["max_abs_err"] for r in stitch["accumulate"]),
         **numbers(timed["accumulate_probs"]), "library_ms": None},
        {"name": "merge_max", "route": "cuda", "source": f"{src}/merge_max.cu",
         "replaces": "flairtpu/zone/device_engine.py:517-534",
         "launches": sweep_launches("merge_max"),
         "max_abs_err": max(r["max_abs_err"] for r in stitch["merge"]),
         **numbers(timed["merge_max"]), "library_ms": None},
        # the mean mode's numbers (the max mode: stitch_finalize_max in the timings line)
        {"name": "stitch_finalize", "route": "cuda", "source": f"{src}/stitch_finalize.cu",
         "replaces": "flairtpu/zone/device_engine.py:216-220, :539, :728-729, :742-743",
         "launches": sweep_launches("stitch_finalize"), "max_abs_err": 0,
         **numbers(timed["stitch_finalize"]), "library_ms": None},
        # no single PyTorch call computes either mode (softmax, then a
        # permute and a copy, is two)
        {"name": "tile_softmax", "route": "cuda", "source": f"{src}/tile_softmax.cu",
         "replaces": "flairtpu/zone/engine.py:138-145 (XLA-fused full-tile softmax payloads)",
         "launches": sum(m["launches"] for m in softmax_modes),
         "max_abs_err": max(m["max_abs_err"] for m in softmax_modes),
         **numbers(softmax["probs"]), "library_ms": None, "modes": softmax_modes},
        # the 40 int8 sites of one batch of 128, summed (launches: phase 3g's
        # main zone); library: torch._int_mm on each site's im2col operand
        {"name": "int8_conv", "route": "cuda", "source": f"{src}/int8_conv.cu",
         "replaces": "flairtpu/models/quantize.py:218-230 (_quant_conv), with the walk's "
                     "residual and ReLU (:125-135, :174-175) and the next site's requantize "
                     "(:223)",
         "launches": int8_run["launches"]["int8_conv"], "max_abs_err": int8["max_abs_err"],
         **numbers(int8["conv"]), "library_ms": int8["conv"]["library_ms"]},
        # its 4 sites of one batch of 128, summed (launches: phase 3g's main zone)
        {"name": "quantize_act", "route": "cuda", "source": f"{src}/quantize_act.cu",
         "replaces": "flairtpu/models/quantize.py:223 (the requantize of the stem input, "
                     "the pooled stem and the int8 decoder blocks' inputs)",
         "launches": int8_run["launches"]["quantize_act"], "max_abs_err": 0,
         **numbers(int8["quantize"]), "library_ms": None},
        # the train batch's 16 patches (launches: phase 4's train, eval and predict)
        {"name": "augment_normalize", "route": "cuda", "source": f"{src}/augment_normalize.cu",
         "replaces": "flairtpu/data/augment.py:35-54, flairtpu/train/loop.py:271-274 and "
                     ":339-342 (XLA-fused D4 augmentation, label cleaning, normalize_device)",
         "launches": flair["launches"]["augment_normalize"], "max_abs_err": 0,
         **numbers(augment), "library_ms": None},
        # the forward's numbers on the random input, by device time (launches:
        # phase 4's train steps and eval batches); each entry point on each
        # input in its modes. library: F.cross_entropy(weight=w), the loss
        # only (forward), and its VJP alone (backward: nll_loss2d_backward +
        # _log_softmax_backward_data, the graph retained)
        {"name": "weighted_ce", "route": "cuda", "source": f"{src}/weighted_ce.cu",
         "replaces": "flairtpu/train/loop.py:255-269 (_loss and its VJP) with :307-310 and "
                     "flairtpu/ops/confmat.py:19-41 (the confusion matrix)",
         "launches": flair["launches"]["weighted_ce"],
         "max_abs_err": max(r["max_abs_err"] for r in ce.values()),
         **numbers(ce["forward random"]), "call_ms": ce["forward random"]["call_ms"],
         "library_ms": ce["forward random"]["library_ms"],
         "modes": [dict(r, launches=flair["launches"]["weighted_ce" if key.startswith(
             "forward") else "weighted_ce_backward"]) for key, r in ce.items()]},
        # the statistics of one batch-16 step's 46 BatchNorms, summed
        # (launches: phase 4's), library torch.var_mean(correction=0) on each;
        # the backward's 43 sites in its mode; max_abs_err the largest scaled
        # error of either mode (the backward's dy and dd included)
        {"name": "bn_train", "route": "cuda", "source": f"{src}/bn_train.cu",
         "replaces": "flairtpu/models/resnet.py:40-70 (flax train-mode BatchNorm) at the sites "
                     "of resnet.py:177-189, :208-222, :269-273 and flairtpu/models/unet.py:71-76, "
                     "with their VJP",
         "launches": flair["launches"]["bn_stats"], "max_abs_err": bn["max_abs_err"],
         **numbers(bn["stats"]), "call_ms": bn["stats"]["call_ms"],
         "library_ms": bn["stats"]["library_ms"],
         "modes": [dict({k: v for k, v in bn[m].items() if k not in ("sites", "routes")},
                        launches=flair["launches"]["bn_stats" if m == "stats" else
                                                   "bn_backward"]) for m in ("stats",
                                                                             "backward")]},
    ]
    print(json.dumps({"main_path": main_path["stats"], "card": card}))
    print(json.dumps({"class_prob": class_prob["stats"], "card": card}))
    print(json.dumps({"compare_sweep": sweep["results"], "card": card}))
    print(json.dumps({"streaming": {k: {f: v for f, v in r.items() if f != "launches"}
                                    for k, r in streaming.items()}, "card": card}))
    print(json.dumps({"banded": banded, "card": card}))
    print(json.dumps({"batch_mode": {k: v for k, v in batch.items() if k != "launches"},
                      "card": card}))
    print(json.dumps({"uint16_zone": u16, "card": card}))
    print(json.dumps({"bn_fold": fold, "int8": int8_run, "int8_small_zone": int8_small,
                      "card": card}))
    print(json.dumps({"int8_timings": {k: {f: v for f, v in r.items() if f != "sites"}
                                       for k, r in int8.items() if isinstance(r, dict)},
                      "card": card}))
    print(json.dumps({"stitch_timings": timed, "card": card}))
    print(json.dumps({"flair": flair["stats"], "train_step_vs_plain": flair["step"],
                      "launches": flair["launches"], "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
