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
   dilation 2 and 1x1/2, a residual without ReLU, and the dilated encoders'
   3x3 at dilation 4 over 512 channels and 1x1/1 downsample from 256 to
   512). Each kernel and its plain version
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
   (backward), with the backward's sites and times by route. Slice 5's
   kernels: strided_tail's three modes at the archs' main-path shapes
   (head logits (128, 128, 128, 19), (128, 64, 64, 19) and (128, 512, 512,
   19) float32 at U = 4, 8 and 1; argmax and probs at margin 128 into
   whole-tile windows, logits at margin 0) and at STRIDED_EDGES (K = 1, 4,
   7, 13, 19 and 32, margins 0 to 64, 48 to 256 pixels, window rows not a
   multiple of a band), and argmax and probs into the planes of the 1000 x
   1100 zone at each U: logits within STRIDED_TOL of the largest |logit|,
   classes equal except where the plain top-2 gap is below STRIDED_GAP,
   prob and probs within 1; each mode timed beside its plain version (and
   F.interpolate for the logits mode), and printed beside the time of the
   kernel it replaced (STRIDED_BEFORE_MS). The stem conv at the main path's shape, direct
   and space-to-depth (s2d_stem), within STEM_TOL, each timed. group_norm_relu
   at FPN's seven site shapes at batch 128 (GN_SITES) within GN_TOL of its
   plain version, two calls bit-identical, timed beside its plain version
   and F.group_norm; its train-mode forward (the saved mean and rstd) and
   its backward (one launch a call) at the same sites at the train batch
   (16) and at the edges of its plan (GN_EDGES: batch 1, ragged items,
   other channel and group counts; the on-chip route's largest sample and
   the next, re-read): dy within GN_DY_TOL of the largest, dgamma and dbeta
   within GN_GRAD_TOL, two calls bit-identical, FPN's sites timed by device
   and call time beside the earlier three-launch kernel's device time
   (GN_BACKWARD_BEFORE_MS), the plain version and aten's
   native_group_norm_backward (GroupNorm alone, not the same function).
   bn_train's narrow entry points (channels not a multiple of 8) at PAN's
   six 1-channel sites at the train batch (PAN_NARROW_SITES): the
   statistics, the fused forward's output (bit for bit conv_epilogue's
   arithmetic) and the backward against their plain versions, two calls
   bit-identical, one launch each way and no conv_epilogue, timed by
   device time beside torch.var_mean, native_batch_norm_backward and the
   card's launch floors (an empty kernel, one block's reduction).
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
   or INT8_FLOOR), patches/s and the calibration's seconds. 3h: the main
   configuration with s2d_stem: true (the main path's launches), each class
   equal to the default stem's raster except where the default model's
   plain logits have a top-2 gap below GAP_TOL.
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
4b. the reference's best configuration: ``use_metadata: true`` (a
   flair_aerial_metadata.json for the phase's patches from the numpy seed:
   Lambert-93 centroids, altitudes, UCE and other cameras, dates in
   2018-2021, HHhMM times) with ``init_encoder_weights`` (a torchvision-keyed
   resnet34 classifier .pth from the seed), through ``cli.flair_main`` for 2
   epochs at batch 16 with 20 test patches (predict pads the last batch's
   metadata): the launches against steps x sites (the MLP and its fusion are
   plain PyTorch and launch none), finite losses, every artifact, train
   patches/s from epoch 2 and predict patches/s; then one metadata train
   step, the kernels' against the plain step on the same operands and
   dropout masks, as phase 4's (without the float32 runs).
4c. ``accumulate_steps: 2`` for one epoch (launches: two microbatches of
   bn_train and weighted_ce a step, one augment_normalize; one accumulated
   step against the plain accumulated step, the reversed run reversing
   within each microbatch); ``resume_training_from_ckpt`` from phase 4's
   ``last`` (the restored state equal to the saved one bit for bit, the run
   going on at the next epoch); ``autosave_every_steps: 1`` resuming a
   snapshot at epoch 1 step 1 (the epoch's last 3 steps trained, the
   autosave cleared at the end). Each run with the counts set to 0 just
   before it.
4d. ``flair`` with slice 5's decoders: each of ``ARCHS5`` (a random
   resnet34, 19 classes) through ``cli.flair_main`` (train, predict,
   metrics) at phase 4's configuration on its written set, 1 epoch of 4
   steps (deeplabv3plus 2, for its train patches/s past the warm-up), each
   with the counts set to 0 just before it: the launches against steps x
   sites from the model's structure (bn_train's statistics and backward at
   every BatchNorm, the narrow entry points at PAN's 1-channel ones (their
   forward writes the output), conv_epilogue's apply elsewhere; FPN's group_norm_relu 7 a forward and its
   backward 7 a step; weighted_ce; augment_normalize through its tiled
   instance; per predict batch one strided_tail into (B, S, S) tiles at
   margin 0, U = 4, 8 or 1, or one fused_tail for manet and unetplusplus),
   finite losses, every artifact and metrics.json's schema; train and
   predict patches/s (flair_main's, and warm: WARM_STEPS steps on one batch,
   predict again) and the peak device memory. Then one train step from
   the trained weights on one batch with fixed choices and dropout masks
   (ARCH_DROPOUT): the kernels' step site by site against the plain
   versions (the GroupNorm sites' forward and backward too), then free-
   running against the plain step under STEP_LOSS_RTOL, STEP_SLACK and
   STEP_CM_SHARE beside the plain step in four other orders (ten for PAN:
   STEP_REORDERS; no float32 runs; the noise-dominated tensors under
   STEP_NOISE_SLACK, all tensors
   together under STEP_SLACK, the loss under STEP_LOSS_RTOL or
   STEP_NOISE_SLACK x the reordered runs' drift; PAN's kernels' step in
   three orders, STEP_KERNEL_ORDERS, each held so, a tensor failing in
   more than half of them); and flair predict's tail
   on one batch
   against its plain version (the near-tie rule). PyTorch's default
   precision flags, as a user's run has them.
5. slice 5's smp decoders (``ARCHS5``: deeplabv3plus, deeplabv3, fpn,
   pspnet, pan, linknet, manet, unetplusplus), each a random resnet34 (19
   classes) on the main configuration and zone through detect_main with the
   counts set to 0 just before it: the raster's shape, georeferencing and
   coverage, the launches (gather_normalize and the tail once a batch:
   strided_tail, or fused_tail for manet and unetplusplus, whose decoder
   runs whole tiles through the node before the last; conv_epilogue once
   per BatchNorm site outside the tail, FPN's group_norm_relu 7 a batch),
   and against its all-plain run (GapRunner): no class moved where the
   plain logits' top-2 gap is at least ARCH_GAP, prob |diff| <= 1; zone
   patches/s, compute s and peak device memory; one batch by stage (CUDA
   events; with --profile the profiler's kernel table). deeplabv3plus and
   manet also with class_prob (the probs mode, every band within 1 of
   plain) and ``-c -m`` at size 512 (the four methods, each run's launches
   and agreement with plain). Phase 5 runs with PyTorch's default precision
   flags.
5b. the knobs off the U-Net: ``bn_fold: true`` and INT8_KNOBS (int8_decoder
   ignored: the encoder alone in int8) for deeplabv3 (dilations 2 and 4) and
   unetplusplus on the main zone, and INT8_KNOBS for the other six archs on
   phase 3g's 1024² zone. Each run: its launches with the counts set to 0
   just before it (int8_conv at each encoder conv and quantize_act twice a
   batch, conv_epilogue at the decoder's BatchNorm sites), against its
   all-plain run on the same model by phase 5's rule, its class agreement
   with the arch's float raster of the zone (>= FOLD_FLOOR or INT8_FLOOR),
   patches/s and the calibration's seconds.
   Phase 2 also holds the grouped int8_conv (int8_conv_grouped, a
   ResNeXt's 3x3) bit for bit to its plain version at the 16 grouped sites
   of resnext50_32x4d-unet's int8 walk (batch 2; the int8 output the walk
   asks for, and float32 beside it) and at GROUPED_EDGES (dilations 2 and 4
   of the off-U-Net walks, Wo not a multiple of the 16-pixel tile, stride 2
   from odd sides with a residual and no ReLU, 48 channels a group, 4 a
   group at stride 2, a slab of 128 channels part empty, a band that ends
   short, each of the kernel's nine instances), and times it at batch 128
   by geometry beside its bound (HBM bytes, or multiply-adds at
   PEAK_INT8_OPS), its share of the bound, PR 20's dp4a kernel's time
   (GROUPED_BEFORE_MS) and the plain version.
6. native weights: the port's ``tools.py make-toy-zone`` at its defaults (a
   2048² zone, 13 classes, resnet34-unet, .msgpack weights), flair-detect
   on its detect YAML (launches as the main path's) and its compare YAML
   with ``-c -m`` from the .msgpack; the argmax raster of the same weights
   saved as .pth is byte-equal; save_weights_msgpack's file reads back to
   the same state dict; the zone's patches/s.
7. resnext50_32x4d-unet at full width (random weights, 19 classes): the
   main path on the 4096² zone (512/128, batch 128, argmax, exact
   clipping) against its all-plain run, bn_fold and INT8_KNOBS held as 3f
   and 3g hold resnet34 (int8_conv_grouped 16 a batch), launches,
   patches/s, peak memory; then flair (phase 4's values, batch 16, one
   epoch of 4 steps) initialized from a .msgpack through
   init_weights_only_from_ckpt, one train step held to the plain step as
   phase 4d holds the other archs, and its predict tail.
8. EfficientNet, serving (random weights, 19 classes): the SiLU epilogue
   (conv_epilogue with silu) and the squeeze-excite kernels (se_gate.cu:
   se_squeeze, se_excite) at every site of one efficientnet-b4-unet batch
   of 128 tiles and at SE_EDGES against their plain versions (bf16 within
   one ulp, the squeeze's mean within SQUEEZE_REL_TOL of its largest value
   and the same bits from a second call; every other
   conv_epilogue site bit for bit), each timed beside its bound, plain
   version and library call; the depthwise convs' share of that batch;
   efficientnet-b4-unet on the 4096² zone (argmax and class_prob) and
   efficientnet-b0 under deeplabv3plus and pspnet through detect_main,
   each against its all-plain run by phase 5's rule, with launches and
   patches/s; flair predict and metrics of b4-unet from a .msgpack (the
   PRED classes against the all-plain run of the first batch).
8b. EfficientNet, training: flair (train, predict, metrics) of
   efficientnet-b4-unet at phase 4's values (512², batch 16, one epoch of 4
   steps on phase 4's set) from phase 8's .msgpack, its launches against
   steps x sites (the SiLU, affine and channel-tiled bn_train modes,
   se_backward, conv_epilogue's drop-connect mode counted apart), the
   artifacts, the trained gate biases and running statistics float32 in the
   checkpoint and in a .msgpack written after a predict, warm train and
   predict rates; one step by CUDA events (the forward, the depthwise convs'
   forward and backward, the host's issue time) and the profiler's kernel
   groups; the new kernel modes at every site of one step against their
   plain versions (TrainKernelTimer: dy within BN_DY_TOL, the gate's
   gradient within GATE_GRAD_TOL, the drop-connect bit for bit) and timed
   beside their bounds, plain versions and library calls; one step held site
   by site and free-running against the plain step on injected dropout
   masks (a sample dropped); the channel-tiled statistics, SiLU and affine
   backward and gate gradient at every site above 2048 channels of
   WIDE_ENCODERS at batch 2; one efficientnet-b0-deeplabv3plus step held the
   same way, from random weights after EFFNET_WARM_STEPS train steps.
9. the kernels line, the card line, the script's seconds, and last the JSON
   result line.

    python3 chip_smoke.py --profile  # also one batch per program by stage, the profiler
                                     # table, the same for one flair train step with
                                     # and without metadata, and the metadata MLP's
                                     # and fusion's call and device ms
    python3 chip_smoke.py --step-study pan [--orders 10] [--study-seed S]
        # only the sample-order study of one arch's phase-4d step check
        # (step_order_study): its flair run on the set written from seed S,
        # then the kernels' and the plain step in each order, judged by the
        # check's own rule; one JSON line, no result line
    python3 chip_smoke.py --effnet-train
        # only phase 8b, on its own written set (phase 4's) and .msgpack
        # (phase 8's); one JSON line, no result line
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import itertools
import re
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

from flairtpu_torch import cli, tools
from flairtpu_torch.config import gen_param_combination, validate_detect_config
from flairtpu_torch.data.manifest import gather_paths
from flairtpu_torch.data.patches import PatchDataset, PatchLoader
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models.deeplab import align_corners_weights
from flairtpu_torch.models import efficientnet as en
from flairtpu_torch.models.convert import load_weights, write_native
from flairtpu_torch.models.factory import FlairSegmentationModel, create_model, init_weights
from flairtpu_torch.models.resnet import stem_conv
from flairtpu_torch.models.unet import plan_inner_crops
from flairtpu_torch.predict.runner import predict
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import augment as au
from flairtpu_torch.ops import bn_train as bt
from flairtpu_torch.ops.bn_train_phases import device_ms
# FPN's seven Conv3x3GNReLU sites at 512 tiles: (label, input side, upsample)
from flairtpu_torch.ops.group_norm_phases import SITES as GN_SITES
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
from flairtpu_torch.ops.fused import write_windows
from flairtpu_torch.ops import gather as ga
from flairtpu_torch.ops import group_norm as gnr
from flairtpu_torch.ops import strided_tail as sp
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops import quantize_act as qa
from flairtpu_torch.ops import se_gate as sg
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
    # the dilated encoders of phase 5b (deeplabv3's output stride 8): layer4's
    # 3x3 at dilation 4, padding 4, and layer3's 1x1 stride-1 downsample
    ("dilation 4, padding 4, Cp 512 (output stride 8, layer4)", 2, 64, 64, 512, 512, 3, 1, 4,
     4, True, True),
    ("1x1/1 downsample 256 -> 512 (a dilated stage)", 2, 64, 64, 256, 512, 1, 1, 0, 1, False,
     False),
)
# the grouped int8_conv (int8_conv_grouped): resnext50_32x4d's 16 grouped
# 3x3 sites (layer1-4: 32 groups of 4, 8, 16 and 32 channels), and at
# geometries its U-Net walk does not reach: (label, B, H, W, groups,
# channels a group, stride, pad, dilation, residual, ReLU), each with both
# outputs
RESNEXT = "resnext50_32x4d"
RESNEXT_GROUPED_SITES = 16
GROUPED_EDGES = (
    ("dilation 2, 32 a group (output stride 16, layer4)", 2, 32, 32, 32, 32, 1, 2, 2, False,
     True),
    ("dilation 2, 16 a group (output stride 8, layer3)", 2, 64, 64, 32, 16, 1, 2, 2, False, True),
    ("dilation 4, 32 a group (output stride 8, layer4)", 2, 64, 64, 32, 32, 1, 4, 4, True, True),
    ("Wo 13 (not a multiple of the 16-pixel tile), batch 1", 1, 13, 13, 32, 4, 1, 1, 1, True,
     True),
    ("stride 2, odd sides, residual without ReLU", 3, 33, 31, 32, 8, 2, 1, 1, True, False),
    ("48 a group (resnext101_32x48d's layer1)", 1, 32, 32, 32, 48, 1, 1, 1, False, True),
    ("4 a group at stride 2, odd sides", 2, 31, 29, 32, 4, 2, 1, 1, False, True),
    ("80 channels: a slab of 128 part empty, stride 2", 2, 15, 17, 20, 4, 2, 1, 1, True, True),
    ("32 a group at stride 2 from odd sides, Wo 9", 2, 17, 17, 32, 32, 2, 1, 1, False, True),
    ("16 a group, 96 channels, Wo 40 (three tiles)", 1, 21, 40, 6, 16, 1, 1, 1, True, False),
    ("64 a group (resnext101_32x8d's layer4)", 1, 16, 16, 8, 64, 1, 1, 1, False, True),
)
# edges at a launch other than grouped_plan's: (label, B, H, W, groups,
# channels a group, stride, band, depth, rows a step): bands that end
# short and mid-step, one-row bands, the deepest and the shallowest copy
# ring
GROUPED_PLAN_EDGES = (
    ("bands of 5 rows over 13, depth 1, 4 rows a step", 2, 13, 21, 32, 4, 1, 5, 1, 4),
    ("bands of 3 rows over 16, depth 8, stride 2, 2 rows a step", 2, 32, 32, 32, 8, 2, 3, 8,
     2),
    ("one-row bands, depth 8, 4 rows a step", 1, 16, 24, 32, 16, 1, 1, 8, 4),
    ("bands of 7 rows over 16 (cg 32), depth 2, 3 rows a step", 2, 16, 16, 32, 32, 1, 7, 2,
     3),
    ("bands of 6 rows over 32 (cg 16, stride 2), 1 row a step", 2, 63, 33, 32, 16, 2, 6, 3, 1),
)
# int8_conv_grouped's call time by geometry in PR 20 (commit 2e6c683's dp4a
# kernel, chip_smoke call 10, H100 80GB HBM3 at 700 W), keyed by (input
# channels, stride), batch 128, 512 tiles
GROUPED_BEFORE_MS = {(128, 1): 1.0291, (256, 2): 0.6949, (256, 1): 0.5186, (512, 2): 0.4347,
                     (512, 1): 0.3717, (1024, 2): 0.3574, (1024, 1): 0.3243}
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


def compare_tail(name: str, cls_k, prob_k, cls_p, prob_p, gap, gap_tol: float = GAP_TOL) -> dict:
    """Kernel vs plain class and prob (any matching shapes), with the plain
    logits' top-2 gap at each pixel."""
    off = cls_k != cls_p
    agree = 1.0 - off.float().mean().item()
    worst_gap = gap[off].max().item() if off.any() else 0.0
    dprob = (prob_k.int() - prob_p.int()).abs().max().item()
    check(agree >= 0.999, f"{name}: class agreement {agree:.6f} >= 0.999")
    check(worst_gap < gap_tol, f"{name}: {int(off.sum())} class mismatches, largest "
          f"top-2 gap there {worst_gap:.2e} < {gap_tol}")
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


# -- slice 5's kernels (phase 2) ---------------------------------------------

# strided_tail vs its plain version on the same head logits: the same taps
# and weights, the kernel's two products a pass summed without FMA against
# cuBLAS's float32 dot products over the dense matrix rows (TF32 off), so
# the logits differ by about an ulp: within STRIDED_TOL of the largest
# |logit|; a class may differ only where the plain top-2 gap is below
# STRIDED_GAP; prob and probs within 1
STRIDED_TOL = 1e-6
STRIDED_GAP = 1e-5
# the head logits of the archs at the main path's shapes (512 tiles,
# batch 128, 19 classes): (archs, upsample)
STRIDED_CASES = (("deeplabv3plus, fpn, pan", 4), ("deeplabv3, pspnet", 8), ("linknet", 1))
# the odd cases: (tile, margin, upsample, classes, batch); then window rows
# not a multiple of a band (140 at U = 4), K = 1 and FLAIR's 13 classes at
# U = 4 and 8, and a 256-pixel tile with a 64 margin at U = 8
STRIDED_EDGES = ((64, 16, 4, 4, 3), (64, 8, 8, 32, 2), (96, 20, 1, 32, 2), (48, 0, 4, 7, 2),
                 (200, 30, 4, 19, 2), (64, 16, 4, 1, 2), (64, 8, 8, 1, 2), (64, 16, 4, 13, 2),
                 (64, 8, 8, 13, 2), (256, 64, 8, 19, 2))
# the one-thread-a-pixel kernel of fe34f71 at the main-path shapes (PERF.md
# §6's "was" times: chip_smoke, H100 80GB HBM3 at 700 W), printed beside
# this run's
STRIDED_BEFORE_MS = {4: {"argmax": 0.3317, "probs": 0.4700, "logits": 1.6079},
                   8: {"argmax": 0.3048, "probs": 0.4424, "logits": 1.2700},
                   1: {"argmax": 0.2961, "probs": 0.3803, "logits": 1.9344}}
# the stem conv (resnet, 7 x 7 / 2, 5 -> 64 channels) in its two forms, s2d_stem
# false and true: cuDNN sums the same bf16 products in float32 in other orders,
# then rounds to bf16, so the two may differ by a bf16 ulp of an output:
# within STEM_TOL (two ulps) of the largest |output|
STEM_TOL = 2.0 ** -6
# group_norm_relu vs its plain version: float32 sums of up to 65536 values
# a group in other orders, then the same per-element arithmetic: within
# GN_TOL of the largest output
GN_TOL = 1e-5


def head_logits(gen, batch: int, n: int, k: int) -> torch.Tensor:
    return torch.randn((batch, n, n, k), generator=gen, device="cuda") * 2.0


def check_strided_tail(gen, label: str, size: int, margin: int, up: int, k: int, batch: int,
                       timed: bool = False) -> dict:
    """The three modes into whole-tile windows against the plain version:
    argmax at ``margin`` (class and prob), probs at ``margin`` (bytes within
    1) and logits at margin 0 (within STRIDED_TOL of the largest |logit|)."""
    g, g0 = sp.strided_geometry(size, margin, up), sp.strided_geometry(size, 0, up)
    p = sp.StridedTail(up, k, torch.device("cuda"))
    x = head_logits(gen, batch, size // up, k)
    s = g.out_extent
    name = f"strided_tail {label}: {size}/{margin}, U={up}, B={batch}, K={k}"
    cls_k, prob_k = sp.strided_tail(x, p, g)
    cls_p, prob_p = sp.strided_tail_plain(x, p, g)
    out = compare_tail(f"{name}, argmax", cls_k, prob_k, cls_p, prob_p,
                       top2_gap_last(sp.upsample_window(x, g)), STRIDED_GAP)
    win = ft.full_windows(batch, s, x.device)
    got = torch.zeros((batch * s, s, k), dtype=torch.uint8, device="cuda")
    want = torch.zeros_like(got)
    sp.strided_tail_probs(x, p, g, got, win)
    sp.strided_tail_probs_plain(x, p, g, want, win)
    d = (got.int() - want.int()).abs().max().item()
    check(d <= 1, f"{name}, probs: |diff| {d} <= 1, "
          f"{(got != want).float().mean().item():.2e} of bytes differ")
    del got, want
    logits = sp.strided_tail_logits(x, p, g0)
    scale = x.abs().max().item()
    err = (logits - sp.strided_tail_logits_plain(x, p, g0)).abs().max().item()
    torch.cuda.synchronize()
    check(err <= STRIDED_TOL * scale, f"{name}, logits at margin 0: largest |diff| {err:.2e} "
          f"<= {STRIDED_TOL} x {scale:.2f}")
    out.update(max_abs_err=max(out["max_abs_err"], d), logits_err=err)
    if timed:
        cls_plane = torch.empty((2, batch * s, s), dtype=torch.uint8, device="cuda")
        probs_plane = torch.empty((batch * s, s, k), dtype=torch.uint8, device="cuda")
        full = ft.full_windows(batch, size, x.device)
        wins = {m: (win if m != "logits" else full).cpu().numpy() for m in
                ("argmax", "probs", "logits")}
        calls = {
            "argmax": (lambda: sp.strided_tail(x, p, g, cls_plane, win),
                       lambda: sp.strided_tail_plain(x, p, g, cls_plane, win)),
            "probs": (lambda: sp.strided_tail_probs(x, p, g, probs_plane, win),
                      lambda: sp.strided_tail_probs_plain(x, p, g, probs_plane, win)),
            "logits": (lambda: sp.strided_tail_logits(x, p, g0, logits),
                       lambda: sp.strided_tail_logits_plain(x, p, g0, logits))}
        # one PyTorch call computes the logits mode's function: the whole-tile
        # align-corners upsample of the channels_last logits (NHWC bytes out);
        # none the argmax or probs mode's
        nchw = x.permute(0, 3, 1, 2)
        library = {"logits": lambda: F.interpolate(nchw, size=(size, size), mode="bilinear",
                                                   align_corners=True)}
        modes = {}
        for mode, (kern, plain) in calls.items():
            ops, nbytes = sp.strided_cost(g if mode != "logits" else g0, wins[mode], k,
                                          mode)
            lib = library.get(mode)
            modes[mode] = dict(mode=mode, ms=cuda_ms(kern, 10, 2),
                               plain_ms=cuda_ms(plain, 3, 1),
                               library_ms=cuda_ms(lib, 10, 2) if lib else None,
                               bytes=nbytes, **bound(ops, nbytes, PEAK_FP32_FLOPS))
        out["modes"] = modes
    return out


def check_strided_planes(gen, height: int, width: int, batch: int, up: int) -> dict:
    """Argmax and probs through the owned windows of a zone with realigned
    tiles, batch by batch, against plain tiles written in tile order."""
    g = sp.strided_geometry(S, M, up)
    s = g.out_extent
    p = sp.StridedTail(up, K, torch.device("cuda"))
    tiles = slice_grid(width, height, S, M).tiles
    n = len(tiles)
    n_total = n + (-n) % batch
    x = head_logits(gen, n, S // up, K)
    x = torch.cat([x, x[-1:].expand(n_total - n, -1, -1, -1)]).contiguous()
    windows = torch.from_numpy(exact_windows(tiles, height, width, s, n_total)).to("cuda")
    Ho, Wo = max(height, s), max(width, s)
    planes = torch.zeros((2, Ho, Wo), dtype=torch.uint8, device="cuda")
    plane = torch.zeros((Ho, Wo, K), dtype=torch.uint8, device="cuda")
    for b0 in range(0, n_total, batch):
        sp.strided_tail(x[b0:b0 + batch], p, g, planes, windows[b0:b0 + batch])
        sp.strided_tail_probs(x[b0:b0 + batch], p, g, plane, windows[b0:b0 + batch])
    cls_p, prob_p = sp.strided_tail_plain(x[:n], p, g)
    gap_p = top2_gap_last(sp.upsample_window(x[:n], g))
    probs_p = torch.zeros((n * s, s, K), dtype=torch.uint8, device="cuda")
    sp.strided_tail_probs_plain(x[:n], p, g, probs_p, ft.full_windows(n, s, x.device))
    ref = torch.zeros((3, Ho, Wo), dtype=torch.float32, device="cuda")
    ref_probs = torch.zeros_like(plane)
    for i, t in enumerate(tiles):  # the reference's tile-order writes, last wins
        r0, c0 = min(t.irow0, Ho - s), min(t.icol0, Wo - s)
        ref[:, r0:r0 + s, c0:c0 + s] = torch.stack([cls_p[i].float(), prob_p[i].float(),
                                                    gap_p[i]])
        ref_probs[r0:r0 + s, c0:c0 + s] = probs_p[i * s:(i + 1) * s]
    torch.cuda.synchronize()
    out = compare_tail(f"strided_tail into planes, {height}x{width} zone, {n} tiles, U={up}, "
                       f"B={batch}", planes[0], planes[1], ref[0].to(torch.uint8),
                       ref[1].to(torch.uint8), ref[2], STRIDED_GAP)
    d = (plane.int() - ref_probs.int()).abs().max().item()
    check(d <= 1, f"strided_tail probs into the plane, {height}x{width} zone: |diff| {d} <= 1")
    return out


def check_strided_kernels(gen) -> dict:
    """strided_tail at the archs' main-path shapes (timed) and the odd cases."""
    cases = {}
    for label, up in STRIDED_CASES:
        cases[label] = check_strided_tail(gen, label, S, M, up, K, BATCH, timed=True)
        torch.cuda.empty_cache()
    worst = max(r["max_abs_err"] for r in cases.values())
    for size, margin, up, k, batch in STRIDED_EDGES:
        worst = max(worst, check_strided_tail(gen, "edge", size, margin, up, k,
                                              batch)["max_abs_err"])
    for up in (4, 8, 1):
        worst = max(worst, check_strided_planes(gen, 1000, 1100, 8, up)["max_abs_err"])
    return {"cases": cases, "max_abs_err": worst,
            "logits_err": max(r["logits_err"] for r in cases.values())}


def check_stems(gen) -> dict:
    """The stem conv at the main path's shape (batch 128, 512², bf16
    channels_last, random weights): the direct 7 x 7 / 2 conv against its
    space-to-depth form (``models/resnet.py:stem_conv``, the repacks
    included), each timed."""
    conv1 = nn.Conv2d(C, 64, 7, 2, 3, bias=False).to("cuda", torch.bfloat16)
    conv1.weight.data = (torch.randn(conv1.weight.shape, generator=gen, device="cuda")
                         * (2.0 / (C * 49)) ** 0.5).to(torch.bfloat16)
    x = torch.rand((BATCH, S, S, C), generator=gen, device="cuda").to(torch.bfloat16)
    x = x.permute(0, 3, 1, 2)  # an NCHW view of NHWC memory, as the encoder takes it
    direct = stem_conv(x, conv1, torch.bfloat16, False)
    s2d = stem_conv(x, conv1, torch.bfloat16, True)
    scale = direct.abs().max().item()
    err = (direct.float() - s2d.float()).abs().max().item()
    check(err <= STEM_TOL * scale, f"stem conv, space-to-depth vs direct (batch {BATCH}): "
          f"largest |diff| {err:.3e} <= {STEM_TOL} x {scale:.3f}")
    del direct, s2d
    return {"direct_ms": cuda_ms(lambda: stem_conv(x, conv1, torch.bfloat16, False), 10, 2),
            "s2d_ms": cuda_ms(lambda: stem_conv(x, conv1, torch.bfloat16, True), 10, 2),
            "max_abs_err": err}


def check_group_norm(gen) -> dict:
    """group_norm_relu at FPN's seven site shapes at batch 128 (bf16
    channels_last conv outputs, random GroupNorm affines): within GN_TOL of
    the plain version, two calls bit-identical; timed beside its plain
    version and F.group_norm (GroupNorm alone, bf16, not the same function)."""
    rows, worst = [], 0.0
    for label, side, up in GN_SITES:
        y = (torch.randn((BATCH, side, side, 128), generator=gen, device="cuda") * 1.5 + 0.3)
        y = y.to(torch.bfloat16).permute(0, 3, 1, 2)
        gamma = torch.rand(128, generator=gen, device="cuda") + 0.5
        beta = torch.randn(128, generator=gen, device="cuda") * 0.2
        got = gnr.group_norm_relu(y, gamma, beta, upsample=up)
        again = gnr.group_norm_relu(y, gamma, beta, upsample=up)
        want = gnr.group_norm_relu_plain(y, gamma, beta, upsample=up)
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        torch.cuda.synchronize()
        name = f"group_norm_relu {label}: (128, 128, {side}, {side}){', 2x up' if up else ''}"
        check(err <= GN_TOL * scale, f"{name}: largest |diff| {err:.2e} <= {GN_TOL} x {scale:.2f}")
        check(torch.equal(got, again), f"{name}: two calls bit-identical")
        worst = max(worst, err)
        n_in, n_out = y.numel(), got.numel()
        nbytes = 2 * n_in + 4 * n_out + 2 * 4 * 128
        ops = 3 * n_in + 4 * n_in  # statistics (add, square, add), apply (sub, mul, add, max)
        g16, b16 = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
        rows.append(dict(site=label, ms=cuda_ms(lambda: gnr.group_norm_relu(y, gamma, beta,
                                                                             upsample=up), 10, 2),
                         plain_ms=cuda_ms(lambda: gnr.group_norm_relu_plain(
                             y, gamma, beta, upsample=up), 3, 1),
                         library_ms=cuda_ms(lambda: F.group_norm(y, 32, g16, b16, 1e-5), 10, 2),
                         bytes=nbytes, **bound(ops, nbytes, PEAK_FP32_FLOPS)))
        del y, got, again, want
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bytes")}
    return dict(total, sites=rows, max_abs_err=worst,
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations")


# group_norm_relu's backward vs its plain version: dy in bf16 (two ulps of
# the largest |dy|, as bn_train's), dgamma and dbeta float32 sums over up to
# 262144 values in other orders (of 1 + the largest |value|)
GN_DY_TOL = 2.0 ** -6
GN_GRAD_TOL = 1e-4
# the backward's device ms at FPN's sites before its one-launch design: the
# three-launch kernel of commit 0510a73 (group_norm_phases --baseline, one
# H100 80GB HBM3 at 700 W)
GN_BACKWARD_BEFORE_MS = {"seg0_c0 (p5)": 0.0367, "seg0_c1": 0.0953, "seg0_c2": 0.1453,
                         "seg1_c0 (p4)": 0.0961, "seg1_c1": 0.1451, "seg2_c0 (p3)": 0.1464,
                         "seg3_c0 (p2)": 0.1889}
# the backward at the edges of its plan: (label, batch, side, width,
# channels, groups, upsample)
GN_EDGES = (("batch 1", 1, 64, 64, 128, 32, True),
            ("an item's last pass ragged (37 x 29 pixels)", 2, 37, 29, 128, 32, True),
            ("the re-read route, ragged (45 x 45 pixels)", 3, 45, 45, 128, 32, False),
            ("256 channels", 2, 32, 32, 256, 32, True),
            ("16 groups", 2, 48, 48, 128, 16, False),
            ("8 channels, one group", 2, 20, 20, 8, 1, True),
            ("512 channels (two warps a pixel)", 2, 12, 12, 512, 32, True),
            ("2048 channels", 1, 8, 8, 2048, 32, False))
# PAN's 1-channel BatchNorm sites at the train batch (512 tiles, the FPA on
# the stride-16 map): (label, map side)
PAN_NARROW_SITES = (("fpa.down1", 16), ("fpa.down2", 8), ("fpa.down3.1", 4),
                    ("fpa.down3.2", 4), ("fpa.conv2", 8), ("fpa.conv1", 16))


def gn_backward_cost(y: torch.Tensor, up: bool) -> tuple[int, int]:
    """(operations, bytes) of one group_norm_relu backward: y and the
    gradient read once, dy written once, the statistics and affines."""
    n = y.numel()
    B, C = y.shape[:2]
    u2 = 4 if up else 1
    nbytes = 2 * n + 4 * u2 * n + 2 * n + 2 * 4 * B * 32 + 4 * 4 * C
    return (u2 - 1) * n + 14 * n, nbytes


def gn_library_backward(y, g, mean, rstd, gamma):
    """aten's native_group_norm_backward on the site's bf16 map and the
    bf16 gradient (GroupNorm alone: no ReLU, no upsample; not the same
    function), or the error PyTorch raised."""
    B, C, H, W = y.shape
    yc = y.contiguous()
    gc = g[:, :, :H, :W].to(torch.bfloat16).contiguous()
    m, r = mean.to(torch.bfloat16), rstd.to(torch.bfloat16)
    g16 = gamma.to(torch.bfloat16)

    def run():
        torch.ops.aten.native_group_norm_backward(gc, yc, m, r, g16, B, C, H * W, 32,
                                                  [True, True, True])

    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return run


def gn_backward_operands(gen, batch: int, side: int, channels: int, up: bool,
                         width: int | None = None) -> tuple:
    """(y, gamma, beta, g) of one group_norm_relu site: y a bf16 channels_last
    (batch, channels, side, width) map, g its float32 gradient at 2x where
    ``up``."""
    width = width or side
    y = (torch.randn((batch, side, width, channels), generator=gen, device="cuda") * 1.5
         + 0.3).to(torch.bfloat16).permute(0, 3, 1, 2)
    gamma = torch.rand(channels, generator=gen, device="cuda") + 0.5
    beta = torch.randn(channels, generator=gen, device="cuda") * 0.2
    u = 2 if up else 1
    g = torch.randn((batch, u * side, u * width, channels), generator=gen,
                    device="cuda").permute(0, 3, 1, 2)
    return y, gamma, beta, g


def hold_gn_backward(name: str, y, gamma, beta, g, groups: int, up: bool) -> tuple:
    """The train-mode forward's saved statistics, then the backward against
    its plain version (dy within GN_DY_TOL of the largest, dgamma and dbeta
    within GN_GRAD_TOL) and two calls bit-identical, each launching once.
    Returns (worst error, the statistics, the plan)."""
    out, mean, rstd = gnr.group_norm_relu(y, gamma, beta, groups, upsample=up, stats=True)
    _, mean_p, rstd_p = gnr.group_norm_relu_plain(y, gamma, beta, groups, upsample=up,
                                                  stats=True)
    stat_err = max(vec_err(mean, mean_p), vec_err(rstd, rstd_p))
    before = gnr.backward_launches
    got = gnr.group_norm_relu_backward(g, y, mean, rstd, gamma, beta, groups, upsample=up)
    again = gnr.group_norm_relu_backward(g, y, mean, rstd, gamma, beta, groups, upsample=up)
    want = gnr.group_norm_relu_backward_plain(g, y, mean, rstd, gamma, beta, groups,
                                              upsample=up)
    torch.cuda.synchronize()
    dy_err = scaled_err(got[0], want[0])
    grad_err = max(vec_err(got[1], want[1]), vec_err(got[2], want[2]))
    B, C, H, W = y.shape
    plan = gnr.launch_plan(B, H, W, C, groups, up, gnr.device_limits(y.device))
    route = (f"{'on chip' if plan.on_chip else 're-read'}, {plan.part} px an item, "
             f"{plan.slots} of {B} samples in flight, grid {plan.grid}")
    check(stat_err <= BN_STAT_TOL, f"{name}: saved mean and rstd within {stat_err:.1e} <= "
          f"{BN_STAT_TOL} of the plain forward's")
    check(dy_err <= GN_DY_TOL and grad_err <= GN_GRAD_TOL,
          f"{name} ({route}): dy within {dy_err:.1e} <= {GN_DY_TOL:.1e} of the largest, dgamma "
          f"and dbeta within {grad_err:.1e} <= {GN_GRAD_TOL}")
    check(all(torch.equal(a, b) for a, b in zip(got, again))
          and gnr.backward_launches - before == 2,
          f"{name}: two calls bit-identical, one launch each")
    return max(dy_err, grad_err), (mean, rstd), plan


def gn_on_chip_edge(limits) -> int:
    """The largest side of a square upsampling map (128 channels, 32 groups)
    whose sample fits the on-chip route: the next side takes the re-read
    route."""
    side = 16
    while gnr.launch_plan(2, side + 1, side + 1, 128, 32, True, limits).on_chip:
        side += 1
    return side


def check_group_norm_backward(gen) -> dict:
    """group_norm_relu's train-mode forward (its saved statistics) and its
    backward at FPN's seven site shapes at the train batch (16), then at the
    edges of its plan (GN_EDGES and the on-chip route's largest sample and
    the next): dy within GN_DY_TOL of the largest, dgamma and dbeta within
    GN_GRAD_TOL, two calls bit-identical and one launch each; FPN's sites
    timed by device time (device_ms) and call time (cuda_ms) beside the
    earlier three-launch kernel's (GN_BACKWARD_BEFORE_MS), the plain
    version and aten's native_group_norm_backward."""
    rows, worst = [], 0.0
    library_error = None
    for label, side, up in GN_SITES:
        y, gamma, beta, g = gn_backward_operands(gen, TRAIN_BATCH, side, 128, up)
        name = (f"group_norm_relu backward {label}: ({TRAIN_BATCH}, 128, {side}, {side})"
                f"{', 2x up' if up else ''}")
        err, (mean, rstd), plan = hold_gn_backward(name, y, gamma, beta, g, 32, up)
        worst = max(worst, err)
        ops, nbytes = gn_backward_cost(y, up)
        lib = gn_library_backward(y, g, mean, rstd, gamma)
        if isinstance(lib, str):
            library_error = lib

        def run():
            gnr.group_norm_relu_backward(g, y, mean, rstd, gamma, beta, upsample=up)

        rows.append(dict(
            site=label, ms=device_ms(run), call_ms=cuda_ms(run, 10, 2),
            before_ms=GN_BACKWARD_BEFORE_MS[label],
            plain_ms=cuda_ms(lambda: gnr.group_norm_relu_backward_plain(
                g, y, mean, rstd, gamma, beta, upsample=up), 3, 1),
            library_ms=None if isinstance(lib, str) else device_ms(lib),
            route="on_chip" if plan.on_chip else "reread", grid=plan.grid,
            blocks_per_sm=plan.blocks_per_sm, hbm_bytes=plan.hbm_bytes,
            bytes=nbytes, **bound(ops, nbytes, PEAK_FP32_FLOPS)))
        del y, g, lib
        torch.cuda.empty_cache()
    edge = gn_on_chip_edge(gnr.device_limits(torch.device("cuda")))
    for label, batch, side, width, channels, groups, up in GN_EDGES + (
            ("the on-chip route's largest sample", 2, edge, edge, 128, 32, True),
            ("one side more: the re-read route", 2, edge + 1, edge + 1, 128, 32, True)):
        y, gamma, beta, g = gn_backward_operands(gen, batch, side, channels, up, width)
        name = (f"group_norm_relu backward, {label}: ({batch}, {channels}, {side}, {width}), "
                f"{groups} groups{', 2x up' if up else ''}")
        worst = max(worst, hold_gn_backward(name, y, gamma, beta, g, groups, up)[0])
        del y, g
    torch.cuda.empty_cache()
    libs = [r["library_ms"] for r in rows]
    total = {k: sum(r[k] for r in rows) for k in ("ms", "call_ms", "before_ms", "plain_ms",
                                                  "bound_ms", "bytes", "hbm_bytes")}
    return dict(total, sites=rows, max_abs_err=worst, library_error=library_error,
                library_ms=None if None in libs else sum(libs),
                bound_by="bytes" if all(r["bound_by"] == "bytes" for r in rows)
                else "operations")


def bn_narrow_library_backward(g32, out, y, mean, invstd, gamma):
    """aten's native_batch_norm_backward on the ReLU-masked gradient in bf16
    at a narrow site; a function to time, or the error PyTorch raised."""
    gm = (g32 * (out > 0)).to(torch.bfloat16)

    def run():
        torch.ops.aten.native_batch_norm_backward(gm, y, gamma, None, None, mean, invstd, True,
                                                  bt.EPS, [True, True, True])

    try:
        run()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError) as e:
        return f"{type(e).__name__}: {str(e).splitlines()[0]}"
    return run


def launch_floors() -> dict:
    """The card's floor for one launch, by device time (device_ms): an empty
    kernel, and a kernel of one block that reduces 256 values as the narrow
    entry points do (bn_train_launch_floor)."""
    fn = _build.entry("bn_train", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p], "bn_train_launch_floor")
    src = torch.rand(256, device="cuda")
    dst = torch.empty(1, device="cuda")
    stream = _build.stream_handle(src)

    def launch(mode: int):
        _build.check(fn(mode, src.data_ptr(), dst.data_ptr(), stream), "bn_train_launch_floor")

    launch(1)
    torch.cuda.synchronize()
    want = src.double().sum().float()
    check(abs(dst.item() - want.item()) <= 1e-6 * (1 + abs(want.item())),
          f"launch floor: the one-block reduction gives {dst.item():.6f} for {want.item():.6f}")
    return {"empty_ms": device_ms(lambda: launch(0)), "reduce_ms": device_ms(lambda: launch(1))}


def check_bn_narrow(gen) -> dict:
    """bn_train's narrow entry points at PAN's six 1-channel sites at the
    train batch: the statistics alone (bn_stats) and with the site's output
    (bn_stats_apply, ReLU and the float32 copy as PAN's sites take them;
    also without either), the statistics (running ones too) within
    BN_STAT_TOL, the output bit for bit, of the plain versions; the
    backward's dy within BN_DY_TOL of the largest, dgamma and dbeta within
    BN_STAT_TOL; two calls bit-identical, one launch each and no
    conv_epilogue launch; timed (device ms) beside the plain versions,
    torch.var_mean(correction=0) and aten's native_batch_norm_backward, and
    the card's launch floors."""
    rows, worst = [], 0.0
    library_error = None
    for label, side in PAN_NARROW_SITES:
        y = torch.randn((TRAIN_BATCH, 1, side, side), generator=gen, device="cuda").to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        gamma, beta = torch.rand(1, generator=gen, device="cuda") + 0.5, torch.zeros(1,
                                                                                    device="cuda")

        def fresh():
            return torch.zeros(1, device="cuda"), torch.ones(1, device="cuda")

        launches = (bt.narrow_launches, ep.launches)
        runs = []
        for _ in range(2):
            rm, rv = fresh()
            runs.append(bt.bn_stats(y, gamma, beta, rm, rv) + (rm, rv))
        rmp, rvp = fresh()
        want = bt.bn_stats_plain(y, gamma, beta, rmp, rvp) + (rmp, rvp)
        stat_err = max(vec_err(a, b) for a, b in zip(runs[0], want))
        out_same = True
        for relu, keep_f32 in ((True, True), (False, False)):
            fused = []
            for _ in range(2):
                rm, rv = fresh()
                fused.append(bt.bn_stats_apply(y, gamma, beta, rm, rv, relu, keep_f32)
                             + (rm, rv))
            rmp, rvp = fresh()
            wantf = bt.bn_stats_apply_plain(y, gamma, beta, rmp, rvp, relu, keep_f32) + (rmp,
                                                                                       rvp)
            stat_err = max(stat_err, *(vec_err(fused[0][i], wantf[i]) for i in (0, 1, 2, 3, 6, 7)))
            # the output from the kernel's own scale and shift, by the plain epilogue
            out_p = ep.conv_epilogue_plain(y, fused[0][2], fused[0][3], relu=relu,
                                           keep_f32=keep_f32)
            out_same &= torch.equal(fused[0][4], out_p[0]) and (
                not keep_f32 or torch.equal(fused[0][5], out_p[1]))
            out_same &= all(a is b or torch.equal(a, b) for a, b in zip(*fused))
        n_calls = (bt.narrow_launches - launches[0], ep.launches - launches[1])
        mean, invstd, scale, shift = want[:4]
        out = ep.conv_epilogue_plain(y, scale, shift)[0]
        g32 = torch.randn(y.shape, generator=gen, device="cuda").contiguous(
            memory_format=torch.channels_last)
        args = (None, g32, out, y, mean, invstd, gamma)
        before = bt.narrow_backward_launches
        got = [bt.bn_backward(*args) for _ in range(2)]
        wantb = bt.bn_backward_plain(*args)
        torch.cuda.synchronize()
        dy_err = scaled_err(got[0][0], wantb[0])
        grad_err = max(vec_err(got[0][1], wantb[1]), vec_err(got[0][2], wantb[2]))
        name = f"bn_train narrow {label}: ({TRAIN_BATCH}, 1, {side}, {side})"
        check(stat_err <= BN_STAT_TOL and dy_err <= BN_DY_TOL and grad_err <= BN_STAT_TOL,
              f"{name}: statistics within {stat_err:.1e}, dy {dy_err:.1e} of the largest, "
              f"dgamma and dbeta {grad_err:.1e} (limits {BN_STAT_TOL}, {BN_DY_TOL:.1e})")
        check(out_same, f"{name}: the fused forward's output (ReLU and float32 copy, and "
              "neither) bit for bit conv_epilogue's arithmetic from its scale and shift")
        check(all(torch.equal(a, b) for a, b in zip(*runs)) and
              all(torch.equal(a, b) for a, b in zip(got[0][:3], got[1][:3])),
              f"{name}: two calls of each entry point bit-identical")
        check(n_calls == (6, 0) and bt.narrow_backward_launches - before == 2,
              f"{name}: one launch a call each way ({n_calls[0]} forward for 6 calls, "
              f"{bt.narrow_backward_launches - before} backward for 2), {n_calls[1]} "
              "conv_epilogue")
        worst = max(worst, stat_err, dy_err, grad_err)
        lib = bn_narrow_library_backward(g32, out, y, mean, invstd, gamma)
        if isinstance(lib, str):
            library_error = lib
        n = y.numel()
        rows.append({
            "site": label,
            "stats_ms": device_ms(lambda: bt.bn_stats_apply(y, gamma, beta, rmp, rvp, True, True)),
            "stats_plain_ms": cuda_ms(lambda: bt.bn_stats_apply_plain(
                y, gamma, beta, rmp, rvp, True, True), 3, 1),
            "stats_library_ms": device_ms(lambda: torch.var_mean(y, dim=(0, 2, 3),
                                                                 correction=0)),
            "stats_bound": bound(5 * n, 2 * n + 2 * n + 4 * n + 4 * 8, PEAK_FP32_FLOPS),
            "backward_ms": device_ms(lambda: bt.bn_backward(*args)),
            "backward_plain_ms": cuda_ms(lambda: bt.bn_backward_plain(*args), 3, 1),
            "backward_library_ms": None if isinstance(lib, str) else device_ms(lib),
            "backward_bound": bound(12 * n, 4 * n + 2 * n + 2 * n + 2 * n, PEAK_FP32_FLOPS)})
    out = {"sites": rows, "max_abs_err": worst, "library_error": library_error,
           "floors": launch_floors()}
    for mode in ("stats", "backward"):
        libs = [r[f"{mode}_library_ms"] for r in rows]
        out[mode] = {"ms": sum(r[f"{mode}_ms"] for r in rows),
                     "plain_ms": sum(r[f"{mode}_plain_ms"] for r in rows),
                     "bound_ms": sum(r[f"{mode}_bound"]["bound_ms"] for r in rows),
                     "bound_by": "bytes" if all(r[f"{mode}_bound"]["bound_by"] == "bytes"
                                                for r in rows) else "operations",
                     "library_ms": None if None in libs else sum(libs)}
    return out


def top2_gap_last(x: torch.Tensor) -> torch.Tensor:
    """The top-2 gap over the last axis (one class: no second, an infinite gap)."""
    if x.shape[-1] == 1:
        return torch.full(x.shape[:-1], float("inf"), device=x.device)
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
    their data (with ``grouped``, the grouped sites' only)."""

    def __init__(self, model: pq.QuantizedZoneModel | None = None, grouped: bool = False):
        self.convs: list[dict] = []
        self.grouped = grouped
        self.quants: list[dict] = []
        self.names: list[str] = []  # each conv's site name, with a model
        self._names = {} if model is None else {
            id(p): name for qp in (model.qparams, model.dec_qparams or {})
            for name, p in qp.items()}

    def conv(self, x, p, stride, padding, dilation=1, **kw):
        site = dict(x=x, p=p, stride=stride, padding=padding, dilation=dilation, **kw)
        if p.groups > 1 or not self.grouped:
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
    (groups, cg), dil = (site["p"].groups, site["p"].wq.shape[1]), site["dilation"]
    return (f"site {k} {tuple(site['x'].shape)} -> ({B}, {co}, {ho}, {wo}) {kh}x{kh}/"
            f"{site['stride']}{f' d{dil}' if dil > 1 else ''}"
            f"{f', {groups} groups of {cg}' if groups > 1 else ''}"
            f"{', residual' if site['residual'] is not None else ''}"
            f"{'' if site['relu'] else ', no ReLU'}, out {outs.strip()}")


def int8_cost(site: dict) -> tuple[int, int]:
    """(operations, bytes): 2 per int8 MAC over the real channels (a grouped
    site's over each output channel's group); each input read once
    (activations, weights, deq and b, the residual), each output written
    once."""
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


def grouped_instance(site: dict, **forced) -> ic.GroupedPlan:
    """grouped_plan's launch for a grouped site on this card (``forced``:
    its band and / or depth)."""
    B, co, ho, wo, _, _ = int8_shape(site)
    return ic.grouped_plan(B, ho, wo, co, site["p"].groups, site["stride"], site["padding"],
                           site["dilation"], ic._sm_count(site["x"].device), **forced)


def plan_label(plan: ic.GroupedPlan) -> str:
    return (f"instance {plan.instance}, slab {plan.slab}, band {plan.band}, depth "
            f"{plan.depth}, {plan.rows_step} row(s) a step, {plan.grid} blocks of "
            f"{plan.threads}, {plan.smem} B shared")


def compare_grouped(label: str, site: dict, plan: ic.GroupedPlan | None = None) -> int:
    """int8_conv_grouped (at ``plan``, else grouped_plan's) against its
    plain version, float32 and int8 outputs bit for bit; its instance."""
    plan = plan or grouped_instance(site)
    got = ic.int8_conv_grouped(**site, plan=plan)
    want = ic.int8_conv_plain(**site)
    torch.cuda.synchronize()
    same = all((a is None and b is None) or (a is not None and b is not None and torch.equal(a, b))
               for a, b in zip(got, want))
    check(same, f"int8_conv {label} ({plan_label(plan)}): float32 and int8 outputs exactly "
          "equal")
    return plan.instance


def grouped_edge_site(gen, B, H, W, groups, cg, stride, pad, dil, res, relu,
                      device: str = "cuda") -> dict:
    co = groups * cg
    p = ic.Int8ConvParams(
        torch.randint(-127, 128, (co, cg, 3, 3), generator=gen, device=device,
                      dtype=torch.int8), 0.05,
        torch.rand(co, generator=gen, device=device) * 2e-3 + 1e-4,
        torch.randn(co, generator=gen, device=device), groups)
    x = torch.randint(-127, 128, (B, H, W, co), generator=gen, device=device,
                      dtype=torch.int8).permute(0, 3, 1, 2)
    ho, wo = (ic._out_hw(n, 3, stride, pad, dil) for n in (H, W))
    r = (torch.randn((B, ho, wo, co), generator=gen, device=device).permute(0, 3, 1, 2)
         if res else None)
    return dict(x=x, p=p, stride=stride, padding=pad, dilation=dil, residual=r, relu=relu,
                keep_f32=True, out_sx=0.04)


def check_grouped_edges(device: str = "cuda") -> set:
    """int8_conv_grouped exactly equal to its plain version at GROUPED_EDGES
    and GROUPED_PLAN_EDGES on random int8 operands, float32 and int8
    outputs; returns the instances they took."""
    gen = torch.Generator(device).manual_seed(SEED + 19)
    taken = set()
    for k, (label, B, H, W, groups, cg, stride, pad, dil, res, relu) in enumerate(
            GROUPED_EDGES):
        site = grouped_edge_site(gen, B, H, W, groups, cg, stride, pad, dil, res, relu, device)
        taken.add(compare_grouped(f"grouped {label}: {int8_label(k, site)}", site))
    for k, (label, B, H, W, groups, cg, stride, band, depth, step) in enumerate(
            GROUPED_PLAN_EDGES):
        site = grouped_edge_site(gen, B, H, W, groups, cg, stride, 1, 1, False, True, device)
        plan = grouped_instance(site, band=band, depth=depth, rows_step=step)
        taken.add(compare_grouped(f"grouped {label}: {int8_label(k, site)}", site, plan))
    return taken


def check_int8_grouped(qmodel: pq.QuantizedZoneModel, x: torch.Tensor) -> dict:
    """The grouped int8_conv against its plain version, bit for bit, at
    every grouped site of resnext50_32x4d-unet's int8 walk on 2 tiles of x
    (the int8 output the walk asks for, and float32 beside it) and at
    GROUPED_EDGES; then at every site of one batch of x (each distinct
    geometry once, at the plan the main path launches, held bit for bit the
    same way, then timed and weighted by its sites), with its bound (bytes
    over HBM or multiply-adds at the card's int8 rate, whichever is larger)
    and the plain version's time. No PyTorch call computes a grouped int8
    convolution: library none."""

    def grouped_sites(batch: torch.Tensor) -> list[dict]:
        rec = Int8Recorder(grouped=True)
        qmodel.tail_input(batch, M, conv=rec.conv, quantize=rec.quantize)
        return rec.convs

    sites = grouped_sites(x[:2])
    check(len(sites) == RESNEXT_GROUPED_SITES,
          f"{RESNEXT}: {len(sites)} grouped int8 sites ({RESNEXT_GROUPED_SITES})")
    taken = set()
    for k, site in enumerate(sites):
        taken.add(compare_grouped(f"grouped {int8_label(k, site)} B=2", site))
        compare_grouped(f"grouped site {k}, float32 out too", dict(site, keep_f32=True))
    taken |= check_grouped_edges()
    check(taken == set(range(9)), f"int8_conv_grouped: instances {sorted(taken)} checked "
          "(all nine: the general one and cg 4, 8, 16, 32 at strides 1 and 2)")
    out = {"max_abs_err": 0, "sites": len(sites),
           "edge_cases": len(GROUPED_EDGES) + len(GROUPED_PLAN_EDGES)}
    geometries: dict = {}
    for site in grouped_sites(x):
        key = (tuple(site["x"].shape), tuple(site["p"].wq.shape), site["stride"],
               site["dilation"], site["keep_f32"], site["out_sx"] is not None)
        geometries.setdefault(key, [site, 0])[1] += 1
    rows = []
    for k, (site, n) in enumerate(geometries.values()):
        # the launches the main path makes (its batch sets the band), held
        # as at B=2 before they are timed
        compare_grouped(f"grouped {int8_label(k, site)} B={site['x'].shape[0]}", site)
        compare_grouped(f"grouped geometry {k}, float32 out too", dict(site, keep_f32=True))
        torch.cuda.empty_cache()
        ops, nbytes = int8_cost(site)
        r = {"site": int8_label(k, site), "count": n, "plan": plan_label(grouped_instance(site)),
             "ms": device_ms(lambda a=site: ic.int8_conv_grouped(**a), 10),
             "call_ms": cuda_ms(lambda a=site: ic.int8_conv_grouped(**a), 10, 2),
             "before_ms": GROUPED_BEFORE_MS.get((site["x"].shape[1], site["stride"])),
             "plain_ms": cuda_ms(lambda a=site: ic.int8_conv_plain(**a), 1, 1),
             "ops": ops, "bytes": nbytes, **bound(ops, nbytes, PEAK_INT8_OPS)}
        rows.append(dict(r, share=r["bound_ms"] / r["ms"]))
        torch.cuda.empty_cache()
    del geometries
    ms = sum(r["count"] * r["ms"] for r in rows)
    out["call_ms"] = sum(r["count"] * r["call_ms"] for r in rows)
    bound_ms = sum(r["count"] * r["bound_ms"] for r in rows)
    out.update(rows=rows, ms=ms, plain_ms=sum(r["count"] * r["plain_ms"] for r in rows),
               before_ms=sum(r["count"] * (r["before_ms"] or 0) for r in rows),
               bound_ms=bound_ms, library_ms=None,
               bytes=sum(r["count"] * r["bytes"] for r in rows),
               bound_by=max(("bytes", "operations"), key=lambda b: sum(
                   r["count"] * r["bound_ms"] for r in rows if r["bound_by"] == b)))
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
    weights = tmp / "resnet34_unet_19cl.pth"
    torch.save(random_weights(FlairSegmentationModel("resnet34", K, C), rng), weights)
    return zone, truth, weights


def random_weights(model: nn.Module, rng) -> dict:
    """A seeded smp-keyed state dict for ``model``: He-scaled conv weights,
    random BatchNorm statistics and affines (GroupNorm's too), small biases."""
    sd = {}
    for key, v in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            sd[key] = v
        elif key.endswith("running_var"):
            sd[key] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        elif key.endswith(("running_mean", ".bias")):
            sd[key] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
        elif v.dim() == 1:  # BatchNorm / GroupNorm gamma
            sd[key] = torch.from_numpy(rng.uniform(0.5, 1.0, v.shape).astype(np.float32))
        else:  # conv weights, He-scaled
            fan_in = v[0].numel()
            sd[key] = torch.from_numpy(
                (rng.standard_normal(v.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32))
    return sd


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

    def __init__(self, config: dict, model, tail):
        super().__init__(config, model, tail)
        self.tail_fns = tail.plain_versions()

    def _tail_input(self, zone_p, origins, margin):
        x = ga.gather_normalize_plain(zone_p, origins, self.size,
                                      out_dtype=self.model.dtype, **self.norm)
        plain = dict(epilogue=ep.conv_epilogue_plain, group_norm=gnr.group_norm_relu_plain)
        if isinstance(self.model, FlairSegmentationModel):
            plain.update(se_gate=sg.squeeze_excite_plain)
        if isinstance(self.model, pq.QuantizedZoneModel):
            plain.update(conv=ic.int8_conv_plain, quantize=qa.quantize_act_plain)
        return self.model.tail_input(x, margin, **plain)


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
    sp.launches = sp.probs_launches = sp.logits_launches = gnr.launches = 0
    ga.typed_launches = ic.launches = ic.grouped_launches = qa.launches = 0
    au.launches = au.tiled_launches = 0
    wc.launches = wc.backward_launches = bt.launches = bt.backward_launches = 0
    bt.narrow_launches = bt.narrow_backward_launches = gnr.backward_launches = 0
    ep.silu_launches = sg.squeeze_launches = sg.excite_launches = 0
    bt.wide_launches = bt.wide_backward_launches = bt.silu_backward_launches = 0
    bt.affine_backward_launches = sg.backward_launches = ep.drop_launches = 0
    for counts in (st.launches, ts.launches):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    return {"fused_tail": ft.launches, "fused_tail_probs": ft.probs_launches,
            "fused_tail_logits": ft.logits_launches, "gather_normalize": ga.launches,
            "gather_normalize_typed": ga.typed_launches, "conv_epilogue": ep.launches,
            "int8_conv": ic.launches, "int8_conv_grouped": ic.grouped_launches,
            "quantize_act": qa.launches,
            "augment_normalize": au.launches, "weighted_ce": wc.launches,
            "weighted_ce_backward": wc.backward_launches, "bn_stats": bt.launches,
            "bn_backward": bt.backward_launches, "bn_stats_narrow": bt.narrow_launches,
            "bn_backward_narrow": bt.narrow_backward_launches, "strided_tail": sp.launches,
            "strided_tail_probs": sp.probs_launches, "strided_tail_logits": sp.logits_launches,
            "group_norm_relu": gnr.launches,
            "group_norm_relu_backward": gnr.backward_launches,
            "conv_epilogue_silu": ep.silu_launches, "se_squeeze": sg.squeeze_launches,
            "se_excite": sg.excite_launches, "bn_stats_wide": bt.wide_launches,
            "bn_backward_wide": bt.wide_backward_launches,
            "bn_backward_silu": bt.silu_backward_launches,
            "bn_backward_affine": bt.affine_backward_launches, "se_backward": sg.backward_launches,
            "conv_epilogue_drop": ep.drop_launches, **st.launches, **ts.launches}


def expected_launches(method: str, output_type: str, n_batches: int,
                      streaming: bool = False, typed: bool = False,
                      int8_blocks: int | None = None, sites: int = EPILOGUE_SITES,
                      int8_sites: int = ENCODER_INT8_SITES, grouped: int = 0,
                      quantized: int = 2) -> dict:
    """Each kernel's launches for one zone run of ``n_batches`` batches, on
    the device route or the streaming route (whose stitches run on the
    host, after the full-tile softmax kernel); ``typed``: a zone that is
    not uint8; ``int8_blocks``: the int8 model with that many int8 decoder
    blocks (the others' two convs each an epilogue). ``sites``,
    ``int8_sites``, ``grouped`` and ``quantized``: the U-Net's conv_epilogue
    sites a batch, its encoder's int8 sites, of them the grouped ones, and
    the encoder's quantize_act launches (resnet34-unet's by default: the
    tile and the pooled stem output; a bottleneck encoder quantizes the
    pooled output twice, for layer1's conv1 and its downsample)."""
    out = dict.fromkeys(read_launches(), 0)
    out["gather_normalize_typed" if typed else "gather_normalize"] = n_batches
    out["conv_epilogue"] = sites * n_batches
    if int8_blocks is not None:
        out.update(int8_conv=(int8_sites - grouped + 2 * int8_blocks) * n_batches,
                   int8_conv_grouped=grouped * n_batches,
                   quantize_act=(quantized + int8_blocks) * n_batches,
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


def run_main_path(cfg: dict, conf: Path, zone_hw: int, card: str,
                  sites: int = EPILOGUE_SITES) -> dict:
    # the plain versions first: their run also warms cuDNN up for the encoder
    plain = run_plain(cfg)
    print(f"  plain-version run: compute {plain['compute_seconds']:.4f} s, "
          f"{plain['patches_per_sec']:.2f} patches/s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    stats = cli.detect_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9

    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    expected = expected_launches("exact-clipping", "argmax", n_batches, sites=sites)
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
            plain["compute_seconds"], "agree_plain": agree, "prob_diff_plain": dprob,
            "peak_gb": peak}


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
              float_raster: np.ndarray, int8_blocks: int | None = None,
              expect: dict | None = None) -> dict:
    """detect_main with ``knobs`` on the zone of ``cfg``, the counts set to 0
    just before it: its launches, raster shape and coverage; against its
    all-plain run on the same model (class agreement >= 0.999, prob |diff|
    <= 1) and against the float path's raster of the zone (class agreement
    >= ``floor``); patches/s and calibration seconds. ``expect``: the
    model's site counts for expected_launches (resnet34-unet's by
    default)."""
    kc = dict(cfg, output_path=str(Path(cfg["output_path"]).parent / f"out_{label}"), **knobs)
    conf = write_conf(kc, label)
    with captured_models() as models:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        stats = cli.detect_main([f"--conf={conf}"])
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 1e9
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    check_launches(f"{label}, {n_batches} batches", launches,
                   expected_launches("exact-clipping", "argmax", n_batches,
                                     int8_blocks=int8_blocks, **(expect or {})))
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
            "prob_diff_plain": dprob, "agree_float": agree_float, "peak_gb": peak,
            "launches": launches}


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


def plain_gap(cfg: dict) -> np.ndarray:
    """The top-2 gap (H, W) of the plain logits of ``cfg``'s model at each
    pixel of its zone (GapRunner's all-plain route)."""
    device = torch.device("cuda")
    pc = eng.setup_out_path(dict(cfg, compare=False))
    with TiffReader(pc["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, S, M, S - 2 * M, reader.transform,
                          reader.crs)
    runner = GapRunner(pc, *eng.prepare_model(cfg, device))
    runner.run(grid, "exact-clipping", eng.stage_zone(pc, device))
    return runner.gap.cpu().numpy()


def run_s2d_stem(cfg: dict, zone_hw: int, default_raster: np.ndarray) -> dict:
    """The main configuration with ``s2d_stem: true`` through detect_main
    (the counts set to 0 just before it: the main path's launches) against
    the default stem's raster of the zone: a class may differ only where the
    default model's plain logits have a top-2 gap below GAP_TOL (the two
    stems round the same sums apart, in bf16, and the convolutions after
    them carry it on); patches/s."""
    sc = dict(cfg, output_path=str(Path(cfg["output_path"]).parent / "out_s2d"),
              s2d_stem=True)
    conf = write_conf(sc, "s2d_stem")
    reset_launches()
    stats = cli.detect_main([f"--conf={conf}"])
    launches = read_launches()
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    check_launches(f"s2d_stem, {n_batches} batches", launches,
                   expected_launches("exact-clipping", "argmax", n_batches))
    have = read_raster(Path(sc["output_path"]) / "zone-ARGMAX.tif")
    check(have.shape == (2, zone_hw, zone_hw) and bool((have[1] > 0).all()),
          f"s2d_stem: raster {have.shape}, every pixel written")
    off = have[0] != default_raster[0]
    moved = off & (plain_gap(cfg) >= GAP_TOL)
    dprob = int(np.abs(have[1].astype(int) - default_raster[1].astype(int)).max())
    check(int(moved.sum()) == 0, f"s2d_stem vs the default stem: {int(off.sum())} class "
          f"mismatches, {int(moved.sum())} beyond the near-tie rule (top-2 gap < {GAP_TOL})")
    print(f"  s2d_stem: {stats['tiles']} tiles, compute {stats['compute_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s; {int(off.sum())} near-tie class "
          f"mismatches against the default stem, prob |diff| {dprob}", flush=True)
    return {"patches_per_sec": stats["patches_per_sec"],
            "compute_seconds": stats["compute_seconds"], "mismatches": int(off.sum()),
            "prob_diff": dprob, "launches": launches}


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
# phase 4d: a tensor whose gradient moves by STEP_NOISE or more in relative
# L2 between two orders of the same plain step is noise-dominated in bf16
# (the slice-5 decoders' few-value sites: PAN's 1-channel pyramid, the SE
# gates' and PSP's 1 x 1 pools, BatchNorms over a few close values). The
# kernels' step also rounds elementwise where a reordered plain step only
# sums in another order (the loss gradient's exp, every BatchNorm's dy in
# bf16), so its drift there runs above the reordered runs': 2.6 x at MAnet's
# SE gates, 2.8-3.1 x at PAN's fpa.down1 BatchNorm. Those tensors are held
# to STEP_NOISE_SLACK x the largest reordered drift, all tensors together
# to STEP_SLACK, and the loss, where the reordered runs move it by more
# than STEP_LOSS_RTOL (PAN: about 1e-3), to STEP_NOISE_SLACK x that drift
STEP_NOISE, STEP_NOISE_SLACK = 0.25, 6.0


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

    def site(self, y, bn, residual=None, branch=None, act="relu", keep_f32=False, drop=None):
        self.sites.append(dict(y=y, bn=bn, residual=residual, branch=branch, keep_f32=keep_f32))
        return super().site(y, bn, residual, branch, act, keep_f32, drop)


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
    downsample's BatchNorm inside its block's last site), of them the
    narrow ones (channels not a multiple of 8: bn_train's narrow entry
    points), GroupNorm sites, the inference sites of tail_input (all but
    the fused tail's last block) and the tail's kernel. An EfficientNet's:
    its SiLU sites (the stem, each expand), squeeze-excite sites (each
    block's depthwise BatchNorm: no conv_epilogue in training, a squeeze,
    an excite and a gate backward), drop-connect sites (each block j > 0
    with an identity) and the BatchNorms above 2048 channels (``wide``)."""
    n_bn = sum(isinstance(m, nn.BatchNorm2d) for m in model.modules())
    n_ds = sum(getattr(m, "downsample", None) is not None for m in model.encoder.modules())
    narrow = sum(isinstance(m, nn.BatchNorm2d) and m.num_features % 8 != 0
                 for m in model.modules())
    tail = model.zone_tail()
    enc = effnet_counts(model) or {"silu": 0, "se": 0}
    drop = (sum(b.skip for j, b in enumerate(model.encoder._blocks) if j) if enc["se"] else 0)
    return {"bn": n_bn, "sites": n_bn - n_ds, "tail_sites": arch_sites(model, tail),
            "narrow": narrow, "gn": sum(isinstance(m, nn.GroupNorm) for m in model.modules()),
            "tail": "strided_tail" if isinstance(tail, sp.StridedTail) else "fused_tail",
            "silu": enc["silu"], "se": enc["se"], "drop": drop,
            "wide": sum(isinstance(m, nn.BatchNorm2d) and m.num_features > 8 * bt.THREADS
                        for m in model.modules())}


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


def write_flair_dataset(root: Path, rng, splits=FLAIR_SPLITS, first: int = 0) -> dict:
    """FLAIR-like 512 x 512 x 5 uint8 patches and masks written with
    flairtpu_torch.io, one CSV a split; file stems numbered from ``first``
    across the splits, unique as FLAIR's (the metadata JSON's keys)."""
    csvs = {}
    n_file = first
    for split, n in splits:
        d = root / split
        d.mkdir(parents=True)
        rows = []
        for i in range(n):
            img, msk = flair_patch(rng, S)
            tr = Affine.from_origin(650000.0 + i * S * 0.2, 6860000.0, 0.2, 0.2)
            ip, mp = d / f"IMG_{n_file:06d}.tif", d / f"MSK_{n_file:06d}.tif"
            n_file += 1
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


def flair_expected(counts: dict, steps: int, eval_batches: int, predict_batches: int,
                   micro: int = 1) -> dict:
    """Each kernel's launches for a flair run: per train step one
    augment_normalize and, for each of its ``micro`` microbatches, one
    weighted_ce forward and backward, a statistics launch a BatchNorm, a
    conv_epilogue and a backward launch a site (a narrow site's statistics
    launch writes its output: no conv_epilogue); per eval batch one
    augment_normalize, one weighted_ce and the full model's conv_epilogue
    sites; per predict batch one augment_normalize, the encoder's and
    decoder blocks 0-3's sites and one fused_tail (the other archs: every
    site outside the tail and its tail, fused_tail or strided_tail). The
    narrow BatchNorms (PAN's) take the narrow entry points; FPN's GroupNorm
    sites launch group_norm_relu each forward (train, eval, predict) and its
    backward each step. An EfficientNet's squeeze-excite sites launch a
    squeeze and an excite each forward and, in training, a gate backward,
    and no conv_epilogue; its SiLU sites launch conv_epilogue's SiLU mode
    each forward and bn_train's SiLU backward each step, its depthwise and
    drop-connect sites the affine backward each step, its drop-connect
    sites conv_epilogue's drop mode each step (the generator's masks),
    its BatchNorms above 2048 channels the channel-tiled statistics and
    backward each step. The metadata MLP and its fusion launch none of
    these."""
    out = dict.fromkeys(read_launches(), 0)
    m = steps * micro
    narrow, gn = counts["narrow"], counts["gn"]
    se, silu, drop, wide = (counts.get(k, 0) for k in ("se", "silu", "drop", "wide"))
    forwards = m + eval_batches + predict_batches
    out.update(augment_normalize=steps + eval_batches + predict_batches,
               weighted_ce=m + eval_batches, weighted_ce_backward=m,
               bn_stats=(counts["bn"] - narrow) * m, bn_backward=(counts["sites"] - narrow) * m,
               bn_stats_narrow=narrow * m, bn_backward_narrow=narrow * m,
               conv_epilogue=(counts["sites"] - narrow - se) * m
               + (counts["sites"] - se) * eval_batches + counts["tail_sites"] * predict_batches,
               group_norm_relu=gn * forwards, group_norm_relu_backward=gn * m,
               conv_epilogue_silu=silu * forwards, se_squeeze=se * forwards,
               se_excite=se * forwards, se_backward=se * m, bn_backward_silu=silu * m,
               bn_backward_affine=(se + drop) * m, conv_epilogue_drop=drop * m,
               bn_stats_wide=wide * m, bn_backward_wide=wide * m)
    out[counts["tail"]] = predict_batches
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
    stats_apply = staticmethod(bt.bn_stats_apply_plain)
    backward = staticmethod(bt.bn_backward_plain)
    gn_forward = staticmethod(gnr.group_norm_relu_plain)
    gn_backward = staticmethod(gnr.group_norm_relu_backward_plain)
    squeeze = staticmethod(sg.se_squeeze_plain)
    excite = staticmethod(sg.se_excite_plain)
    squeeze_backward = staticmethod(sg.se_backward_plain)


class StepChecker:
    """A train-mode site's parts and the loss as the kernels, each also run
    plain on the same operands; keeps each part's worst disagreement (with
    the shape where it was) and how many calls it checked."""

    def __init__(self):
        self.worst: dict[str, tuple[float, tuple]] = {}
        self.calls = dict.fromkeys(("stats", "epilogue", "stats_apply", "backward",
                                    "gn_forward", "gn_backward", "squeeze", "excite",
                                    "squeeze_backward"), 0)

    def note(self, part: str, err: float, shape) -> None:
        if part not in self.worst or err > self.worst[part][0]:
            self.worst[part] = (err, tuple(shape))

    def stats(self, x, gamma, beta, rm, rv, eps=bt.EPS, momentum=bt.MOMENTUM):
        rmp, rvp = rm.clone(), rv.clone()
        got = bt.bn_stats(x, gamma, beta, rm, rv, eps, momentum)
        want = bt.bn_stats_plain(x, gamma, beta, rmp, rvp, eps, momentum)
        self.note("stats", max(vec_err(a, b) for a, b in zip(got + (rm, rv), want + (rmp, rvp))),
                  x.shape)
        self.calls["stats"] += 1
        return got

    def epilogue(self, y, scale, shift, **kw):
        got = ep.conv_epilogue(y, scale, shift, **kw)
        want = ep.conv_epilogue_plain(y, scale, shift, **kw)
        if kw.get("silu"):  # the accurate expf on the card, torch.sigmoid plain
            self.note("epilogue_silu", bf16_ulps(got[0], want[0]), y.shape)
        else:
            self.note("epilogue", max(max_diff(a, b) for a, b in zip(got, want)), y.shape)
        self.calls["epilogue"] += 1
        return got

    def stats_apply(self, y, gamma, beta, rm, rv, relu, keep_f32, eps=bt.EPS,
                    momentum=bt.MOMENTUM):
        rmp, rvp = rm.clone(), rv.clone()
        got = bt.bn_stats_apply(y, gamma, beta, rm, rv, relu, keep_f32, eps, momentum)
        want = bt.bn_stats_apply_plain(y, gamma, beta, rmp, rvp, relu, keep_f32, eps, momentum)
        self.note("stats", max(vec_err(a, b) for a, b in zip(got[:4] + (rm, rv),
                                                                 want[:4] + (rmp, rvp))), y.shape)
        # the output against the plain epilogue from the kernel's own scale and shift
        out = ep.conv_epilogue_plain(y, got[2], got[3], relu=relu, keep_f32=keep_f32)
        self.note("epilogue", max(max_diff(a, b) for a, b in zip(got[4:], out)), y.shape)
        self.calls["stats_apply"] += 1
        return got

    def backward(self, *args, **kw):
        got, want = bt.bn_backward(*args, **kw), bt.bn_backward_plain(*args, **kw)
        shape = args[3].shape
        pairs = [(got[:3], want[:3])] + ([(got[4], want[4])] if got[4] is not None else [])
        for g, w in pairs:  # (dy, dgamma, dbeta), then the branch's
            self.note("dy", scaled_err(g[0], w[0]), shape)
            self.note("dgamma_dbeta", max(scaled_err(g[1], w[1]), scaled_err(g[2], w[2])), shape)
        self.note("dres", max_diff(got[3], want[3]), shape)
        self.calls["backward"] += 1
        return got

    def squeeze(self, y, scale, shift):
        got, want = sg.se_squeeze(y, scale, shift), sg.se_squeeze_plain(y, scale, shift)
        self.note("squeeze", scaled_err(got, want), y.shape)
        self.calls["squeeze"] += 1
        return got

    def excite(self, y, scale, shift, gate):
        got, want = sg.se_excite(y, scale, shift, gate), sg.se_excite_plain(y, scale, shift, gate)
        self.note("excite", bf16_ulps(got, want), y.shape)
        self.calls["excite"] += 1
        return got

    def squeeze_backward(self, g, y, scale, shift):
        got, want = sg.se_backward(g, y, scale, shift), sg.se_backward_plain(g, y, scale, shift)
        self.note("gate_grad", scaled_err(got, want), y.shape)
        self.calls["squeeze_backward"] += 1
        return got

    def gn_forward(self, y, gamma, beta, groups, eps, upsample, stats=True):
        got = gnr.group_norm_relu(y, gamma, beta, groups, eps, upsample, stats=True)
        want = gnr.group_norm_relu_plain(y, gamma, beta, groups, eps, upsample, stats=True)
        self.note("gn_out", scaled_err(got[0], want[0]), y.shape)
        self.note("gn_stats", max(vec_err(got[1], want[1]), vec_err(got[2], want[2])), y.shape)
        self.calls["gn_forward"] += 1
        return got

    def gn_backward(self, *args):
        got = gnr.group_norm_relu_backward(*args)
        want = gnr.group_norm_relu_backward_plain(*args)
        shape = args[1].shape
        self.note("gn_dy", scaled_err(got[0], want[0]), shape)
        self.note("gn_dgamma_dbeta", max(vec_err(got[1], want[1]), vec_err(got[2], want[2])),
                  shape)
        self.calls["gn_backward"] += 1
        return got


class SiteFunction(torch.autograd.Function):
    """A train-mode site through ``impl``'s stats, epilogue and backward
    (bn_train's site_forward and site_backward, as BNTrainSite runs them)."""

    @staticmethod
    def forward(ctx, impl, *args):
        ctx.impl = impl
        return bt.site_forward(ctx, impl.stats, impl.epilogue, impl.stats_apply, *args)

    @staticmethod
    def backward(ctx, g, g32=None):
        return (None, *bt.site_backward(ctx, ctx.impl.backward, g, g32))


class GroupNormFunction(torch.autograd.Function):
    """A train-mode GroupNorm site through ``impl``'s gn_forward and
    gn_backward (group_norm's gn_forward and gn_backward seam, as
    GroupNormReLU runs it)."""

    @staticmethod
    def forward(ctx, impl, *args):
        ctx.impl = impl
        return gnr.gn_forward(ctx, impl.gn_forward, *args)

    @staticmethod
    def backward(ctx, g):
        return (None, *gnr.gn_backward(ctx, ctx.impl.gn_backward, g))


class SEFunction(torch.autograd.Function):
    """An EfficientNet depthwise site through ``impl``'s stats, squeeze,
    excite, squeeze_backward and backward (bn_train's se_site_forward and
    se_site_backward, as SEGateSite runs them)."""

    @staticmethod
    def forward(ctx, impl, *args):
        ctx.impl = impl
        return bt.se_site_forward(ctx, impl, *args)

    @staticmethod
    def backward(ctx, g):
        return (None, *bt.se_site_backward(ctx, ctx.impl, g))


class SitesThrough(TrainSites):
    def __init__(self, impl):
        self.impl = impl

    def apply(self, *args):
        return SiteFunction.apply(self.impl, *args)

    def apply_se(self, *args):
        return SEFunction.apply(self.impl, *args)

    def group_norm(self, y, gamma, beta, groups, eps, upsample):
        return GroupNormFunction.apply(self.impl, y, gamma, beta, groups, eps, upsample)


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

    def micro_step(self, x, tgt, cm, mtd=None, masks=None):
        logits = self.model(x, epilogue=self.sites, mtd=mtd,
                            dropout=self.generator if masks is None else masks)
        loss = PlainWeightedCE.apply(logits, tgt, self.class_weights, cm)
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

    def micro_step(self, x, tgt, cm, mtd=None, masks=None):
        logits = self.model(x, epilogue=self.sites, mtd=mtd,
                            dropout=self.generator if masks is None else masks)
        loss = CheckedWeightedCE.apply(self.checker, logits, tgt, self.class_weights, cm)
        loss.backward()
        return loss.detach()


class HeldStep:
    """Stands in for a trainer's optimizer: ``step`` keeps the (mean)
    gradients instead of applying them."""

    def __init__(self, model: nn.Module):
        self.names, self.params = zip(*model.named_parameters())
        self.grads = None

    def step(self) -> None:
        self.grads = {n: p.grad.detach().clone() for n, p in zip(self.names, self.params)}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def one_step(trainer, batch: dict, choices: torch.Tensor, masks=None) -> dict:
    """The trainer's train_step on ``batch`` with ``choices`` (and the
    metadata MLP's keep ``masks``, one entry a microbatch), its optimizer
    held back: the loss, the gradients, the running statistics after it and
    the confusion matrix."""
    trainer.opt = HeldStep(trainer.model)
    cm = trainer.new_confmat()
    loss = trainer.train_step(batch, cm, choices, masks)
    torch.cuda.synchronize()
    return {"loss": loss.item(), "cm": cm.clone(), "grads": trainer.opt.grads,
            "stats": {n: b.detach().clone() for n, b in trainer.model.named_buffers()
                      if "running" in n}}


@contextlib.contextmanager
def no_tf32():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def step_site_limits(gn: bool, se: bool = False) -> dict:
    """Each part's limit in the site-by-site check of a step (GroupNorm's
    parts where the model has GroupNorm sites, an EfficientNet's SiLU and
    squeeze-excite parts where it has them: the SiLU epilogue and the
    excite within one bf16 ulp, the squeeze and the gate's gradient within
    SQUEEZE_REL_TOL and GATE_GRAD_TOL of their largest value)."""
    limits = {"augment": 0.0, "stats": BN_STAT_TOL, "epilogue": 0.0, "dy": BN_DY_TOL,
              "dgamma_dbeta": BN_GRAD_TOL, "dres": 0.0, "ce_loss": CE_LOSS_RTOL,
              "ce_weight_sum": 0.0, "ce_confmat": 0.0, "ce_grad": CE_GRAD_TOL}
    if gn:
        limits.update(gn_out=GN_TOL, gn_stats=BN_STAT_TOL, gn_dy=GN_DY_TOL,
                      gn_dgamma_dbeta=BN_GRAD_TOL)
    if se:
        limits.update(epilogue_silu=1.0, squeeze=SQUEEZE_REL_TOL, excite=1.0,
                      gate_grad=GATE_GRAD_TOL)
    return limits


def check_step_sites(checker: StepChecker, counts: dict, micro: int = 1) -> dict:
    """The site-by-site check of the kernels' step (StepChecker's records),
    over ``micro`` microbatches."""
    calls = checker.calls
    gn, narrow, se = counts["gn"], counts["narrow"], counts.get("se", 0)
    check(calls == {"stats": micro * (counts["bn"] - narrow),
                    "epilogue": micro * (counts["sites"] - narrow - se),
                    "stats_apply": micro * narrow, "backward": micro * counts["sites"],
                    "gn_forward": micro * gn, "gn_backward": micro * gn,
                    "squeeze": micro * se, "excite": micro * se, "squeeze_backward": micro * se},
          f"train step, site by site: {calls} kernel calls each held to its plain version on "
          f"the step's own operands ({micro} x {counts['bn']} BatchNorms, {counts['sites']} "
          f"sites, {narrow} of them narrow, {gn} GroupNorm sites, {se} squeeze-excite sites)")
    for part, limit in step_site_limits(gn, se > 0).items():
        err, shape = checker.worst[part]
        check(err <= limit, f"train step, site by site: {part} within {err:.2e} <= {limit:.2e} "
              f"(worst at {shape})")
    return {part: {"err": e, "shape": list(sh)} for part, (e, sh) in checker.worst.items()}


def permute_masks(masks: dict, idx: torch.Tensor) -> dict:
    """A microbatch's keep masks by module name (each a tensor, a list of
    them, or the drop-connect's dict of them by block) for its samples in
    the order ``idx``."""
    idx = idx.to("cuda")
    return {k: [m[idx] for m in v] if isinstance(v, list) else
            {j: m[idx] for j, m in v.items()} if isinstance(v, dict) else v[idx]
            for k, v in masks.items()}


# conv biases in front of a train-mode BatchNorm (PAN's ConvBnRelu convs,
# LinkNet's transposed convs): their gradient is zero in exact arithmetic,
# so each step's value is rounding noise, reported but not held to a
# relative bound
BIAS_BEFORE_BN = re.compile(r"^decoder\.(fpa|gau\d)\..*conv\.bias$|"
                            r"^decoder\.blocks\.\d\.block\.1\.0\.bias$")


def sample_orders(n: int, count: int) -> dict:
    """``count`` other orders of a microbatch's n samples, by name: reversed,
    rolled by half and by a quarter, reversed and rolled, then shuffles
    from fixed seeds."""
    orders = {"plain, reversed": torch.arange(n).flip(0),
              "plain, rolled": torch.arange(n).roll(n // 2),
              "plain, rolled by a quarter": torch.arange(n).roll(n // 4),
              "plain, reversed and rolled": torch.arange(n).flip(0).roll(n // 2)}
    for k in range(len(orders), count):
        orders[f"plain, shuffled {k - 3}"] = torch.randperm(
            n, generator=torch.Generator().manual_seed(SEED + 100 + k))
    return dict(list(orders.items())[:count])


def free_running_verdict(got: dict, drifts: list[dict], got_all: float,
                         drift_all: list[float], noise: bool) -> dict:
    """The free-running step check of one half of a step (its gradients or
    its running statistics): each tensor's relative L2 ``got`` to the plain
    step against ``floor``, the largest of the reordered plain runs'
    ``drifts``, and ``got_all`` over all tensors against ``drift_all``'s
    largest. Tensors zero in exact arithmetic (BIAS_BEFORE_BN) are not
    held; with ``noise``, those whose floor is STEP_NOISE or more are held to
    STEP_NOISE_SLACK x it (``noisy``, over it ``over``), the rest to
    STEP_SLACK (``held``, over it ``bad``), and all tensors together to
    STEP_SLACK. ``failed`` lists every tensor over its bound, then "all
    tensors" where that sum is."""
    a, b0 = STEP_SLACK
    floor = {t: max(d[t] for d in drifts) for t in got}
    zero = sorted(t for t in got if BIAS_BEFORE_BN.match(t))
    noisy = sorted(t for t in got if noise and t not in zero and floor[t] >= STEP_NOISE)
    held = [t for t in got if t not in zero and t not in noisy]
    bad = [t for t in held if got[t] > a * floor[t] + b0]
    over = [t for t in noisy if got[t] > STEP_NOISE_SLACK * floor[t]]
    all_over = noise and got_all > a * max(drift_all) + b0
    return dict(floor=floor, floor_all=max(drift_all), zero=zero, noisy=noisy, held=held,
                bad=bad, over=over, failed=bad + over + (["all tensors"] if all_over else []))


def loss_tolerance(drift_loss: list[float], noise: bool) -> float:
    """The free-running step's relative loss tolerance: STEP_LOSS_RTOL or,
    with ``noise`` (the loss moves with the order too where the step is
    noise-dominated), STEP_NOISE_SLACK x the reordered runs' largest
    relative loss drift ``drift_loss``, whichever is larger."""
    return max(STEP_LOSS_RTOL, STEP_NOISE_SLACK * max(drift_loss)) if noise else STEP_LOSS_RTOL


def majority_failed(failed: list[list[str]]) -> list[str]:
    """What fails in more than half of the kernel orders, given what fails
    in each (a fault shows in every order, a rounding outlier of the
    kernels' step in one)."""
    counts = collections.Counter(itertools.chain.from_iterable(failed))
    return sorted(t for t, c in counts.items() if 2 * c > len(failed))


def compare_train_step(cfg: dict, state: dict, batch: dict, counts: dict, masks=None,
                       drift: bool = True, reorders: int = 1, noise: bool = False,
                       kernel_orders: int = 1) -> dict:
    """One train step, from the same weights, batch, choices (and dropout
    ``masks``, one dict by module name a microbatch): the kernels' step held
    site by site to the plain versions, then against the plain step, beside
    the plain step on the samples reversed (within each microbatch: the same
    microbatches in another order) and, with ``reorders`` > 1, also in the
    other orders of :func:`sample_orders` (each tensor's drift then the
    largest of theirs) and, with ``drift``,
    repeated and both orders in float32. Tensors whose gradient is zero in
    exact arithmetic (BIAS_BEFORE_BN) are reported, not held to the drift
    bound; with ``noise``, the noise-dominated ones (STEP_NOISE) are held to
    STEP_NOISE_SLACK x their drift, all tensors together to STEP_SLACK, and
    the loss to STEP_LOSS_RTOL or STEP_NOISE_SLACK x the reordered runs'
    loss drift, whichever is larger. With ``kernel_orders`` > 1 the kernels'
    step also runs in the first kernel_orders - 1 other orders (each held
    site by site too), each against the plain step in its order beside the
    plain steps in all the others, and a tensor, the sum over all tensors
    or the loss fails where it is over its bound in more than half of the
    kernel orders (majority_failed)."""
    runs = {}
    A = int(cfg.get("accumulate_steps", 1))
    n = TRAIN_BATCH // A
    orders = sample_orders(n, reorders)
    choices = choices_all(TRAIN_BATCH)
    checker = StepChecker()
    variants = [("kernels", lambda: CheckedTrainer(cfg, checker), batch, choices, masks),
                ("plain", lambda: PlainTrainer(cfg), batch, choices, masks)]
    reordered = {}
    for name, idx in orders.items():
        perm = (torch.arange(A)[:, None] * n + idx[None]).flatten()
        reordered[name] = ({k: v[perm] for k, v in batch.items() if k != "id"},
                           choices[perm.to(choices.device)].contiguous(),
                           masks and [permute_masks(mb, idx) for mb in masks])
        variants.append((name, lambda: PlainTrainer(cfg), *reordered[name]))
    # the kernels' step in other orders: (its plain run, its run)
    kern_orders = [("plain", "kernels")] + [
        (name, f"kernels, {name[7:]}") for name in list(orders)[:kernel_orders - 1]]
    checkers = [checker] + [StepChecker() for _ in kern_orders[1:]]
    for (name, kname), ck in zip(kern_orders[1:], checkers[1:]):
        variants.append((kname, lambda ck=ck: CheckedTrainer(cfg, ck), *reordered[name]))
    rev, rev_choices, rev_masks = reordered["plain, reversed"]
    if drift:
        variants += [
            ("plain, again", lambda: PlainTrainer(cfg), batch, choices, masks),
            ("plain float32", lambda: PlainTrainer(cfg, torch.float32), batch, choices, masks),
            ("plain float32, reversed", lambda: PlainTrainer(cfg, torch.float32), rev,
             rev_choices, rev_masks)]
    for name, make, b, ch, mk in variants:
        trainer = make()
        trainer.load_state(state)
        with no_tf32() if "float32" in name else contextlib.nullcontext():
            runs[name] = one_step(trainer, b, ch, mk)
        del trainer
        torch.cuda.empty_cache()
    out = {"sites": check_step_sites(checker, counts, A)}
    for ck in checkers[1:]:
        check_step_sites(ck, counts, A)
    k, p, r = runs["kernels"], runs["plain"], runs["plain, reversed"]
    a, b0 = STEP_SLACK
    plains = ["plain", *orders]
    votes = f" in more than half of {len(kern_orders)} kernel orders" if kernel_orders > 1 else ""

    def rel_loss(x: dict, y: dict) -> float:
        return abs(x["loss"] - y["loss"]) / abs(y["loss"])

    loss_failed = majority_failed([
        ["loss"] if rel_loss(runs[kn], runs[pn]) > loss_tolerance(
            [rel_loss(runs[t], runs[pn]) for t in plains if t != pn], noise) else []
        for pn, kn in kern_orders])
    loss_tol = loss_tolerance([rel_loss(runs[name], p) for name in orders], noise)
    check(not loss_failed, f"train step, free-running: loss {k['loss']:.6f} vs "
          f"plain {p['loss']:.6f} (reversed {r['loss']:.6f}): relative "
          f"{rel_loss(k, p):.1e} <= {loss_tol:.1e}"
          + (f" (STEP_LOSS_RTOL {STEP_LOSS_RTOL}, or {STEP_NOISE_SLACK} x "
             "the reordered runs' drift)" if noise else "") + (
              ", over" + votes + ": " + ", ".join(
                  f"{rel_loss(runs[kn], runs[pn]):.1e}" for pn, kn in kern_orders)
              if kernel_orders > 1 else ""))
    out.update(loss=k["loss"], plain_loss=p["loss"], reversed_loss=r["loss"])
    for what in ("grads", "stats"):
        vs = [free_running_verdict(
            grad_rel(runs[kn][what], runs[pn][what]),
            [grad_rel(runs[t][what], runs[pn][what]) for t in plains if t != pn],
            all_rel(runs[kn][what], runs[pn][what]),
            [all_rel(runs[t][what], runs[pn][what]) for t in plains if t != pn], noise)
            for pn, kn in kern_orders]
        failed = majority_failed([x["failed"] for x in vs])
        got = grad_rel(k[what], p[what])
        rel = {"kernels": all_rel(k[what], p[what]), "reversed": all_rel(r[what], p[what])}
        v = vs[0]
        floor, zero, noisy, held = v["floor"], v["zero"], v["noisy"], v["held"]
        bad = [t for t in failed if t != "all tensors" and t not in noisy]
        worst = max(held or got, key=lambda t: got[t] - a * floor[t])
        check(not bad, f"train step, free-running {what}: every tensor's relative L2 to the "
              f"plain step <= {a} x the reordered runs' ({len(orders)}) + {b0} (a bound on "
              f"the drift; worst {worst}: {got[worst]:.3e}, "
              f"reordered {floor[worst]:.3e}; {len(v['bad'])} over, {len(bad)} over{votes})")
        if noisy:
            over = [t for t in failed if t in noisy]
            check(not over, f"train step, free-running {what}: the {len(noisy)} "
                  f"noise-dominated tensors (reordered drift >= {STEP_NOISE}) within "
                  f"{STEP_NOISE_SLACK} x their drift{votes}: " + ", ".join(
                      f"{t} {got[t]:.2e} / {floor[t]:.2e}" for t in noisy))
            out[f"{what}_noise_dominated"] = {t: (got[t], floor[t]) for t in noisy}
        if kernel_orders > 1:
            out[f"{what}_over_by_kernel_order"] = [x["failed"] for x in vs]
        if zero:
            out[f"{what}_zero_in_exact_arithmetic"] = {t: (got[t], floor[t]) for t in zero}
            print(f"    {len(zero)} {what} zero in exact arithmetic (conv biases before a "
                  f"train-mode BatchNorm), relative L2 kernels / reordered: "
                  + ", ".join(f"{got[t]:.2e} / {floor[t]:.2e}" for t in zero), flush=True)
        if noise:
            rel["reordered"] = v["floor_all"]
            check("all tensors" not in failed,
                  f"train step, free-running {what}: relative L2 over all tensors "
                  f"{rel['kernels']:.3e} <= {a} x the reordered runs' {rel['reordered']:.3e} + "
                  f"{b0}")
        out[what] = {"worst": worst, "worst_rel_l2": got[worst], "reversed": floor[worst],
                     "median_rel_l2": float(np.median([got[t] for t in held or got])),
                     "median_rel_l2_reversed": float(np.median([floor[t] for t in held or got])),
                     "all_rel_l2": rel}
        line = (f"    train step {what}, relative L2 over all tensors to the plain bf16 step: "
                f"kernels {rel['kernels']:.3e}, plain reversed {rel['reversed']:.3e}")
        if drift:
            f, fr = runs["plain float32"], runs["plain float32, reversed"]
            rel.update(again=all_rel(runs["plain, again"][what], p[what]),
                       float32_reversed=all_rel(fr[what], f[what]),
                       float32_vs_bf16=all_rel(p[what], f[what]))
            out[what]["median_rel_l2_float32_reversed"] = float(np.median(list(
                grad_rel(fr[what], f[what]).values())))
            line += (f", plain again {rel['again']:.3e}; plain float32 reversed to float32 "
                     f"{rel['float32_reversed']:.3e}; plain bf16 to float32 "
                     f"{rel['float32_vs_bf16']:.3e}")
        print(f"{line}; median over tensors {out[what]['median_rel_l2']:.3e} (reversed "
              f"{out[what]['median_rel_l2_reversed']:.3e})", flush=True)
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

    mtd = tr.metadata(batch)

    def forward():
        return tr.model(x, epilogue=tr.sites, mtd=mtd, dropout=tr.generator)

    def forward_backward():
        WeightedCE.apply(forward(), tgt, tr.class_weights, None).backward()

    ms = {"augment_normalize_with_upload": cuda_ms(lambda: tr.prepare(batch, True, ch), 5, 1),
          "forward": cuda_ms(forward, 5, 1),
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


def check_flair_outputs(label: str, cfg: dict, result: dict, test_csv: Path,
                        n_test: int) -> dict:
    """The artifacts of a flair_main run with train, predict and metrics:
    the log, checkpoints, histories, PRED rasters (shape, georeferencing,
    classes) and metrics.json's schema; returns the metrics JSON."""
    out = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"])
    name = cfg["paths"]["out_model_name"]
    best = Path(result["train"]["best_path"])
    for rel in ("flair-compute.log", "used_csv_and_config", "metrics.jsonl", "history.json",
                "last", "best", f"predictions_{name}", "metrics/confmat.npy",
                "metrics/metrics.json"):
        check((out / rel).exists(), f"{label} artifact {rel}")
    check(best.exists() and best.name.startswith("ckpt-") and best.name.endswith(f"_{name}"),
          f"{label} best checkpoint {best.name}")
    preds = sorted((out / f"predictions_{name}").glob("PRED_*.tif"))
    check(len(preds) == n_test, f"{label}: {len(preds)} PRED files")
    first = Path(test_csv).read_text().split()[0].split(",")[0]
    with TiffReader(out / f"predictions_{name}" / f"PRED_{Path(first).name}") as r, \
            TiffReader(first) as src:
        check((r.width, r.height, r.count, r.crs) == (S, S, 1, src.crs) and
              r.transform == src.transform, f"{label} PRED raster: 512 x 512 x 1, georeferenced")
        check(int(r.read(1).max()) < K, f"{label} PRED classes in [0, {K})")
    metrics = json.loads((out / "metrics" / "metrics.json").read_text())
    used = sum(1 for v in cfg["classes"].values() if v[0] != 0)
    check(metrics["Avg_metrics_name"] == ["mIoU", "Overall Accuracy", "Fscore", "Precision",
                                          "Recall"]
          and len(metrics["Avg_metrics"]) == 5 and len(metrics["classes"]) == used
          and all(len(metrics[k]) == used for k in ("per_class_iou", "per_class_fscore",
                                                   "per_class_precision", "per_class_recall")),
          f"{label} metrics.json: the reference's schema, {used} classes of weight != 0")
    check(np.load(out / "metrics" / "confmat.npy").shape == (K, K),
          f"{label} confmat.npy (19, 19)")
    return metrics


def counted_flair_main(cfg: dict, conf: Path) -> tuple[dict, dict, float]:
    """cli.flair_main on ``cfg`` (written to ``conf``) with the counts set to
    0 just before it: (its result, the launches, its wall seconds)."""
    conf.write_text(yaml.safe_dump(cfg))
    reset_launches()
    t0 = time.perf_counter()
    result = cli.flair_main([f"--conf={conf}"])
    wall = time.perf_counter() - t0
    return result, read_launches(), wall


def check_flair_run(label: str, cfg: dict, result: dict, launches: dict, counts: dict,
                    predict_batches: int) -> list:
    """A run's launches against its steps x sites (each augment_normalize
    through the tiled instance), its epochs and finite losses; returns the
    (train, val) losses by epoch."""
    history = result["train"]["history"]
    epochs = result["train"]["epochs"]
    micro = int(cfg.get("accumulate_steps", 1))
    steps = sum(e["train_patches"] for e in epochs) // TRAIN_BATCH
    n_val = sum(n for split, n in FLAIR_SPLITS if split == "val")
    eval_batches = (len(epochs) + 1) * (n_val // TRAIN_BATCH)  # each epoch, and the final validate
    check_launches(f"{label}: {steps} train steps of {micro} microbatch(es), {eval_batches} eval "
                   f"and {predict_batches} predict batches", launches,
                   flair_expected(counts, steps, eval_batches, predict_batches, micro))
    check(au.tiled_launches == launches["augment_normalize"],
          f"{label}: all {launches['augment_normalize']} augment_normalize launches took the "
          f"tiled instance ({au.tiled_launches})")
    losses = [(h["train_loss"], h["val_loss"]) for h in history]
    check(all(np.isfinite(v) for pair in losses for v in pair),
          f"{label}: every epoch's train and val loss finite: " +
          ", ".join(f"{a:.4f}/{b:.4f}" for a, b in losses))
    return losses


def first_batch(cfg: dict, split: str = "train") -> dict:
    ds = PatchDataset(gather_paths(cfg, split), cfg["channels"],
                      use_metadata=bool(cfg.get("use_metadata")))
    batches = iter(PatchLoader(ds, TRAIN_BATCH, pin=True))
    batch = next(batches)
    batches.close()
    return batch


def run_flair(tmp: Path, rng, card: str, profile: bool = False) -> dict:
    """Phase 4: flair train / predict / metrics through cli.flair_main at
    the config's full width, then one train step against the plain versions
    (and with ``profile`` the train step's breakdown)."""
    t0 = time.perf_counter()
    csvs = write_flair_dataset(tmp / "flair", rng)
    cfg = flair_config(tmp / "flair", csvs)
    print(f"    wrote {sum(n for _, n in FLAIR_SPLITS)} patches of {S}x{S}x{C} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    counts = train_site_counts(FlairSegmentationModel("resnet34", K, C))

    result, launches, wall = counted_flair_main(cfg, tmp / "flair" / "flair.yaml")
    n_train, n_val, n_test = (n for _, n in FLAIR_SPLITS)
    steps = FLAIR_EPOCHS * (n_train // TRAIN_BATCH)
    history = result["train"]["history"]
    eval_batches = (len(history) + 1) * (n_val // TRAIN_BATCH)
    predict_batches = -(-n_test // TRAIN_BATCH)
    losses = check_flair_run("flair", cfg, result, launches, counts, predict_batches)
    check(len(history) == FLAIR_EPOCHS, f"flair: {len(history)} epochs")
    metrics = check_flair_outputs("flair", cfg, result, csvs["test"], n_test)

    best = Path(result["train"]["best_path"])
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
    batch = first_batch(cfg)
    step = compare_train_step(cfg, state, batch, counts)
    out = {"stats": stats, "launches": launches, "step": step, "cfg": cfg, "csvs": csvs,
           "counts": counts, "history": history}
    if profile:
        out["breakdown"] = train_breakdown(cfg, state, batch)
    return out


# -- phase 4b: the reference's best configuration ---------------------------

META_TEST = 20  # 4b's test patches: not a multiple of the batch, so predict pads mtd
META_EPOCHS = 2
META_CAMERAS = ("UCE-M3-f120-s06", "UCE-M1-f100-s03", "ADS100-f-A-s03", "DMC-f-B-s04")


def write_metadata_json(path: Path, csvs: list, rng) -> None:
    """flair_aerial_metadata.json for every image of ``csvs``, keyed by file
    stem: Lambert-93 centroids over France, altitudes, UCE and other
    cameras, dates in 2018-2021 and HHhMM times."""
    meta = {}
    for csv in csvs:
        for row in Path(csv).read_text().split():
            meta[Path(row.split(",")[0]).stem] = {
                "patch_centroid_x": float(rng.uniform(100000, 1200000)),
                "patch_centroid_y": float(rng.uniform(6050000, 7100000)),
                "patch_centroid_z": float(rng.uniform(0, 3000)),
                "camera": META_CAMERAS[int(rng.integers(0, len(META_CAMERAS)))],
                "date": f"{int(rng.integers(2018, 2022))}-{int(rng.integers(1, 13)):02d}-"
                        f"{int(rng.integers(1, 29)):02d}",
                "time": f"{int(rng.integers(0, 24)):02d}h{int(rng.integers(0, 60)):02d}"}
    path.write_text(json.dumps(meta))


def resnet34_classifier(rng) -> dict:
    """A torchvision-keyed resnet34 ImageNet classifier state dict from a
    numpy seed (3 input channels, random BatchNorm statistics, the fc head)."""
    sd = {}
    for k, v in FlairSegmentationModel("resnet34", K, 3).encoder.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, tuple(v.shape))
        elif v.dim() == 1:
            a = rng.normal(0.0 if "bias" in k or "mean" in k else 1.0, 0.1, tuple(v.shape))
        else:
            a = rng.standard_normal(tuple(v.shape)) * np.sqrt(2.0 / v[0].numel())
        sd[k] = torch.from_numpy(a.astype(np.float32))
    sd["fc.weight"] = torch.from_numpy((rng.standard_normal((1000, 512)) * 0.03).astype(
        np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def profiled_device_ms(fn, reps: int = 20) -> float:
    """The device time of fn()'s kernels a call, by the profiler: for calls
    of a few small kernels the events around back-to-back calls measure the
    host's issue time instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / reps


def metadata_ms(cfg: dict, state: dict, batch: dict, masks) -> dict:
    """The metadata MLP and its fusion at the step's shapes, forward and
    forward + backward, the plain PyTorch ops a step adds: call time (CUDA
    events around back-to-back calls) and device time (the profiler)."""
    from flairtpu_torch.models.metadata_mlp import fuse_metadata

    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    mtd = tr.metadata(batch)
    emb = tr.model.enc(mtd, masks)
    g_emb = torch.randn_like(emb)
    feat = torch.randn((TRAIN_BATCH, 512, S // 32, S // 32), device="cuda",
                       dtype=tr.dtype).contiguous(memory_format=torch.channels_last)
    feat.requires_grad_()
    g_feat = torch.randn_like(feat)
    leaf = emb.detach().requires_grad_()
    fns = {"mlp_forward": lambda: tr.model.enc(mtd, masks),
           "mlp_forward_backward": lambda: torch.autograd.backward(tr.model.enc(mtd, masks),
                                                                   g_emb),
           "fusion_forward": lambda: fuse_metadata(feat, leaf),
           "fusion_forward_backward": lambda: torch.autograd.backward(
               fuse_metadata(feat, leaf), g_feat)}
    out = {}
    for name, fn in fns.items():
        out[f"{name}_call"] = cuda_ms(fn)
        out[f"{name}_device"] = profiled_device_ms(fn)
    del tr
    torch.cuda.empty_cache()
    return out


def run_flair_metadata(tmp: Path, rng, card: str, main: dict, profile: bool = False) -> dict:
    """Phase 4b: the reference's best configuration (U-Net/ResNet34 with
    metadata and augmentation) with init_encoder_weights, through
    cli.flair_main for META_EPOCHS epochs, predict over a test split that is
    not a multiple of the batch, metrics; then one metadata train step
    against the plain step on the same operands and dropout masks."""
    from flairtpu_torch.models.metadata_mlp import MetadataMLP

    root = tmp / "flair"
    csvs, counts = main["csvs"], main["counts"]
    test = write_flair_dataset(root, rng, (("test_meta", META_TEST),),
                               first=sum(n for _, n in FLAIR_SPLITS))["test_meta"]
    js = root / "flair_aerial_metadata.json"
    write_metadata_json(js, [csvs["train"], csvs["val"], test], rng)
    clf = root / "resnet34_classifier.pth"
    torch.save(resnet34_classifier(rng), clf)
    cfg = flair_config(root, csvs)
    cfg["paths"].update(out_folder=str(root / "out_meta"), test_csv=str(test),
                        path_metadata_aerial=str(js))
    cfg.update(use_metadata=True, init_encoder_weights=str(clf), num_epochs=META_EPOCHS)

    result, launches, wall = counted_flair_main(cfg, root / "flair_meta.yaml")
    predict_batches = -(-META_TEST // TRAIN_BATCH)
    losses = check_flair_run("flair metadata", cfg, result, launches, counts, predict_batches)
    check(len(result["train"]["history"]) == META_EPOCHS,
          f"flair metadata: {len(result['train']['history'])} epochs")
    metrics = check_flair_outputs("flair metadata", cfg, result, test, META_TEST)
    log = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"],
               "flair-compute.log").read_text()
    check("encoder initialized from classifier weights" in log,
          "flair metadata: the encoder initialized from the classifier .pth")
    pred = result["predict"]
    check(pred["patches"] == META_TEST, f"flair metadata: {pred['patches']} patches predicted "
          f"in {predict_batches} batches, the last padded")
    epochs = result["train"]["epochs"]
    train_ps = (sum(e["train_patches"] for e in epochs[1:]) /
                sum(e["train_seconds"] for e in epochs[1:]))
    stats = {"train_patches_per_sec_from_epoch_2": train_ps,
             "train_seconds_by_epoch": [e["train_seconds"] for e in epochs],
             "loader_wait_seconds_by_epoch": [e["loader_wait_seconds"] for e in epochs],
             "predict_patches_per_sec": pred["patches"] / pred["seconds"],
             "predict_seconds": pred["seconds"], "losses": losses,
             "miou": metrics["Avg_metrics"][0], "flair_main_wall_seconds": wall, "card": card}
    print(f"  flair metadata on {card}: train {train_ps:.2f} patches/s from epoch 2 (loader "
          f"wait {', '.join(f'{w:.3f}' for w in stats['loader_wait_seconds_by_epoch'])} s of "
          f"{', '.join(f'{t:.3f}' for t in stats['train_seconds_by_epoch'])} s a epoch), "
          f"predict {stats['predict_patches_per_sec']:.2f} patches/s ({pred['patches']} "
          f"patches, {predict_batches} batches, first call), losses "
          f"{', '.join(f'{a:.4f}/{b:.4f}' for a, b in losses)}, flair_main wall {wall:.1f} s",
          flush=True)

    print("  one metadata train step, kernels against plain versions (same weights, batch, "
          "choices, dropout masks)", flush=True)
    state = ckpt_lib.CheckpointManager.restore(result["train"]["best_path"])
    batch = first_batch(cfg)
    masks = [{"enc": MetadataMLP().draw_masks(TRAIN_BATCH,
                                              torch.Generator("cuda").manual_seed(SEED))}]
    step = compare_train_step(cfg, state, batch, counts, masks, drift=False)
    out = {"stats": stats, "launches": launches, "step": step}
    if profile:
        out["metadata_ms"] = metadata_ms(cfg, state, batch, masks[0]["enc"])
        out["breakdown"] = train_breakdown(cfg, state, batch)
    return out


# -- phase 4c: accumulate_steps, resume, the step autosave -------------------

def a1_config(cfg: dict, root: Path, name: str, **over) -> dict:
    """``cfg`` training only, into its own out_folder."""
    out = dict(cfg, **over)
    out["paths"] = dict(cfg["paths"], out_folder=str(root / name))
    out["tasks"] = dict(cfg["tasks"], predict=False, metrics=False)
    return out


def run_flair_a1(tmp: Path, main: dict) -> dict:
    """Phase 4c: accumulate_steps 2 for one epoch (launches, then one
    accumulated step against the plain accumulated step); a run resumed from
    the main run's ``last`` checkpoint (the restored state bit for bit, the
    run going on at the next epoch); a step autosave resumed mid-epoch."""
    root = tmp / "flair"
    cfg, counts = main["cfg"], main["counts"]
    n_train = FLAIR_SPLITS[0][1]
    out = {}

    acfg = a1_config(cfg, root, "out_accum", accumulate_steps=2, num_epochs=1)
    result, launches, _ = counted_flair_main(acfg, root / "flair_accum.yaml")
    check_flair_run("flair accumulate_steps 2", acfg, result, launches, counts, 0)
    print("  one accumulated step (2 microbatches), kernels against plain versions",
          flush=True)
    state = ckpt_lib.CheckpointManager.restore(result["train"]["best_path"])
    out["accumulate"] = {"launches": launches,
                         "step": compare_train_step(acfg, state, first_batch(acfg), counts,
                                                    drift=False)}

    last = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"], "last")
    saved = ckpt_lib.CheckpointManager.restore(last)
    tr = SegmentationTrainer(cfg)
    tr.load_state(saved)
    got = tr.model.state_dict()
    same = all(torch.equal(got[k].cpu(), v) for k, v in saved["state_dict"].items())
    check(same and set(got) >= set(saved["state_dict"]) and
          tr.opt.state_dict() == saved["opt_state"] and saved["epoch"] == FLAIR_EPOCHS - 1,
          f"flair resume: the state restored from last (epoch {saved['epoch']}) equals the "
          f"saved one bit for bit, {len(saved['state_dict'])} tensors and the optimizer's")
    gen_state = tr.generator.get_state()
    del tr
    rcfg = a1_config(cfg, root, "out_resume", num_epochs=FLAIR_EPOCHS + 1)
    rcfg["paths"]["ckpt_model_path"] = str(last)
    rcfg["tasks"]["train_tasks"] = dict(cfg["tasks"]["train_tasks"],
                                        resume_training_from_ckpt=True)
    result, launches, _ = counted_flair_main(rcfg, root / "flair_resume.yaml")
    check_flair_run("flair resume", rcfg, result, launches, counts, 0)
    epochs = [h["epoch"] for h in result["train"]["history"]]
    check(epochs == [FLAIR_EPOCHS], f"flair resume: went on at epoch {epochs}")
    out["resume"] = {"launches": launches, "epochs": epochs}

    scfg = a1_config(cfg, root, "out_autosave", autosave_every_steps=1, num_epochs=2)
    run_dir = Path(scfg["paths"]["out_folder"], scfg["paths"]["out_model_name"])
    ckpt_lib.StepAutosaver(run_dir, 1).save(
        {"state_dict": saved["state_dict"], "opt_state": saved["opt_state"],
         "generator": gen_state, "cm_sum": torch.zeros((K, K), dtype=torch.int64)},
        {"epoch": 1, "step": 1, "loss_sum": 3.0, "n_batches": 1,
         "plateau": {"lr": float(cfg["learning_rate"]), "best": None, "num_bad_epochs": 0,
                     "cooldown_counter": 0},
         "stopper": {"best": None, "wait": 0, "stopped": False},
         "manager": {"best_metric": None, "best_path": None},
         "history": main["history"][:1]})
    result, launches, _ = counted_flair_main(scfg, root / "flair_autosave.yaml")
    check_flair_run("flair autosave resume", scfg, result, launches, counts, 0)
    epochs = [h["epoch"] for h in result["train"]["history"]]
    patches = [e["train_patches"] for e in result["train"]["epochs"]]
    check(epochs == [0, 1] and patches == [n_train - TRAIN_BATCH]
          and not (run_dir / "autosave").exists(),
          f"flair autosave: resumed at epoch 1 step 1 ({patches} patches trained, history "
          f"epochs {epochs}), the autosave cleared at the end")
    out["autosave"] = {"launches": launches, "epochs": epochs, "train_patches": patches}
    for name, r in out.items():
        print(f"  flair {name}: launches " + ", ".join(f"{k} {v}" for k, v in
                                                      r["launches"].items() if v), flush=True)
    return out


# -- phase 4d: flair with the slice-5 decoders ---------------------------------

# epochs of each arch's flair run (4 steps an epoch): deeplabv3plus's second
# epoch gives its train patches/s past the first steps' warm-up
ARCH_EPOCHS = {"deeplabv3plus": 2}
# phase 4d's other orders of the plain step an arch, STEP_REORDERS_DEFAULT
# for the others: the largest drift of four orders samples PAN's spread too
# low now and then (step_order_study, 30 trained states, 12 orders each:
# the check failed for 0.9-21% of (order, four reorders) pairs a state,
# 8.5% on average over 16 of them, 1.0% with ten)
STEP_REORDERS_DEFAULT = 4
STEP_REORDERS = {"pan": 10}
# phase 4d's orders of the kernels' step an arch (1 for the others), each
# against the plain step in its order beside the plain steps in all the
# others; a tensor fails in more than half of them (majority_failed):
# PAN's kernels' step is now and then an outlier in one order, which no
# number of reorders bounds (step_order_study: encoder.layer4.2.bn2.weight
# 0.625 in one order, 0.17-0.23 in the 11 others, drifts at most 0.232),
# while a fault shows in every order (narrow dgamma x 1.1 failed 100% of
# the three-order sets, narrow dx x 0.9 99.6-100%; clean states none)
STEP_KERNEL_ORDERS = {"pan": 3}
WARM_STEPS = 3  # timed train steps after one untimed, on one batch
# the train-mode dropout of the decoders that have one: (keep probability,
# channels a keep value covers the map of), by arch (models/factory.py:
# DROPOUT_ARCHS)
ARCH_DROPOUT = {"deeplabv3plus": (0.5, False), "deeplabv3": (0.5, False),
                "fpn": (0.8, True), "pspnet": (0.8, True)}


def arch_flair_config(cfg: dict, arch: str, root: Path) -> dict:
    """Phase 4's flair config (configs/flair-1-config.yaml's values) with
    resnet34 ``arch``, into its own out_folder."""
    out = copy.deepcopy(cfg)
    out["paths"]["out_folder"] = str(root / arch)
    out["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = f"resnet34_{arch}"
    out["num_epochs"] = ARCH_EPOCHS.get(arch, 1)
    return out


def decoder_keep(arch: str, batch: int, size: int, gen) -> dict | None:
    """Keep masks for the decoder's dropout of a batch of ``batch`` tiles of
    ``size`` (one microbatch's dict by module name), drawn from ``gen``, or
    None: deeplabv3(plus)'s ASPP output at stride 16 (8), 256 channels, one
    value an element; FPN's merge (128 channels) and PSPNet's fuse (512) one
    value a (sample, channel)."""
    if arch not in ARCH_DROPOUT:
        return None
    keep, channels = ARCH_DROPOUT[arch]
    ch, stride = {"deeplabv3plus": (256, 16), "deeplabv3": (256, 8), "fpn": (128, 4),
                  "pspnet": (512, 8)}[arch]
    shape = (batch, ch, 1, 1) if channels else (batch, ch, size // stride, size // stride)
    return {"decoder": torch.rand(shape, generator=gen, device="cuda") < keep}


def check_predict_tail(cfg: dict, state: dict, batch: dict) -> dict:
    """flair predict's tail at margin 0 into (B, S, S) tiles (strided_tail
    at the arch's U, or fused_tail) on one batch of the trained model's
    tail input, against its plain version: classes equal except where the
    plain logits' top-2 gap is below GAP_TOL (STRIDED_GAP for
    strided_tail), prob within 1; both timed."""
    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    with torch.inference_mode():
        x, _ = tr.prepare(batch)
        xin = tr.model.tail_input(x, 0)
        tail = tr.model.zone_tail()
        kern, plain = tail.wrappers()[0], tail.plain_versions()[0]
        g = tail.geometry(S, 0)
        cls_k, prob_k = kern(xin, tail, g)
        cls_p, prob_p = plain(xin, tail, g)
        strided = isinstance(tail, sp.StridedTail)
        if strided:
            gap, tol = top2_gap_last(sp.upsample_window(xin, g)), STRIDED_GAP
            ops, nbytes = sp.strided_cost(g, ft.full_windows(x.shape[0], S, x.device).cpu()
                                          .numpy(), K, "argmax")
            costs = bound(ops, nbytes, PEAK_FP32_FLOPS)
        else:
            gap = top2_gap_last(ft.tail_logits_plain(xin, tail, g).permute(0, 2, 3, 1))
            tol = GAP_TOL
            nbytes = xin.numel() * xin.element_size() + 2 * x.shape[0] * S * S
            costs = bound(tail_flops(g, x.shape[0], K), nbytes)
        name = (f"{cfg['model_framework']['SegmentationModelsPytorch']['encoder_decoder']} "
                f"predict tail ({'strided_tail, U = %d' % tail.up if strided else 'fused_tail'}"
                f", margin 0, batch {x.shape[0]})")
        out = compare_tail(name, cls_k, prob_k, cls_p, prob_p, gap, tol)
        out.update(kernel="strided_tail" if strided else "fused_tail", up=tail.up,
                   ms=cuda_ms(lambda: kern(xin, tail, g), 10, 2),
                   plain_ms=cuda_ms(lambda: plain(xin, tail, g), 3, 1), bytes=nbytes, **costs)
    del tr
    torch.cuda.empty_cache()
    return out


def warm_rates(cfg: dict, state: dict, batch: dict, out: Path) -> tuple[float, float]:
    """(train, predict) patches/s once warm: WARM_STEPS train steps on one
    batch after one untimed (no loader), and predict over the test split
    again."""
    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    ch = choices_all(TRAIN_BATCH)
    tr.train_step(batch, choices=ch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WARM_STEPS):
        tr.train_step(batch, choices=ch)
    torch.cuda.synchronize()
    train = WARM_STEPS * TRAIN_BATCH / (time.perf_counter() - t0)
    pred = predict(cfg, gather_paths(cfg, "test"), out, tr, progress=lambda _: None)
    del tr
    torch.cuda.empty_cache()
    return train, pred["patches"] / pred["seconds"]


def run_flair_archs(tmp: Path, main: dict) -> dict:
    """Phase 4d: flair (train, predict, metrics through cli.flair_main) for
    each of ARCHS5 on phase 4's written set, a random resnet34 (19 classes)
    at configs/flair-1-config.yaml's values, with the counts set to 0 just
    before each run: its launches against steps x sites, finite losses,
    every artifact; train and predict patches/s and the peak device memory.
    Then one train step from the trained weights on one batch with fixed
    choices and dropout masks, the kernels' step held site by site to the
    plain versions and free-running against the plain step (without the
    float32 runs), and the predict tail on one batch against its plain
    version."""
    n_train, n_val, n_test = (n for _, n in FLAIR_SPLITS)
    (tmp / "flair_archs").mkdir(exist_ok=True)
    print(f"    precision flags, kernels' and plain steps alike: cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    out = {}
    for arch in ARCHS5:
        t0 = time.perf_counter()
        cfg = arch_flair_config(main["cfg"], arch, tmp / "flair_archs")
        counts = train_site_counts(FlairSegmentationModel("resnet34", K, C, arch=arch))
        torch.cuda.reset_peak_memory_stats()
        result, launches, wall = counted_flair_main(
            cfg, tmp / "flair_archs" / f"{arch}.yaml")
        peak = torch.cuda.max_memory_allocated() / 1e9
        label = f"flair {arch}"
        losses = check_flair_run(label, cfg, result, launches, counts, -(-n_test // TRAIN_BATCH))
        check_flair_outputs(label, cfg, result, main["csvs"]["test"], n_test)
        epochs = result["train"]["epochs"]
        timed = epochs[1:] or epochs
        train_ps = (sum(e["train_patches"] for e in timed)
                    / sum(e["train_seconds"] for e in timed))
        pred = result["predict"]
        state = ckpt_lib.CheckpointManager.restore(Path(result["train"]["best_path"]))
        batch = first_batch(cfg)
        gen = torch.Generator("cuda").manual_seed(SEED)
        keep = decoder_keep(arch, TRAIN_BATCH, S, gen)
        warm_train, warm_predict = warm_rates(cfg, state, batch,
                                              tmp / "flair_archs" / f"{arch}_predict_warm")
        step = compare_train_step(cfg, state, batch, counts,
                                  None if keep is None else [keep], drift=False,
                                  reorders=STEP_REORDERS.get(arch, STEP_REORDERS_DEFAULT),
                                  noise=True, kernel_orders=STEP_KERNEL_ORDERS.get(arch, 1))
        tail = check_predict_tail(cfg, state, batch)
        r = out[arch] = {
            "train_patches_per_sec": train_ps,
            "train_patches_per_sec_from": "epoch 2" if len(epochs) > 1 else "epoch 1",
            "predict_patches_per_sec": pred["patches"] / pred["seconds"],
            "warm_train_patches_per_sec": warm_train,
            "warm_predict_patches_per_sec": warm_predict,
            "peak_gb": peak, "losses": losses, "flair_main_wall_seconds": wall,
            "launches": launches, "step": step, "predict_tail": tail,
            "seconds": time.perf_counter() - t0}
        print(f"  flair {arch}: train {train_ps:.2f} patches/s ({r['train_patches_per_sec_from']}"
              f", {len(epochs)} epoch(s) of {n_train // TRAIN_BATCH} steps), warm "
              f"{warm_train:.2f} ({WARM_STEPS} steps on one batch); predict "
              f"{r['predict_patches_per_sec']:.2f} patches/s (first call, {pred['patches']} "
              f"patches), warm {warm_predict:.2f}; peak {peak:.2f} GB, losses "
              f"{', '.join(f'{a:.4f}/{b:.4f}' for a, b in losses)}; step loss "
              f"{step['loss']:.5f} vs plain {step['plain_loss']:.5f}; predict tail "
              f"{tail['kernel']} {tail['ms']:.4f} ms, plain {tail['plain_ms']:.4f} ms, bound "
              f"{tail['bound_ms']:.4f} ms; {r['seconds']:.1f} s", flush=True)
        for name_, got in launches.items():
            if got:
                print(f"    launches {name_}: {got}")
        del state, batch
        torch.cuda.empty_cache()
    return out


# the tensor whose phase-4d check failed once on PAN (PR 20, call 5)
STUDY_TENSOR = "decoder.fpa.down2.1.bn.bias"


def step_order_study(arch: str, n_orders: int, tmp: Path, rng) -> dict:
    """The sample-order study of ``arch``'s phase-4d step check: phase 4's
    written set, the arch's flair run (random resnet34, as phase 4d), then
    from its best weights the kernels' step (CheckedTrainer) and the plain
    step on phase 4d's batch in each of ``n_orders`` sample orders (the
    identity, then sample_orders). For each order o: the relative L2 of
    each tensor and of the loss between the kernels' and the plain step in
    o ("got"), and between the plain steps of o and of each other order
    (a reorder's drift). Reports STUDY_TENSOR's and the loss's got beside
    the largest drift over the other orders, the spread of got against the
    spread of the drifts, and the share of (order, set of k reorders)
    pairs for which phase 4d's check (free_running_verdict of the
    gradients and of the running statistics, and loss_tolerance) fails,
    for k = 4 (the check as PR 20 made it) up to n_orders - 1, and which
    tensors fail it; the share of (left-out order, set of
    STEP_KERNEL_ORDERS kernel orders) for which the check as phase 4d runs
    it fails (n_orders - 2 reorders, majority_failed); and the site-by-site
    check's worst error of each part over the kernels' steps beside its
    limit (step_site_limits)."""
    (tmp / "flair_archs").mkdir(parents=True, exist_ok=True)
    csvs = write_flair_dataset(tmp / "flair", rng)
    cfg = arch_flair_config(flair_config(tmp / "flair", csvs), arch, tmp / "flair_archs")
    result, _, _ = counted_flair_main(cfg, tmp / "flair_archs" / f"{arch}.yaml")
    state = ckpt_lib.CheckpointManager.restore(Path(result["train"]["best_path"]))
    batch = first_batch(cfg)
    keep = decoder_keep(arch, TRAIN_BATCH, S, torch.Generator("cuda").manual_seed(SEED))
    choices = choices_all(TRAIN_BATCH)
    orders = {"identity": torch.arange(TRAIN_BATCH), **sample_orders(TRAIN_BATCH, n_orders - 1)}
    kern, plain, checkers = {}, {}, []
    for name, idx in orders.items():
        b = {k: v[idx] for k, v in batch.items() if k != "id"}
        ch = choices[idx.to(choices.device)].contiguous()
        mk = keep and [permute_masks(keep, idx)]
        checkers.append(StepChecker())
        for runs, make in ((kern, lambda: CheckedTrainer(cfg, checkers[-1])),
                           (plain, lambda: PlainTrainer(cfg))):
            trainer = make()
            trainer.load_state(state)
            runs[name] = one_step(trainer, b, ch, mk)
            del trainer
            torch.cuda.empty_cache()
    names = list(orders)
    halves = ("grads", "stats")
    got = {(w, o): grad_rel(kern[o][w], plain[o][w]) for w in halves for o in names}
    got_all = {(w, o): all_rel(kern[o][w], plain[o][w]) for w in halves for o in names}
    got_loss = {o: abs(kern[o]["loss"] - plain[o]["loss"]) / abs(plain[o]["loss"]) for o in names}
    drift, drift_all, drift_loss = {}, {}, {}
    for o in names:
        for t in names:
            if t != o:
                for w in halves:
                    drift[w, o, t] = grad_rel(plain[t][w], plain[o][w])
                    drift_all[w, o, t] = all_rel(plain[t][w], plain[o][w])
                drift_loss[o, t] = abs(plain[t]["loss"] - plain[o]["loss"]) / abs(
                    plain[o]["loss"])
    rows = []
    for o in names:
        others = [t for t in names if t != o]
        rows.append({"order": o, "got": got["grads", o][STUDY_TENSOR],
                     "drift_max": max(drift["grads", o, t][STUDY_TENSOR] for t in others),
                     "drift_first_4": max(drift["grads", o, t][STUDY_TENSOR]
                                          for t in others[:4]),
                     "loss_got": got_loss[o], "loss_drift_max": max(drift_loss[o, t]
                                                                    for t in others)})
    fails: dict = {}
    for k in range(4, n_orders):
        pairs = failed = 0
        which: dict = {}
        for o in names:
            others = [t for t in names if t != o]
            for subset in itertools.combinations(others, k):
                bad = [f"{w} {t}" for w in halves for t in free_running_verdict(
                    got[w, o], [drift[w, o, t] for t in subset], got_all[w, o],
                    [drift_all[w, o, t] for t in subset], True)["failed"]]
                if got_loss[o] > loss_tolerance([drift_loss[o, t] for t in subset], True):
                    bad.append("loss")
                pairs += 1
                failed += bool(bad)
                for t in bad:
                    which[t] = which.get(t, 0) + 1
        fails[k] = {"pairs": pairs, "failed": failed, "share": failed / pairs,
                    "tensors": dict(sorted(which.items(), key=lambda kv: -kv[1])[:8])}
    # the check as phase 4d runs it: the plain step in the orders but one
    # (x left out: n_orders - 2 reorders), the kernels' step in m of them
    # (STEP_KERNEL_ORDERS), each against the others, failing by majority
    m = STEP_KERNEL_ORDERS.get(arch, 1)
    verdict = {}
    for x in names:
        for o in names:
            if o != x:
                others = [t for t in names if t not in (o, x)]
                bad = [f"{w} {t}" for w in halves for t in free_running_verdict(
                    got[w, o], [drift[w, o, t] for t in others], got_all[w, o],
                    [drift_all[w, o, t] for t in others], True)["failed"]]
                if got_loss[o] > loss_tolerance([drift_loss[o, t] for t in others], True):
                    bad.append("loss")
                verdict[o, x] = bad
    pairs = failed = 0
    which = {}
    for x in names:
        for kern_set in itertools.combinations([o for o in names if o != x], m):
            bad = majority_failed([verdict[o, x] for o in kern_set])
            pairs += 1
            failed += bool(bad)
            for t in bad:
                which[t] = which.get(t, 0) + 1
    majority = {"kernel_orders": m, "reorders": n_orders - 2, "sets": pairs, "failed": failed,
                "share": failed / pairs, "tensors": dict(sorted(which.items(),
                                                                key=lambda kv: -kv[1])[:8])}
    # what fails against all the other orders: each (order, tensor) with
    # its got, the other orders' drifts and its got in every order
    against_all = []
    for o in names:
        others = [t for t in names if t != o]
        for w in halves:
            v = free_running_verdict(got[w, o], [drift[w, o, t] for t in others], got_all[w, o],
                                     [drift_all[w, o, t] for t in others], True)
            against_all += [{"order": o, "half": w, "tensor": t, "got": got[w, o][t],
                             "drifts": sorted(drift[w, o, u][t] for u in others),
                             "got_each_order": [got[w, u][t] for u in names]}
                            for t in v["bad"] + v["over"]]
    spread = {"got": sorted(got["grads", o][STUDY_TENSOR] for o in names),
              "drift": sorted(d[STUDY_TENSOR] for (w, _, _), d in drift.items()
                              if w == "grads")}
    counts = train_site_counts(FlairSegmentationModel("resnet34", K, C, arch=arch))
    limits = step_site_limits(counts["gn"] > 0)
    sites = {part: (max(c.worst[part][0] for c in checkers), limit)
             for part, limit in limits.items()}
    return {"arch": arch, "orders": n_orders, "tensor": STUDY_TENSOR, "rows": rows,
            "fails": fails, "majority": majority, "against_all": against_all, "sites": sites,
            "sites_over": [part for part, (err, limit) in sites.items() if err > limit], "spread_median": {k: float(np.median(v)) for k, v in spread.items()},
            "spread_max": {k: max(v) for k, v in spread.items()},
            "loss_spread": {"got": sorted(got_loss.values()),
                            "drift_median": float(np.median(list(drift_loss.values()))),
                            "drift_max": max(drift_loss.values())}}


# -- phase 5: slice 5's smp decoders on the zone -------------------------------

ARCHS5 = ("deeplabv3plus", "deeplabv3", "fpn", "pspnet", "pan", "linknet", "manet",
          "unetplusplus")
# a class of an arch's raster may differ from its all-plain run's only where
# the plain logits' top-2 gap is below ARCH_GAP: the routes share the
# gather's and the epilogue's bits; the tail's upsample rounds an ulp apart
# (STRIDED_TOL), and FPN's GroupNorm sums in another order, which moves bf16
# roundings of the convolutions after it, as GAP_TOL allows the fused tail
ARCH_GAP = GAP_TOL


class GapRunner(PlainRunner):
    """The all-plain route that also keeps, in ``gap`` (H, W) float32, the
    top-2 gap of the plain logits at each owned pixel (the logits of the
    tail's plain version, of either kind)."""

    gap = None

    def _forward_tiles(self, zone_p, origins, planes, windows):
        x = self._tail_input(zone_p, origins, self.margin)
        self.tail_fns[0](x, self.tail, self.geometry, planes, windows)
        if isinstance(self.tail, sp.StridedTail):
            gap = top2_gap_last(sp.upsample_window(x, self.geometry))
        else:
            gap = top2_gap_last(ft.tail_logits_plain(x, self.tail, self.geometry)
                                .permute(0, 2, 3, 1))
        if self.gap is None:
            self.gap = torch.zeros(planes.shape[1:], dtype=torch.float32, device=planes.device)
        write_windows([self.gap], [gap], windows)


def arch_config(cfg: dict, tmp: Path, arch: str, rng) -> dict:
    """The main configuration with a random resnet34 ``arch`` (19 classes)."""
    weights = tmp / f"resnet34_{arch}_19cl.pth"
    torch.save(random_weights(FlairSegmentationModel("resnet34", K, C, arch=arch), rng), weights)
    return dict(cfg, model_weights=str(weights), output_name=f"zone-{arch}",
                output_path=str(tmp / f"out_{arch}"),
                model_framework={"model_provider": "SegmentationModelsPytorch",
                                 "SegmentationModelsPytorch": {"encoder_decoder":
                                                               f"resnet34_{arch}"}})


def bn_count(module: nn.Module) -> int:
    return sum(isinstance(m, nn.BatchNorm2d) for m in module.modules())


def encoder_sites(model) -> int:
    """conv_epilogue launches of the encoder a batch: every BatchNorm but the
    downsamples' (folded into their block's last site); the folded walk's
    too (one a conv but the downsamples); an EfficientNet's SiLU and
    project sites (its depthwise BatchNorms are squeeze-excite sites)."""
    counts = effnet_counts(model) if hasattr(model, "encoder") else None
    if counts is not None:
        return counts["sites"]
    return bn_count(model.encoder) - sum(getattr(m, "downsample", None) is not None
                                         for m in model.encoder.modules())


def decoder_sites(model, tail) -> int:
    """conv_epilogue launches of the decoder a batch: every BatchNorm but the
    two of the last block, which the fused tail runs."""
    return bn_count(model.decoder) - 2 * isinstance(tail, ft.TailParams)


def arch_sites(model, tail) -> int:
    """conv_epilogue launches per batch, from the model's structure."""
    return encoder_sites(model) + decoder_sites(model, tail)


def arch_launches(model, tail, n_batches: int, method: str = "exact-clipping",
                  output_type: str = "argmax", int8: bool = False) -> dict:
    """Each kernel's launches for one device-route zone run of an smp model
    (the float one, or of a folded or int8 zone model): the gather and each
    BatchNorm site a batch, FPN's seven GroupNorm sites a batch, and the
    tail's mode (or, averaging or max, its logits and the stitch), whose
    kernels the tail's kind names (``fused_tail`` or ``strided_tail``; at
    U = 1 strided_tail's logits are handed through). ``int8``: the int8
    encoder (int8_conv at each of its conv sites, quantize_act at the stem's
    input and the pooled stem output) before the float decoder."""
    out = dict.fromkeys(read_launches(), 0)
    out.update(gather_normalize=n_batches, conv_epilogue=arch_sites(model, tail) * n_batches)
    if int8:
        out.update(int8_conv=bn_count(model.encoder) * n_batches, quantize_act=2 * n_batches,
                   conv_epilogue=decoder_sites(model, tail) * n_batches)
    if model.arch == "fpn":
        out["group_norm_relu"] = len(GN_SITES) * n_batches
    counts = effnet_counts(model) if not int8 else None
    if counts is not None:
        out.update(conv_epilogue_silu=counts["silu"] * n_batches,
                   se_squeeze=counts["se"] * n_batches, se_excite=counts["se"] * n_batches)
    name = "strided_tail" if isinstance(tail, sp.StridedTail) else "fused_tail"
    if output_type == "class_prob":
        out[f"{name}_probs"] = n_batches
    elif method == "exact-clipping":
        out[name] = n_batches
    else:
        out.update(stitch_finalize=1)
        out["merge_max" if method == "max" else "accumulate_probs"] = n_batches
        if tail.up != 1:
            out[f"{name}_logits"] = n_batches
    return out


def compare_arch(label: str, cls, prob, plain: dict, gap: torch.Tensor) -> dict:
    """A raster's class and prob against the all-plain run's: every class
    mismatch where the plain top-2 gap is below ARCH_GAP, prob within 1."""
    off = cls != plain["cls"]
    moved = off & (gap.cpu().numpy()[:cls.shape[0], :cls.shape[1]] >= ARCH_GAP)
    dprob = int(np.abs(plain["prob"].astype(int) - prob.astype(int)).max())
    agree = 1.0 - float(off.mean())
    check(int(moved.sum()) == 0, f"{label} vs plain versions: {int(off.sum())} class "
          f"mismatches, {int(moved.sum())} beyond the near-tie rule (top-2 gap < {ARCH_GAP})")
    check(dprob <= 1, f"{label} vs plain versions: prob |diff| {dprob} <= 1")
    return {"agree_plain": agree, "mismatches": int(off.sum()), "prob_diff_plain": dprob}


def run_arch(cfg: dict, arch: str, zone_hw: int) -> dict:
    """One arch's main path through detect_main (counts set to 0 just
    before, peak device memory from a reset just before) against its
    all-plain run on the same model."""
    device = torch.device("cuda")
    prepared = eng.prepare_model(cfg, device)
    model = prepared[0]
    pc = eng.setup_out_path(dict(cfg, compare=False))
    with TiffReader(pc["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, S, M, S - 2 * M, reader.transform,
                          reader.crs)
    runner = GapRunner(pc, *prepared)
    t0 = time.perf_counter()
    plain = runner.run(grid, "exact-clipping", eng.stage_zone(pc, device))
    plain_wall = time.perf_counter() - t0
    conf = write_conf(cfg, f"arch_{arch}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    stats = cli.detect_main([f"--conf={conf}"])
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-len(grid.tiles) // BATCH)
    check_launches(f"{arch} main path, {n_batches} batches", launches,
                   arch_launches(model, prepared[1], n_batches))
    with TiffReader(cfg["input_img_path"]) as src, TiffReader(
            Path(cfg["output_path"]) / f"{cfg['output_name']}.tif") as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, 2),
              f"{arch}: output raster {r.width}x{r.height}x{r.count}")
        check(r.transform == src.transform and r.crs == src.crs,
              f"{arch}: georeferencing kept (crs {r.crs})")
        cls, prob = r.read(1), r.read(2)
    check(bool((prob > 0).all()), f"{arch}: every pixel written (prob > 0)")
    check(int(cls.max()) < K, f"{arch}: classes in [0, {K})")
    out = compare_arch(arch, cls, prob, plain, runner.gap)
    keep = {k: stats[k] for k in ("tiles", "seconds", "patches_per_sec", "read_seconds",
                                  "h2d_seconds", "compute_seconds", "d2h_seconds")}
    out.update(keep, launches=launches, peak_memory_gb=peak / 1e9,
               plain_compute_seconds=plain["compute_seconds"], plain_wall_seconds=plain_wall,
               sites=arch_sites(model, prepared[1]), tail=type(prepared[1]).__name__)
    print(f"  {arch}: {stats['tiles']} tiles, compute {stats['compute_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s, peak memory {peak / 1e9:.2f} GB, "
          f"{out['sites']} epilogue sites a batch; plain compute "
          f"{plain['compute_seconds']:.4f} s; class agreement {out['agree_plain']:.6f} "
          f"({out['mismatches']} near-tie mismatches)", flush=True)
    del prepared, model, runner
    torch.cuda.empty_cache()
    return out


def run_arch_class_prob(cfg: dict, zone_hw: int) -> dict:
    """class_prob of an arch through detect_main against its all-plain run:
    a K-band raster, the tail's probs mode once a batch, every band within 1."""
    cp = dict(cfg, output_type="class_prob", output_name=f"{cfg['output_name']}-PROBS")
    conf = write_conf(cp, f"{cp['output_name']}")
    device = torch.device("cuda")
    prepared = eng.prepare_model(cp, device)
    reset_launches()
    stats = cli.detect_main([f"--conf={conf}"])
    launches = read_launches()
    n_batches = -(-len(slice_grid(zone_hw, zone_hw, S, M).tiles) // BATCH)
    check_launches(f"{cp['output_name']}, {n_batches} batches", launches,
                   arch_launches(*prepared, n_batches, output_type="class_prob"))
    with TiffReader(Path(cp["output_path"]) / f"{cp['output_name']}.tif") as r:
        check((r.width, r.height, r.count) == (zone_hw, zone_hw, K),
              f"{cp['output_name']}: raster {r.width}x{r.height}x{r.count}")
        probs = r.read()
    plain = run_plain(cp, prepared=prepared)["probs"]
    d = int(np.abs(plain.astype(np.int16) - probs.astype(np.int16)).max())
    check(d <= 1, f"{cp['output_name']} vs plain versions: every band |diff| {d} <= 1 "
          f"({float((plain == probs).mean()):.6f} of bytes equal)")
    print(f"  {cp['output_name']}: compute {stats['compute_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s", flush=True)
    return {"compute_seconds": stats["compute_seconds"],
            "patches_per_sec": stats["patches_per_sec"], "launches": launches,
            "max_abs_err": d}


def run_arch_sweep(cfg: dict, zone_hw: int) -> dict:
    """``detect_main -c -m`` of an arch with the compare config's strategies
    at one size (512: the four stitching methods), each run's launches and
    each against its all-plain run."""
    sw = sweep_config(cfg)
    strategies = json.loads(json.dumps(sw["strategies"]))
    strategies["tiling"]["size_range"] = [S]
    sw.update(strategies=strategies, output_name=f"{cfg['output_name']}-S",
              output_path=str(Path(cfg["output_path"]).parent / f"{cfg['output_name']}_sweep"))
    conf = write_conf(sw, sw["output_name"])
    with counted_runs() as per_run:
        results = cli.detect_main([f"--conf={conf}", "-c", "-m"])
    combos = [(c["img_pixels_detection"], c["margin"], c["stride"], c["stitching"])
              for c in gen_param_combination(validate_detect_config(dict(sw, compare=True)))]
    check(len(combos) == 4 and len(per_run) == 4, f"{sw['output_name']}: {len(per_run)} runs")
    stamped = [p for p in Path(sw["output_path"]).iterdir() if p.is_dir()]
    device = torch.device("cuda")
    prepared = eng.prepare_model(sw, device)
    staged = eng.stage_zone(sw, device)
    out = {}
    for sz, mg, sd, m in combos:
        method = method_string(sz, sd, mg, "no-padding", m)
        n_batches = -(-len(slice_grid(zone_hw, zone_hw, sz, mg, sd).tiles) // sw["batch_size"])
        check_launches(f"{sw['output_name']} {method}", per_run[method],
                       arch_launches(*prepared, n_batches, m))
        plain = run_plain(dict(sw, img_pixels_detection=sz, margin=mg), m, sd, staged,
                          prepared)
        with TiffReader(stamped[0] / f"{sw['output_name']}_{method}.tif") as r:
            cls, prob = r.read(1), r.read(2)
        agree = float((plain["cls"] == cls).mean())
        dprob = int(np.abs(plain["prob"].astype(int) - prob.astype(int)).max())
        check(agree >= 0.999, f"{sw['output_name']} {method} vs plain versions: class "
              f"agreement {agree:.6f} >= 0.999")
        check(dprob <= 1, f"{sw['output_name']} {method} vs plain versions: prob |diff| "
              f"{dprob} <= 1")
        r_ = results[method]
        out[m] = {"compute_seconds": r_["compute_seconds"],
                  "patches_per_sec": r_["patches_per_sec"], "agree_plain": agree,
                  "launches": per_run[method]}
        print(f"  {sw['output_name']} {m}: {r_['tiles']} tiles, compute "
              f"{r_['compute_seconds']:.4f} s, {r_['patches_per_sec']:.2f} patches/s, "
              f"agreement with plain {agree:.6f}", flush=True)
    return out


def arch_breakdown(cfg: dict, zone_hw: int, profile: bool = False) -> dict:
    """Where one main-path batch of an arch goes, by CUDA events around each
    stage (each stage three times, the last taken): gather, encoder, then a
    strided-head model's decoder, head and strided_tail, or a fused-tail
    model's decoder through the node before the last (whole tiles), the crop
    to block 3's interior extent and fused_tail; the decoder's 4x resize by
    F.interpolate (the port's) beside the dense weight-matrix einsum
    (flairtpu's TPU choice) at its shape; with ``profile`` the profiler's
    kernel table of the batch."""
    device = torch.device("cuda")
    model, tail = eng.prepare_model(cfg, device)
    runner = DeviceZoneRunner(cfg, model, tail)
    staged = eng.stage_zone(cfg, device)
    zone = staged["zone_dev"]
    zp = torch.zeros((zone.shape[0] + 2 * M, zone.shape[1] + 2 * M, C), dtype=zone.dtype,
                     device=device)
    zp[M:-M, M:-M] = zone
    tiles = slice_grid(zone_hw, zone_hw, S, M).tiles[:BATCH]
    org = torch.tensor([(t.row0 + M, t.col0 + M) for t in tiles], dtype=torch.int32,
                       device=device)
    planes = torch.zeros((2, zone_hw, zone_hw), dtype=torch.uint8, device=device)
    win = torch.from_numpy(exact_windows(tiles, zone_hw, zone_hw, S - 2 * M, BATCH)).to(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    strided = isinstance(tail, sp.StridedTail)
    lo, hi = plan_inner_crops(S, M)[-2]["post"]
    for _ in range(3):
        ev[0].record()
        x = ga.gather_normalize(zp, org, S, out_dtype=model.dtype, **runner.norm)
        ev[1].record()
        feats = model.features(x)
        ev[2].record()
        if strided:
            y = model.decoder(feats)
            ev[3].record()
            y = model.segmentation_head(y).permute(0, 2, 3, 1).contiguous()
        else:
            y = model.decoder.penultimate(feats)
            ev[3].record()
            y = y[:, :, lo:hi, lo:hi].contiguous(memory_format=torch.channels_last)
        ev[4].record()
        runner.tail_fns[0](y, tail, runner.geometry, planes, win)
        ev[5].record()
        torch.cuda.synchronize()
    names = (("gather", "encoder", "decoder", "head", "strided_tail") if strided else
             ("gather", "encoder", "decoder_blocks_0_3", "crop", "fused_tail"))
    out = {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}
    out["batch"] = ev[0].elapsed_time(ev[5])
    if cfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"].endswith(
            "deeplabv3plus"):
        a = torch.randn((BATCH, 32, 32, 256), device=device).to(torch.bfloat16)
        a = a.permute(0, 3, 1, 2)
        w = torch.from_numpy(align_corners_weights(128, 32)).to(device, torch.bfloat16)
        out["resize_interpolate_ms"] = cuda_ms(lambda: F.interpolate(
            a, size=(128, 128), mode="bilinear", align_corners=True), 10, 2)
        out["resize_einsum_ms"] = cuda_ms(lambda: torch.einsum(
            "pw,bcow->bcop", w, torch.einsum("oh,bchw->bcow", w, a)), 10, 2)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner._forward_tiles(zp, org, planes, win)
            torch.cuda.synchronize()
        out["kernel_table"] = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    del model, runner, zp
    torch.cuda.empty_cache()
    return out


def run_archs(cfg: dict, tmp: Path, zone_hw: int,
              profile: bool = False) -> tuple[dict, dict]:
    """Phase 5: the eight archs on the main configuration, deeplabv3plus (the
    strided tail) and manet (the fused tail on a whole-tile decode) also
    with class_prob and a one-size sweep, and their batch breakdowns.
    Returns (results, each arch's configuration)."""
    rng = np.random.default_rng(SEED + 5)
    out, configs = {}, {}
    for arch in ARCHS5:
        configs[arch] = acfg = arch_config(cfg, tmp, arch, rng)
        out[arch] = run_arch(acfg, arch, zone_hw)
        out[arch]["breakdown_ms"] = arch_breakdown(acfg, zone_hw, profile)
        if arch in ("deeplabv3plus", "manet"):
            out[arch]["class_prob"] = run_arch_class_prob(acfg, zone_hw)
            out[arch]["sweep"] = run_arch_sweep(acfg, zone_hw)
    return out, configs


# -- phase 5b: bn_fold and int8 with the archs other than the U-Net -----------

# on the main zone: a strided tail over a dilated encoder, and the fused tail
# over the largest whole-tile decode; the other archs int8 on ZONE_SMALL
KNOB_ARCHS_MAIN = ("deeplabv3", "unetplusplus")


def run_arch_knob(acfg: dict, label: str, knobs: dict, zone_hw: int, floor: float,
                  float_raster: np.ndarray) -> dict:
    """detect_main of an arch's configuration with ``knobs``, the counts set
    to 0 just before it: its launches (the int8 encoder's counted from its
    walk), raster shape and coverage; against its all-plain run on the same
    model (GapRunner: no class moved where the plain top-2 gap is at least
    ARCH_GAP, prob |diff| <= 1) and against the float model's raster of the
    zone (class agreement >= ``floor``); patches/s and calibration seconds."""
    device = torch.device("cuda")
    kc = dict(acfg, output_path=str(Path(acfg["output_path"]).parent / f"out_{label}"), **knobs)
    conf = write_conf(kc, label)
    with captured_models() as models:
        reset_launches()
        stats = cli.detect_main([f"--conf={conf}"])
        launches = read_launches()
    zone_model, tail = models[0]
    pc = eng.setup_out_path(dict(kc, compare=False))
    with TiffReader(pc["input_img_path"]) as reader:
        grid = slice_grid(reader.width, reader.height, S, M, S - 2 * M, reader.transform,
                          reader.crs)
    n_batches = -(-len(grid.tiles) // BATCH)
    check_launches(f"{label}, {n_batches} batches", launches,
                   arch_launches(zone_model.model, tail, n_batches,
                                 int8=bool(knobs.get("quantize"))))
    have = read_raster(Path(kc["output_path"]) / f"{kc['output_name']}.tif")
    check(have.shape == (2, zone_hw, zone_hw) and bool((have[1] > 0).all()),
          f"{label}: raster {have.shape}, every pixel written")
    runner = GapRunner(pc, zone_model, tail)
    plain = runner.run(grid, "exact-clipping", eng.stage_zone(pc, device))
    out = compare_arch(label, have[0], have[1], plain, runner.gap)
    agree_float = float((float_raster[0] == have[0]).mean())
    check(agree_float >= floor, f"{label} vs the float model: class agreement "
          f"{agree_float:.6f} >= {floor}")
    calib = stats.get("calibration_seconds")
    print(f"  {label}: {stats['tiles']} tiles, compute {stats['compute_seconds']:.4f} s, "
          f"{stats['patches_per_sec']:.2f} patches/s"
          + (f", calibration {calib:.4f} s" if calib is not None else "")
          + f"; agreement with the float model {agree_float:.6f}", flush=True)
    keep = ("tiles", "seconds", "patches_per_sec", "compute_seconds", "calibration_seconds")
    del models, zone_model, runner
    torch.cuda.empty_cache()
    return {**{k: stats[k] for k in keep if k in stats}, **out, "agree_float": agree_float,
            "launches": launches}


def run_arch_knobs(configs: dict, tmp: Path, zone_hw: int) -> dict:
    """Phase 5b: bn_fold and int8 (INT8_KNOBS: int8_decoder is ignored off
    the U-Net) for KNOB_ARCHS_MAIN on the main zone, each against the arch's
    float raster of phase 5; int8 for the other archs on phase 3g's
    ZONE_SMALL zone, each against its float raster of that zone."""
    out = {}
    for arch in KNOB_ARCHS_MAIN:
        acfg = configs[arch]
        float_raster = read_raster(Path(acfg["output_path"]) / f"{acfg['output_name']}.tif")
        for label, knobs, floor in (("bn_fold", {"bn_fold": True}, FOLD_FLOOR),
                                    ("int8", INT8_KNOBS, INT8_FLOOR)):
            out[f"{arch} {label}"] = run_arch_knob(acfg, f"{arch}_{label}", knobs, zone_hw,
                                                   floor, float_raster)
    small = tmp / DPT / "Z_SMALL" / "zone.tif"
    for arch in ARCHS5:
        if arch in KNOB_ARCHS_MAIN:
            continue
        sc = dict(configs[arch], input_img_path=str(small),
                  output_path=str(tmp / f"out_small_{arch}"))
        cli.detect_main([f"--conf={write_conf(sc, f'small_{arch}')}"])
        float_raster = read_raster(Path(sc["output_path"]) / f"{sc['output_name']}.tif")
        out[f"{arch} int8, {ZONE_SMALL}² zone"] = run_arch_knob(
            sc, f"small_{arch}_int8", INT8_KNOBS, ZONE_SMALL, INT8_FLOOR, float_raster)
    return out


# -- phase 6: native weights on the card -------------------------------------

def run_native_weights(tmp: Path, card: str) -> dict:
    """The port's make-toy-zone at its defaults (a 2048² zone, 13 classes,
    resnet34-unet at full width, its weights as .msgpack), then flair-detect
    on its detect YAML and on its compare YAML with -c -m from the .msgpack,
    each with the counts set to 0 just before it; the same weights saved as
    .pth by the port give the same argmax raster byte for byte; a .msgpack
    written by save_weights_msgpack reads back to the same state dict."""
    root = tmp / "toy_zone"
    t0 = time.perf_counter()
    conf = tools.make_toy_zone(root)
    made = time.perf_counter() - t0
    dcfg = yaml.safe_load(conf.read_text())
    weights = Path(dcfg["model_weights"])
    check(weights.suffix == ".msgpack" and dcfg["use_gpu"] is True,
          f"make-toy-zone: {weights.name}, use_gpu true ({made:.1f} s)")
    reset_launches()
    stats = cli.detect_main([f"--conf={conf}"])
    launches = read_launches()
    n_batches = -(-len(slice_grid(2048, 2048, dcfg["img_pixels_detection"],
                                  dcfg["margin"]).tiles) // dcfg["batch_size"])
    check_launches(f"toy zone from .msgpack, {n_batches} batches", launches,
                   expected_launches("exact-clipping", "argmax", n_batches))
    raster = read_raster(Path(dcfg["output_path"]) / f"{dcfg['output_name']}.tif")
    model = create_model(dcfg)
    load_weights(model, weights)
    pth = root / "toy-weights.pth"
    torch.save(model.state_dict(), pth)
    pcfg = dict(dcfg, model_weights=str(pth), output_path=str(root / "out-pth"))
    pconf = root / "toy-config-detect-pth.yaml"
    pconf.write_text(yaml.safe_dump(pcfg))
    cli.detect_main([f"--conf={pconf}"])
    from_pth = read_raster(Path(pcfg["output_path"]) / f"{pcfg['output_name']}.tif")
    check(raster.shape == (2, 2048, 2048) and raster.tobytes() == from_pth.tobytes(),
          f"toy zone: the .msgpack and .pth rasters are byte-equal ({raster.shape})")
    compare = root / "toy-config-detect-compare.yaml"
    ccfg = yaml.safe_load(compare.read_text())
    with counted_runs() as per_run:
        cli.detect_main([f"--conf={compare}", "-c", "-m"])
    check(len(per_run) == 2 and all(r["fused_tail_logits"] or r["fused_tail"]
                                    for r in per_run.values()),
          f"toy zone -c -m: {len(per_run)} runs ({', '.join(per_run)})")
    metrics = Path(ccfg["metrics_out"])
    stamped = [p for p in Path(ccfg["output_path"]).iterdir() if p.is_dir()]
    per_patch = [q for p in stamped for q in p.glob("metrics_per-patch_*.json")]
    check(metrics.exists() or bool(per_patch),
          f"toy zone -c -m: metrics written ({[q.name for q in per_patch]})")
    again = root / "again.msgpack"
    ckpt_lib.save_weights_msgpack(again, model)
    back = create_model(dcfg)
    load_weights(back, again)
    same = all(torch.equal(v, back.state_dict()[k]) for k, v in model.state_dict().items())
    check(same and again.read_bytes() == weights.read_bytes(),
          "save_weights_msgpack: read back, the same state dict (and make-toy-zone's bytes)")
    print(f"  toy zone from .msgpack on {card}: {stats['tiles']} tiles, "
          f"{stats['patches_per_sec']:.2f} patches/s, compute {stats['compute_seconds']:.4f} s",
          flush=True)
    keep = ("tiles", "patches_per_sec", "compute_seconds", "read_seconds", "h2d_seconds")
    return {**{k: stats[k] for k in keep}, "make_toy_zone_seconds": made,
            "msgpack_bytes": weights.stat().st_size, "launches": launches,
            "compare_runs": sorted(per_run)}


# -- phase 7: ResNeXt at full width -------------------------------------------

def resnext_detect_config(cfg: dict, tmp: Path, rng) -> dict:
    """The main configuration with resnext50_32x4d-unet, random weights."""
    weights = tmp / f"{RESNEXT}_unet_19cl.pth"
    torch.save(random_weights(FlairSegmentationModel(RESNEXT, K, C), rng), weights)
    rcfg = copy.deepcopy(cfg)
    rcfg.update(model_weights=str(weights), output_path=str(tmp / "out_resnext"))
    rcfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = f"{RESNEXT}_unet"
    return rcfg


def resnext_sites(model) -> dict:
    """expected_launches' site counts of a resnext U-Net."""
    convs = [m for m in model.encoder.modules() if isinstance(m, nn.Conv2d)]
    return {"sites": epilogue_sites(model), "int8_sites": len(convs),
            "grouped": sum(m.groups > 1 for m in convs), "quantized": 3}


def run_resnext(rcfg: dict, zone_hw: int, card: str) -> dict:
    """resnext50_32x4d-unet on the main zone through detect_main (512/128,
    batch 128, argmax, exact clipping) against its all-plain run, then
    bn_fold and INT8_KNOBS against their all-plain runs and the float
    raster, as phases 3f and 3g hold resnet34; launches, patches/s, peak
    memory."""
    sites = resnext_sites(FlairSegmentationModel(RESNEXT, K, C))
    conf = write_conf(rcfg, "resnext")
    main = run_main_path(rcfg, conf, zone_hw, card, sites=sites["sites"])
    float_raster = read_raster(Path(rcfg["output_path"]) / "zone-ARGMAX.tif")
    fold = run_knobs(rcfg, "resnext_bn_fold", {"bn_fold": True}, zone_hw, FOLD_FLOOR,
                     float_raster, expect={"sites": sites["sites"]})
    int8 = run_knobs(rcfg, "resnext_int8", INT8_KNOBS, zone_hw, INT8_FLOOR, float_raster,
                     int8_blocks=INT8_KNOBS["int8_decoder"], expect=sites)
    print(f"  {RESNEXT}-unet: {main['stats']['patches_per_sec']:.2f} patches/s, peak "
          f"{main['peak_gb']:.2f} GB; bn_fold "
          f"{fold['patches_per_sec']:.2f} (peak {fold['peak_gb']:.2f} GB), int8 "
          f"{int8['patches_per_sec']:.2f} patches/s (peak {int8['peak_gb']:.2f} GB)", flush=True)
    return {"main": main, "bn_fold": fold, "int8": int8, "sites": sites}


def run_resnext_flair(tmp: Path, main: dict, rng) -> dict:
    """flair (train, predict, metrics) of resnext50_32x4d-unet at phase 4's
    values (batch 16) for one 4-step epoch, initialized from a .msgpack of
    random weights through init_weights_only_from_ckpt (which loads with no
    surgery), its launches against steps x sites; then one train step from
    the trained weights held to the plain step as phase 4d holds the other
    archs, and the predict tail against its plain version."""
    root = tmp / "flair_resnext"
    root.mkdir(exist_ok=True)
    model = FlairSegmentationModel(RESNEXT, K, C)
    init_sd = random_weights(model, rng)
    ckpt = root / f"{RESNEXT}_init.msgpack"
    write_native(ckpt, init_sd)
    cfg = copy.deepcopy(main["cfg"])
    cfg["paths"]["out_folder"] = str(root)
    cfg["paths"]["ckpt_model_path"] = str(ckpt)
    cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = True
    cfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = f"{RESNEXT}_unet"
    cfg["num_epochs"] = 1
    zeroed = ckpt_lib.init_weights_with_surgery(ckpt, model, verbose=False)
    same = all(torch.equal(model.state_dict()[k], v) for k, v in init_sd.items())
    check(not zeroed and same, f"{ckpt.name}: every tensor loads, none zeroed")
    counts = train_site_counts(model)
    n_test = sum(n for split, n in FLAIR_SPLITS if split == "test")
    torch.cuda.reset_peak_memory_stats()
    result, launches, wall = counted_flair_main(cfg, root / "flair.yaml")
    peak = torch.cuda.max_memory_allocated() / 1e9
    label = f"flair {RESNEXT}-unet"
    losses = check_flair_run(label, cfg, result, launches, counts, -(-n_test // TRAIN_BATCH))
    check_flair_outputs(label, cfg, result, main["csvs"]["test"], n_test)
    epochs = result["train"]["epochs"]
    train_ps = sum(e["train_patches"] for e in epochs) / sum(e["train_seconds"] for e in epochs)
    pred = result["predict"]
    state = ckpt_lib.CheckpointManager.restore(Path(result["train"]["best_path"]))
    batch = first_batch(cfg)
    step = compare_train_step(cfg, state, batch, counts, None, drift=False,
                              reorders=STEP_REORDERS_DEFAULT,
                              noise=True)
    tail = check_predict_tail(cfg, state, batch)
    print(f"  {label}: train {train_ps:.2f} patches/s (1 epoch of 4 steps, with its warm-up), "
          f"predict {pred['patches'] / pred['seconds']:.2f} patches/s, peak {peak:.2f} GB, "
          f"losses {', '.join(f'{a:.4f}/{b:.4f}' for a, b in losses)}; step loss "
          f"{step['loss']:.5f} vs plain {step['plain_loss']:.5f}", flush=True)
    del state, batch
    torch.cuda.empty_cache()
    return {"train_patches_per_sec": train_ps,
            "predict_patches_per_sec": pred["patches"] / pred["seconds"], "peak_gb": peak,
            "losses": losses, "flair_main_wall_seconds": wall, "launches": launches,
            "step": step, "predict_tail": tail}


# -- phase 8: EfficientNet, serving ---------------------------------------------

EFFNET = "efficientnet-b4"
EFFNET_SMALL = "efficientnet-b0"
EFFNET_ARCHS = ("deeplabv3plus", "pspnet")  # under EFFNET_SMALL: output stride 16, depth 3
SQUEEZE_REL_TOL = 1e-5  # the squeeze's mean: max |kernel - plain| / max |plain|
# squeeze-excite maps off b4's path: a small odd map (one block), b7's widest
SE_EDGES = ((2, 48, 9, 7), (128, 3840, 16, 16))


def effnet_config(cfg: dict, tmp: Path, encoder: str, arch: str, rng) -> dict:
    """The main configuration with a random ``encoder`` ``arch`` (19 classes)."""
    name = f"{encoder}_{arch}"
    weights = tmp / f"{name}_19cl.pth"
    torch.save(random_weights(FlairSegmentationModel(encoder, K, C, arch=arch), rng), weights)
    return dict(cfg, model_weights=str(weights), output_name=f"zone-{name}",
                output_path=str(tmp / f"out_{name}"),
                model_framework={"model_provider": "SegmentationModelsPytorch",
                                 "SegmentationModelsPytorch": {"encoder_decoder": name}})


def effnet_counts(model) -> dict | None:
    """An EfficientNet encoder's launches a batch: SiLU epilogues (the stem
    and each expand), squeeze-excite sites (one a block), all its
    conv_epilogue sites (the SiLU ones and each project); None for another
    encoder."""
    if not isinstance(model.encoder, en.EfficientNetEncoder):
        return None
    blocks = list(model.encoder._blocks)
    silu = 1 + sum(b.expand != 1 for b in blocks)
    return {"silu": silu, "se": len(blocks), "sites": silu + len(blocks)}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| of two bf16 tensors in units of the bf16 ulp at
    the larger magnitude of each pair (0 where both are 0)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max())


class EffnetChecker:
    """An epilogue and a squeeze-excite site that launch the kernels on the
    main path's operands and hold each against its plain version on the
    same operands: conv_epilogue bit for bit (its bf16 and float32
    outputs), the SiLU epilogue and the excite within one bf16 ulp, the
    squeeze's mean within SQUEEZE_REL_TOL of the largest |mean|; with
    ``timed``, the SiLU epilogue's and both squeeze-excite kernels' times,
    their plain versions', their library calls' and their bounds, a site at
    a time. Nothing is kept of a site but its numbers."""

    def __init__(self, timed: bool = False):
        self.timed = timed
        self.rows = {"conv_epilogue_silu": [], "se_squeeze": [], "se_excite": []}
        self.err = {"conv_epilogue_silu": 0.0, "se_squeeze": 0.0, "se_excite": 0.0}
        # the worst reading of each check: bf16 ulps, the squeeze's relative error
        self.worst = {"conv_epilogue_silu": 0.0, "se_squeeze": 0.0, "se_excite": 0.0}
        self.exact_sites = 0  # conv_epilogue sites without SiLU, held bit for bit

    @staticmethod
    def hold(ok: bool, msg: str) -> None:
        """A site's check: silent when it holds, the run's failure when not."""
        if not ok:
            check(False, msg)

    def __call__(self, y, scale, shift, residual=None, branch=None, relu=True, keep_f32=False,
                 silu=False):
        args = dict(y=y, scale=scale, shift=shift, residual=residual, branch=branch, relu=relu,
                    keep_f32=True, silu=silu)
        out, out32 = ep.conv_epilogue(**args)
        ref, ref32 = ep.conv_epilogue_plain(**args)
        label = f"{tuple(y.shape)}{' SiLU' if silu else ''}"
        if silu:
            ulps = bf16_ulps(out, ref)
            self.hold(ulps <= 1, f"conv_epilogue SiLU {label}: bf16 within one ulp ({ulps:.2f})")
            err = (out32 - ref32).abs().max().item()
            self.err["conv_epilogue_silu"] = max(self.err["conv_epilogue_silu"], err)
            self.worst["conv_epilogue_silu"] = max(self.worst["conv_epilogue_silu"], ulps)
        else:
            self.hold(torch.equal(out, ref) and torch.equal(out32, ref32),
                      f"conv_epilogue {label}: bf16 and fp32 outputs exactly equal")
            self.exact_sites += 1
        if silu and self.timed:
            n, c = y.numel(), y.shape[1]
            nbytes = 2 * n + 2 * 4 * c + 2 * n
            self.rows["conv_epilogue_silu"].append(dict(
                shape=tuple(y.shape), bytes=nbytes,
                ms=cuda_ms(lambda: ep.conv_epilogue(y, scale, shift, relu=False, silu=True),
                           5, 1),
                plain_ms=cuda_ms(lambda: ep.conv_epilogue_plain(y, scale, shift, relu=False,
                                                                silu=True), 2, 1),
                library_ms=cuda_ms(lambda: F.silu(y), 5, 1),
                **bound(6 * n, nbytes, PEAK_FP32_FLOPS)))
        return out, (out32 if keep_f32 else None)

    def se_gate(self, y, scale, shift, reduce, expand):
        mean = sg.se_squeeze(y, scale, shift)
        ref = sg.se_squeeze_plain(y, scale, shift)
        rel = ((mean - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()
        label = f"{tuple(y.shape)}"
        self.hold(rel <= SQUEEZE_REL_TOL, f"se_squeeze {label}: mean within {SQUEEZE_REL_TOL} "
                  f"of the largest |mean| ({rel:.2e})")
        self.hold(torch.equal(sg.se_squeeze(y, scale, shift), mean),
                  f"se_squeeze {label}: a second call gives the same bits")
        self.err["se_squeeze"] = max(self.err["se_squeeze"], (mean - ref).abs().max().item())
        self.worst["se_squeeze"] = max(self.worst["se_squeeze"], rel)
        gate = sg.se_gate_vector(mean, reduce, expand, y.dtype)
        out = sg.se_excite(y, scale, shift, gate)
        want = sg.se_excite_plain(y, scale, shift, gate)
        ulps = bf16_ulps(out, want)
        self.hold(ulps <= 1, f"se_excite {label}: bf16 within one ulp ({ulps:.2f})")
        self.err["se_excite"] = max(self.err["se_excite"],
                                    (out.float() - want.float()).abs().max().item())
        self.worst["se_excite"] = max(self.worst["se_excite"], ulps)
        if self.timed:
            n, c, bc = y.numel(), y.shape[1], y.shape[0] * y.shape[1]
            sq_bytes, ex_bytes = 2 * n + 2 * 4 * c + 4 * bc, 2 * n + 2 * 4 * c + 4 * bc + 2 * n
            # device time (the queue filled first): a small site's kernel
            # takes less than the wrapper's host call
            self.rows["se_squeeze"].append(dict(
                shape=tuple(y.shape), bytes=sq_bytes,
                ms=device_ms(lambda: sg.se_squeeze(y, scale, shift)),
                call_ms=cuda_ms(lambda: sg.se_squeeze(y, scale, shift), 5, 1),
                plain_ms=cuda_ms(lambda: sg.se_squeeze_plain(y, scale, shift), 2, 1),
                library_ms=device_ms(lambda: torch.mean(y, dim=(2, 3))),
                **bound(7 * n, sq_bytes, PEAK_FP32_FLOPS)))
            self.rows["se_excite"].append(dict(
                shape=tuple(y.shape), bytes=ex_bytes,
                ms=cuda_ms(lambda: sg.se_excite(y, scale, shift, gate), 5, 1),
                plain_ms=cuda_ms(lambda: sg.se_excite_plain(y, scale, shift, gate), 2, 1),
                library_ms=None, **bound(7 * n, ex_bytes, PEAK_FP32_FLOPS)))
        return out

    def summary(self, name: str) -> dict:
        rows = self.rows[name]
        lib = [r["library_ms"] for r in rows]
        return {"sites": len(rows), "ms": sum(r["ms"] for r in rows),
                "call_ms": sum(r.get("call_ms", r["ms"]) for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                             else "operations"),
                "bytes": sum(r["bytes"] for r in rows),
                "library_ms": None if None in lib else sum(lib),
                "largest": max(rows, key=lambda r: r["bytes"]),
                "max_abs_err": self.err[name]}


def check_effnet_kernels(model, x: torch.Tensor) -> dict:
    """The SiLU epilogue, the squeeze and the excite at every site of one
    main-path batch of tiles ``x`` through ``model`` (every other
    conv_epilogue site held too), timed; the squeeze (twice, the same
    bits) and the excite at SE_EDGES; then a 20-channel map (not a
    multiple of 8) through the SiLU epilogue's one-element-a-thread
    kernel, and the excite's and squeeze's refusal of it."""
    chk = EffnetChecker(timed=True)
    model.tail_input(x, M, epilogue=chk, se_gate=chk.se_gate)
    counts = effnet_counts(model)
    check(len(chk.rows["conv_epilogue_silu"]) == counts["silu"]
          and len(chk.rows["se_squeeze"]) == counts["se"]
          and chk.exact_sites == counts["sites"] - counts["silu"] + bn_count(model.decoder) - 2,
          f"{EFFNET}: {counts['silu']} SiLU sites within one bf16 ulp (worst "
          f"{chk.worst['conv_epilogue_silu']:.2f}), {counts['se']} squeeze-excite sites (squeeze "
          f"worst {chk.worst['se_squeeze']:.2e} of the largest |mean|, excite worst "
          f"{chk.worst['se_excite']:.2f} ulp), {chk.exact_sites} other conv_epilogue sites bit "
          "for bit; every site timed")
    gen = torch.Generator("cuda").manual_seed(SEED + 8)
    edge = EffnetChecker()
    for shape in SE_EDGES:
        site = random_site(gen, shape, "none")
        gate_convs = [nn.Conv2d(c_in, c_out, 1).to("cuda", torch.bfloat16)
                      for c_in, c_out in ((shape[1], 8), (8, shape[1]))]
        edge.se_gate(site["y"], site["scale"], site["shift"], *gate_convs)
        del site
    check(edge.worst["se_squeeze"] <= SQUEEZE_REL_TOL and edge.worst["se_excite"] <= 1,
          f"se_squeeze and se_excite at {', '.join(map(str, SE_EDGES))}: the squeeze "
          f"within {SQUEEZE_REL_TOL} (worst {edge.worst['se_squeeze']:.2e}), the same bits "
          f"twice; the excite within one bf16 ulp ({edge.worst['se_excite']:.2f})")
    site = random_site(gen, (3, 20, 17, 19), "none")
    edge(**dict(site, relu=False, silu=True))
    try:
        sg.se_squeeze(site["y"], site["scale"], site["shift"])
        refused = False
    except ValueError:
        refused = True
    check(refused, "se_squeeze: C = 20 (not a multiple of 8) raises")
    ulps = edge.worst["conv_epilogue_silu"]
    check(ulps <= 1, "conv_epilogue SiLU, C = 20 (the one-element-a-thread kernel): within "
          f"one bf16 ulp ({ulps:.2f})")
    out = {name: chk.summary(name) for name in chk.rows}
    for name in out:
        out[name]["worst"] = chk.worst[name]
    return out


def depthwise_share(model, x: torch.Tensor) -> dict:
    """One main-path batch of tiles ``x`` by CUDA events: the whole
    tail_input and the tail, and around each depthwise conv (cuDNN's
    grouped conv, with the F.pad copy of an asymmetric stride-2 pad); the
    pad copies timed alone on maps of the same shapes."""
    tail = model.zone_tail()
    g = tail.geometry(S, M)
    kern = tail.wrappers()[0]
    planes = torch.zeros((2, ZONE, ZONE), dtype=torch.uint8, device=x.device)
    win = torch.from_numpy(exact_windows(slice_grid(ZONE, ZONE, S, M).tiles[:BATCH], ZONE, ZONE,
                                         S - 2 * M, BATCH)).to(x.device)
    events, pads = [], []
    inner = en.same_conv

    def timed_conv(h, m, pad, dtype):
        if m.groups == 1:
            return inner(h, m, pad, dtype)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        y = inner(h, m, pad, dtype)
        b.record()
        events.append((a, b))
        if pad[0] != pad[1]:
            pads.append((tuple(h.shape), pad))
        return y

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    en.same_conv = timed_conv
    try:
        for _ in range(2):  # the second pass is taken
            events.clear()
            pads.clear()
            torch.cuda.synchronize()
            start.record()
            kern(model.tail_input(x, M), tail, g, planes, win)
            end.record()
            torch.cuda.synchronize()
    finally:
        en.same_conv = inner
    batch = start.elapsed_time(end)
    dw = sum(a.elapsed_time(b) for a, b in events)
    pad_ms = 0.0
    for shape, (lo, hi) in pads:
        h = torch.empty(shape, dtype=x.dtype, device=x.device).contiguous(
            memory_format=torch.channels_last)
        pad_ms += cuda_ms(lambda: F.pad(h, (lo, hi, lo, hi)), 5, 1)
        del h
    return {"batch_ms": batch, "depthwise_ms": dw, "depthwise_share": dw / batch,
            "depthwise_sites": len(events), "pad_copy_ms": pad_ms, "pad_sites": len(pads)}


def run_effnet_predict(main: dict, tmp: Path, rng) -> dict:
    """flair predict and metrics of EFFNET-unet (19 classes) at phase 4's
    values (batch 16) on phase 4's test split, from a .msgpack of random
    weights (paths.ckpt_model_path): its launches (one predict batch: the
    gather and tail kernels of a batch, every encoder and decoder site),
    the PRED rasters and metrics.json, and the first batch's classes
    against its all-plain run by the near-tie rule; patches/s."""
    root = tmp / "flair_effnet"
    root.mkdir(exist_ok=True)
    model = FlairSegmentationModel(EFFNET, K, C)
    ckpt = root / f"{EFFNET}_unet.msgpack"
    write_native(ckpt, random_weights(model, rng))
    cfg = copy.deepcopy(main["cfg"])
    cfg["paths"].update(out_folder=str(root), ckpt_model_path=str(ckpt))
    cfg["tasks"].update(train=False, predict=True, metrics=True)
    cfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = f"{EFFNET}_unet"
    n_test = sum(n for split, n in FLAIR_SPLITS if split == "test")
    batches = -(-n_test // TRAIN_BATCH)
    result, launches, wall = counted_flair_main(cfg, root / "flair.yaml")
    counts = effnet_counts(model)
    want = dict.fromkeys(read_launches(), 0)
    want.update(augment_normalize=batches, fused_tail=batches,
                conv_epilogue=(counts["sites"] + bn_count(model.decoder) - 2) * batches,
                conv_epilogue_silu=counts["silu"] * batches, se_squeeze=counts["se"] * batches,
                se_excite=counts["se"] * batches)
    label = f"flair predict {EFFNET}-unet (.msgpack)"
    check_launches(f"{label}, {batches} batch(es)", launches, want)
    out = Path(cfg["paths"]["out_folder"], cfg["paths"]["out_model_name"])
    name = cfg["paths"]["out_model_name"]
    preds = sorted((out / f"predictions_{name}").glob("PRED_*.tif"))
    check(len(preds) == n_test, f"{label}: {len(preds)} PRED files")
    check((out / "metrics" / "metrics.json").exists(), f"{label}: metrics.json")
    tr = SegmentationTrainer(cfg)
    zeroed = ckpt_lib.init_weights_with_surgery(ckpt, tr.model, verbose=False)
    check(not zeroed, f"{label}: every tensor of the .msgpack loads")
    batch = first_batch(cfg, "test")
    with torch.inference_mode():
        x, _ = tr.prepare(batch)
        xin = tr.model.tail_input(x, 0, epilogue=ep.conv_epilogue_plain,
                                  se_gate=sg.squeeze_excite_plain)
        tail = tr.model.zone_tail()
        g = tail.geometry(S, 0)
        cls_p, prob_p = tail.plain_versions()[0](xin, tail, g)
        gap = top2_gap_last(ft.tail_logits_plain(xin, tail, g).permute(0, 2, 3, 1))
    cls_k = []
    for src in batch["id"]:
        with TiffReader(out / f"predictions_{name}" / f"PRED_{Path(src).name}") as r:
            cls_k.append(r.read(1))
    cls_k = torch.from_numpy(np.stack(cls_k)).to(cls_p.device)
    off = cls_k != cls_p.to(cls_k.dtype)
    moved = int((off & (gap >= GAP_TOL)).sum())
    check(moved == 0, f"{label}: PRED classes vs the all-plain run: {int(off.sum())} "
          f"mismatches, {moved} beyond the near-tie rule (top-2 gap < {GAP_TOL})")
    pred = result["predict"]
    rate = pred["patches"] / pred["seconds"]
    print(f"  {label}: {pred['patches']} patches, {rate:.2f} patches/s (its first batch, "
          f"warm-up included), flair_main wall {wall:.2f} s; {int(off.sum())} near-tie "
          "mismatches against the plain run", flush=True)
    del tr, x, xin
    torch.cuda.empty_cache()
    return {"patches_per_sec": rate, "wall_seconds": wall, "launches": launches,
            "mismatches": int(off.sum())}


def run_effnet(cfg: dict, tmp: Path, main: dict, card: str) -> dict:
    """Phase 8: EFFNET-unet on the main zone (argmax and class_prob) and
    EFFNET_SMALL under EFFNET_ARCHS, each through detect_main against its
    all-plain run with its launches; the new kernels at every site of one
    EFFNET batch against their plain versions, timed; the depthwise convs'
    share of that batch; flair predict from a .msgpack."""
    rng = np.random.default_rng(SEED + 800)
    bcfg = effnet_config(cfg, tmp, EFFNET, "unet", rng)
    device = torch.device("cuda")
    model, _ = eng.prepare_model(bcfg, device)
    gen = torch.Generator("cuda").manual_seed(SEED + 80)
    x = torch.rand((BATCH, S, S, C), generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        kernels = check_effnet_kernels(model, x)
        share = depthwise_share(model, x)
    del model, x
    torch.cuda.empty_cache()
    out = {"kernels": kernels, "depthwise": share}
    out["main"] = run_arch(bcfg, f"{EFFNET}_unet", ZONE)
    print(f"  {EFFNET}-unet: {out['main']['patches_per_sec']:.2f} patches/s on {card}",
          flush=True)
    out["class_prob"] = run_arch_class_prob(bcfg, ZONE)
    for arch in EFFNET_ARCHS:
        acfg = effnet_config(cfg, tmp, EFFNET_SMALL, arch, rng)
        out[f"{EFFNET_SMALL}_{arch}"] = run_arch(acfg, f"{EFFNET_SMALL}_{arch}", ZONE)
    out["predict"] = run_effnet_predict(main, tmp, rng)
    for name, r in kernels.items():
        big = r["largest"]
        print(f"    {name}, {r['sites']} sites of one {EFFNET} batch: {r['ms']:.4f} ms (call "
              f"{r['call_ms']:.4f}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e9:.2f} "
              f"GB); largest site {big['shape']}: {big['ms']:.4f} ms, bound "
              f"{big['bound_ms']:.4f} ms", flush=True)
    print(f"    {EFFNET}-unet batch of {BATCH}: {share['batch_ms']:.2f} ms, depthwise convs "
          f"{share['depthwise_ms']:.2f} ms ({100 * share['depthwise_share']:.1f}%, "
          f"{share['depthwise_sites']} sites; their {share['pad_sites']} F.pad copies "
          f"{share['pad_copy_ms']:.2f} ms alone) on {card}", flush=True)
    return out


# -- phase 8b: EfficientNet, training ------------------------------------------

GATE_GRAD_TOL = 1e-5  # se_backward: max |kernel - plain| / max |plain| of the (B, C) gradient
EFFNET_TRAIN_ARCH = "deeplabv3plus"  # one EFFNET_SMALL step under it: the dilated blocks
EFFNET_WARM_STEPS = 4  # train steps before that step is held (its state's training)
# the encoders whose maps above 2048 channels phase 8b holds at batch 2, off b4's path
WIDE_ENCODERS = ("efficientnet-b2", "efficientnet-b6", "efficientnet-b7")
WIDE_BATCH = 2
# the new kernel modes of an EfficientNet train step, as the kernels line names them
TRAIN_KERNELS = ("bn_train_wide", "bn_backward_silu", "se_backward", "bn_backward_affine",
                 "conv_epilogue_drop")


def wide_site_shapes(encoder: str, batch: int) -> list[tuple]:
    """(B, C, H, W) of each BatchNorm site of ``encoder`` above 2048
    channels on 512² tiles: an expand site at its block's input side, a
    depthwise site at its output side."""
    side, out = S // 2, set()
    for b in en.efficientnet_plan(encoder)["blocks"]:
        mid, before = b["cin"] * b["expand"], side
        side = -(-side // b["stride"])
        if mid > 8 * bt.THREADS:
            out |= {(batch, mid, before, before), (batch, mid, side, side)}
    return sorted(out)


def effnet_masks(model, gen, arch: str = "unet") -> dict:
    """One microbatch's dropout masks by module name for an EfficientNet
    model's train step: each dropping block's (B,) keep mask drawn at its
    rate (sample 0 dropped at the first, so at least one sample drops), and
    the decoder's (decoder_keep)."""
    enc = model.encoder
    drop = {j: torch.rand(TRAIN_BATCH, generator=gen, device="cuda")
            >= en.DROP_CONNECT_RATE * j / enc.n_blocks
            for j, b in enumerate(enc._blocks) if j and b.skip}
    drop[min(drop)][0] = False
    return {"drop_connect": drop, **(decoder_keep(arch, TRAIN_BATCH, S, gen) or {})}


def bn_library(gz, y, mean, invstd, gamma):
    """aten's native_batch_norm_backward on the pre-multiplied gradient
    (the affine and the SiLU's derivative already in gz, cast to y's
    dtype): BatchNorm's VJP alone, not the same function."""
    g = gz.to(y.dtype).contiguous(memory_format=torch.channels_last)
    return lambda: torch.ops.aten.native_batch_norm_backward(
        g, y, gamma, None, None, mean, invstd, True, en.BN_EPS, [True, True, True])


class TrainKernelTimer:
    """A train step's sites through the kernels, each call of a new kernel
    mode (the channel-tiled statistics and backward above 2048 channels,
    the SiLU backward, the affine backward, the gate's gradient, the
    drop-connect epilogue) also through its plain version on the same
    operands, held to its limit, and both timed (device_ms; the plain by
    events) beside the bound and the library call."""

    def __init__(self):
        self.rows = {name: [] for name in TRAIN_KERNELS}

    def add(self, name: str, err: float, fn, plain, library, ops: float, nbytes: float,
            **extra) -> None:
        self.rows[name].append(dict(
            err=err, ms=device_ms(fn), plain_ms=cuda_ms(plain, 2, 1),
            library_ms=None if library is None else device_ms(library), bytes=nbytes,
            **bound(ops, nbytes, PEAK_FP32_FLOPS), **extra))

    def stats(self, x, gamma, beta, rm, rv, eps=bt.EPS, momentum=bt.MOMENTUM):
        rm0, rv0 = rm.clone(), rv.clone()
        got = bt.bn_stats(x, gamma, beta, rm, rv, eps, momentum)
        if x.shape[1] > 8 * bt.THREADS:
            want = bt.bn_stats_plain(x, gamma, beta, rm0.clone(), rv0.clone(), eps, momentum)
            err = max(vec_err(a, b) for a, b in zip(got, want))
            EffnetChecker.hold(err <= BN_STAT_TOL, f"bn_stats, {x.shape[1]} channels in "
                               f"{bt.channel_tiles(x.shape[1])} tiles, {tuple(x.shape)}: "
                               f"within {err:.1e}")
            n = x.numel()
            self.add("bn_train_wide", err, lambda: bt.bn_stats(x, gamma, beta, rm0, rv0, eps,
                                                                momentum),
                     lambda: bt.bn_stats_plain(x, gamma, beta, rm0, rv0, eps, momentum),
                     lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0), 3 * n,
                     2 * n + 4 * 8 * x.shape[1], mode="stats", shape=tuple(x.shape))
        return got

    def epilogue(self, y, scale, shift, **kw):
        got = ep.conv_epilogue(y, scale, shift, **kw)
        if kw.get("drop") is not None:
            want = ep.conv_epilogue_plain(y, scale, shift, **kw)
            err = max(max_diff(a, b) for a, b in zip(got, want))
            EffnetChecker.hold(err == 0, f"conv_epilogue drop-connect {tuple(y.shape)}: bit "
                               f"for bit ({err:.1e})")
            n = y.numel()
            self.add("conv_epilogue_drop", err, lambda: ep.conv_epilogue(y, scale, shift, **kw),
                     lambda: ep.conv_epilogue_plain(y, scale, shift, **kw), None, 5 * n,
                     2 * n + 4 * n + 2 * n + 4 * n * kw.get("keep_f32", False),
                     shape=tuple(y.shape))
        return got

    def stats_apply(self, *args):
        return bt.bn_stats_apply(*args)

    def backward(self, *args, **kw):
        got = bt.bn_backward(*args, **kw)
        g, g32, out, y, mean, invstd, gamma, branch, relu, residual = args
        wide = y.shape[1] > 8 * bt.THREADS
        affine = "gmul" in kw or "gadd" in kw
        if not (wide or affine or "shift" in kw):
            return got
        want = bt.bn_backward_plain(*args, **kw)
        dy_err = scaled_err(got[0], want[0])
        vec = max(vec_err(got[1], want[1]), vec_err(got[2], want[2]))
        err = max(dy_err, vec)
        EffnetChecker.hold(
            dy_err <= BN_DY_TOL and vec <= BN_GRAD_TOL
            and (got[3] is None or torch.equal(got[3], want[3])),
            f"bn_backward {'affine' if affine else 'SiLU'} {tuple(y.shape)}: dy within "
            f"{dy_err:.1e}, dgamma and dbeta within {vec:.1e}"
            + (", the identity's gradient exact" if got[3] is not None else ""))
        n, bc = y.numel(), 2 * 4 * y.shape[0] * y.shape[1]
        nbytes = (2 * n * (g is not None) + 4 * n * (g32 is not None) + 2 * n
                  + 2 * n * relu + bc * affine + 2 * n + 4 * n * residual)
        ops = 12 * n + 10 * n * ("shift" in kw) + 2 * n * affine
        gz = bt._site_grad(bt._grad_in(g, g32, out, relu), y, gamma, invstd, kw.get("shift"),
                           kw.get("gmul"), kw.get("gadd"))
        library = bn_library(gz, y, mean, invstd, gamma)
        del gz
        fn = lambda: bt.bn_backward(*args, **kw)  # noqa: E731
        plain = lambda: bt.bn_backward_plain(*args, **kw)  # noqa: E731
        name = "bn_backward_affine" if affine else "bn_backward_silu"
        self.add(name, err, fn, plain, library, ops, nbytes, shape=tuple(y.shape))
        if wide:
            self.rows["bn_train_wide"].append(dict(self.rows[name][-1], mode="backward"))
        return got

    def squeeze(self, y, scale, shift):
        return sg.se_squeeze(y, scale, shift)

    def excite(self, y, scale, shift, gate):
        return sg.se_excite(y, scale, shift, gate)

    def squeeze_backward(self, g, y, scale, shift):
        got = sg.se_backward(g, y, scale, shift)
        want = sg.se_backward_plain(g, y, scale, shift)
        err = scaled_err(got, want)
        EffnetChecker.hold(err <= GATE_GRAD_TOL, f"se_backward {tuple(y.shape)}: within "
                           f"{err:.1e} of the largest |dgate| <= {GATE_GRAD_TOL}")
        n, bc = y.numel(), y.shape[0] * y.shape[1]
        self.add("se_backward", err, lambda: sg.se_backward(g, y, scale, shift),
                 lambda: sg.se_backward_plain(g, y, scale, shift),
                 lambda: torch.linalg.vecdot(g.flatten(2), y.flatten(2)), 8 * n,
                 4 * n + 2 * 4 * y.shape[1] + 4 * bc, shape=tuple(y.shape))
        return got


def time_train_kernels(cfg: dict, state: dict, batch: dict, masks: dict) -> dict:
    """One train step of ``cfg``'s model from ``state`` through
    TrainKernelTimer: each new kernel mode held and timed at every one of
    its sites, summed by kernel."""
    timer = TrainKernelTimer()
    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    tr.sites = SitesThrough(timer)
    tr.train_step(batch, choices=choices_all(TRAIN_BATCH), masks=[masks])
    torch.cuda.synchronize()
    del tr
    torch.cuda.empty_cache()
    out = {}
    for name, rows in timer.rows.items():
        check(bool(rows), f"{name}: at least one site in the step")
        libs = [r["library_ms"] for r in rows]
        out[name] = {"sites": len(rows), "ms": sum(r["ms"] for r in rows),
                     "plain_ms": sum(r["plain_ms"] for r in rows),
                     "bound_ms": sum(r["bound_ms"] for r in rows),
                     "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in rows)
                                  else "operations"),
                     "bytes": sum(r["bytes"] for r in rows),
                     "library_ms": None if None in libs else sum(libs),
                     "max_abs_err": max(r["err"] for r in rows),
                     "largest": max(rows, key=lambda r: r["bytes"]),
                     "under_half": sum(r["bound_ms"] < 0.5 * r["ms"] for r in rows)}
        if name == "bn_train_wide":
            out[name]["modes"] = [
                {"mode": m, "sites": len(rs), "ms": sum(r["ms"] for r in rs),
                 "plain_ms": sum(r["plain_ms"] for r in rs),
                 "bound_ms": sum(r["bound_ms"] for r in rs),
                 "library_ms": sum(r["library_ms"] for r in rs),
                 "shapes": sorted({r["shape"] for r in rs})}
                for m in ("stats", "backward") for rs in [[r for r in rows if r["mode"] == m]]]
    return out


def check_wide_sites(gen) -> dict:
    """The channel-tiled statistics, the SiLU and the affine backward and
    the gate's gradient at every site above 2048 channels of WIDE_ENCODERS
    at batch WIDE_BATCH, random operands, against their plain versions;
    two statistics calls give the same bits."""
    out = {}
    for encoder in WIDE_ENCODERS:
        for shape in wide_site_shapes(encoder, WIDE_BATCH):
            B, C = shape[:2]
            y = random_site(gen, shape, "none")["y"]
            g = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            vec = [torch.rand(C, device="cuda", generator=gen) + 0.5 for _ in range(4)]
            runs = [bt.bn_stats(y, *[v.clone() for v in vec], en.BN_EPS, 0.99)
                    for _ in range(2)]
            want = bt.bn_stats_plain(y, *[v.clone() for v in vec], en.BN_EPS, 0.99)
            errs = {"stats": max(vec_err(a, b) for a, b in zip(runs[0], want))}
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            mean, invstd, _, shift = want
            gate = torch.rand((B, C), device="cuda", generator=gen)
            gadd = torch.randn((B, C), device="cuda", generator=gen) * 1e-3
            for mode, kw in (("silu", {"shift": shift}),
                             ("affine", {"shift": shift, "gmul": gate, "gadd": gadd})):
                args = (g, None, None, y, mean, invstd, vec[0], None, False, False)
                a, b = bt.bn_backward(*args, **kw), bt.bn_backward_plain(*args, **kw)
                errs[f"dy_{mode}"] = scaled_err(a[0], b[0])
                errs[f"dgamma_dbeta_{mode}"] = max(vec_err(a[1], b[1]), vec_err(a[2], b[2]))
            errs["gate_grad"] = scaled_err(sg.se_backward(g, y, want[2], shift),
                                           sg.se_backward_plain(g, y, want[2], shift))
            torch.cuda.synchronize()
            check(same and errs["stats"] <= BN_STAT_TOL and errs["gate_grad"] <= GATE_GRAD_TOL
                  and max(errs["dy_silu"], errs["dy_affine"]) <= BN_DY_TOL
                  and max(errs["dgamma_dbeta_silu"], errs["dgamma_dbeta_affine"]) <= BN_GRAD_TOL,
                  f"{encoder} {shape} ({bt.channel_tiles(C)} channel tiles): {errs}, two "
                  "statistics calls the same bits")
            out[f"{encoder} {shape}"] = errs
            del y, g
    return out


def effnet_step_breakdown(cfg: dict, state: dict, batch: dict, masks: dict) -> dict:
    """One train step (the second of two) of ``cfg``'s model by CUDA
    events: the whole step, the forward, the depthwise convs' forward and
    backward (events around each forward, and recorded by autograd hooks
    when the conv's output gradient is ready and when its input gradient
    is written), the host's time to issue the step, and the profiler's
    device time by kernel group with the card's busy share."""
    from torch.profiler import ProfilerActivity, profile

    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    ch = choices_all(TRAIN_BATCH)
    events = {"forward": [], "backward": []}
    inner = en.same_conv

    def event():
        return torch.cuda.Event(enable_timing=True)

    def timed(h, m, pad, dtype):
        if m.groups == 1 or not torch.is_grad_enabled():
            return inner(h, m, pad, dtype)
        a, b, c, d = event(), event(), event(), event()
        a.record()
        y = inner(h, m, pad, dtype)
        b.record()
        y.register_hook(lambda g: c.record())
        h.register_hook(lambda g: d.record())
        events["forward"].append((a, b))
        events["backward"].append((c, d))
        return y

    def step():
        tr.train_step(batch, choices=ch, masks=[masks])

    x, tgt = tr.prepare(batch, True, ch)
    ms = {"forward": cuda_ms(lambda: tr.model(x, epilogue=tr.sites, dropout=masks), 3, 1)}
    del x, tgt
    en.same_conv = timed
    try:
        for _ in range(2):
            for v in events.values():
                v.clear()
            start, end = event(), event()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            step()
            issued = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        en.same_conv = inner
    ms.update(step=start.elapsed_time(end), step_wall=wall * 1e3, host_issue=issued * 1e3,
              depthwise_forward=sum(a.elapsed_time(b) for a, b in events["forward"]),
              depthwise_backward=sum(a.elapsed_time(b) for a, b in events["backward"]),
              depthwise_sites=len(events["forward"]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3

    def group(*keys) -> float:
        return sum(e.self_device_time_total for e in rows if any(k in e.key for k in keys)) / 1e3

    ms.update(profiled_wall=wall_ms, profiled_busy=busy,
              bn_train=group("stats_kernel", "backward_reduce", "backward_apply"),
              se_squeeze_excite=group("se_squeeze_kernel<false>", "se_excite_kernel"),
              se_backward=group("se_squeeze_kernel<true>"),
              conv_epilogue=group("conv_epilogue_"),
              weighted_ce_augment=group("weighted_ce", "augment"))
    ms["other_kernels"] = busy - sum(ms[k] for k in ("bn_train", "se_squeeze_excite",
                                                     "se_backward", "conv_epilogue",
                                                     "weighted_ce_augment"))
    del tr
    torch.cuda.empty_cache()
    return {"ms": ms, "busy_share": busy / wall_ms,
            "depthwise_backward_share": ms["depthwise_backward"] / busy,
            "kernel_table": prof.key_averages().table(sort_by="self_cuda_time_total",
                                                      row_limit=15)}


def check_trained_dtypes(cfg: dict, state: dict, root: Path) -> dict:
    """The trained model's gate biases and running statistics stay float32:
    in flair's checkpoint, and in a .msgpack written from the model after a
    predict (which never casts the weights, as prepare_inference would)."""
    sd = state["state_dict"]
    keys = [k for k in sd if re.search(r"_se_(reduce|expand)\.bias$|running_(mean|var)$", k)]
    tr = SegmentationTrainer(cfg)
    tr.load_state(state)
    predict(cfg, gather_paths(cfg, "test"), root / "predict_after", tr, progress=lambda _: None)
    path = root / "trained.msgpack"
    ckpt_lib.save_weights_msgpack(path, tr.model)
    back = ckpt_lib.load_state_dict_file(path)
    del tr
    bad = [k for k in keys if sd[k].dtype != torch.float32 or back[k].dtype != np.float32]
    check(not bad and len(keys) > 0, f"{len(keys)} gate biases and running statistics float32 "
          f"in the checkpoint and in {path.name} written after a predict"
          + (f"; not: {bad[:4]}" if bad else ""))
    return {"tensors": len(keys)}


def run_effnet_train(tmp: Path, main: dict, card: str) -> dict:
    """Phase 8b: flair (train, predict, metrics) of EFFNET-unet for one
    epoch of 4 steps at phase 4's values from phase 8's .msgpack
    (init_weights_only_from_ckpt), its launches against steps x sites; the
    trained tensors' dtypes; warm rates; one step by stage; the new kernel
    modes at every site of one step held and timed; one step held site by
    site and free-running against the plain step (injected dropout masks,
    a sample dropped); the sites above 2048 channels of WIDE_ENCODERS; one
    EFFNET_SMALL-EFFNET_TRAIN_ARCH step held the same way, from random
    weights after EFFNET_WARM_STEPS steps."""
    t0 = time.perf_counter()
    root = tmp / "flair_effnet_train"
    root.mkdir(exist_ok=True)
    cfg = copy.deepcopy(main["cfg"])
    cfg["paths"].update(out_folder=str(root),
                        ckpt_model_path=str(tmp / "flair_effnet" / f"{EFFNET}_unet.msgpack"))
    cfg["tasks"].update(train=True, predict=True, metrics=True)
    cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = True
    cfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = f"{EFFNET}_unet"
    cfg["num_epochs"] = 1
    model = FlairSegmentationModel(EFFNET, K, C)
    counts = train_site_counts(model)
    n_test = sum(n for split, n in FLAIR_SPLITS if split == "test")
    torch.cuda.reset_peak_memory_stats()
    result, launches, wall = counted_flair_main(cfg, root / "flair.yaml")
    peak = torch.cuda.max_memory_allocated() / 1e9
    label = f"flair {EFFNET}-unet"
    losses = check_flair_run(label, cfg, result, launches, counts, -(-n_test // TRAIN_BATCH))
    check_flair_outputs(label, cfg, result, main["csvs"]["test"], n_test)
    for name in TRAIN_KERNELS[1:] + ("bn_stats_wide", "bn_backward_wide"):
        check(launches[name] > 0, f"{label}: {name} launched ({launches[name]})")
    epochs = result["train"]["epochs"]
    train_ps = sum(e["train_patches"] for e in epochs) / sum(e["train_seconds"] for e in epochs)
    pred = result["predict"]
    state = ckpt_lib.CheckpointManager.restore(Path(result["train"]["best_path"]))
    dtypes = check_trained_dtypes(cfg, state, root)
    batch = first_batch(cfg)
    warm_train, warm_predict = warm_rates(cfg, state, batch, root / "predict_warm")
    gen = torch.Generator("cuda").manual_seed(SEED + 81)
    masks = effnet_masks(model, gen)
    breakdown = effnet_step_breakdown(cfg, state, batch, masks)
    kernels = time_train_kernels(cfg, state, batch, masks)
    step = compare_train_step(cfg, state, batch, counts, [masks], drift=False,
                              reorders=STEP_REORDERS_DEFAULT, noise=True)
    wide = check_wide_sites(gen)
    name = f"{EFFNET_SMALL}_{EFFNET_TRAIN_ARCH}"
    dcfg = copy.deepcopy(cfg)
    dcfg["model_framework"]["SegmentationModelsPytorch"]["encoder_decoder"] = name
    # a trained state, as phases 4d and 7 hold theirs: at the initial one
    # every beta is 0, so an expand site's batch mean is 0 in exact
    # arithmetic and the steps' values of it are bf16 rounding noise, which
    # reordering the batch does not sample
    dtr = SegmentationTrainer(dcfg)
    for _ in range(EFFNET_WARM_STEPS):
        dtr.train_step(batch, choices=choices_all(TRAIN_BATCH))
    dstate = dtr.state()
    dmodel = dtr.model
    dmasks = effnet_masks(dmodel, gen, EFFNET_TRAIN_ARCH)
    dcounts = train_site_counts(dmodel)
    del dtr
    small = compare_train_step(dcfg, dstate, batch, dcounts, [dmasks], drift=False,
                               reorders=STEP_REORDERS_DEFAULT, noise=True)
    del state, dstate, batch
    torch.cuda.empty_cache()
    bd = breakdown["ms"]
    print(f"  {label}: train {train_ps:.2f} patches/s (1 epoch of 4 steps, with its warm-up), "
          f"warm {warm_train:.2f} ({WARM_STEPS} steps on one batch); predict "
          f"{pred['patches'] / pred['seconds']:.2f} patches/s (first call), warm "
          f"{warm_predict:.2f}; peak {peak:.2f} GB; losses "
          f"{', '.join(f'{a:.4f}/{b:.4f}' for a, b in losses)}; step loss {step['loss']:.5f} vs "
          f"plain {step['plain_loss']:.5f}; {name} step loss {small['loss']:.5f} vs plain "
          f"{small['plain_loss']:.5f} on {card}", flush=True)
    print(f"    {label} step: {bd['step']:.2f} ms device-timed ({bd['step_wall']:.2f} ms wall, "
          f"the host issued it in {bd['host_issue']:.2f} ms), forward {bd['forward']:.2f} ms; "
          f"depthwise convs forward {bd['depthwise_forward']:.2f} ms, backward "
          f"{bd['depthwise_backward']:.2f} ms ({100 * breakdown['depthwise_backward_share']:.1f}% "
          f"of the profiled step's {bd['profiled_busy']:.2f} ms of kernels, busy "
          f"{100 * breakdown['busy_share']:.1f}% of {bd['profiled_wall']:.2f} ms); kernels: "
          f"bn_train {bd['bn_train']:.2f}, squeeze and excite {bd['se_squeeze_excite']:.2f}, "
          f"se_backward {bd['se_backward']:.2f}, conv_epilogue {bd['conv_epilogue']:.2f}, "
          f"weighted_ce and augment {bd['weighted_ce_augment']:.2f}, other (cuDNN, PyTorch) "
          f"{bd['other_kernels']:.2f}", flush=True)
    for kname, r in kernels.items():
        big = r["largest"]
        print(f"    {kname}, {r['sites']} sites of one {EFFNET}-unet step: device "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e9:.3f} GB), worst error "
              f"{r['max_abs_err']:.2e}; largest site {big['shape']}: {big['ms']:.4f} ms, bound "
              f"{big['bound_ms']:.4f}", flush=True)
    for kname in ("bn_backward_silu", "bn_backward_affine"):
        r = kernels[kname]
        print(f"    {kname}: {100 * r['bound_ms'] / r['ms']:.1f}% of its bound "
              f"({r['bound_ms']:.4f} of {r['ms']:.4f} ms device), {r['under_half']} of "
              f"{r['sites']} sites under half of theirs", flush=True)
    for kname, got in launches.items():
        if got:
            print(f"    launches {kname}: {got}")
    return {"train_patches_per_sec": train_ps, "warm_train_patches_per_sec": warm_train,
            "predict_patches_per_sec": pred["patches"] / pred["seconds"],
            "warm_predict_patches_per_sec": warm_predict, "peak_gb": peak, "losses": losses,
            "flair_main_wall_seconds": wall, "launches": launches, "dtypes": dtypes,
            "breakdown": breakdown, "kernels": kernels, "step": step, "wide_sites": wide,
            f"{name}_step": small, "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time one main-path batch and one flair train step "
                         "stage by stage and print the profiler's kernel tables")
    ap.add_argument("--step-study", metavar="ARCH",
                    help="only the sample-order study of ARCH's phase-4d step check "
                         "(step_order_study), one JSON line")
    ap.add_argument("--effnet-train", action="store_true",
                    help="only phase 8b, on its own written set and .msgpack (phase 4's and "
                         "phase 8's), one JSON line")
    ap.add_argument("--orders", type=int, default=10, help="the study's sample orders")
    ap.add_argument("--study-seed", type=int, default=SEED,
                    help="the numpy seed of the study's written set")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"    built {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
          f"into {_build.build_dir()}", flush=True)

    rng = np.random.default_rng(SEED)
    if args.step_study:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, torch_defaults():
            study = step_order_study(args.step_study, args.orders, Path(tmp),
                                     np.random.default_rng(args.study_seed))
        print(json.dumps({"step_order_study": study, "study_seed": args.study_seed, "card": card,
                          "seconds": time.perf_counter() - t_start}), flush=True)
        return 0
    if args.effnet_train:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp, torch_defaults():
            tmp = Path(tmp)
            csvs = write_flair_dataset(tmp / "flair", rng)
            (tmp / "flair_effnet").mkdir()
            write_native(tmp / "flair_effnet" / f"{EFFNET}_unet.msgpack",
                         random_weights(FlairSegmentationModel(EFFNET, K, C),
                                        np.random.default_rng(SEED + 800)))
            out = run_effnet_train(tmp, {"cfg": flair_config(tmp / "flair", csvs),
                                         "csvs": csvs}, card)
        print(out["breakdown"].pop("kernel_table"))
        for r in out["kernels"].values():
            r.pop("largest")
        out.pop("launches")
        print(json.dumps({"effnet_train": out, "card": card,
                          "seconds": time.perf_counter() - t_start}), flush=True)
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        zone, truth, weights = synth_inputs(tmp, ZONE, rng)
        cfg = detect_config(tmp, zone, truth, weights)
        conf = tmp / "detect.yaml"
        conf.write_text(yaml.safe_dump(cfg))
        rcfg = resnext_detect_config(cfg, tmp, np.random.default_rng(SEED + 700))
        print(f"    synthesized a {ZONE}x{ZONE}x{C} zone, resnet34-unet and {RESNEXT}-unet "
              f"weights in {time.perf_counter() - t0:.1f} s", flush=True)

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
            rqmodel, _ = eng.prepare_model(dict(rcfg, **INT8_KNOBS), torch.device("cuda"))
            grouped = check_int8_grouped(rqmodel, torch.rand((BATCH, S, S, C), generator=gen,
                                                             device="cuda"))
            del rqmodel
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
            strided = check_strided_kernels(gen)
            torch.cuda.empty_cache()
            stems = check_stems(gen)
            torch.cuda.empty_cache()
            gnorm = check_group_norm(gen)
            torch.cuda.empty_cache()
            gnorm_back = check_group_norm_backward(gen)
            bn_narrow = check_bn_narrow(gen)
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
        for r in grouped["rows"]:
            print(f"    int8_conv_grouped {r['site']}, x {r['count']}: device {r['ms']:.4f} ms "
                  f"({r['share']:.0%} of its bound), call {r['call_ms']:.4f} ms (PR 20's dp4a "
                  f"kernel: call {r['before_ms']} ms), "
                  f"plain {r['plain_ms']:.4f} ms, library none, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}); {r['plan']}")
        print(f"    int8_conv_grouped, the {grouped['sites']} grouped sites of one {RESNEXT} "
              f"batch of {BATCH}: device {grouped['ms']:.4f} ms ({grouped['bound_ms'] / grouped['ms']:.0%}"
              f" of its bound), call {grouped['call_ms']:.4f} ms (PR 20's dp4a kernel: call "
              f"{grouped['before_ms']:.4f} ms), plain "
              f"{grouped['plain_ms']:.4f} ms, "
              f"library none, bound {grouped['bound_ms']:.4f} ms ({grouped['bound_by']}, "
              f"{grouped['bytes'] / 1e9:.2f} GB)",
              flush=True)
        for name, r in (("fused_tail probs", probs), ("fused_tail logits", logits),
                        *stitch["timed"].items(), ("tile_softmax probs", softmax["probs"]),
                        ("tile_softmax argmax", softmax["argmax"])):
            print(f"    {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

        for (label, up), case in zip(STRIDED_CASES, strided["cases"].values()):
            for r in case["modes"].values():
                print(f"    strided_tail {r['mode']} ({label}), batch {BATCH}: {r['ms']:.4f} ms "
                      f"(fe34f71's kernel {STRIDED_BEFORE_MS[up][r['mode']]:.4f} ms), plain "
                      f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)",
                      flush=True)
        print(f"    stem conv, batch {BATCH} x {S}² x {C} -> 64, bf16: direct "
              f"{stems['direct_ms']:.4f} ms, space-to-depth (s2d_stem) {stems['s2d_ms']:.4f} ms",
              flush=True)
        for r in gnorm["sites"]:
            print(f"    group_norm_relu {r['site']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
                  f"ms, F.group_norm {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB)", flush=True)
        print(f"    group_norm_relu, FPN's 7 sites of one batch: {gnorm['ms']:.4f} ms, plain "
              f"{gnorm['plain_ms']:.4f} ms, F.group_norm {gnorm['library_ms']:.4f} ms, bound "
              f"{gnorm['bound_ms']:.4f} ms ({gnorm['bound_by']}, {gnorm['bytes'] / 1e9:.2f} GB)",
              flush=True)
        for r in gnorm_back["sites"]:
            print(f"    group_norm_relu backward {r['site']}, batch {TRAIN_BATCH}: device "
                  f"{r['ms']:.4f} ms (0510a73's three launches {r['before_ms']:.4f}), call "
                  f"{r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"native_group_norm_backward {r['library_ms']} ms, bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB; the design moves "
                  f"{r['hbm_bytes'] / 1e6:.1f} MB), {r['route']}, grid {r['grid']}, "
                  f"{r['blocks_per_sm']} a SM", flush=True)
        print(f"    group_norm_relu backward, FPN's 7 sites of one batch-{TRAIN_BATCH} step: "
              f"device {gnorm_back['ms']:.4f} ms (0510a73's {gnorm_back['before_ms']:.4f}), "
              f"call {gnorm_back['call_ms']:.4f} ms, plain {gnorm_back['plain_ms']:.4f} ms, "
              f"native_group_norm_backward {gnorm_back['library_ms']} ms, bound "
              f"{gnorm_back['bound_ms']:.4f} ms ({gnorm_back['bound_by']}, "
              f"{gnorm_back['bytes'] / 1e9:.3f} GB)"
              + (f"; library: none ({gnorm_back['library_error']})"
                 if gnorm_back["library_error"] else ""), flush=True)
        for r in bn_narrow["sites"]:
            print(f"    bn_train narrow {r['site']}: forward (statistics and output) device "
                  f"{r['stats_ms']:.4f} ms, torch.var_mean {r['stats_library_ms']:.4f} ms; "
                  f"backward {r['backward_ms']:.4f} ms, native_batch_norm_backward "
                  f"{r['backward_library_ms']} ms", flush=True)
        for mode in ("stats", "backward"):
            r = bn_narrow[mode]
            print(f"    bn_train narrow {mode}, PAN's 6 one-channel sites of one batch-"
                  f"{TRAIN_BATCH} step: device {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms "
                  f"({r['bound_by']})", flush=True)
        fl = bn_narrow["floors"]
        print(f"    launch floor, device: an empty kernel {fl['empty_ms']:.4f} ms, one block's "
              f"reduction of 256 values {fl['reduce_ms']:.4f} ms"
              + (f"; narrow library: {bn_narrow['library_error']}"
                 if bn_narrow["library_error"] else ""), flush=True)
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
        print("[3h] s2d_stem on the main configuration, against the default stem",
              flush=True)
        s2d = run_s2d_stem(cfg, ZONE, float_raster)
        print("[4] flair train / predict / metrics on the card: resnet34-unet, 512 patches, "
              f"batch {TRAIN_BATCH}, {K} classes", flush=True)
        with torch_defaults():
            flair = run_flair(tmp, rng, card, profile=args.profile)
            print(f"[4b] flair with use_metadata and init_encoder_weights: {META_EPOCHS} epochs, "
                  f"{META_TEST} test patches", flush=True)
            meta = run_flair_metadata(tmp, rng, card, flair, profile=args.profile)
            print("[4c] flair with accumulate_steps 2, resume from last, the step autosave",
                  flush=True)
            a1 = run_flair_a1(tmp, flair)
            print("[4d] flair train / predict / metrics with slice 5's decoders: resnet34, "
                  f"{', '.join(ARCHS5)}", flush=True)
            t4 = time.perf_counter()
            flair_archs = run_flair_archs(tmp, flair)
            print(f"    phase 4d: {time.perf_counter() - t4:.1f} s", flush=True)
            print("[5] slice 5's smp decoders: flair-detect on the card, resnet34, "
                  f"{', '.join(ARCHS5)}", flush=True)
            t5 = time.perf_counter()
            archs, arch_configs = run_archs(cfg, tmp, ZONE, args.profile)
            print(f"    phase 5: {time.perf_counter() - t5:.1f} s", flush=True)
            print(f"[5b] bn_fold and int8 off the U-Net: {', '.join(KNOB_ARCHS_MAIN)} on the "
                  f"main zone, int8 for the other archs on the {ZONE_SMALL}² zone", flush=True)
            t5 = time.perf_counter()
            arch_knobs = run_arch_knobs(arch_configs, tmp, ZONE)
            print(f"    phase 5b: {time.perf_counter() - t5:.1f} s", flush=True)
            print("[6] native weights: make-toy-zone (.msgpack), flair-detect and -c -m from it",
                  flush=True)
            t6 = time.perf_counter()
            native = run_native_weights(tmp, card)
            print(f"    phase 6: {time.perf_counter() - t6:.1f} s", flush=True)
            print(f"[7] {RESNEXT}-unet at full width: the main path, bn_fold, int8; flair "
                  "from a .msgpack", flush=True)
            t7 = time.perf_counter()
            resnext = run_resnext(rcfg, ZONE, card)
            resnext["flair"] = run_resnext_flair(tmp, flair, np.random.default_rng(SEED + 701))
            print(f"    phase 7: {time.perf_counter() - t7:.1f} s", flush=True)
            print(f"[8] EfficientNet: {EFFNET}-unet on the main zone (argmax, class_prob), "
                  f"{EFFNET_SMALL} under {', '.join(EFFNET_ARCHS)}, flair predict from a "
                  ".msgpack; the SiLU epilogue and squeeze-excite kernels", flush=True)
            t8 = time.perf_counter()
            effnet = run_effnet(cfg, tmp, flair, card)
            print(f"    phase 8: {time.perf_counter() - t8:.1f} s", flush=True)
            print(f"[8b] EfficientNet training: flair {EFFNET}-unet (one epoch of 4 steps, "
                  f"predict, metrics) from phase 8's .msgpack; one step by stage and site by "
                  f"site; the sites above 2048 channels of {', '.join(WIDE_ENCODERS)}; one "
                  f"{EFFNET_SMALL}-{EFFNET_TRAIN_ARCH} step", flush=True)
            t8 = time.perf_counter()
            effnet_train = run_effnet_train(tmp, flair, card)
            print(f"    phase 8b: {time.perf_counter() - t8:.1f} s", flush=True)
        if args.profile:
            with torch.inference_mode():
                prof = stage_breakdown(cfg, ZONE, rng, epi)
            print(prof["kernel_table"])
            print(json.dumps({"stage_ms": prof["stage_ms"], "card": card}), flush=True)
            print(flair["breakdown"]["kernel_table"])
            print(json.dumps({"train_step_ms": flair["breakdown"]["stage_ms"],
                              "busy_share": flair["breakdown"]["busy_share"], "card": card}),
                  flush=True)
            print(meta["breakdown"]["kernel_table"])
            print(json.dumps({"metadata_train_step_ms": meta["breakdown"]["stage_ms"],
                              "busy_share": meta["breakdown"]["busy_share"],
                              "metadata_mlp_and_fusion_ms": meta["metadata_ms"], "card": card}),
                  flush=True)

    src = "flairtpu_torch/csrc"
    timed = stitch["timed"]

    def numbers(r: dict) -> dict:
        return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    def sweep_launches(name: str) -> int:
        return sum(run[name] for run in sweep["launches"].values())

    def stream_launches(name: str) -> int:
        return sum(run["launches"][name] for run in streaming.values())

    def arch_launch_sum(name: str) -> int:
        """A kernel's launches on phase 5's main paths, class_prob runs and
        sweeps, and phase 5b's knob runs."""
        runs = [r["launches"] for r in archs.values()]
        runs += [r[k]["launches"] for r in archs.values() for k in ("class_prob",) if k in r]
        runs += [x["launches"] for r in archs.values() if "sweep" in r
                 for x in r["sweep"].values()]
        runs += [r["launches"] for r in arch_knobs.values()]
        return sum(run[name] for run in runs)

    def flair_arch_launches(name: str) -> int:
        """A kernel's launches on phase 4d's flair runs."""
        return sum(r["launches"][name] for r in flair_archs.values())

    def case_launches(label: str, mode: str) -> int:
        """strided_tail's launches in phase 5 for the archs of a phase 2 case:
        argmax on their main paths; probs and logits on deeplabv3plus's
        class_prob run and sweep (linknet's route hands its head logits
        through: the logits mode at U = 1 is timed here, never launched)."""
        of = label.split(", ")
        if mode == "argmax":
            return sum(archs[a]["launches"]["strided_tail"] for a in of)
        if "deeplabv3plus" not in of:
            return 0
        dl = archs["deeplabv3plus"]
        if mode == "probs":
            return dl["class_prob"]["launches"]["strided_tail_probs"]
        return sum(x["launches"]["strided_tail_logits"] for x in dl["sweep"].values())

    # fused_tail: the argmax mode's numbers on the main path, and each mode's
    # (launches counted on the run of its own path: class_prob, the sweep,
    # and the streaming runs)
    modes = [
        {"mode": "argmax", "launches": main_path["launches"]["fused_tail"]
         + stream_launches("fused_tail") + arch_launch_sum("fused_tail"),
         "max_abs_err": tail["max_abs_err"], **numbers(tail), "library_ms": tail["library_ms"]},
        {"mode": "probs", "replaces": "flairtpu/zone/device_engine.py:176-185",
         "launches": class_prob["launches"]["fused_tail_probs"]
         + stream_launches("fused_tail_probs") + arch_launch_sum("fused_tail_probs"),
         "max_abs_err": probs["max_abs_err"], **numbers(probs),
         "library_ms": probs["library_ms"]},
        {"mode": "argmax, margin 0 (flair predict)", "replaces": "flairtpu/predict/runner.py:"
         "80-81 with flairtpu/train/loop.py:405-415", "launches": flair["launches"]["fused_tail"],
         "launches_flair_archs": flair_arch_launches("fused_tail"),
         "max_abs_err": tail0["max_abs_err"], **numbers(tail0),
         "library_ms": tail0["library_ms"]},
        {"mode": "logits", "replaces": "flairtpu/zone/device_engine.py:206, :519",
         "launches": sweep_launches("fused_tail_logits") + stream_launches("fused_tail_logits")
         + arch_launch_sum("fused_tail_logits"),
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
         "launches_flair_archs": flair_arch_launches("conv_epilogue"),
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
        # main zone and phase 5b's runs); library: torch._int_mm on each
        # site's im2col operand
        {"name": "int8_conv", "route": "cuda", "source": f"{src}/int8_conv.cu",
         "replaces": "flairtpu/models/quantize.py:218-230 (_quant_conv), with the walk's "
                     "residual and ReLU (:125-135, :174-175) and the next site's requantize "
                     "(:223)",
         "launches": int8_run["launches"]["int8_conv"] + arch_launch_sum("int8_conv"),
         "max_abs_err": int8["max_abs_err"],
         **numbers(int8["conv"]), "library_ms": int8["conv"]["library_ms"]},
        # the 16 grouped sites of one resnext50_32x4d batch of 128, summed
        # (launches: phase 7's int8 run); bound by the card's int8 rate
        # (PEAK_INT8_OPS) or HBM bytes; no PyTorch call computes a grouped
        # int8 convolution
        {"name": "int8_conv_grouped", "route": "cuda", "source": f"{src}/int8_conv.cu",
         "replaces": "flairtpu/models/quantize.py:218-230 (_quant_conv with "
                     "feature_group_count=groups) at the resnext walk's grouped 3x3 "
                     "(:122-124)",
         "launches": resnext["int8"]["launches"]["int8_conv_grouped"],
         "max_abs_err": grouped["max_abs_err"], **numbers(grouped), "library_ms": None,
         "ms_is": "device", "call_ms": grouped["call_ms"]},
        # its 4 sites of one batch of 128, summed (launches: phase 3g's main
        # zone and phase 5b's runs)
        {"name": "quantize_act", "route": "cuda", "source": f"{src}/quantize_act.cu",
         "replaces": "flairtpu/models/quantize.py:223 (the requantize of the stem input, "
                     "the pooled stem and the int8 decoder blocks' inputs)",
         "launches": int8_run["launches"]["quantize_act"] + arch_launch_sum("quantize_act"),
         "max_abs_err": 0,
         **numbers(int8["quantize"]), "library_ms": None},
        # the train batch's 16 patches (launches: phase 4's train, eval and predict)
        {"name": "augment_normalize", "route": "cuda", "source": f"{src}/augment_normalize.cu",
         "replaces": "flairtpu/data/augment.py:35-54, flairtpu/train/loop.py:271-274 and "
                     ":339-342 (XLA-fused D4 augmentation, label cleaning, normalize_device)",
         "launches": flair["launches"]["augment_normalize"],
         "launches_flair_archs": flair_arch_launches("augment_normalize"), "max_abs_err": 0,
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
         "launches_flair_archs": flair_arch_launches("weighted_ce"),
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
         "launches": flair["launches"]["bn_stats"],
         "launches_flair_archs": flair_arch_launches("bn_stats"),
         "max_abs_err": bn["max_abs_err"],
         **numbers(bn["stats"]), "call_ms": bn["stats"]["call_ms"],
         "library_ms": bn["stats"]["library_ms"],
         "modes": [dict({k: v for k, v in bn[m].items() if k not in ("sites", "routes")},
                        launches=flair["launches"]["bn_stats" if m == "stats" else
                                                   "bn_backward"]) for m in ("stats",
                                                                             "backward")]},
        # the deeplabv3plus / fpn / pan head logits (U = 4) at the main path's
        # shapes (launches: phase 5's main-path runs and phase 5b's); each case's modes
        # (probs: deeplabv3plus's class_prob run, logits: its sweep)
        {"name": "strided_tail", "route": "cuda", "source": f"{src}/strided_tail.cu",
         "replaces": "flairtpu/models/deeplab.py:73-91 (via flairtpu/models/factory.py:285-293), "
                     "flairtpu/ops/fused.py:38-45 and the plane writes "
                     "flairtpu/zone/device_engine.py:140-160 (XLA-fused)",
         "launches": arch_launch_sum("strided_tail"),
         "max_abs_err": strided["max_abs_err"],
         **numbers(strided["cases"]["deeplabv3plus, fpn, pan"]["modes"]["argmax"]),
         "library_ms": None,
         "launches_flair_archs": flair_arch_launches("strided_tail"),
         "modes": [dict(case=label, launches=case_launches(label, m["mode"]), **m)
                   for label, case in strided["cases"].items() for m in case["modes"].values()]
         + [dict(case=f"{arch} (flair predict: argmax into tiles, margin 0, batch "
                      f"{TRAIN_BATCH})", launches=r["launches"]["strided_tail"],
                 **{k: r["predict_tail"][k] for k in ("up", "ms", "plain_ms", "bound_ms",
                                                       "bound_by", "max_abs_err")})
            for arch, r in flair_archs.items() if r["predict_tail"]["kernel"] == "strided_tail"]},
        # FPN's 7 sites of one batch of 128, summed (launches: phase 5's fpn
        # run and phase 5b's); library: F.group_norm alone on each site's bf16 input (no
        # ReLU, no upsample, bf16 out: not the same function)
        {"name": "group_norm_relu", "route": "cuda", "source": f"{src}/group_norm.cu",
         "replaces": "flairtpu/models/smp_extra.py:52-68 at :95-100 (XLA-fused GroupNorm(32), "
                     "ReLU and 2x nearest upsample)",
         "launches": arch_launch_sum("group_norm_relu"),
         "launches_flair_archs": flair_arch_launches("group_norm_relu"),
         "max_abs_err": gnorm["max_abs_err"], **numbers(gnorm),
         "library_ms": gnorm["library_ms"]},
        # FPN's 7 sites of one batch-16 step, summed, device time (call_ms:
        # events around the calls; launches: phase 4d's fpn run); library:
        # aten's native_group_norm_backward on each site's bf16 map
        # (GroupNorm alone: no ReLU, no upsample; not the same function)
        {"name": "group_norm_relu_backward", "route": "cuda", "source": f"{src}/group_norm.cu",
         "replaces": "the VJP of flairtpu/models/smp_extra.py:52-68 at :95-100 in "
                     "flairtpu/train/loop.py:286-311 (jax.value_and_grad, XLA-fused)",
         "launches": flair_arch_launches("group_norm_relu_backward"),
         "max_abs_err": gnorm_back["max_abs_err"], **numbers(gnorm_back),
         "call_ms": gnorm_back["call_ms"], "library_ms": gnorm_back["library_ms"]},
        # PAN's 6 one-channel sites of one batch-16 step, summed, device time
        # (launches: phase 4d's pan run): the forward (statistics and the
        # site's output, one launch), the backward in its mode; library
        # torch.var_mean(correction=0) and aten's native_batch_norm_backward;
        # floors: an empty kernel's launch and one block's reduction
        {"name": "bn_train_narrow", "route": "cuda", "source": f"{src}/bn_train.cu",
         "replaces": "flairtpu/models/pan.py:39-55 (flax train-mode BatchNorm) at the "
                     "1-channel sites of :83-95, with their VJP",
         "launches": flair_arch_launches("bn_stats_narrow"),
         "max_abs_err": bn_narrow["max_abs_err"], **numbers(bn_narrow["stats"]),
         "library_ms": bn_narrow["stats"]["library_ms"], "floors_ms": bn_narrow["floors"],
         "modes": [dict(numbers(bn_narrow[m]), mode=m, library_ms=bn_narrow[m]["library_ms"],
                        launches=flair_arch_launches("bn_stats_narrow" if m == "stats" else
                                                     "bn_backward_narrow"))
                   for m in ("stats", "backward")]},
    ]
    # the SiLU epilogue and squeeze-excite kernels: their sites of one
    # efficientnet-b4-unet batch of 128 (phase 8), summed; launches on its
    # main path, and on phase 8's other runs beside
    ek = effnet["kernels"]
    effnet_runs = [effnet[k]["launches"] for k in
                   ("class_prob", *(f"{EFFNET_SMALL}_{a}" for a in EFFNET_ARCHS), "predict")]
    for name, replaces, library in (
            ("conv_epilogue_silu", "flairtpu/models/efficientnet.py:182, :244-245 (XLA-fused "
             "BatchNorm and SiLU after the expand and stem convs)", "F.silu on the bf16 map"),
            ("se_squeeze", "flairtpu/models/efficientnet.py:191-193 (XLA-fused depthwise "
             "BatchNorm, SiLU and the squeeze-excite mean)", "torch.mean on the bf16 map"),
            ("se_excite", "flairtpu/models/efficientnet.py:191, :199-201 (XLA-fused depthwise "
             "BatchNorm, SiLU, the gate multiply and the cast)", None)):
        r = ek[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{src}/{'conv_epilogue' if name.startswith('conv') else 'se_gate'}.cu",
            "replaces": replaces, "launches": effnet["main"]["launches"][name],
            "launches_effnet_other_runs": sum(run[name] for run in effnet_runs),
            "max_abs_err": r["max_abs_err"], **numbers(r), "call_ms": r["call_ms"],
            "library_ms": r["library_ms"], "library": library, "sites": r["sites"]})
    # EfficientNet training's kernel modes: their sites of one
    # efficientnet-b4-unet train step at batch 16 (phase 8b), summed, device
    # time; launches on its flair run (one epoch of 4 steps); library: the
    # nearest PyTorch call, not the same function (torch.var_mean and aten's
    # native_batch_norm_backward on the pre-multiplied gradient: BatchNorm
    # alone; torch.linalg.vecdot of g and the raw map: no BatchNorm, no SiLU)
    tk, tl = effnet_train["kernels"], effnet_train["launches"]
    for name, source, replaces, counter, library in (
            ("bn_train_wide", "bn_train.cu", "flairtpu/models/efficientnet.py:170-182, :191 "
             "(flax train-mode BatchNorm and its VJP at the maps above 2048 channels)",
             "bn_stats_wide", "torch.var_mean; native_batch_norm_backward"),
            ("bn_backward_silu", "bn_train.cu", "the VJP of flairtpu/models/efficientnet.py:182,"
             " :244-245 (train-mode BatchNorm + SiLU at the stem and expand sites; XLA-fused)",
             "bn_backward_silu", "native_batch_norm_backward"),
            ("se_backward", "se_gate.cu", "the VJP of flairtpu/models/efficientnet.py:193-199 "
             "(the squeeze-excite gate's gradient; XLA-fused)", "se_backward",
             "torch.linalg.vecdot"),
            ("bn_backward_affine", "bn_train.cu", "the VJP of flairtpu/models/efficientnet.py:"
             "191-199, :202-211 (the depthwise site's BatchNorm, SiLU, gate and mean; the "
             "drop-connect; XLA-fused)", "bn_backward_affine", "native_batch_norm_backward"),
            ("conv_epilogue_drop", "conv_epilogue.cu", "flairtpu/models/efficientnet.py:"
             "202-211 (the project BatchNorm, drop-connect and identity; XLA-fused)",
             "conv_epilogue_drop", None)):
        r = tk[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"{src}/{source}", "replaces": replaces,
            "launches": tl[counter], "max_abs_err": r["max_abs_err"], **numbers(r),
            "ms_is": "device", "library_ms": r["library_ms"], "library": library,
            "sites": r["sites"], **({"modes": r["modes"]} if "modes" in r else {})})
    # each kernel's launches on phase 6's toy-zone run and phase 7's runs
    # (the resnext main path, bn_fold, int8 and flair)
    counters = {"fused_tail": "fused_tail", "gather_normalize": "gather_normalize",
                "conv_epilogue": "conv_epilogue", "int8_conv": "int8_conv",
                "int8_conv_grouped": "int8_conv_grouped", "quantize_act": "quantize_act",
                "augment_normalize": "augment_normalize", "weighted_ce": "weighted_ce",
                "bn_train": "bn_stats"}
    resnext_runs = [resnext[k]["launches"] for k in ("main", "bn_fold", "int8", "flair")]
    for kernel in kernels:
        name = counters.get(kernel["name"])
        if name:
            kernel["launches_native_weights"] = native["launches"][name]
            kernel["launches_resnext"] = sum(run[name] for run in resnext_runs)
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
    print(json.dumps({"s2d_stem": {k: v for k, v in s2d.items() if k != "launches"},
                      "stem_conv_ms": stems, "card": card}))
    print(json.dumps({"int8_timings": {k: {f: v for f, v in r.items() if f != "sites"}
                                       for k, r in int8.items() if isinstance(r, dict)},
                      "card": card}))
    print(json.dumps({"stitch_timings": timed, "card": card}))
    print(json.dumps({"flair": flair["stats"], "train_step_vs_plain": flair["step"],
                      "launches": flair["launches"], "card": card}))
    print(json.dumps({"flair_metadata": meta["stats"], "train_step_vs_plain": meta["step"],
                      "launches": meta["launches"], "card": card}))
    print(json.dumps({"flair_a1": a1, "card": card}))
    print(json.dumps({"flair_archs": {a: {k: v for k, v in r.items() if k != "launches"}
                                      for a, r in flair_archs.items()}, "card": card}))
    for arch, r in archs.items():
        if "kernel_table" in r["breakdown_ms"]:
            print(f"{arch}: one batch's kernels")
            print(r["breakdown_ms"].pop("kernel_table"))
    print(json.dumps({"archs": {a: {k: v for k, v in r.items() if k != "launches"}
                                for a, r in archs.items()}, "card": card}))
    print(json.dumps({"arch_knobs": {a: {k: v for k, v in r.items() if k != "launches"}
                                     for a, r in arch_knobs.items()}, "card": card}))
    print(json.dumps({"native_weights": {k: v for k, v in native.items() if k != "launches"},
                      "card": card}))
    print(json.dumps({"resnext": {
        "main": resnext["main"]["stats"], "main_peak_gb": resnext["main"]["peak_gb"],
        **{k: {f: v for f, v in resnext[k].items() if f != "launches"}
           for k in ("bn_fold", "int8")},
        "flair": {k: v for k, v in resnext["flair"].items() if k != "launches"},
        "launches": {k: resnext[k]["launches"] for k in ("main", "bn_fold", "int8")},
        "flair_launches": resnext["flair"]["launches"]}, "card": card}))
    print(json.dumps({"effnet": {
        **{k: {f: v for f, v in effnet[k].items() if f != "launches"}
           for k in ("main", "class_prob", *(f"{EFFNET_SMALL}_{a}" for a in EFFNET_ARCHS),
                     "predict")},
        "depthwise": effnet["depthwise"],
        "kernels": {k: {f: v for f, v in r.items() if f != "largest"} for k, r in ek.items()},
        "launches": {k: effnet[k]["launches"] for k in ("main", "predict")}}, "card": card}))
    bd = effnet_train["breakdown"]
    print(bd["kernel_table"])
    print(json.dumps({"effnet_train": {
        **{k: v for k, v in effnet_train.items() if k not in ("launches", "kernels",
                                                               "breakdown")},
        "breakdown": {k: v for k, v in bd.items() if k != "kernel_table"},
        "kernels": {k: {f: v for f, v in r.items() if f != "largest"} for k, r in tk.items()},
        "launches": {k: v for k, v in tl.items() if v}}, "card": card}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
