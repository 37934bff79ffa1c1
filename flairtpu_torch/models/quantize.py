"""Post-training int8 quantization (w8a8) of the ResNet encoders for zone
inference (``quantize: int8``; counterpart of
``flairtpu/models/quantize.py:200-427, 495-518``, the ResNet part).

BatchNorm folds into each conv (``models/fold.py``); weights are quantized
per output channel and activations per tensor, with symmetric scales
calibrated on 16 tiles of the zone itself. The encoder and decoder blocks
0..``int8_decoder``-1 then run as int8 sites (``ops/int8_conv.py``: int8 x
int8 -> int32, dequantize, bias, residual, ReLU, and the next site's
requantize in one kernel; ``ops/quantize_act.py`` where a site's input is
not an int8 site's output). The other decoder blocks and the head stay
folded float in the model's compute dtype; ``int8_decoder: 0`` keeps the
float decoder with its BatchNorms, as ``flairtpu`` does. The other archs
quantize their encoder only, at their output stride and depth, and keep
their float decoder and head: ``int8_decoder`` has no effect there
(``quantize.py:398-410``).

Calibration (:func:`calibrate`) runs the folded float32 walk over the
calibration tiles and takes ``max|x|`` at every site's input. On the card it
runs as float32 cuDNN convolutions with ``allow_tf32`` off and PyTorch
element-wise ops and ``amax``: it is set-up, once per zone or department,
not the per-batch path; its seconds are reported in the run's stats.

Scales are computed as ``flairtpu`` computes them, so that both packages
hold the same int8 weights and scales: ``sx = max(act_max, 1e-12) / 127``
as a Python float cast to float32, ``sw`` and ``wq`` in float32.

On the card, with ``quantize`` alone, ``flairtpu`` runs the float sites in
float32; the port has no float32 instance of ``conv_epilogue`` or
``fused_tail`` and runs them in the compute dtype (bfloat16), as with
``bn_fold`` (ROADMAP queue 3). On the CPU both run float32.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.models.fold import (N_DECODER_BLOCKS, FloatSites, float_sites,
                                        fold_encoder, fold_tail_params, fold_unet_decoder,
                                        head_logits, join_values, walk_features,
                                        walk_unet_decode)
from flairtpu_torch.models.resnet import RESNET_SPECS
from flairtpu_torch.ops.epilogue import conv_epilogue
from flairtpu_torch.ops.group_norm import group_norm_relu
from flairtpu_torch.ops.int8_conv import Int8ConvParams, int8_conv
from flairtpu_torch.ops.quantize_act import quantize_act

# decoder blocks in int8 by default (flairtpu/models/quantize.py:362)
DEFAULT_DECODER_BLOCKS = 2
CALIBRATION_TILES, CALIBRATION_BATCH = 16, 4


def decoder_quant_blocks(config: dict) -> int:
    """The ``int8_decoder`` knob as a block count 0..5 (``quantize.py:365-375``)."""
    raw = config.get("int8_decoder", True)
    if raw is True:
        return DEFAULT_DECODER_BLOCKS
    if raw is False or raw is None:
        return 0
    n = int(raw)
    if not 0 <= n <= 5:
        raise ValueError(f"int8_decoder: expected a bool or 0..5, got {raw!r}")
    return n


# ---------------------------------------------------------------------------
# calibration and weight quantization
# ---------------------------------------------------------------------------

class CalibrationSites:
    """Walk ops of the folded float32 walk that record each site's input
    max|x| into ``maxes`` (under ``prefix``); values are float32 tensors."""

    def __init__(self, sites: dict, maxes: dict, prefix: str = ""):
        self.sites, self.maxes, self.prefix = sites, maxes, prefix

    def conv(self, name, x, stride, padding, relu=True, residual=None, keep=True, feeds=None,
             dilation=1, groups=1):
        self.maxes[self.prefix + name] = x.abs().amax()
        c = self.sites[name]
        y = F.conv2d(x, c["w"], None, stride, padding, dilation, groups) + c["b"][:, None, None]
        if residual is not None:
            y = y + residual
        return torch.relu(y) if relu else y

    def downsample(self, name, x, stride):
        return self.conv(name, x, stride, 0, relu=False)

    def pool(self, x):
        return F.max_pool2d(x, 3, 2, 1)

    def join(self, i, x, skip, crop):
        return join_values(x, skip, crop)


def calibrate(spec: str, folded: dict, batches_u8, norm: dict, device: torch.device,
              folded_dec: dict | None = None, output_stride: int = 32,
              depth: int = 5) -> dict:
    """Per-site input absmax over the calibration batches ((B, S, S, C) uint8
    arrays) of the folded float32 walk at ``output_stride`` and ``depth``
    (``quantize.py:254-285``); with ``folded_dec`` the U-Net's full decode
    too, under ``dec/<site>``. One fetch at the end."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    agg: dict = {}
    try:
        with torch.inference_mode():
            for b in batches_u8:
                x = normalize(torch.from_numpy(np.asarray(b)).to(device), **norm)
                maxes: dict = {}
                feats = walk_features(spec, CalibrationSites(folded, maxes),
                                      x.permute(0, 3, 1, 2), output_stride, depth)
                if folded_dec is not None:
                    walk_unet_decode(CalibrationSites(folded_dec, maxes, "dec/"), feats, None)
                agg = maxes if not agg else {k: torch.maximum(agg[k], v)
                                             for k, v in maxes.items()}
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    names = sorted(agg)
    vals = torch.stack([agg[n] for n in names]).cpu()  # one fetch
    return {n: float(v) for n, v in zip(names, vals)}


def quantize_folded(folded: dict, act_max: dict) -> dict:
    """Symmetric per-output-channel weights and per-tensor activation
    scales (``quantize.py:288-297``) -> {site: Int8ConvParams}."""
    qp = {}
    with torch.no_grad():
        for name, c in folded.items():
            w = c["w"]
            sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)), 1e-12) / 127.0
            wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127)
            sx = float(np.float32(max(float(act_max[name]), 1e-12) / 127.0))
            qp[name] = Int8ConvParams(wq.to(torch.int8), sx, (sw * sx).float(),
                                      c["b"].float().contiguous(), c.get("groups", 1))
    return qp


def site_groups(spec: str) -> dict:
    """{site: groups} of the grouped sites of ``spec``'s walk: a ResNeXt's
    3x3s (``layer{s}_{u}/conv2``); none for a ResNet."""
    kind, units, groups, _ = RESNET_SPECS[spec]
    if groups == 1:
        return {}
    return {f"layer{s + 1}_{u}/conv2": groups for s, n in enumerate(units) for u in range(n)}


def qparams_from_numpy(qparams: dict, device="cpu", groups: dict | None = None) -> dict:
    """``flairtpu``'s qparams ({site: {"wq": HWIO int8, "sx", "deq", "b"}} as
    numpy) -> {site: Int8ConvParams}: the same scales for both packages;
    ``groups``: {site: groups} of the grouped sites (:func:`site_groups`)."""
    groups = groups or {}
    return {name: Int8ConvParams(
        torch.from_numpy(np.array(c["wq"], np.int8)).permute(3, 2, 0, 1).contiguous()
        .to(device), float(np.float32(c["sx"])),
        torch.from_numpy(np.array(c["deq"], np.float32)).to(device),
        torch.from_numpy(np.array(c["b"], np.float32)).to(device), groups.get(name, 1))
        for name, c in qparams.items()}


# ---------------------------------------------------------------------------
# the int8 walk and the drop-in model
# ---------------------------------------------------------------------------

@dataclass
class Act:
    """An activation of the int8 walk: its float value (float32 from an int8
    site, the compute dtype from a float site; None where only int8 was
    written) and its int8 quantization ``q`` at scale ``sx``, where the site
    that wrote it wrote one. NCHW channels_last."""

    value: torch.Tensor | None
    q: torch.Tensor | None = None
    sx: float | None = None

    @property
    def shape(self):
        return (self.value if self.value is not None else self.q).shape


class MixedSites:
    """Walk ops of the int8 model: int8 sites for the names in ``qparams``,
    folded float sites (``FloatSites``) for the others. An int8 site takes
    its input's int8 value when it has one at its scale, else quantizes the
    float value (``quantize_act``); it writes float32 where ``keep`` and its
    output's int8 at the scale of the site it ``feeds``, where that site is
    int8. The kernels are arguments, so that a run can take their plain
    versions."""

    def __init__(self, qparams: dict, floats: FloatSites, conv=int8_conv,
                 quantize=quantize_act):
        self.qparams, self.floats = qparams, floats
        self.int8_conv, self.quantize_act = conv, quantize

    def conv(self, name, x: Act, stride, padding, relu=True, residual=None, keep=True,
             feeds=None, dilation=1, groups=1) -> Act:
        p = self.qparams.get(name)
        if p is None:
            return Act(self.floats.conv(name, x.value, stride, padding, relu,
                                        None if residual is None else residual.value,
                                        dilation=dilation, groups=groups))
        if p.groups != groups:
            raise ValueError(f"int8 site {name}: {p.groups} groups, the walk has {groups}")
        if x.q is not None and x.sx == p.sx:
            q = x.q
        else:
            q = self.quantize_act(x.value, p.sx, p.in_channels)
        nxt = self.qparams.get(feeds)
        out32, outq = self.int8_conv(
            q, p, stride, padding, dilation=dilation,
            residual=None if residual is None else residual.value,
            relu=relu, keep_f32=keep or nxt is None, out_sx=None if nxt is None else nxt.sx)
        return Act(out32, outq, None if nxt is None else nxt.sx)

    def downsample(self, name, x: Act, stride) -> Act:
        return self.conv(name, x, stride, 0, relu=False)

    def pool(self, x: Act) -> Act:
        return Act(F.max_pool2d(x.value, 3, 2, 1).contiguous(memory_format=torch.channels_last))

    def join(self, i, x: Act, skip: Act | None, crop) -> Act:
        v = join_values(x.value, None if skip is None else skip.value, crop)
        if f"block{i}/conv1" not in self.qparams:
            v = v.to(self.floats.dtype)
        return Act(v)


class QuantizedZoneModel:
    """The int8 zone model (``flairtpu/models/quantize.py:304-353``): the
    zone runners' surface (``dtype``, ``tail_input``) over the int8 encoder
    walk (at ``output_stride`` and ``depth``), then the U-Net's mixed
    decoder walk (``dec_qparams``: blocks 0..int8_decoder-1 in int8, the
    others folded float, ``tail`` driving ``fused_tail`` for block 4) or,
    with no int8 decoder block, ``model``'s float decoder and head with
    their BatchNorms (any arch; ``tail``: its zone tail).

    ``dtype`` is float32, the type of the tile the stem quantizes (the
    gather's output); the float sites run in ``compute_dtype``."""

    dtype = torch.float32

    def __init__(self, spec: str, qparams: dict, dec_qparams: dict | None, dec_float: dict,
                 model, tail, compute_dtype: torch.dtype, calibration_seconds: float = 0.0,
                 output_stride: int = 32, depth: int = 5):
        self.spec, self.qparams, self.dec_qparams = spec, qparams, dec_qparams
        self.dec_float, self.model, self.tail = dec_float, model, tail
        self.compute_dtype = compute_dtype
        self.calibration_seconds = calibration_seconds
        self.encoder_geometry = (output_stride, depth)

    def features(self, x: torch.Tensor, conv=int8_conv, quantize=quantize_act) -> list:
        """x (B, H, W, C) float32 -> [x, f1..] as ``Act``s."""
        ops = MixedSites(self.qparams, None, conv, quantize)
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return walk_features(self.spec, ops, Act(x), *self.encoder_geometry)

    def float_features(self, feats: list) -> list:
        """The int8 walk's features as the float decoder takes them: in the
        compute dtype (the input, which gives only the tile size, as it is)."""
        return [feats[0].value] + [f.value.to(self.compute_dtype) for f in feats[1:]]

    def decode(self, feats: list, inner_margin: int | None, n_blocks: int,
               epilogue=conv_epilogue, conv=int8_conv, quantize=quantize_act):
        """The U-Net's mixed decoder walk, blocks [0, n_blocks) -> (x in the
        compute dtype or float32, offset)."""
        ops = MixedSites(self.dec_qparams, FloatSites(self.dec_float, self.compute_dtype, epilogue),
                         conv, quantize)
        x, off = walk_unet_decode(ops, feats, inner_margin, n_blocks)
        return x.value, off

    def tail_input(self, x: torch.Tensor, margin: int, epilogue=conv_epilogue, conv=int8_conv,
                   quantize=quantize_act, group_norm=group_norm_relu) -> torch.Tensor:
        """The int8 encoder, then the U-Net's decoder blocks 0-3 on the
        interior plan of ``margin`` (``fused_tail``'s input, in the compute
        dtype) or the float model's ``decode_tail``."""
        feats = self.features(x, conv, quantize)
        if self.model is not None:
            return self.model.decode_tail(self.float_features(feats), margin, epilogue,
                                          group_norm)
        x3, _ = self.decode(feats, margin, N_DECODER_BLOCKS - 1, epilogue, conv, quantize)
        return x3.to(self.compute_dtype).contiguous(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor, inner_margin: int | None = None) -> torch.Tensor:
        """x (B, H, W, C) -> float32 logits (B, h, w, K): every block and the
        head (``QuantizedZoneModel.apply``)."""
        feats = self.features(x)
        if self.model is not None:
            return self.model.decode(self.float_features(feats), inner_margin)
        y, off = self.decode(feats, inner_margin, N_DECODER_BLOCKS)
        return head_logits(y.to(self.compute_dtype), self.tail, x.shape[1], inner_margin, off)

    __call__ = forward


def check_quantizable(model) -> None:
    """The ``ValueError`` of ``flairtpu/models/quantize.py:388-395`` for a
    model the int8 walk does not take (a metadata model, an encoder outside
    the resnet families); the zone engine asks before it reads the
    calibration tiles."""
    if model.use_metadata:
        raise ValueError("quantize: int8 does not support use_metadata")
    if model.encoder_name not in RESNET_SPECS:
        raise ValueError(f"quantize: int8 supports the ResNet encoder families "
                         f"({', '.join(sorted(RESNET_SPECS))}); got {model.encoder_name!r}")


def quantize_model(config: dict, model, calib_batches) -> QuantizedZoneModel:
    """Fold, calibrate on ``calib_batches`` ((B, S, S, C) uint8 arrays,
    normalized as the zone is) and quantize a loaded FlairSegmentationModel
    (float32 weights, before ``prepare_inference``) on its device
    (``quantize.py:378-427``): the encoder, and the U-Net's first
    ``int8_decoder`` blocks."""
    check_quantizable(model)
    n_q = decoder_quant_blocks(config) if model.arch == "unet" else 0  # config.py refuses 5
    norma = config["norma_task"][0]
    norm = dict(norm_type=norma["norm_type"], means=tuple(norma.get("norm_means") or ()),
                stds=tuple(norma.get("norm_stds") or ()))
    device = next(model.parameters()).device
    dtype = model.dtype
    geometry = dict(output_stride=model.encoder.output_stride, depth=model.encoder.depth)
    enc = fold_encoder(model.encoder)
    dec = fold_unet_decoder(model.decoder) if n_q else None
    t0 = time.perf_counter()
    act_max = calibrate(model.encoder_name, enc, calib_batches, norm, device, dec, **geometry)
    seconds = time.perf_counter() - t0
    qparams = quantize_folded(enc, act_max)
    if not n_q:  # the float decoder and tail, as FlairSegmentationModel runs them
        model.prepare_inference()
        return QuantizedZoneModel(model.encoder_name, qparams, None, {}, model,
                                  model.zone_tail(), dtype, seconds, **geometry)
    q_sites = {k: v for k, v in dec.items() if int(k[5]) < n_q}
    dec_q = quantize_folded(q_sites, {k: act_max[f"dec/{k}"] for k in q_sites})
    dec_f = {k: v for k, v in dec.items() if k not in q_sites}
    return QuantizedZoneModel(model.encoder_name, qparams, dec_q, float_sites(dec_f, dtype),
                              None, fold_tail_params(dec_f, model.segmentation_head[0], dtype),
                              dtype, seconds)


def read_calibration_batches(config: dict, n_tiles: int = CALIBRATION_TILES,
                             batch: int = CALIBRATION_BATCH) -> list[np.ndarray]:
    """Up to ``n_tiles`` tiles spread evenly over the zone's grid, in batches
    of ``batch`` ((B, S, S, C) uint8; ``quantize.py:495-518``)."""
    from flairtpu_torch.io import TiffReader, Window
    from flairtpu_torch.zone.grid import get_stride, slice_grid

    size, margin = int(config["img_pixels_detection"]), int(config["margin"])
    stride = get_stride(config)[0]
    out = []
    with TiffReader(config["input_img_path"], cache_blocks=64) as r:
        tiles = slice_grid(r.width, r.height, size, margin, stride, r.transform, r.crs).tiles
        idx = np.unique(np.linspace(0, len(tiles) - 1,
                                    min(n_tiles, len(tiles))).astype(int))
        sel = [tiles[i] for i in idx]
        for i in range(0, len(sel), batch):
            imgs = [np.moveaxis(r.read(config["channels"],
                                       window=Window(t.col0, t.row0, size, size),
                                       boundless=True), 0, -1) for t in sel[i:i + batch]]
            out.append(np.ascontiguousarray(np.stack(imgs), dtype=np.uint8))
    return out
