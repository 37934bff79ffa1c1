"""Weight loading (counterpart of ``flairtpu/models/convert.py:25-37`` and of
its ``torch_to_flax`` for the resnet, resnext, efficientnet, mobilenet_v2
and mobileone encoders (``:53-69, 109-112, 400-455, 527-545``), the unet,
unetplusplus, manet, deeplabv3plus, deeplabv3, fpn, pspnet, linknet and pan
decoders (``:158-177, 655-845``) and the metadata-MLP keys, both ways).

The port's modules carry smp's key names, so an smp ``.pth`` state dict (or a
Lightning ``.ckpt`` after ``normalize_keys``) loads into it strictly as it
is. ``from_flax`` brings ``flairtpu``'s Flax variables, as numpy arrays, into
the port's ``state_dict``, and ``to_flax`` takes a state dict back to the
tree ``flairtpu``'s ``any_state_dict_to_flax`` makes of it. ``flairtpu``'s
native weights (``.msgpack`` / ``.flax``: ``{"params", "batch_stats"}`` in
flax's msgpack form, ``flairtpu/train/checkpoints.py:195-222``) are read
and written through ``io/msgpack.py``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from flairtpu_torch.io import msgpack

NATIVE_SUFFIXES = (".msgpack", ".flax")


def load_torch_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Read a .pth/.pt/.ckpt file into {torch_key: np.ndarray}."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if str(path).endswith(".ckpt") and isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if hasattr(obj, "state_dict") and not isinstance(obj, dict):
        obj = obj.state_dict()
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


def normalize_keys(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Strip Lightning wrappers: model.seg_model.* -> *, keep model.enc.* MLP."""
    if any(k.startswith("model.seg_model.") for k in sd):
        out = {}
        for k, v in sd.items():
            if k.startswith("model.seg_model."):
                out[k[len("model.seg_model."):]] = v
            elif k.startswith("model.enc."):
                out[k[len("model."):]] = v  # enc.enc_mlp.*
        return out
    return dict(sd)


def load_weights(model: torch.nn.Module, path: str | Path) -> None:
    """Strict load of smp-keyed torch weights, or of ``flairtpu``'s native
    ``.msgpack`` / ``.flax`` weights through :func:`from_flax`, into
    ``model`` (the analog of the reference's ``load_state_dict(strict=True)``;
    ``flairtpu/train/checkpoints.py:205-222``)."""
    if str(path).endswith(NATIVE_SUFFIXES):
        model.load_state_dict(from_flax(*read_native(path), model.arch), strict=True)
        return
    sd = normalize_keys(load_torch_state_dict(path))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()
          if not k.startswith(("criterion.", "optimizer."))}
    # BatchNorm counters carry no weights; checkpoints may leave them out
    for k in model.state_dict():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, torch.zeros((), dtype=torch.long))
    model.load_state_dict(sd, strict=True)


_ENC_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")
# EfficientNet (smp's encoder._conv_stem / _bn0 / _blocks.{j}.<member>):
# flax's stem and block member names by smp's
_EN_STEM = {"stem_conv": "_conv_stem", "stem_bn": "_bn0"}
_EN_MEMBER = {"expand_conv": "_expand_conv", "expand_bn": "_bn0", "dw_conv": "_depthwise_conv",
              "dw_bn": "_bn1", "se_reduce": "_se_reduce", "se_expand": "_se_expand",
              "project_conv": "_project_conv", "project_bn": "_bn2"}
_EN_BLOCK_RE = re.compile(r"^block(\d+)$")
# MobileNetV2 (torchvision's encoder.features.{i}): flax's f0_conv / f0_bn
# and f18_conv / f18_bn are features.{0,18}.{0,1}; an inverted residual
# f{i}/<member> is features.{i}.conv.<index>, one index lower in
# features.1, which has no expand (flairtpu/models/convert.py:420-455)
_MN_ENDS_RE = re.compile(r"^f(0|18)_(conv|bn)$")
_MN_BLOCK_RE = re.compile(r"^f(\d+)$")
_MN_MEMBER = {"expand": "0.0", "expand_bn": "0.1", "dw": "1.0", "dw_bn": "1.1", "project": "2",
              "project_bn": "3"}
_MN_MEMBER_EXPANDLESS = {"dw": "0.0", "dw_bn": "0.1", "project": "1", "project_bn": "2"}
# MobileOne (smp's encoder.stage0 and encoder.stage{n}.{i}): flax's stage0 /
# stage{n}_{i}, whose members rbr_conv_{j}/{conv,bn}, rbr_scale/{conv,bn},
# rbr_skip (a bare BatchNorm) and se/{reduce,expand} are smp's rbr_conv.{j}.*,
# rbr_scale.*, rbr_skip and se.* (flairtpu/models/convert.py:109-112, 527-545)
_MO_STAGE_RE = re.compile(r"^stage(\d)(?:_(\d+))?$")
_MO_CONV_RE = re.compile(r"^rbr_conv_(\d+)$")
# a U-Net block (blockN: blocks.N) or a UNet++ node (x_d_l: blocks.x_d_l);
# MAnet's MFAB blocks keep the same conv1/bn1/conv2/bn2 names
_DEC_BLOCK_RE = re.compile(r"^(?:block(\d+)|(x_\d+_\d+))$")
_MLP_FC_RE = re.compile(r"^fc([012])$")
_DEC_SUB = {"conv1": "conv1.0", "bn1": "conv1.1", "conv2": "conv2.0", "bn2": "conv2.1"}
_ENC_SUB = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
_LEAF = {("params", "kernel"): "weight", ("params", "bias"): "bias",
         ("params", "scale"): "weight", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


# flax module paths of the slice-5 decoders (``decoder/<module>/...``) ->
# smp prefixes, by architecture (deeplabv3plus and deeplabv3 share flax
# names under other smp keys)
_ASPP = {"aspp_conv/conv": "convs.0.0", "aspp_conv/bn": "convs.0.1",
         "aspp_pool/conv": "convs.4.1", "aspp_pool/bn": "convs.4.2",
         "aspp_project/conv": "project.0", "aspp_project/bn": "project.1"}
_DECODER_KEYS = {
    "deeplabv3plus": {
        **{k: f"aspp.0.{v}" for k, v in _ASPP.items()},
        **{f"aspp_sep{i}/{sub}": f"aspp.0.convs.{i + 1}.{key}" for i in range(3)
           for sub, key in (("sep/dw", "0.0"), ("sep/pw", "0.1"), ("bn", "1"))},
        "aspp_out/sep/dw": "aspp.1.0", "aspp_out/sep/pw": "aspp.1.1", "aspp_out/bn": "aspp.2",
        "block1/conv": "block1.0", "block1/bn": "block1.1",
        "block2/sep/dw": "block2.0.0", "block2/sep/pw": "block2.0.1", "block2/bn": "block2.1"},
    "deeplabv3": {
        **{k: f"0.{v}" for k, v in _ASPP.items()},
        **{f"aspp_atrous{i}_{sub}": f"0.convs.{i + 1}.{key}" for i in range(3)
           for sub, key in (("conv", "0"), ("bn", "1"))},
        "out_conv": "1", "out_bn": "2"},
    "fpn": {"p5": "p5", **{f"p{n}_skip": f"p{n}.skip_conv" for n in (2, 3, 4)},
            **{f"seg{i}_c{j}/{sub}": f"seg_blocks.{i}.block.{j}.block.{key}"
               for i in range(4) for j in range(3) for sub, key in (("conv", "0"), ("gn", "1"))}},
    "pspnet": {**{f"psp_block{i}/{sub}": f"psp.blocks.{i}.pool.1.{key}" for i in range(4)
                  for sub, key in (("conv", "0"), ("bn", "1"))},
               "conv/conv": "conv.0", "conv/bn": "conv.1"},
    "linknet": {f"block{i}/{sub}": f"blocks.{i}.block.{key}" for i in range(5)
                for sub, key in (("conv_in/conv", "0.0"), ("conv_in/bn", "0.1"),
                                 ("convt", "1.0"), ("convt_bn", "1.1"),
                                 ("conv_out/conv", "2.0"), ("conv_out/bn", "2.1"))},
    "manet": {**{f"center/{c}": f"center.{c}" for c in ("top_conv", "center_conv",
                                                         "bottom_conv", "out_conv")},
              **{f"block{i}/hl{j}_{sub}": f"blocks.{i}.hl_conv.{j}.{key}" for i in range(4)
                 for j in (0, 1) for sub, key in (("conv", "0"), ("bn", "1"))},
              **{f"block{i}/se_{w}/fc{j}": f"blocks.{i}.SE_{w}.{2 * j + 1}" for i in range(4)
                 for w in ("hl", "ll") for j in (0, 1)}},
    "pan": {**{f"fpa/{name}/{sub}": f"fpa.{key}.{sub}" for sub in ("conv", "bn")
               for name, key in (("branch1", "branch1.1"), ("mid", "mid.0"),
                                 ("down1", "down1.1"), ("down2", "down2.1"),
                                 ("down3_0", "down3.1"), ("down3_1", "down3.2"),
                                 ("conv1", "conv1"), ("conv2", "conv2"))},
            **{f"gau{n}/{name}/{sub}": f"gau{n}.{key}.{sub}" for n in (1, 2, 3)
               for sub in ("conv", "bn") for name, key in (("conv1", "conv1.1"),
                                                           ("conv2", "conv2"))}},
}


def _module_prefix(path: tuple[str, ...], arch: str = "unet") -> str:
    """Flax module path -> smp module prefix (resnet encoder, ``arch``'s
    decoder, head, metadata MLP)."""
    top, rest = path[0], path[1:]
    if top == "decoder":
        key = _DECODER_KEYS.get(arch, {}).get("/".join(rest))
        if key is not None:
            return f"decoder.{key}"
    if top == "encoder":
        if len(rest) == 1 and rest[0] in ("conv1", "bn1"):
            return f"encoder.{rest[0]}"
        m = _ENC_LAYER_RE.match(rest[0])
        if m and len(rest) == 2:
            return f"encoder.layer{m.group(1)}.{m.group(2)}.{_ENC_SUB.get(rest[1], rest[1])}"
        if len(rest) == 1 and rest[0] in _EN_STEM:
            return f"encoder.{_EN_STEM[rest[0]]}"
        m = _EN_BLOCK_RE.match(rest[0])
        if m and len(rest) == 2 and rest[1] in _EN_MEMBER:
            return f"encoder._blocks.{m.group(1)}.{_EN_MEMBER[rest[1]]}"
        m = _MN_ENDS_RE.match(rest[0])
        if m and len(rest) == 1:
            return f"encoder.features.{m.group(1)}.{int(m.group(2) == 'bn')}"
        m = _MN_BLOCK_RE.match(rest[0])
        members = _MN_MEMBER_EXPANDLESS if m and m.group(1) == "1" else _MN_MEMBER
        if m and len(rest) == 2 and rest[1] in members:
            return f"encoder.features.{m.group(1)}.conv.{members[rest[1]]}"
        member = _mobileone_member(rest[1:])
        m = _MO_STAGE_RE.match(rest[0])
        if m and member is not None:
            block = "" if m.group(2) is None else f".{m.group(2)}"
            return f"encoder.stage{m.group(1)}{block}.{member}"
    if top == "decoder" and len(rest) == 2:
        m = _DEC_BLOCK_RE.match(rest[0])
        if m and rest[1] in _DEC_SUB:
            return f"decoder.blocks.{m.group(1) or m.group(2)}.{_DEC_SUB[rest[1]]}"
    if top == "segmentation_head" and rest == ("conv",):
        return "segmentation_head.0"
    if top == "metadata_mlp" and len(rest) == 1:
        m = _MLP_FC_RE.match(rest[0])
        if m:  # Linear, Dropout, ReLU a stage: the Linears at 0, 3, 6
            return f"enc.enc_mlp.{3 * int(m.group(1))}"
    raise KeyError(f"no smp key for flax module {'/'.join(path)!r}")


def _mobileone_member(rest: tuple[str, ...]) -> str | None:
    """A MobileOne block's flax member path -> its smp suffix, or None."""
    if rest == ("rbr_skip",):
        return "rbr_skip"
    if len(rest) != 2:
        return None
    m = _MO_CONV_RE.match(rest[0])
    if m and rest[1] in ("conv", "bn"):
        return f"rbr_conv.{m.group(1)}.{rest[1]}"
    if rest[0] == "rbr_scale" and rest[1] in ("conv", "bn"):
        return f"rbr_scale.{rest[1]}"
    if rest[0] == "se" and rest[1] in ("reduce", "expand"):
        return f"se.{rest[1]}"
    return None


def _leaves(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(params: Mapping, batch_stats: Mapping, arch: str = "unet",
              skip_unknown: bool = False) -> dict[str, torch.Tensor]:
    """flairtpu variables (numpy leaves) of a resnet, efficientnet,
    mobilenet_v2 or mobileone encoder with ``arch``'s decoder, the metadata MLP's
    included, -> the port's state_dict. A flax module with no smp key
    raises, or with ``skip_unknown`` is left out."""
    sd: dict[str, torch.Tensor] = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, value in _leaves(tree):
            try:
                prefix = _module_prefix(path[:-1], arch)
            except KeyError:
                if skip_unknown:
                    continue
                raise
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if path[-2:] == ("convt", "kernel"):
                # linknet's transposed conv: flax keeps torch's (I, O, kH, kW)
                # flipped and transposed to (kH, kW, I, O) (smp_extra.py:158-172)
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif path[-1] == "kernel":  # (kH, kW, I, O) -> (O, I, kH, kW); (I, O) -> (O, I)
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            sd[f"{prefix}.{_LEAF[(coll, path[-1])]}"] = torch.from_numpy(
                np.ascontiguousarray(arr))
            if coll == "batch_stats" and path[-1] == "mean":
                sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return sd


def read_native(path: str | Path) -> tuple[dict, dict]:
    """(params, batch_stats) of a native ``.msgpack`` / ``.flax`` file
    (``flairtpu``'s ``load_weights_msgpack``); a ``ValueError`` for a file
    that is not flax's msgpack form of such a tree."""
    tree = msgpack.unpackb(Path(path).read_bytes())
    if not isinstance(tree, dict) or not isinstance(tree.get("params"), dict):
        raise ValueError(f"{path}: not a native weights file (a msgpack map with 'params')")
    stats = tree.get("batch_stats", {})
    if not isinstance(stats, dict):
        raise ValueError(f"{path}: its 'batch_stats' is not a map")
    return tree["params"], stats


_DECODER_INV = {arch: {v: k for k, v in keys.items()} for arch, keys in _DECODER_KEYS.items()}
_DEC_SUB_INV = {v: k for k, v in _DEC_SUB.items()}
_ENC_SUB_INV = {v: k for k, v in _ENC_SUB.items()}
_SMP_LAYER_RE = re.compile(r"^layer(\d+)\.(\d+)\.(.+)$")
_SMP_DEC_BLOCK_RE = re.compile(r"^blocks\.(\d+|x_\d+_\d+)\.(conv[12]\.[01])$")
_SMP_MLP_RE = re.compile(r"^enc\.enc_mlp\.(\d+)$")
_EN_STEM_INV = {v: k for k, v in _EN_STEM.items()}
_EN_MEMBER_INV = {v: k for k, v in _EN_MEMBER.items()}
_SMP_EN_BLOCK_RE = re.compile(r"^_blocks\.(\d+)\.(_\w+)$")
_SMP_MN_ENDS_RE = re.compile(r"^features\.(0|18)\.([01])$")
_SMP_MN_BLOCK_RE = re.compile(r"^features\.(\d+)\.conv\.([\d.]+)$")
_MN_MEMBER_INV = {v: k for k, v in _MN_MEMBER.items()}
_MN_MEMBER_EXPANDLESS_INV = {v: k for k, v in _MN_MEMBER_EXPANDLESS.items()}
_SMP_MO_RE = re.compile(r"^stage(\d)(?:\.(\d+))?\.(rbr_conv\.(\d+)\.(conv|bn)|rbr_scale\.(conv|bn)"
                        r"|rbr_skip|se\.(reduce|expand))$")


def _flax_module(prefix: str, arch: str = "unet") -> tuple[str, ...]:
    """smp module prefix -> flax module path: the inverse of :func:`_module_prefix`."""
    top, _, rest = prefix.partition(".")
    if top == "decoder":
        if rest in _DECODER_INV.get(arch, {}):
            return ("decoder", *_DECODER_INV[arch][rest].split("/"))
        m = _SMP_DEC_BLOCK_RE.match(rest)
        if m:
            block = m.group(1)
            return ("decoder", f"block{block}" if block.isdigit() else block,
                    _DEC_SUB_INV[m.group(2)])
    if top == "encoder":
        if rest in ("conv1", "bn1"):
            return ("encoder", rest)
        m = _SMP_LAYER_RE.match(rest)
        if m:
            return ("encoder", f"layer{m.group(1)}_{m.group(2)}",
                    _ENC_SUB_INV.get(m.group(3), m.group(3)))
        if rest in _EN_STEM_INV:
            return ("encoder", _EN_STEM_INV[rest])
        m = _SMP_EN_BLOCK_RE.match(rest)
        if m and m.group(2) in _EN_MEMBER_INV:
            return ("encoder", f"block{m.group(1)}", _EN_MEMBER_INV[m.group(2)])
        m = _SMP_MN_ENDS_RE.match(rest)
        if m:
            return ("encoder", f"f{m.group(1)}_{('conv', 'bn')[int(m.group(2))]}")
        m = _SMP_MN_BLOCK_RE.match(rest)
        members = (_MN_MEMBER_EXPANDLESS_INV if m and m.group(1) == "1" else _MN_MEMBER_INV)
        if m and m.group(2) in members:
            return ("encoder", f"f{m.group(1)}", members[m.group(2)])
        m = _SMP_MO_RE.match(rest)
        if m:
            block = f"stage{m.group(1)}" + ("" if m.group(2) is None else f"_{m.group(2)}")
            if m.group(4) is not None:
                return ("encoder", block, f"rbr_conv_{m.group(4)}", m.group(5))
            if m.group(6) is not None:
                return ("encoder", block, "rbr_scale", m.group(6))
            if m.group(7) is not None:
                return ("encoder", block, "se", m.group(7))
            return ("encoder", block, "rbr_skip")
    if prefix == "segmentation_head.0":
        return ("segmentation_head", "conv")
    m = _SMP_MLP_RE.match(prefix)
    if m and int(m.group(1)) % 3 == 0:
        return ("metadata_mlp", f"fc{int(m.group(1)) // 3}")
    raise KeyError(f"no flax module for smp module {prefix!r}")


def to_flax(state_dict: Mapping, arch: str = "unet") -> dict[str, dict]:
    """The port's (or an smp) state dict -> ``{"params", "batch_stats"}`` of
    float32 numpy leaves, as ``flairtpu``'s ``any_state_dict_to_flax`` maps
    it (``flairtpu/models/convert.py:209-866``): the exact inverse of
    :func:`from_flax`. Conv kernels (O, I, kh, kw) -> (kh, kw, I, O), dense
    (O, I) -> (I, O), a norm's weight -> its scale, running statistics ->
    ``batch_stats``; linknet's transposed kernel (I, O, kh, kw) flipped to
    (kh, kw, I, O); BatchNorm counters dropped."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, value in state_dict.items():
        prefix, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = _flax_module(prefix, arch)
        arr = np.asarray(value.detach().cpu() if isinstance(value, torch.Tensor) else value,
                         dtype=np.float32)
        if leaf == "weight" and path[-1] == "convt":
            coll, name, arr = "params", "kernel", arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        elif leaf == "weight":
            coll, name = ("params", "scale") if arr.ndim == 1 else ("params", "kernel")
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T if arr.ndim == 2 else arr
        else:
            coll, name = {"bias": ("params", "bias"), "running_mean": ("batch_stats", "mean"),
                          "running_var": ("batch_stats", "var")}[leaf]
        node = out[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return out


def write_native(path: str | Path, state_dict: Mapping, arch: str = "unet") -> None:
    """``{"params", "batch_stats"}`` of :func:`to_flax` written as flax's
    msgpack (``flairtpu``'s ``save_weights_msgpack``), through a temporary
    name and an atomic rename."""
    path = Path(path)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(msgpack.packb(to_flax(state_dict, arch)))
    tmp.replace(path)
