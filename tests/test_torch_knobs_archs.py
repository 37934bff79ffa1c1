"""bn_fold and quantize: int8 with the eight smp architectures other than the
U-Net, against flairtpu (CPU, float32).

flairtpu folds and quantizes only their encoder, at the arch's output
stride and depth (``flairtpu/models/quantize.py:51-52, 95-138, 398-410``),
and keeps their float decoder and head; ``int8_decoder`` has no effect.

- The folded encoder walk at (output stride, depth) (32, 5), (16, 5),
  (8, 5) and (32, 3), on resnet18 and on resnet50 at (8, 5), bit for bit
  flairtpu's walk: with weights that take one tap of each output channel
  (+-1) and integer biases and inputs, every sum is exact in any order, so
  the strides, paddings, dilations, downsample branches and stages are
  what is compared. flairtpu runs it eagerly.
- The int8 encoder features at (8, 5) (deeplabv3) and (32, 3) (pspnet),
  bit for bit flairtpu's jitted int8 walk given the same qparams.
- The folded model's logits against flairtpu's ``FoldedZoneModel`` for
  deeplabv3 and unetplusplus, within 2e-5 of the largest |logit| (slice
  5's bound). The jitted programs are two: each runs one int8 walk and
  one folded model.
- Every one of the eight archs folds and quantizes (``int8_decoder: 5``
  ignored), and its zone tail's logits on ``tail_input`` equal the model's
  own logits within 1e-5 of the largest; ``flair-detect`` runs both knobs.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flairtpu.models import quantize as fq
from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.models.fold import fold_model as flax_fold_model
from flairtpu_torch.cli import detect_main
from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.io import TiffReader
from flairtpu_torch.io.tiff import Affine, write_array
from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.factory import FUSED_TAIL_ARCHS, FlairSegmentationModel
from flairtpu_torch.models.fold import FloatSites, float_sites, fold_encoder, fold_model, \
    walk_features
from flairtpu_torch.ops.fused_tail import TailParams
from flairtpu_torch.ops.strided_tail import StridedTail
from tests.test_torch_models import random_state_dict

N_CLASSES = 4
ARCHS8 = ("unetplusplus", "manet", "linknet", "fpn", "pspnet", "deeplabv3", "deeplabv3plus",
          "pan")
# (encoder, arch): the arch sets the encoder's (output stride, depth)
WALKS = (("resnet18", "fpn", 32, 5), ("resnet18", "deeplabv3plus", 16, 5),
         ("resnet18", "deeplabv3", 8, 5), ("resnet18", "pspnet", 32, 3),
         ("resnet50", "deeplabv3", 8, 5))
NORM = dict(norm_type="scaling", means=(), stds=())
REL_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tile(arch: str) -> int:
    return 128 if arch == "pan" else 64


def port_model(arch: str, seed: int, encoder: str = "resnet18") -> FlairSegmentationModel:
    model = FlairSegmentationModel(encoder, N_CLASSES, 5, arch=arch).eval()
    model.load_state_dict(random_state_dict(model, np.random.default_rng(seed)))
    return model


def flax_pair(model: FlairSegmentationModel):
    """flairtpu's model of the same arch and its variables from the same
    state dict."""
    fmodel = flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder":
                                                          f"{model.encoder_name}_{model.arch}"}},
        "n_classes": N_CLASSES, "channels": [1, 2, 3, 4, 5]})
    return fmodel, torch_to_flax({k: v.numpy() for k, v in model.state_dict().items()})


def u8_batch(seed: int, size: int = 64, n: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 5), dtype=np.uint8)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("encoder,arch,output_stride,depth", WALKS)
def test_folded_walk_bit_equal_to_flairtpu(encoder, arch, output_stride, depth):
    """fold_encoder's sites equal flairtpu's bit for bit (their names: the
    stages the depth keeps, the dilated stages' downsamples); then both
    walks on one-tap integer weights give the same features exactly."""
    model = port_model(arch, 3, encoder)
    assert (model.encoder.output_stride, model.encoder.depth) == (output_stride, depth)
    _, variables = flax_pair(model)
    folded = fold_encoder(model.encoder)
    want = fq.fold_encoder(variables["params"], variables["batch_stats"])
    assert set(folded) == set(want)
    for name, c in folded.items():
        np.testing.assert_array_equal(c["w"].permute(2, 3, 1, 0).numpy(), want[name]["w"])
        np.testing.assert_array_equal(c["b"].numpy(), want[name]["b"])
    rng = np.random.default_rng(11)
    sites = {}
    for name, c in folded.items():
        o, i, kh, kw = c["w"].shape
        w = np.zeros((o, i * kh * kw), np.float32)
        w[np.arange(o), rng.integers(0, i * kh * kw, o)] = rng.choice([-1.0, 1.0], o)
        sites[name] = {"w": torch.from_numpy(w.reshape(o, i, kh, kw)),
                       "b": torch.from_numpy(rng.integers(-1, 2, o).astype(np.float32))}
    x = rng.integers(0, 4, (1, 64, 64, 5)).astype(np.float32)
    ops = FloatSites(float_sites(sites, torch.float32), torch.float32)
    with torch.inference_mode():
        got = walk_features(encoder, ops, torch.from_numpy(x).permute(0, 3, 1, 2),
                            output_stride, depth)
    ref = fq.walk_features(
        encoder, fq._float_conv({k: {"w": jnp.asarray(v["w"].permute(2, 3, 1, 0).numpy()),
                                     "b": jnp.asarray(v["b"].numpy())}
                                 for k, v in sites.items()}, None),
        jnp.asarray(x), output_stride, depth)
    assert len(got) == len(ref) == depth + 1
    for k, (a, b) in enumerate(zip(got[1:], ref[1:])):
        np.testing.assert_array_equal(nhwc(a), np.asarray(b), err_msg=f"feature {k + 1}")
    assert ref[-1].shape[1] == 64 // min(output_stride, 2 ** depth)


def to_flax_qparams(qparams: dict) -> dict:
    return {k: {"wq": jnp.asarray(p.wq.permute(2, 3, 1, 0).numpy()), "sx": jnp.float32(p.sx),
                "deq": jnp.asarray(p.deq.numpy()), "b": jnp.asarray(p.b.numpy())}
            for k, p in qparams.items()}


@pytest.fixture(scope="module", params=[("deeplabv3", "deeplabv3"), ("pspnet", "unetplusplus")],
                ids=["deeplabv3_int8_and_fold", "pspnet_int8_unetplusplus_fold"])
def jitted(request):
    """One jitted flairtpu program: the int8 walk of ``int8_arch``'s encoder
    on the port's qparams, and ``fold_arch``'s folded model's logits."""
    int8_arch, fold_arch = request.param
    enc = port_model(int8_arch, 21).encoder
    geometry = (enc.output_stride, enc.depth)
    folded = fold_encoder(enc)
    calib = [u8_batch(5)]
    act_max = pq.calibrate("resnet18", folded, calib, NORM, torch.device("cpu"), None,
                           *geometry)
    qparams = pq.quantize_folded(folded, act_max)
    fmodel_port = port_model(fold_arch, 22)
    fmodel, variables = flax_pair(fmodel_port)
    ffold = flax_fold_model(fmodel, variables["params"], variables["batch_stats"])
    qp = to_flax_qparams(qparams)
    x = normalize(torch.from_numpy(u8_batch(6)), **NORM)

    @jax.jit
    def run(xj, v):
        feats = fq.walk_features("resnet18", fq._quant_conv(qp), xj, *geometry)
        return feats, ffold.apply(v, xj, train=False)

    feats, logits = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(x.numpy()), variables))
    return dict(qparams=qparams, geometry=geometry, x=x, feats=feats, fold_port=fmodel_port,
                logits=logits)


def test_int8_features_bit_equal_to_flairtpu(jitted):
    """The int8 encoder walk at (8, 5) and (32, 3), given flairtpu the
    port's qparams: every feature bit for bit."""
    qm = pq.QuantizedZoneModel("resnet18", jitted["qparams"], None, {}, None, None,
                               torch.float32, 0.0, *jitted["geometry"])
    with torch.inference_mode():
        got = qm.features(jitted["x"])
    assert len(got) == len(jitted["feats"]) == jitted["geometry"][1] + 1
    for k, (a, b) in enumerate(zip(got[1:], jitted["feats"][1:])):
        np.testing.assert_array_equal(nhwc(a.value), b, err_msg=f"feature {k + 1}")


def test_folded_logits_match_flairtpu(jitted):
    """fold_model: the folded encoder, then the arch's float decoder and
    head, against flairtpu's FoldedZoneModel."""
    fm = fold_model(copy.deepcopy(jitted["fold_port"]))
    with torch.inference_mode():
        got = fm(jitted["x"]).numpy()
    want = jitted["logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS8)
def test_knob_models_run_every_arch(arch):
    """fold_model and quantize_model (``int8_decoder: 5``, ignored: no int8
    decoder block) on each arch: the tail kind of the float model, and the
    tail's logits mode on ``tail_input`` at margin 0 equal to the model's
    whole-tile logits."""
    model = port_model(arch, 40 + ARCHS8.index(arch))
    S = tile(arch)
    x = normalize(torch.from_numpy(u8_batch(9, S, 1)), **NORM)
    cfg = {"int8_decoder": 5, "norma_task": [{"norm_type": "scaling"}]}
    for zm in (fold_model(copy.deepcopy(model)),
               pq.quantize_model(cfg, copy.deepcopy(model), [u8_batch(8, S, 1)])):
        want_kind = TailParams if arch in FUSED_TAIL_ARCHS else StridedTail
        assert isinstance(zm.tail, want_kind) and zm.model is not None
        assert getattr(zm, "dec_qparams", None) is None
        with torch.inference_mode():
            logits = zm.tail.plain_versions()[2](zm.tail_input(x, 0), zm.tail,
                                                 zm.tail.geometry(S, 0))
            want = zm(x)
        assert logits.shape == want.shape == (1, S, S, N_CLASSES)
        assert float((logits - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("arch,knobs", [("deeplabv3", {"quantize": "int8", "bn_fold": True}),
                                        ("unetplusplus", {"bn_fold": True})])
def test_detect_runs_the_knobs(tmp_path, arch, knobs):
    """flair-detect with the knobs on an 80 x 64 zone: the raster agrees
    with the float model's (float32 here: bn_fold only reorders sums, so
    >= 0.999; int8 >= 0.8, tests/test_quantize.py:315's floor), and an
    int8 run reports its calibration."""
    model = port_model(arch, 50)
    torch.save(model.state_dict(), tmp_path / "w.pth")
    img = np.random.default_rng(51).integers(0, 256, (5, 64, 80)).astype(np.uint8)
    write_array(tmp_path / "zone.tif", img, transform=Affine.from_origin(0, 100, 0.2, 0.2),
                crs=2154)
    rasters, stats = {}, {}
    for name, over in (("float", {}), ("knobs", knobs)):
        cfg = {"output_path": str(tmp_path / name), "output_name": "zone",
               "input_img_path": str(tmp_path / "zone.tif"), "channels": [1, 2, 3, 4, 5],
               "img_pixels_detection": 64, "margin": 16, "output_type": "argmax",
               "n_classes": N_CLASSES, "model_weights": str(tmp_path / "w.pth"),
               "model_framework": {"model_provider": "SegmentationModelsPytorch",
                                   "SegmentationModelsPytorch": {"encoder_decoder":
                                                                 f"resnet18_{arch}"}},
               "batch_size": 4, "use_gpu": False, "write_dataframe": False,
               "norma_task": [{"norm_type": "scaling"}], **over}
        conf = Path(tmp_path / f"{name}.yaml")
        conf.write_text(yaml.safe_dump(cfg))
        stats[name] = detect_main([f"--conf={conf}"])
        with TiffReader(tmp_path / name / "zone.tif") as r:
            rasters[name] = r.read()
    assert (rasters["knobs"][1] > 0).all()
    agree = float((rasters["knobs"][0] == rasters["float"][0]).mean())
    assert agree >= (0.8 if "quantize" in knobs else 0.999)
    assert ("calibration_seconds" in stats["knobs"]) == ("quantize" in knobs)
