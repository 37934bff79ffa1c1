"""The ResNeXt encoders in flairtpu_torch against flairtpu (CPU, float32).

resnext50_32x4d-unet (5 classes) from one seeded smp-keyed ``.pth`` for
both packages, at 64 x 64 tiles. Two ``flairtpu`` programs are compiled:
the forward and the int8 walk (one train step is held in
``tests/test_torch_resnext_train.py``).

- Logits: within 2e-5 of the largest |logit| (float32 sums in other
  orders), ``tests/test_torch_manet_unetpp.py``'s bound.
- bn_fold: the folded sites bit for bit; the folded logits against
  ``flairtpu``'s float logits of the same weights within atol = rtol =
  2e-4, ``tests/test_torch_fold.py``'s tolerance.
- int8: the weights, scales and grouped int32 sums bit for bit; the int8
  walk's plain version (encoder features, int8 decoder blocks 0-1) bit for
  bit against ``flairtpu``'s jitted walk given the same qparams, as
  ``tests/test_torch_quantize.py`` holds the resnet walk; the grouped
  kernel's loop over its packed weights, transcribed in numpy, against the
  plain sums.
- init_encoder_weights from a torchvision-keyed resnext classifier: the
  encoder equals ``flairtpu``'s conversion of the same dict.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.data.normalize import normalize_device
from flairtpu.models import pretrained as fpre
from flairtpu.models import quantize as fq
from flairtpu.models.convert import torch_to_flax
from flairtpu_torch import config as cfgmod
from flairtpu_torch.config import RESNET_ENCODERS, SMP_ARCHS
from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.convert import load_weights
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.models.fold import (float_sites, fold_encoder, fold_model,
                                        fold_unet_decoder)
from flairtpu_torch.models.resnet import RESNET_SPECS, bottleneck_width
from flairtpu_torch.ops import int8_conv as ic
from tests.test_torch_models import flax_model, random_state_dict

ENCODER = "resnext50_32x4d"
RESNEXTS = tuple(e for e in RESNET_ENCODERS if e.startswith("resnext"))
N_CLASSES, SIZE, N_Q = 5, 64, 2
NORM = dict(norm_type="scaling", means=(), stds=())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs() -> np.ndarray:
    return np.random.default_rng(7).uniform(0, 1, (2, SIZE, SIZE, 5)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(port model loaded from a .pth, state dict, flairtpu variables,
    flairtpu's logits of ``inputs()``)."""
    port = FlairSegmentationModel(ENCODER, N_CLASSES, 5).eval()
    sd = random_state_dict(port, np.random.default_rng(21))
    path = tmp_path_factory.mktemp("resnext") / f"{ENCODER}_unet.pth"
    torch.save(sd, path)
    load_weights(port, path)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    fmodel = flax_model(ENCODER, N_CLASSES)
    want = np.asarray(jax.jit(lambda v: fmodel.apply(v, jnp.asarray(inputs()), train=False))(
        variables))
    return port, sd, variables, want


@pytest.mark.parametrize("encoder", RESNEXTS)
@pytest.mark.parametrize("arch", SMP_ARCHS)
def test_every_resnext_validates_under_the_nine_archs(encoder, arch):
    assert cfgmod.validate_model_framework({
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_{arch}"}}) == (encoder, arch)


def test_specs_and_widths_match_flairtpu():
    """The six resnext specs are flairtpu's; a stage's grouped 3x3 has
    base_width * 2**stage channels a group."""
    from flairtpu.models.resnet import RESNET_SPECS as FLAX_SPECS

    assert RESNET_SPECS == {k: v for k, v in FLAX_SPECS.items() if k in RESNET_SPECS}
    assert len(RESNEXTS) == 6
    enc = FlairSegmentationModel(ENCODER, N_CLASSES, 5).encoder
    for stage in range(4):
        conv2 = getattr(enc, f"layer{stage + 1}")[0].conv2
        assert conv2.groups == 32
        assert conv2.out_channels == bottleneck_width(64 * 2 ** stage, 32, 4) == 128 * 2 ** stage
        assert conv2.weight.shape[1] == 4 * 2 ** stage


def test_logits_match_flairtpu(setup):
    port, sd, _, want = setup
    assert all(torch.equal(port.state_dict()[k], v) for k, v in sd.items())
    with torch.inference_mode():
        got = port(torch.from_numpy(inputs())).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, N_CLASSES)
    assert float(np.abs(got - want).max()) <= 2e-5 * float(np.abs(want).max())


def test_bn_fold_matches_flairtpu(setup):
    port, _, variables, want = setup
    p, s = variables["params"], variables["batch_stats"]
    for got, ref in ((fold_encoder(port.encoder), fq.fold_encoder(p, s)),
                     (fold_unet_decoder(port.decoder), fq.fold_unet_decoder(p, s))):
        assert set(got) == set(ref)
        for name, c in got.items():
            np.testing.assert_array_equal(c["w"].permute(2, 3, 1, 0).numpy(),
                                          np.asarray(ref[name]["w"]), err_msg=name)
            np.testing.assert_array_equal(c["b"].numpy(), np.asarray(ref[name]["b"]),
                                          err_msg=name)
    with torch.inference_mode():
        got = fold_model(port)(torch.from_numpy(inputs())).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("cg,stride,pad,dil", [(4, 1, 1, 1), (8, 2, 1, 1), (16, 1, 2, 2),
                                               (32, 1, 4, 4)])
def test_grouped_sums_match_lax_and_the_kernel_loop(cg, stride, pad, dil):
    """int8_conv_acc_plain at a grouped 3x3 against lax's grouped int8 conv,
    exactly; and the kernel's loop (for each tap and run of 4 of the group's
    channels, the thread's 4 output channels' packed words against the
    input's word, dp4a's sums) transcribed in numpy, exactly."""
    rng = np.random.default_rng(cg)
    groups, co = 8, 8 * cg
    x = rng.integers(-127, 128, (2, 11, 13, groups * cg)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cg, co)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), ((pad, pad), (pad, pad)),
        rhs_dilation=(dil, dil), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32))
    p = ic.Int8ConvParams(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(), 1.0,
                          torch.ones(co), torch.zeros(co), groups)
    assert p.in_channels == groups * cg and p.packed.shape == (9, cg // 4, co, 4)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = ic.int8_conv_acc_plain(xt, p, stride, pad, dil)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)

    packed = p.packed.numpy().astype(np.int64)
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho, wo = want.shape[1:3]
    loop = np.zeros(want.shape, np.int64)
    for ky in range(3):
        for kx in range(3):
            win = xp[:, ky * dil: ky * dil + stride * (ho - 1) + 1: stride,
                     kx * dil: kx * dil + stride * (wo - 1) + 1: stride]
            for j in range(cg // 4):
                for n in range(co):
                    g = n // cg
                    words = win[..., g * cg + 4 * j: g * cg + 4 * j + 4]
                    loop[..., n] += words @ packed[ky * 3 + kx, j, n]
    np.testing.assert_array_equal(loop, want)


def test_grouped_wrapper_on_the_cpu():
    """int8_conv takes a grouped site to int8_conv_grouped, whose CPU path
    is the plain version and counts no launch; what it refuses raises."""
    rng = np.random.default_rng(4)
    wq = torch.from_numpy(rng.integers(-127, 128, (64, 4, 3, 3)).astype(np.int8))
    p = ic.Int8ConvParams(wq, 0.1, torch.full((64,), 1e-3), torch.zeros(64), 16)
    x = torch.from_numpy(rng.integers(-127, 128, (1, 64, 9, 9)).astype(np.int8)).contiguous(
        memory_format=torch.channels_last)
    ic.launches = ic.grouped_launches = 0
    got = ic.int8_conv(x, p, 1, 1, out_sx=0.05)
    want = ic.int8_conv_plain(x, p, 1, 1, out_sx=0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ic.launches == ic.grouped_launches == 0
    with pytest.raises(ValueError, match="multiples of 4"):
        ic.Int8ConvParams(wq[:, :2].contiguous(), 0.1, torch.ones(64), torch.zeros(64), 32)
    with pytest.raises(ValueError, match=r"\(B, 64, H, W\)"):
        ic.int8_conv(x[:, :32], p, 1, 1)
    with pytest.raises(ValueError, match="ungrouped"):
        ic.int8_conv_grouped(x, ic.Int8ConvParams(torch.zeros((8, 64, 1, 1), dtype=torch.int8),
                                                  0.1, torch.ones(8), torch.zeros(8)), 1, 0)


def to_numpy(qparams: dict) -> dict:
    return {k: {f: np.asarray(v) for f, v in c.items()} for k, c in qparams.items()}


def test_int8_walk_bit_equal_to_jitted_flairtpu(setup):
    """The port's folded weights quantized as flairtpu quantizes them, bit
    for bit; then, given flairtpu's qparams, the plain int8 walk's encoder
    features and int8 decoder blocks 0-1 equal flairtpu's jitted walk."""
    port, _, variables, _ = setup
    p, s = variables["params"], variables["batch_stats"]
    batches = [np.random.default_rng(k).integers(0, 256, (2, SIZE, SIZE, 5), dtype=np.uint8)
               for k in range(2)]
    enc, dec = fold_encoder(port.encoder), fold_unet_decoder(port.decoder)
    act_max = pq.calibrate(ENCODER, enc, batches, NORM, torch.device("cpu"), dec)
    f_enc, f_dec = fq.fold_encoder(p, s), fq.fold_unet_decoder(p, s)
    qp = fq.quantize_folded(f_enc, act_max)
    got_qp = pq.quantize_folded(enc, act_max)
    groups = pq.site_groups(ENCODER)
    assert {k: v.groups for k, v in got_qp.items() if v.groups > 1} == groups
    assert len(groups) == 16
    for k, c in got_qp.items():
        np.testing.assert_array_equal(c.wq.permute(2, 3, 1, 0).numpy(), np.asarray(qp[k]["wq"]))
        assert np.float32(c.sx) == np.asarray(qp[k]["sx"])
        np.testing.assert_array_equal(c.deq.numpy(), np.asarray(qp[k]["deq"]))
    q_sites = {k: v for k, v in f_dec.items() if int(k[5]) < N_Q}
    dec_q = fq.quantize_folded(q_sites, {k: act_max[f"dec/{k}"] for k in q_sites})
    dec_f = {k: v for k, v in f_dec.items() if k not in q_sites}

    @jax.jit
    def run(img):
        x = normalize_device(img, src_dtype=np.uint8, **NORM)
        feats = fq.walk_features(ENCODER, fq._quant_conv(qp), x)
        outs, mixed = {}, fq._mixed_conv(dec_q, dec_f)

        def conv_fn(name, v, *args):
            outs[name] = jax.nn.relu(mixed(name, v, *args))
            return outs[name]

        fq.walk_unet_decode(conv_fn, feats, None, N_Q)
        return feats, outs

    feats_ref, outs = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(batches[0])))
    port_dec_f = {k: v for k, v in dec.items() if k in dec_f}
    qm = pq.QuantizedZoneModel(
        ENCODER, pq.qparams_from_numpy(to_numpy(qp), groups=groups),
        pq.qparams_from_numpy(to_numpy(dec_q)), float_sites(port_dec_f, torch.float32), None,
        None, torch.float32)
    x = normalize(torch.from_numpy(batches[0]), **NORM)
    with torch.inference_mode():
        feats = qm.features(x)
        for i, (got, want) in enumerate(zip(feats[1:], feats_ref[1:])):
            np.testing.assert_array_equal(got.value.permute(0, 2, 3, 1).numpy(), want,
                                          err_msg=f"feature {i + 1}")
        y, _ = qm.decode(feats, None, N_Q)
    np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(), outs[f"block{N_Q - 1}/conv2"])


def test_init_encoder_weights_from_a_resnext_classifier(tmp_path):
    """A torchvision-keyed resnext50_32x4d classifier (the encoder's keys at
    3 input channels, fc head, counters) initializes the encoder as
    flairtpu's conversion of the same dict gives it; the rest is kept."""
    rng = np.random.default_rng(8)
    enc = FlairSegmentationModel(ENCODER, N_CLASSES, 3).encoder
    sd = {k: (torch.tensor(3) if k.endswith("num_batches_tracked") else
              torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32)))
          for k, v in enc.state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
    pth = tmp_path / "classifier.pth"
    torch.save(sd, pth)
    want = fpre.classifier_to_encoder_state_dict({k: v.numpy() for k, v in sd.items()},
                                                 ENCODER, 5)
    model = FlairSegmentationModel(ENCODER, N_CLASSES, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ppre.init_encoder_from_classifier(pth, model)
    got = model.state_dict()
    assert {k for k in got if k.startswith("encoder.")
            and not k.endswith("num_batches_tracked")} == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert all(torch.equal(got[k], before[k]) for k in got if not k.startswith("encoder."))
