"""quantize: int8 in flairtpu_torch against flairtpu (CPU, float32).

resnet18-unet, 4 classes, 64/16 tiles, an 80 x 64 zone, one smp-keyed .pth
for both packages (``tests/test_torch_fold.py:make_setup``). Bounds:

- the weight quantization, the int32 sums of the int8 conv, the requantize,
  and the int8 encoder features and int8 decoder blocks: bit for bit,
  against flairtpu's jitted walk given the same qparams;
- the float sites after them (decoder blocks 2-4 and the head in float32):
  atol = rtol = 2e-4 (float32 sums in other orders);
- calibration act_max: rtol 1e-5 (float32 convs in other orders);
- rasters through both CLIs with the same scales: class agreement >= 0.999,
  prob |diff| <= 1; where each package calibrates itself: class agreement
  > 0.8, the floor of tests/test_quantize.py:315.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from flairtpu import config as flax_cfg
from flairtpu.data.normalize import normalize_device
from flairtpu.models import quantize as fq
from flairtpu.zone.engine import run_pipeline
from flairtpu_torch.cli import detect_main
from flairtpu_torch.data.normalize import normalize
from flairtpu_torch.io import TiffReader
from flairtpu_torch.models import quantize as pq
from flairtpu_torch.models.fold import float_sites, fold_encoder, fold_tail_params, \
    fold_unet_decoder
from flairtpu_torch.ops import int8_conv as ic
from flairtpu_torch.ops import quantize_act as qa
from flairtpu_torch.zone import engine as eng
from tests.test_torch_fold import MARGIN, make_setup, raster_agreement, run_both

NORM = dict(norm_type="scaling", means=(), stds=())
N_Q = 2  # int8 decoder blocks of the walk tests


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The shared model and zone, the calibration batches of the zone, and
    flairtpu's folded sites, act_max (with the decoder) and qparams."""
    tmp = tmp_path_factory.mktemp("torch_quantize")
    model, fmodel, variables, make_config = make_setup(tmp)
    cfg = make_config("calib")
    batches = pq.read_calibration_batches(cfg)
    p, s = variables["params"], variables["batch_stats"]
    enc, dec = fq.fold_encoder(p, s), fq.fold_unet_decoder(p, s)
    act_max = fq.calibrate("resnet18", enc, batches, NORM, folded_dec=dec)
    qp = fq.quantize_folded(enc, act_max)
    q_sites = {k: v for k, v in dec.items() if int(k[5]) < N_Q}
    dec_q = fq.quantize_folded(q_sites, {k: act_max[f"dec/{k}"] for k in q_sites})
    dec_f = {k: v for k, v in dec.items() if k not in q_sites}
    return dict(tmp=tmp, model=model, fmodel=fmodel, variables=variables,
                make_config=make_config, batches=batches, act_max=act_max, qp=qp,
                dec_q=dec_q, dec_f=dec_f)


def to_numpy(qparams: dict) -> dict:
    return {k: {f: np.asarray(v) for f, v in c.items()} for k, c in qparams.items()}


def test_calibration_batches_match_flairtpu(setup):
    want = fq.read_calibration_batches(setup["make_config"]("calib"))
    assert len(want) == len(setup["batches"])
    for a, b in zip(setup["batches"], want):
        np.testing.assert_array_equal(a, b)


def test_calibration_act_max_matches_flairtpu(setup):
    model = setup["model"]
    got = pq.calibrate("resnet18", fold_encoder(model.encoder), setup["batches"], NORM,
                       torch.device("cpu"), fold_unet_decoder(model.decoder))
    want = setup["act_max"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_quantize_folded_matches_flairtpu_bit_for_bit(setup):
    """wq, sx and deq of every encoder site from the same act_max."""
    got = pq.quantize_folded(fold_encoder(setup["model"].encoder), setup["act_max"])
    want = setup["qp"]
    assert set(got) == set(want)
    for k, p in got.items():
        np.testing.assert_array_equal(p.wq.permute(2, 3, 1, 0).numpy(), np.asarray(want[k]["wq"]))
        assert np.float32(p.sx) == np.asarray(want[k]["sx"])
        np.testing.assert_array_equal(p.deq.numpy(), np.asarray(want[k]["deq"]))
    back = pq.qparams_from_numpy(to_numpy(want))
    for k, p in back.items():
        assert torch.equal(p.wq, got[k].wq) and p.sx == got[k].sx
        assert torch.equal(p.deq, got[k].deq) and torch.equal(p.b, got[k].b)


@pytest.mark.parametrize("ci,co,k,stride,pad", [(5, 64, 7, 2, 3), (64, 128, 3, 2, 1)])
def test_int8_conv_sums_match_lax(ci, co, k, stride, pad):
    """int8_conv_acc_plain against jax.lax.conv_general_dilated int8 ->
    int32, exactly: the stem (5 channels padded to 8) and a 3x3 stride-2
    site."""
    rng = np.random.default_rng(ci)
    x = rng.integers(-127, 128, (2, 20, 22, ci)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), ((pad, pad), (pad, pad)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    p = ic.Int8ConvParams(torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(), 1.0,
                          torch.ones(co), torch.zeros(co))
    cp = p.in_channels
    xp = np.zeros((2, 20, 22, cp), np.int8)
    xp[..., :ci] = x
    got = ic.int8_conv_acc_plain(torch.from_numpy(xp).permute(0, 3, 1, 2), p, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    assert p.packed.shape == (co, -(-k * k * cp // 32) * 32)


@pytest.mark.parametrize("sx", [0.0123456, 3.7 / 127, 0.731 / 127, 1.9 / 127])
def test_quantize_act_matches_jitted_requantize(sx):
    """quantize_act's plain version against flairtpu's requantize as its
    jitted zone program runs it (sx a constant), exactly; channels padded
    to 8 are 0."""
    x = (np.random.default_rng(7).standard_normal((2, 9, 11, 5)) * 3).astype(np.float32)
    c = jnp.float32(sx)
    want = np.asarray(jax.jit(lambda v: jnp.clip(jnp.round(v / c), -127, 127)
                              .astype(jnp.int8))(jnp.asarray(x)))
    qa.launches = 0
    got = qa.quantize_act(torch.from_numpy(x).permute(0, 3, 1, 2), float(np.float32(sx)), 8)
    assert qa.launches == 0 and got.shape == (2, 8, 9, 11)
    np.testing.assert_array_equal(got[:, :5].permute(0, 2, 3, 1).numpy(), want)
    assert not got[:, 5:].any()


def port_model(setup) -> pq.QuantizedZoneModel:
    """The port's int8 model on flairtpu's qparams (int8_decoder 2)."""
    model = setup["model"]
    dec_f = {k: v for k, v in fold_unet_decoder(model.decoder).items()
             if k in setup["dec_f"]}
    return pq.QuantizedZoneModel(
        "resnet18", pq.qparams_from_numpy(to_numpy(setup["qp"])),
        pq.qparams_from_numpy(to_numpy(setup["dec_q"])), float_sites(dec_f, torch.float32),
        None, fold_tail_params(dec_f, model.segmentation_head[0], torch.float32),
        torch.float32)


def test_int8_walk_bit_equal_to_jitted_flairtpu(setup):
    """Given the same qparams: the int8 encoder features and int8 decoder
    blocks 0-1 equal flairtpu's jitted walk bit for bit; the float blocks
    after them, and the logits, within 2e-4."""
    u8 = setup["batches"][0]
    qp, dec_q, dec_f = setup["qp"], setup["dec_q"], setup["dec_f"]

    flax_q = fq.QuantizedZoneModel(setup["fmodel"], qp, 32, 5, dec_q, dec_f)

    @jax.jit
    def run(img, variables):
        x = normalize_device(img, src_dtype=np.uint8, **NORM)
        feats = fq.walk_features("resnet18", fq._quant_conv(qp), x)
        outs, mixed = {}, fq._mixed_conv(dec_q, dec_f)

        def conv_fn(name, v, *args):
            outs[name] = jax.nn.relu(mixed(name, v, *args))
            return outs[name]

        fq.walk_unet_decode(conv_fn, feats, MARGIN)
        return feats, outs, flax_q.apply(variables, x, train=False, inner_margin=MARGIN)

    feats_ref, outs, want_logits = jax.tree_util.tree_map(
        np.asarray, run(jnp.asarray(u8), setup["variables"]))
    qm = port_model(setup)
    x = normalize(torch.from_numpy(u8), **NORM)
    with torch.inference_mode():
        feats = qm.features(x)
        for i, (got, want) in enumerate(zip(feats[1:], feats_ref[1:])):
            np.testing.assert_array_equal(got.value.permute(0, 2, 3, 1).numpy(), want,
                                          err_msg=f"feature {i + 1}")
        for n in range(N_Q, 4 + 1):
            y, _ = qm.decode(feats, MARGIN, n)
            want = outs[f"block{n - 1}/conv2"]
            got = y.permute(0, 2, 3, 1).numpy()
            if n <= N_Q:
                np.testing.assert_array_equal(got, want, err_msg=f"block {n - 1}")
            else:
                np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4,
                                           err_msg=f"block {n - 1}")
        logits = qm(x, inner_margin=MARGIN).numpy()
    np.testing.assert_allclose(logits, want_logits, atol=2e-4, rtol=2e-4)


def test_int8_conv_outputs_only_what_is_read(setup):
    """The int8 sites write float32 only where kept and int8 only for the
    site they feed; the launches count nothing on the CPU."""
    qm = port_model(setup)
    x = normalize(torch.from_numpy(setup["batches"][0]), **NORM)
    calls = []

    def conv(q, p, stride, padding, **kw):
        calls.append((kw["keep_f32"], kw["out_sx"]))
        return ic.int8_conv(q, p, stride, padding, **kw)

    ic.launches = qa.launches = 0
    with torch.inference_mode():
        qm.tail_input(x, MARGIN, conv=conv)
    assert ic.launches == qa.launches == 0
    # resnet18: stem + 8 blocks x 2 + 3 downsamples, 2 int8 decoder blocks x 2
    assert len(calls) == 1 + 16 + 3 + 2 * N_Q
    assert sum(not keep for keep, _ in calls) == 8 + N_Q  # each block's first conv
    assert sum(sx is not None for _, sx in calls) == 8 + 7 + N_Q


@pytest.mark.parametrize("over", [{"int8_decoder": 0}, {"int8_decoder": 4},
                                  {"int8_decoder": 2, "bn_fold": True}],
                         ids=["dec0", "dec4", "dec2_fold"])
def test_quantized_rasters_match_flairtpu(setup, monkeypatch, over):
    """flair-detect through both CLIs, the port on flairtpu's act_max (the
    same scales). On the CPU both packages run every float site in float32,
    so int8_decoder 2 with bn_fold is also int8_decoder 2 without it."""
    monkeypatch.setattr(pq, "calibrate", lambda *a, **k: dict(setup["act_max"]))
    name = "q_" + "_".join(f"{k}{v}" for k, v in over.items())
    want, have = run_both(setup["tmp"], setup["make_config"](name, quantize="int8", **over))
    agree, dprob = raster_agreement(want, have)
    assert agree >= 0.999 and dprob <= 1


def test_self_calibrated_raster_agrees(setup):
    """Each package calibrating itself: the port's raster and flairtpu's
    (int8_decoder 2 with bn_fold) agree above the floor of
    tests/test_quantize.py:315, and the run reports its calibration."""
    cfg = setup["make_config"]("q_self", quantize="int8", bn_fold=True)
    conf = Path(setup["tmp"]) / "q_self.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    stats = detect_main([f"--conf={conf}"])
    assert stats["calibration_seconds"] > 0
    with TiffReader(Path(cfg["output_path"]) / "zone-ARGMAX.tif") as r:
        have = r.read()
    # flairtpu calibrates itself in every run: its raster of the test above
    ref = Path(setup["tmp"]) / "q_int8_decoder2_bn_foldTrue_ref"
    if not ref.exists():
        run_pipeline(flax_cfg.validate_detect_config(
            dict(cfg, output_path=str(ref), output_name="zone-ARGMAX")))
    with TiffReader(ref / "zone-ARGMAX.tif") as r:
        want = r.read()
    agree, _ = raster_agreement(want, have)
    assert agree > 0.8


def test_batch_mode_calibrates_on_the_first_zone(setup, monkeypatch):
    """-b with quantize: one calibration, on the department's first zone,
    and the second zone's raster equal to its single-zone run on the
    department's model."""
    from flairtpu_torch.io.tiff import Affine, write_array
    from flairtpu_torch.zone import batch as port_batch

    tmp = Path(setup["tmp"]) / "dept"
    dpt, truth = tmp / "in" / "D001_2020", tmp / "truth" / "D001_2020"
    for k, zone in enumerate(("Z1_AA", "Z2_BB")):
        rng = np.random.default_rng(60 + k)
        (dpt / zone).mkdir(parents=True)
        (truth / zone).mkdir(parents=True)
        write_array(dpt / zone / f"D001_2020_{zone}_irc.tif",
                    rng.integers(0, 256, (5, 64, 80)).astype(np.uint8),
                    transform=Affine.from_origin(0, 100, 0.2, 0.2), crs=2154)
        write_array(truth / zone / "truth.tif", rng.integers(1, 5, (64, 80)).astype(np.uint8))
    seen, prepared = [], []
    read, prepare = eng.read_calibration_batches, port_batch.prepare_model
    monkeypatch.setattr(eng, "read_calibration_batches",
                        lambda config: seen.append(config["input_img_path"]) or read(config))
    monkeypatch.setattr(port_batch, "prepare_model",
                        lambda *a: prepared.append(prepare(*a)) or prepared[-1])
    cfg = setup["make_config"]("dept_out", quantize="int8", input_path=str(dpt),
                               truth_root=str(tmp / "truth"),
                               truth_path=str(truth / "Z1_AA" / "truth.tif"), data_type="irc",
                               classes={i + 1: [1, f"c{i}"] for i in range(4)})
    conf = tmp / "dept.yaml"
    conf.write_text(yaml.safe_dump(cfg))
    res = detect_main([f"--conf={conf}", "-b", "-m"])
    assert seen == [str(dpt / "Z1_AA" / "D001_2020_Z1_AA_irc.tif")] and len(prepared) == 1
    assert res["calibration_seconds"] > 0
    single = dict(cfg, input_img_path=str(dpt / "Z2_BB" / "D001_2020_Z2_BB_irc.tif"),
                  output_path=str(tmp / "single"), output_name="z")
    eng.run_pipeline(single, prepared[0])
    with TiffReader(tmp / "single" / "z.tif") as r:
        want = r.read()
    got = next(Path(cfg["output_path"]).glob("D001_2020_Z2_BB_irc-ARGMAX-S_*.tif"))
    with TiffReader(got) as r:
        np.testing.assert_array_equal(r.read(), want)
