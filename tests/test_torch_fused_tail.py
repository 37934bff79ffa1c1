"""The port's plain fused decoder tail (the CPU side of ops/fused_tail.py)
against three references, in float32 on the CPU:

(a) flairtpu's inner-margin logits -> softmax_argmax -> uint8, the stretch
    of the zone program the tail replaces (device_engine.py:143-146);
(b) ``tail_reference`` of benchmarks/pallas_fused_tail.py, on BN-folded
    weights (scale 1, shift = bias);
(c) the Pallas kernel itself, ``make_kernel(float32, interpret=True)``.

Bounds: classes equal except at near-ties (top-2 logit gap < 1e-4: the two
frameworks sum convolutions in other orders); probabilities equal except
where 255 * p lies within 1e-3 of a rounding boundary, for the same reason,
against (a) and (b); |diff| <= 1 against (c), which computes round(255 / s)
where the main path computes round((1 / s) * 255).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.models.convert import torch_to_flax
from flairtpu.ops.fused import softmax_argmax as flax_softmax_argmax
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import fused_tail as ft
from tests.test_torch_models import flax_model, random_state_dict

K = 19
PALLAS_TAIL = Path(__file__).resolve().parent.parent / "benchmarks" / "pallas_fused_tail.py"


@pytest.fixture(scope="module")
def pallas_tail():
    spec = importlib.util.spec_from_file_location("pallas_fused_tail", PALLAS_TAIL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def near_tie(logits: np.ndarray, axis: int) -> np.ndarray:
    top2 = -np.sort(-logits, axis=axis).take([0, 1], axis=axis)
    return (top2.take(0, axis=axis) - top2.take(1, axis=axis)) < 1e-4


def near_rounding_boundary(p: np.ndarray) -> np.ndarray:
    x = p.astype(np.float64) * 255.0
    return np.abs(x - np.floor(x) - 0.5) < 1e-3


@pytest.mark.parametrize("size,margin,want", [
    (512, 128, (136, 5, 262, 3, 256)),  # the Pallas kernel's fixed geometry
    (32, 8, (16, 5, 22, 3, 16)),
    (64, 16, (24, 5, 38, 3, 32)),
    (32, 1, (16, 0, 32, 1, 30)),        # head crop < 3: the convs' zero padding is live
])
def test_tail_geometry(size, margin, want):
    g = ft.tail_geometry(size, margin)
    assert (g.x3_extent, g.up_crop, g.b4_extent, g.head_crop, g.out_extent) == want


def test_geometry_matches_pallas_constants(pallas_tail):
    g = ft.tail_geometry(pallas_tail.SIZE, pallas_tail.MARGIN)
    assert (g.x3_extent, g.b4_extent, g.out_extent) == (
        pallas_tail.X3_EXTENT, pallas_tail.B4_EXTENT, pallas_tail.OUT_EXTENT)


@pytest.mark.parametrize("size,margin", [(32, 8), (64, 16), (32, 1), (512, 128)])
def test_tail_matches_flairtpu_zone_epilogue(size, margin):
    """(a): encoder + blocks 0..3 + plain tail vs flairtpu's full inner decode."""
    rng = np.random.default_rng(size + margin)
    port = FlairSegmentationModel("resnet18", K, 5).eval()
    sd = random_state_dict(port, rng)
    port.load_state_dict(sd, strict=True)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    x = rng.uniform(0, 1, (1, size, size, 5)).astype(np.float32)

    logits = flax_model("resnet18", K).apply(variables, jnp.asarray(x), train=False,
                                             inner_margin=margin)
    cls_ref, p_ref = (np.asarray(a) for a in flax_softmax_argmax(logits))
    prob_ref = np.asarray(jnp.round(p_ref * 255).astype(jnp.uint8))

    ft.launches = 0
    with torch.inference_mode():
        x3 = port.tail_input(torch.from_numpy(x), margin)
        cls, prob = ft.fused_tail(x3, ft.tail_params(port, torch.float32),
                                  ft.tail_geometry(size, margin))
    assert ft.launches == 0  # CPU tensors take the plain version
    assert cls.dtype == prob.dtype == torch.uint8
    assert cls.shape == prob.shape == cls_ref.shape == (1, size - 2 * margin,
                                                        size - 2 * margin)
    ties = near_tie(np.asarray(logits), axis=-1)
    np.testing.assert_array_equal(cls.numpy()[~ties], cls_ref[~ties])
    edge = near_rounding_boundary(p_ref)
    np.testing.assert_array_equal(prob.numpy()[~edge], prob_ref[~edge])


@pytest.fixture(scope="module")
def folded_tail_case(pallas_tail):
    """B=1 random block-3 output and BN-folded tail weights (the benchmark's
    own recipe), in the Flax layouts and as the port's TailParams."""
    rng = np.random.default_rng(0)
    x3 = rng.standard_normal((1, pallas_tail.X3_EXTENT, pallas_tail.X3_EXTENT, 32)
                             ).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, 32, 16)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    b2 = (rng.standard_normal(16) * 0.1).astype(np.float32)
    wh = (rng.standard_normal((3, 3, 16, K)) * 0.1).astype(np.float32)
    bh = (rng.standard_normal(K) * 0.1).astype(np.float32)

    def oihw(w):
        return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))

    ones = torch.ones(16)
    p = ft.TailParams(oihw(w1), ones, torch.from_numpy(b1), oihw(w2), ones,
                      torch.from_numpy(b2), oihw(wh), torch.from_numpy(bh))
    g = ft.tail_geometry(pallas_tail.SIZE, pallas_tail.MARGIN)
    x3_t = torch.from_numpy(x3).permute(0, 3, 1, 2)
    with torch.inference_mode():
        logits = ft.tail_logits_plain(x3_t, p, g).numpy()
        cls, prob = ft.fused_tail(x3_t, p, g)
    return dict(x3=x3, flax_w=(w1, b1, w2, b2, wh, bh), logits=logits,
                cls=cls.numpy(), prob=prob.numpy())


def test_tail_matches_tail_reference(pallas_tail, folded_tail_case):
    """(b): the benchmark's plain-jnp tail."""
    c = folded_tail_case
    cls_ref, prob_ref = pallas_tail.tail_reference(
        jnp.asarray(c["x3"]), *(jnp.asarray(a) for a in c["flax_w"]))
    ties = near_tie(c["logits"], axis=1)
    np.testing.assert_array_equal(c["cls"][~ties], np.asarray(cls_ref)[~ties])
    lg = c["logits"].astype(np.float64)
    p = 1.0 / np.exp(lg - lg.max(axis=1, keepdims=True)).sum(axis=1)
    edge = near_rounding_boundary(p)
    np.testing.assert_array_equal(c["prob"][~edge], np.asarray(prob_ref)[~edge])


def test_tail_matches_pallas_kernel_interpret(pallas_tail, folded_tail_case):
    """(c): the Pallas kernel in interpret mode, fed as its own main() feeds it."""
    c = folded_tail_case
    w1, b1, w2, b2, wh, bh = c["flax_w"]
    w1e, w1o, w2p, whp = pallas_tail.pack_weights(w1, w2, wh)
    x3t = np.transpose(c["x3"], (0, 3, 1, 2)).reshape(32, pallas_tail.X3_EXTENT,
                                                      pallas_tail.X3_EXTENT)
    f32 = jnp.float32
    run = pallas_tail.make_kernel(f32, interpret=True)
    cls_k, prob_k = run(jnp.asarray(x3t), jnp.asarray(pallas_tail._col_expand_matrix()),
                        jnp.asarray(w1e), jnp.asarray(w1o), jnp.asarray(w2p),
                        jnp.asarray(whp), jnp.asarray(b1.reshape(-1, 1, 1)),
                        jnp.asarray(b2.reshape(-1, 1, 1)), jnp.asarray(bh.reshape(-1, 1, 1)))
    ties = near_tie(c["logits"], axis=1)
    np.testing.assert_array_equal(c["cls"][~ties], np.asarray(cls_k)[~ties])
    dprob = np.abs(c["prob"].astype(int) - np.asarray(prob_k).astype(int))
    assert dprob.max() <= 1
