"""The stitch kernels' plain versions (ops/stitch.py, ops/fused.py) and the
fused tail's probs and logits modes (ops/fused_tail.py), CPU.

- ``scatter_accumulate`` is bit-equal to flairtpu's on the same tiles,
  origins and weights, overlapping origins included;
- ``tile_starts`` / ``patch_weights`` equal flairtpu's;
- ``accumulate_probs``, ``merge_max`` and ``stitch_finalize`` equal a numpy
  float32 transcription of ``flairtpu/zone/device_engine.py:203-221,
  517-539`` bit for bit, padding duplicates (valid 0) included. np.exp and
  torch.exp differ in the last bit, so the transcription takes torch's
  exponential; every other step is numpy's;
- the plain softmax is ``jax.nn.softmax`` to 1e-6;
- the tail's logits mode at margin 0 is the full ``model(x)`` forward
  (1e-5: the head adds its bias inside or after the convolution), and its
  probs mode is round(255 * softmax) of the tail's logits;
- the new wrappers count no launches on the CPU and raise on a meta tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.ops.fused import scatter_accumulate as flax_scatter_accumulate
from flairtpu.zone import weights as flax_weights
from flairtpu_torch.models.factory import FlairSegmentationModel
from flairtpu_torch.ops import _build
from flairtpu_torch.ops import accumulate_probs_phases as phases
from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.ops import stitch as st
from flairtpu_torch.ops.fused import scatter_accumulate, softmax
from flairtpu_torch.zone import weights
from flairtpu_torch.zone.device_engine import estimate_bytes, zone_padding
from flairtpu_torch.zone.grid import slice_grid
from tests.test_torch_models import random_state_dict

K = 5
S = 8


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def make_batch(k: int = K):
    """A batch of 6 tiles of k classes on a 20 x 22 plane: overlapping
    origins, a repeated origin, and two padding duplicates (valid 0) of the
    last tile."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, S, S, k)) * 3).astype(np.float32)
    logits[5] = logits[3]  # the duplicates repeat the last real tile
    logits[4] = logits[3]
    origins = np.array([[0, 0], [4, 6], [4, 6], [12, 14], [12, 14], [12, 14]], np.int32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return logits, origins, valid


@pytest.fixture
def batch():
    return make_batch()


def np_softmax(x: np.ndarray) -> np.ndarray:
    """float32, step by step: exp(x - max), the sum in ascending class order,
    a division."""
    e = torch.exp(t(x - x.max(axis=-1, keepdims=True))).numpy()
    s = e[..., 0].copy()
    for k in range(1, e.shape[-1]):
        s = s + e[..., k]
    return e / s[..., None]


@pytest.mark.parametrize("with_weights", [False, True])
def test_scatter_accumulate_bit_equal_flairtpu(with_weights):
    rng = np.random.default_rng(0)
    acc = rng.standard_normal((20, 20, 3)).astype(np.float32)
    tiles = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    org = np.array([[0, 0], [4, 4], [4, 4], [12, 3], [10, 10], [2, 9]], np.int32)
    w = rng.uniform(0, 1, (8, 8)).astype(np.float32) if with_weights else None
    want = np.asarray(flax_scatter_accumulate(
        jnp.asarray(acc), jnp.asarray(tiles), jnp.asarray(org),
        None if w is None else jnp.asarray(w)))
    got = scatter_accumulate(t(acc.copy()), t(tiles), t(org), None if w is None else t(w))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [2, 8, 33, 512])
def test_weights_match_flairtpu(size):
    for mode in ("exp", "gaussian"):
        np.testing.assert_array_equal(weights.patch_weights(size, mode=mode),
                                      flax_weights.patch_weights(size, mode=mode))
    for extent, stride in ((100, 16), (size, 3), (size - 1, 8), (4096, 384)):
        np.testing.assert_array_equal(weights.tile_starts(extent, size, stride),
                                      flax_weights.tile_starts(extent, size, stride))


def test_softmax_matches_jax():
    x = (np.random.default_rng(1).standard_normal((4, 7, 19)) * 4).astype(np.float32)
    np.testing.assert_allclose(softmax(t(x)).numpy(), np.asarray(jax.nn.softmax(x, axis=-1)),
                               rtol=1e-6, atol=1e-7)
    assert np.array_equal(softmax(t(x)).numpy(), np_softmax(x))


# K classes, and FLAIR's class counts 13, 15 and 19
ACCUMULATE_CASES = [(w, k) for k in (K, 13, 15, 19) for w in (False, True)]


@pytest.mark.parametrize("weighted,k", ACCUMULATE_CASES,
                         ids=[str(w) if k == K else f"{w}-K{k}" for w, k in ACCUMULATE_CASES])
def test_accumulate_probs_plain_matches_numpy(weighted, k):
    logits, origins, valid = make_batch(k)
    w = weights.patch_weights(S).astype(np.float32) if weighted else np.ones((S, S), np.float32)
    acc = np.zeros((20, 22, k), np.float32)
    div = np.zeros((20, 22), np.float32)
    probs = np_softmax(logits)
    for (r, c), p, v in zip(origins, probs, valid):  # device_engine.py:206-210, in order
        wv = w * v
        acc[r:r + S, c:c + S] = acc[r:r + S, c:c + S] + p * wv[..., None]
        div[r:r + S, c:c + S] = div[r:r + S, c:c + S] + wv

    acc_t, div_t = torch.zeros((20, 22, k)), torch.zeros((20, 22))
    fp = st.footprint(origins, valid, S)
    st.accumulate_probs(t(logits), t(origins), t(valid), t(w) if weighted else None,
                        acc_t, div_t, fp)
    assert np.array_equal(acc_t.numpy(), acc) and np.array_equal(div_t.numpy(), div)

    # device_engine.py:216-220, then the crop
    crop = (1, 2, 17, 19)
    mean = acc / np.maximum(div, np.float32(1e-8))[..., None]
    cls = mean.argmax(axis=-1).astype(np.uint8)
    prob = np.round(mean.max(axis=-1) * np.float32(255)).astype(np.uint8)
    got = st.stitch_finalize_mean(acc_t, div_t, crop).numpy()
    assert got.shape == (2, 17, 19)
    np.testing.assert_array_equal(got, np.stack([cls, prob])[:, 1:18, 2:21])


def test_merge_max_plain_matches_numpy(batch):
    logits, origins, valid = batch
    logits[2] = logits[1]  # a later tile with equal probabilities keeps nothing
    best_p = np.zeros((20, 22), np.float32)
    best_c = np.zeros((20, 22), np.uint8)
    m = logits.max(axis=-1, keepdims=True)
    e = torch.exp(t(logits - m)).numpy()
    s = e[..., 0].copy()
    for k in range(1, K):
        s = s + e[..., k]
    prob, cls = np.float32(1) / s, logits.argmax(axis=-1).astype(np.uint8)
    for (r, c), p, k in zip(origins, prob, cls):  # device_engine.py:522-531, in order
        cur_p, cur_c = best_p[r:r + S, c:c + S], best_c[r:r + S, c:c + S]
        better = p > cur_p
        best_c[r:r + S, c:c + S] = np.where(better, k, cur_c)
        best_p[r:r + S, c:c + S] = np.where(better, p, cur_p)

    bp, bc = torch.zeros((20, 22)), torch.zeros((20, 22), dtype=torch.uint8)
    st.merge_max(t(logits), t(origins), t(valid), bp, bc, st.footprint(origins, valid, S))
    assert np.array_equal(bp.numpy(), best_p) and np.array_equal(bc.numpy(), best_c)

    crop = (0, 3, 20, 19)  # device_engine.py:539, then the crop
    want = np.stack([best_c, np.round(best_p * np.float32(255)).astype(np.uint8)])
    np.testing.assert_array_equal(st.stitch_finalize_max(bp, bc, crop).numpy(),
                                  want[:, :, 3:22])


def test_footprint_leaves_out_padding(batch):
    _, origins, valid = batch
    assert st.footprint(origins, valid, S) == (0, 0, 20, 22)
    assert st.footprint(origins[1:3], valid[1:3], S) == (4, 6, 8, 8)


@pytest.mark.parametrize("size", [32, 64])
def test_logits_mode_at_margin_0_is_the_full_forward(size):
    rng = np.random.default_rng(size)
    model = FlairSegmentationModel("resnet18", K, 5).eval()
    model.load_state_dict(random_state_dict(model, rng))
    x = torch.from_numpy(rng.uniform(0, 1, (2, size, size, 5)).astype(np.float32))
    g = ft.tail_geometry(size, 0)
    assert (g.up_crop, g.head_crop, g.b4_extent, g.out_extent, g.x3_extent) == (
        0, 0, size, size, size // 2)
    with torch.inference_mode():
        got = ft.fused_tail_logits(model.tail_input(x, 0), ft.tail_params(model, torch.float32),
                                   g)
        want = model(x)
    assert got.shape == want.shape == (2, size, size, K) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_full_tile_geometry_at_512():
    g = ft.tail_geometry(512, 0)
    assert (g.up_crop, g.head_crop, g.b4_extent, g.out_extent, g.x3_extent) == (0, 0, 512,
                                                                                512, 256)


def test_probs_mode_writes_rounded_softmax_through_windows():
    rng = np.random.default_rng(2)
    g = ft.tail_geometry(32, 8)
    model = FlairSegmentationModel("resnet18", K, 5).eval()
    model.load_state_dict(random_state_dict(model, rng))
    p = ft.tail_params(model, torch.float32)
    x3 = torch.from_numpy(rng.standard_normal((2, g.x3_extent, g.x3_extent, 32))
                          .astype(np.float32)).permute(0, 3, 1, 2)
    windows = torch.tensor([[0, 0, 0, 16, 0, 10], [4, 10, 2, 16, 0, 16]], dtype=torch.int32)
    plane = torch.zeros((20, 26, K), dtype=torch.uint8)
    with torch.inference_mode():
        ft.fused_tail_probs(x3, p, g, plane, windows)
        logits = ft.tail_logits_plain(x3, p, g).permute(0, 2, 3, 1).numpy()
    want = np.zeros((20, 26, K), np.uint8)
    probs = np.round(np_softmax(logits) * np.float32(255)).astype(np.uint8)
    want[0:16, 0:10] = probs[0, 0:16, 0:10]
    want[6:20, 10:26] = probs[1, 2:16, 0:16]
    np.testing.assert_array_equal(plane.numpy(), want)


def test_estimate_bytes_counts_each_program():
    grid = slice_grid(90, 70, 32, 8, 16)
    lo, hi_r, hi_c = zone_padding(70, 90, 32, 8)
    zone = (70 * 90 + (70 + lo + hi_r) * (90 + lo + hi_c)) * 5
    hp_wp = (70 + lo + hi_r) * (90 + lo + hi_c)
    logits = 4 * 32 * 32 * K * 4
    assert estimate_bytes(grid, 5, K, "exact-clipping", "argmax", 4) == zone + 70 * 90 * 2
    assert estimate_bytes(grid, 5, K, "max", "class_prob", 4) == zone + 70 * 90 * K
    assert estimate_bytes(grid, 5, K, "average", "argmax", 4) == (
        zone + logits + hp_wp * (K + 1) * 4 + 70 * 90 * 2)
    assert estimate_bytes(grid, 5, K, "max", "argmax", 4) == (
        zone + logits + hp_wp * 5 + 70 * 90 * 2)


def _new_wrapper_calls(dev: str):
    """Each new wrapper once, on tensors on ``dev``."""
    g = ft.tail_geometry(32, 8)
    p = ft.tail_params(FlairSegmentationModel("resnet18", K, 5).eval(), torch.float32)
    x3 = torch.zeros((2, 32, g.x3_extent, g.x3_extent), device=dev)
    win = torch.zeros((2, 6), dtype=torch.int32, device=dev)
    logits = torch.zeros((2, S, S, K), device=dev)
    org = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    val = torch.ones(2, device=dev)
    acc, div = torch.zeros((S, S, K), device=dev), torch.zeros((S, S), device=dev)
    bp, bc = torch.zeros((S, S), device=dev), torch.zeros((S, S), dtype=torch.uint8, device=dev)
    fp, crop = (0, 0, S, S), (0, 0, S, S)
    return [
        lambda: ft.fused_tail_probs(x3, p, g, torch.zeros((16, 16, K), dtype=torch.uint8,
                                                          device=dev), win),
        lambda: ft.fused_tail_logits(x3, p, g),
        lambda: st.accumulate_probs(logits, org, val, None, acc, div, fp),
        lambda: st.merge_max(logits, org, val, bp, bc, fp),
        lambda: st.stitch_finalize_mean(acc, div, crop),
        lambda: st.stitch_finalize_max(bp, bc, crop),
    ]


def test_new_wrappers_run_plain_on_cpu_and_count_nothing():
    ft.probs_launches = ft.logits_launches = 0
    st.launches = dict.fromkeys(st.launches, 0)
    with torch.inference_mode():
        for call in _new_wrapper_calls("cpu"):
            call()
    assert ft.probs_launches == ft.logits_launches == 0
    assert set(st.launches.values()) == {0}


@pytest.mark.parametrize("name", list(phases.EDITS["strip"]))
def test_phase_variants_anchor_in_the_kernel(name):
    """Every variant of accumulate_probs_phases finds each of its anchors in
    csrc/accumulate_probs.cu exactly once, and only ``full`` leaves it as it is."""
    src = (_build.CSRC / "accumulate_probs.cu").read_text()
    assert (phases.variant_source(src, "strip", name) == src) == (name == "full")


@pytest.mark.parametrize("k", range(6))
def test_new_wrappers_raise_on_other_devices(k):
    """Neither CPU nor CUDA: no fallback, an error."""
    with pytest.raises(RuntimeError, match="unsupported device"):
        _new_wrapper_calls("meta")[k]()
