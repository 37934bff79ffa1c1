"""The plain versions of slice 5's kernels against flairtpu (CPU, float32):
``strided_tail`` (its three modes) against ``upsample_align_corners_window``
/ ``upsample_align_corners`` with ``softmax_argmax`` and the window crop,
and ``group_norm_relu`` against ``flax.linen.GroupNorm(32, epsilon=1e-5)``,
ReLU and ``upsample2x_nearest``. The kernels themselves run only on the
card (``chip_smoke.py`` phase 2 holds them to these plain versions).

Bounds: the upsampled logits within 1e-6 of the largest |logit| (the same
two products a pixel, summed in another order by the dense einsum);
classes equal except where the top-2 gap is below 1e-5; the uint8 prob and
probs within 1; GroupNorm within 1e-5 of the largest |output| (float32 sums
over 4096 values in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from flairtpu.models.deeplab import (_align_corners_weights, upsample_align_corners,
                                     upsample_align_corners_window)
from flairtpu.models.unet import upsample2x_nearest
from flairtpu.ops.fused import softmax_argmax
from flairtpu_torch.models.deeplab import align_corners_weights
from flairtpu_torch.ops import group_norm as gn
from flairtpu_torch.ops import strided_tail as sp
from flairtpu_torch.zone.device_engine import estimate_bytes, exact_windows
from flairtpu_torch.zone.grid import slice_grid

CASES = [  # (batch, tile, margin, upsample, classes)
    (2, 64, 16, 4, 19), (2, 64, 8, 8, 4), (3, 32, 4, 1, 32), (1, 48, 0, 4, 7), (2, 24, 5, 8, 19)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's workers
    share the cores, and torch's thread pools would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def logits(b: int, n: int, k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 2, (b, n, n, k)).astype(np.float32)


def reference_window(x: np.ndarray, size: int, margin: int) -> np.ndarray:
    """flairtpu's windowed upsample; at upsample 1 the crop its zone route takes."""
    if x.shape[1] == size:
        return x[:, margin:size - margin, margin:size - margin]
    return np.asarray(upsample_align_corners_window(jnp.asarray(x), (size, size), margin,
                                                    size - margin))


def top2_gap(v: np.ndarray) -> np.ndarray:
    top2 = -np.sort(-v, axis=-1)[..., :2]
    return top2[..., 0] - top2[..., 1]


@pytest.mark.parametrize("n_out,n_in", [(512, 128), (512, 64), (64, 16), (7, 3), (5, 1),
                                        (1, 4), (33, 33)])
def test_align_corners_weights_match_flairtpu(n_out, n_in):
    """The port's copy of the weights, built from the kernel's two taps a
    row, equals flairtpu's matrix bit for bit."""
    np.testing.assert_array_equal(align_corners_weights(n_out, n_in),
                                  _align_corners_weights(n_out, n_in))


@pytest.mark.parametrize("b,size,margin,up,k", CASES)
def test_upsample_window_matches_flairtpu(b, size, margin, up, k):
    x = logits(b, size // up, k)
    g = sp.strided_geometry(size, margin, up)
    got = sp.upsample_window(torch.from_numpy(x), g).numpy()
    want = reference_window(x, size, margin)
    assert got.shape == want.shape == (b, size - 2 * margin, size - 2 * margin, k)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(x).max())


@pytest.mark.parametrize("b,size,margin,up,k", CASES)
def test_argmax_tiles_match_flairtpu(b, size, margin, up, k):
    """Argmax mode into tiles: softmax_argmax of flairtpu's window, the
    prob rounded to uint8."""
    x = logits(b, size // up, k, seed=1)
    g = sp.strided_geometry(size, margin, up)
    p = sp.StridedTail(up, k, torch.device("cpu"))
    sp.launches = 0
    cls, prob = sp.strided_tail(torch.from_numpy(x), p, g)
    assert sp.launches == 0  # the plain version counts no launch
    ref = reference_window(x, size, margin)
    want_cls, want_prob = (np.asarray(a) for a in softmax_argmax(jnp.asarray(ref)))
    ties = top2_gap(ref) < 1e-5
    np.testing.assert_array_equal(cls.numpy()[~ties], want_cls[~ties])
    want_u8 = np.round(want_prob * 255).astype(int)
    assert np.abs(prob.numpy().astype(int) - want_u8).max() <= 1


def test_plane_modes_write_owned_windows():
    """Argmax and probs modes through the exact windows of a 100 x 90 zone
    (the last row and column realign): each plane pixel is its owning tile's
    value, as flairtpu's tile-order writes leave it."""
    size, margin, up, k = 32, 8, 4, 5
    s = size - 2 * margin
    grid = slice_grid(100, 90, size, margin)
    tiles = grid.tiles
    x = logits(len(tiles), size // up, k, seed=2)
    g = sp.strided_geometry(size, margin, up)
    p = sp.StridedTail(up, k, torch.device("cpu"))
    win = torch.from_numpy(exact_windows(tiles, 90, 100, s, len(tiles)))
    planes = sp.strided_tail(torch.from_numpy(x), p, g,
                             torch.zeros((2, 90, 100), dtype=torch.uint8), win).numpy()
    plane = sp.strided_tail_probs(torch.from_numpy(x), p, g,
                                  torch.zeros((90, 100, k), dtype=torch.uint8), win).numpy()
    ref = reference_window(x, size, margin)
    cls, prob = (np.asarray(a) for a in softmax_argmax(jnp.asarray(ref)))
    e = np.exp(ref - ref.max(axis=-1, keepdims=True))
    probs = np.round(e / e.sum(axis=-1, keepdims=True) * 255).astype(int)
    want = np.zeros((2, 90, 100), int)
    want_probs = np.zeros((90, 100, k), int)
    gap = np.zeros((90, 100))
    for i, t in enumerate(tiles):  # the reference's order: last write wins
        r0, c0 = min(t.irow0, 90 - s), min(t.icol0, 100 - s)
        want[0, r0:r0 + s, c0:c0 + s] = cls[i]
        want[1, r0:r0 + s, c0:c0 + s] = np.round(prob[i] * 255)
        want_probs[r0:r0 + s, c0:c0 + s] = probs[i]
        gap[r0:r0 + s, c0:c0 + s] = top2_gap(ref[i])
    ties = gap < 1e-5
    np.testing.assert_array_equal(planes[0][~ties], want[0][~ties])
    assert np.abs(planes[1].astype(int) - want[1]).max() <= 1
    assert np.abs(plane.astype(int) - want_probs).max() <= 1
    assert (planes[1] > 0).all()


@pytest.mark.parametrize("size,up,k", [(64, 4, 19), (64, 8, 4), (32, 1, 32)])
def test_logits_mode_whole_tile_matches_flairtpu(size, up, k):
    """Logits mode at margin 0: flairtpu's whole-tile upsample (its average
    and max programs), into a caller's buffer."""
    x = logits(2, size // up, k, seed=3)
    g = sp.strided_geometry(size, 0, up)
    p = sp.StridedTail(up, k, torch.device("cpu"))
    out = torch.empty((2, size, size, k))
    got = sp.strided_tail_logits(torch.from_numpy(x), p, g, out)
    assert got is out
    want = x if up == 1 else np.asarray(upsample_align_corners(jnp.asarray(x), (size, size)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(x).max())


def test_taps_and_geometry():
    """The kernel's taps: two per row, their weights the matrix rows'."""
    g = sp.strided_geometry(512, 128, 4)
    idx, wts = sp.taps(g)
    assert idx.shape == wts.shape == (2, 256) and g.n_in == 128 and g.out_extent == 256
    w = align_corners_weights(512, 128)[128:384]
    rows = np.arange(256)
    recon = np.zeros_like(w)
    np.add.at(recon, (rows, idx[0]), wts[0])
    np.add.at(recon, (rows, idx[1]), wts[1])
    np.testing.assert_array_equal(recon, w)
    with pytest.raises(ValueError):
        sp.strided_geometry(100, 10, 8)  # not a multiple of the upsample


def test_wrappers_raise_on_other_devices():
    g = sp.strided_geometry(32, 8, 4)
    p = sp.StridedTail(4, 3, torch.device("meta"))
    x = torch.empty((1, 8, 8, 3), device="meta")
    for fn, args in ((sp.strided_tail, ()), (sp.strided_tail_logits, ())):
        with pytest.raises(RuntimeError, match="unsupported device"):
            fn(x, p, g, *args)
    y = torch.empty((1, 128, 4, 4), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        gn.group_norm_relu(y, torch.ones(128), torch.zeros(128))


def test_estimate_counts_head_logits():
    """A strided-head model's run holds a batch of float32 head logits."""
    grid = slice_grid(4096, 4096, 512, 128)
    base = estimate_bytes(grid, 5, 19, "exact-clipping", "argmax", 128)
    assert estimate_bytes(grid, 5, 19, "exact-clipping", "argmax", 128,
                          head_up=4) - base == 128 * 128 * 128 * 19 * 4
    assert estimate_bytes(grid, 5, 19, "exact-clipping", "argmax", 128,
                          head_up=1) - base == 128 * 512 * 512 * 19 * 4


@pytest.mark.parametrize("shape,upsample", [
    ((2, 128, 16, 16), True), ((2, 128, 8, 12), False), ((1, 64, 5, 7), True),
    ((3, 256, 4, 4), False)])
def test_group_norm_relu_matches_flax(shape, upsample):
    """The plain version against Flax's GroupNorm(32, epsilon=1e-5) (its
    fast variance), ReLU and the 2x nearest upsample, on NHWC."""
    rng = np.random.default_rng(5)
    B, C, H, W = shape
    x = (rng.normal(0.3, 1.5, (B, H, W, C))).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.normal(0, 0.2, C).astype(np.float32)
    mod = fnn.GroupNorm(num_groups=32, epsilon=1e-5, dtype=jnp.float32,
                        param_dtype=jnp.float32)
    want = mod.apply({"params": {"scale": gamma, "bias": beta}}, jnp.asarray(x))
    want = fnn.relu(want)
    if upsample:
        want = upsample2x_nearest(want)
    want = np.asarray(want)
    y = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    gn.launches = 0
    got = gn.group_norm_relu(y, torch.from_numpy(gamma), torch.from_numpy(beta),
                             upsample=upsample)
    assert gn.launches == 0
    assert got.dtype == torch.float32 and got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_group_norm_channel_checks():
    gn.check_channels(128, 32)
    for c, g in ((12, 4), (96, 32), (128, 3)):  # not 8-aligned, 12 octets, groups
        with pytest.raises(ValueError):
            gn.check_channels(c, g)
    assert gn.chunks(128 * 128) == 32 and gn.chunks(16 * 16) == 1
