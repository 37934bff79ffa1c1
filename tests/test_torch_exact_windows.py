"""Exact-clipping owned windows (``zone/device_engine.py:exact_windows``) and
the fused tail's plane writes, on the CPU.

The reference writes each tile's s x s interior into the planes in grid
order, last write wins (flairtpu/zone/device_engine.py:148-156). The windows
must give every pixel to the same tile as that loop, the padding duplicates
of the last batch must own nothing, and the plain tail written through the
windows must equal the tile-order loop over plain tiles bit for bit.
"""

import numpy as np
import pytest
import torch

from flairtpu_torch.ops import fused_tail as ft
from flairtpu_torch.zone.device_engine import exact_windows
from flairtpu_torch.zone.grid import slice_grid

SIZE, MARGIN = 32, 8
S_IN = SIZE - 2 * MARGIN
ZONES = {  # name: (width, height, batch)
    "realigned_90x70": (90, 70, 4),
    "realigned_1000x1100": (1000, 1100, 128),
    "below_tile_24x20": (24, 20, 4),
    "ragged_batch_70x45": (70, 45, 7),
}


def zone_windows(name: str):
    width, height, batch = ZONES[name]
    tiles = slice_grid(width, height, SIZE, MARGIN).tiles
    n_total = len(tiles) + (-len(tiles)) % batch
    return tiles, width, height, batch, exact_windows(tiles, height, width, S_IN, n_total)


def tile_order_writes(tiles, height: int, width: int, values: list) -> np.ndarray:
    """The reference's loop: tile i's s x s interior, clamped into the
    (max(H, s), max(W, s)) planes, written in grid order."""
    Ho, Wo = max(height, S_IN), max(width, S_IN)
    out = np.full(np.shape(values[0])[:-2] + (Ho, Wo), -1, np.int64)
    for t, v in zip(tiles, values):
        r0, c0 = min(t.irow0, Ho - S_IN), min(t.icol0, Wo - S_IN)
        out[..., r0:r0 + S_IN, c0:c0 + S_IN] = v
    return out


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_windows_give_the_tile_order_owner_map(zone):
    tiles, width, height, _, win = zone_windows(zone)
    want = tile_order_writes(tiles, height, width,
                             [np.full((S_IN, S_IN), i) for i in range(len(tiles))])
    got = np.full_like(want, -1)
    for i, (r0, c0, rlo, rhi, clo, chi) in enumerate(win):
        assert 0 <= rlo <= rhi <= S_IN and 0 <= clo <= chi <= S_IN
        block = got[r0 + rlo:r0 + rhi, c0 + clo:c0 + chi]
        assert (block == -1).all()  # windows are disjoint
        block[...] = i
    np.testing.assert_array_equal(got, want)
    assert (got[:height, :width] >= 0).all()  # every zone pixel has an owner


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_padding_duplicates_own_nothing(zone):
    tiles, _, _, batch, win = zone_windows(zone)
    assert len(win) % batch == 0
    if zone.startswith("ragged"):
        assert len(win) > len(tiles)
    assert (win[len(tiles):] == 0).all()


def random_tail(rng, k: int) -> ft.TailParams:
    def t(shape, scale=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    return ft.TailParams(t((16, 32, 3, 3)), 1 + t(16), t(16), t((16, 16, 3, 3)), 1 + t(16),
                         t(16), t((k, 16, 3, 3)), t(k))


@pytest.mark.parametrize("zone", sorted(ZONES))
def test_plain_tail_into_planes_matches_tile_order_loop(zone):
    tiles, width, height, batch, win = zone_windows(zone)
    rng = np.random.default_rng(len(tiles))
    g = ft.tail_geometry(SIZE, MARGIN)
    p = random_tail(rng, 5)
    n = len(tiles)
    x3 = torch.from_numpy(rng.standard_normal((n, g.x3_extent, g.x3_extent, 32))
                          .astype(np.float32)).permute(0, 3, 1, 2)
    x3 = torch.cat([x3, x3[-1:].expand(len(win) - n, -1, -1, -1)])
    with torch.inference_mode():
        cls, prob = ft.fused_tail_plain(x3[:n], p, g)
        planes = torch.zeros((2, max(height, S_IN), max(width, S_IN)), dtype=torch.uint8)
        windows = torch.from_numpy(win)
        ft.launches = 0
        for b0 in range(0, len(win), batch):
            out = ft.fused_tail(x3[b0:b0 + batch], p, g, planes, windows[b0:b0 + batch])
            assert out is planes
        assert ft.launches == 0  # CPU tensors take the plain version
    want = tile_order_writes(tiles, height, width,
                             list(torch.stack([cls, prob], 1).numpy()))
    np.testing.assert_array_equal(planes.numpy(), want)


def test_tile_output_is_the_planes_of_full_windows():
    """Without planes the tail returns (B, s, s) tiles; the kernel writes
    them as (B s, s) planes through full windows."""
    w = ft.full_windows(3, S_IN, torch.device("cpu"))
    assert w.tolist() == [[b * S_IN, 0, 0, S_IN, 0, S_IN] for b in range(3)]
    rng = np.random.default_rng(1)
    g = ft.tail_geometry(SIZE, MARGIN)
    p = random_tail(rng, 3)
    x3 = torch.from_numpy(rng.standard_normal((3, g.x3_extent, g.x3_extent, 32))
                          .astype(np.float32)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        cls, prob = ft.fused_tail(x3, p, g)
        planes = ft.fused_tail(x3, p, g, torch.zeros((2, 3 * S_IN, S_IN), dtype=torch.uint8), w)
    assert torch.equal(planes[0].view(3, S_IN, S_IN), cls)
    assert torch.equal(planes[1].view(3, S_IN, S_IN), prob)
