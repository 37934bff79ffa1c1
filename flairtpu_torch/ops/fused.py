"""Softmax epilogues and the tile-order scatter-accumulate (counterpart of
``flairtpu/ops/fused.py:38-76`` and ``jax.nn.softmax``).

The exact-clipping argmax program needs only the argmax class and the
maximum probability per pixel; ``maxprob == 1 / sum(exp(x - max))``, so the
full softmax is never formed. On the card these epilogues run inside the
kernels (``ops/fused_tail.py``, ``ops/stitch.py``); the plain versions here
are their references. :func:`class_sum` adds the classes one by one in
ascending order, the order the kernels' softmax sums take.
"""

from __future__ import annotations

import torch


def softmax_argmax(logits: torch.Tensor, dim: int = -1):
    """logits (..., K) -> (argmax int32, maxprob float32). Ties go to the
    first maximum, as ``jnp.argmax`` does."""
    x = logits.to(torch.float32)
    m = x.amax(dim=dim, keepdim=True)
    arg = x.argmax(dim=dim).to(torch.int32)
    s = torch.exp(x - m).sum(dim=dim)
    return arg, 1.0 / s


def prob_to_u8(prob: torch.Tensor) -> torch.Tensor:
    """round(255 * p) with round-half-to-even, as ``jnp.round`` does."""
    return torch.round(prob * 255).to(torch.uint8)


def class_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim``, one class after another in ascending order."""
    parts = x.unbind(dim)
    s = parts[0].clone()
    for p in parts[1:]:
        s = s + p
    return s


def softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """exp(x - max) / sum, as ``jax.nn.softmax`` writes it (a division, not a
    product with 1 / sum), float32, the sum in ascending class order."""
    x = logits.to(torch.float32)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / class_sum(e, dim).unsqueeze(dim)


def write_windows(planes: list[torch.Tensor], tiles: list[torch.Tensor], windows) -> None:
    """Tile i's owned window of each of ``tiles`` (N, s, s[, K]) into the
    matching plane, ``windows[i] = (R0, C0, rlo, rhi, clo, chi)``: interior
    pixel (r, c) with rlo <= r < rhi, clo <= c < chi lands at (R0 + r, C0 + c)."""
    for i, (r0, c0, rlo, rhi, clo, chi) in enumerate(windows.tolist()):
        for plane, t in zip(planes, tiles):
            plane[r0 + rlo:r0 + rhi, c0 + clo:c0 + chi] = t[i, rlo:rhi, clo:chi]


def scatter_accumulate(acc: torch.Tensor, tiles: torch.Tensor, origins,
                       weights: torch.Tensor | None = None) -> torch.Tensor:
    """acc[r0:r0+h, c0:c0+w] += tiles[i] (* weights), one tile after another
    in order, in place (``flairtpu/ops/fused.py:56-76``); returns ``acc``.

    acc (H, W, K); tiles (N, h, w, K); origins (N, 2) (row, col) with every
    window inside acc; weights (h, w) or None."""
    if weights is not None:
        tiles = tiles * weights[None, :, :, None]
    tiles = tiles.to(acc.dtype)
    h, w = tiles.shape[1:3]
    for tile, (r0, c0) in zip(tiles, origins.tolist()):
        acc[r0:r0 + h, c0:c0 + w] += tile
    return acc
