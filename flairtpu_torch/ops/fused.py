"""Softmax max/argmax epilogue (counterpart of ``flairtpu/ops/fused.py:38-44``).

The zone program needs only the argmax class and the maximum probability per
pixel; ``maxprob == 1 / sum(exp(x - max))``, so the full softmax is never
formed. On the main path this epilogue runs inside the fused decoder-tail
kernel (``ops/fused_tail.py``); this plain version is its reference.
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
