"""PyTorch / CUDA port of flairtpu for one NVIDIA H100.

Same module names as ``flairtpu``, so each module's counterpart is easy to
find. The port imports PyTorch and never JAX, Flax or ``flairtpu``; where it
needs a jax-free module of the reference it keeps its own copy (``io``,
``native``, ``zone/grid.py``, ``utils/logger.py``).

Implemented: ``flair-detect`` with a ``resnet*_unet`` model, ``output_type:
argmax`` and exact-clipping stitching, device-resident on the card. Two
hand-written CUDA kernels carry it (``csrc/``): the tile gather with
normalization, and the fused decoder tail (last U-Net block + head +
softmax max/argmax epilogue). Everything else raises ``NotImplementedError``
naming the slice of the port that brings it.
"""

__version__ = "0.1.0"
