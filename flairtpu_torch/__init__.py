"""PyTorch / CUDA port of flairtpu for one NVIDIA H100.

Same module names as ``flairtpu``, so each module's counterpart is easy to
find. The port imports PyTorch and never JAX, Flax or ``flairtpu``; where it
needs a jax-free module of the reference it keeps its own copy (``io``,
``native``, ``zone/grid.py``, ``utils/logger.py``).

Implemented: ``flair-detect`` with the ``resnet*_unet`` models (every
output type, stitching method and route, the compare sweep, batch mode, the
``bn_fold`` and int8 knobs) and ``flair`` train / predict / metrics, on the
card through hand-written CUDA kernels (``csrc/``) or on the CPU through
their plain PyTorch versions. What is not ported raises
``NotImplementedError`` naming the slice of the port that brings it.
"""

__version__ = "0.1.0"
