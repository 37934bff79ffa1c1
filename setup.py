"""Packaging for flairtpu with the reference-compatible console entry points.

The two CLIs mirror the reference's installed scripts (reference setup.py:43-48):
`flair --conf=<yaml>` and `flair-detect --conf=<yaml> [-c] [-m] [-b]`.
"""

from setuptools import find_packages, setup

setup(
    name="flairtpu",
    version="0.2.0",
    description="TPU-native framework for FLAIR-1 land-cover segmentation (JAX/Flax/Pallas)",
    python_requires=">=3.10",
    packages=find_packages(include=["flairtpu", "flairtpu.*",
                                    "flairtpu_torch", "flairtpu_torch.*"]),
    package_data={"flairtpu.native": ["*.cpp", "*.py"],
                  "flairtpu_torch.native": ["*.cpp", "*.py"],
                  "flairtpu_torch": ["csrc/*.cu"]},
    entry_points={
        "console_scripts": [
            "flair = flairtpu.cli:flair_main",
            "flair-detect = flairtpu.cli:detect_main",
        ]
    },
)
