"""gather_normalize (plain, CPU) against flairtpu's DeviceZoneRunner._gather +
normalize_device, jitted as the zone program runs them: exactly equal in
float32, for both normalizations the detect config allows."""

import jax
import numpy as np
import pytest
import torch

from flairtpu.data.normalize import normalize_device
from flairtpu.zone.device_engine import DeviceZoneRunner
from flairtpu_torch.ops import gather as ga

S, C = 32, 5
NORMS = {
    "scaling": dict(norm_type="scaling", means=(), stds=()),
    "custom": dict(norm_type="custom", means=(105.0, 110.5, 97.25, 120.0, 18.5),
                   stds=(52.0, 45.5, 44.0, 39.75, 27.0)),
}


def reference_runner(norm: dict) -> DeviceZoneRunner:
    return DeviceZoneRunner({
        "img_pixels_detection": S, "margin": 8, "batch_size": 4, "n_classes": 4,
        "output_type": "argmax",
        "norma_task": [{"norm_type": norm["norm_type"], "norm_means": list(norm["means"]),
                        "norm_stds": list(norm["stds"])}]}, None, None, None)


@pytest.mark.parametrize("norm", sorted(NORMS))
def test_gather_normalize_matches_flairtpu(norm):
    rng = np.random.default_rng(7)
    zone = rng.integers(0, 256, (70, 90, C), dtype=np.uint8)
    origins = np.stack([rng.integers(0, 70 - S + 1, 6), rng.integers(0, 90 - S + 1, 6)],
                       axis=1).astype(np.int32)
    runner = reference_runner(NORMS[norm])
    want = np.array(jax.jit(lambda z, o: normalize_device(
        runner._gather(z, o), src_dtype=np.uint8, **runner.norm))(zone, origins))

    ga.launches = 0
    got = ga.gather_normalize(torch.from_numpy(zone), torch.from_numpy(origins), S,
                              out_dtype=torch.float32, **NORMS[norm])
    assert ga.launches == 0  # CPU tensors take the plain version
    assert got.dtype == torch.float32 and got.shape == (6, S, S, C)
    np.testing.assert_array_equal(got.numpy(), want)

    got16 = ga.gather_normalize(torch.from_numpy(zone), torch.from_numpy(origins), S,
                                out_dtype=torch.bfloat16, **NORMS[norm])
    assert torch.equal(got16, torch.from_numpy(want).to(torch.bfloat16))


def test_gather_output_is_channels_last_view():
    """The encoder takes the NHWC tiles as an NCHW channels_last view, no copy."""
    zone = torch.zeros((40, 40, C), dtype=torch.uint8)
    x = ga.gather_normalize(zone, torch.zeros((2, 2), dtype=torch.int32), S, "scaling")
    assert x.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
