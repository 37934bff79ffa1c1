"""flairtpu_torch models against flairtpu: weight bridge and logits (CPU, fp32).

One random smp-keyed state dict feeds both packages: the port loads it
strictly, flairtpu through its own torch->flax converter.
"""

import jax
import numpy as np
import pytest
import torch

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.models.factory import FlairSegmentationModel

N_CLASSES = 4


def random_state_dict(model: torch.nn.Module, rng: np.random.Generator) -> dict:
    """Seeded smp-keyed weights: He-scaled convs, random BatchNorm statistics."""
    sd = {}
    for key, v in model.state_dict().items():
        shape = tuple(v.shape)
        if key.endswith("num_batches_tracked"):
            sd[key] = v.clone()
            continue
        if key.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif key.endswith(("running_mean", ".bias")):
            a = rng.normal(0.0, 0.1, shape)
        elif v.dim() == 1:  # BatchNorm gamma
            a = rng.uniform(0.5, 1.0, shape)
        else:
            a = rng.standard_normal(shape) * np.sqrt(2.0 / v[0].numel())
        sd[key] = torch.from_numpy(a.astype(np.float32))
    return sd


def flax_model(encoder: str, n_classes: int = N_CLASSES):
    return flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_unet"}},
        "n_classes": n_classes, "channels": [1, 2, 3, 4, 5]})


@pytest.fixture(scope="module", params=["resnet18", "resnet34", "resnet50"])
def pair(request):
    """(encoder, port model, flax model, flax variables) on shared weights."""
    rng = np.random.default_rng(11)
    port = FlairSegmentationModel(request.param, N_CLASSES, 5).eval()
    sd = random_state_dict(port, rng)
    port.load_state_dict(sd, strict=True)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    return request.param, port, flax_model(request.param), variables, sd


def test_from_flax_round_trip_is_exact(pair):
    _, port, _, variables, sd = pair
    back = from_flax(variables["params"], variables["batch_stats"])
    assert set(back) == set(sd) == set(port.state_dict())
    for k, v in sd.items():
        assert back[k].dtype == v.dtype, k
        assert torch.equal(back[k], v), k
    port.load_state_dict(back, strict=True)


@pytest.mark.parametrize("inner_margin", [None, 16])
def test_logits_match_flairtpu(pair, inner_margin):
    """fp32 logits agree to 1e-4 (the two frameworks sum convs in other orders)."""
    _, port, fmodel, variables, _ = pair
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 5)).astype(np.float32)
    want = np.asarray(fmodel.apply(variables, jax.numpy.asarray(x), train=False,
                                   inner_margin=inner_margin))
    with torch.inference_mode():
        got = port(torch.from_numpy(x), inner_margin=inner_margin).numpy()
    assert got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
