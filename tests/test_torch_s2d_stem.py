"""``s2d_stem``: the resnet stem conv on a space-to-depth repack, against the
direct 7 x 7 / 2 conv and against ``flairtpu``'s ``StemConv(s2d=True)``
(CPU, float32).

The repack of the input and of the kernel are reshapes, so they equal
``flairtpu``'s bit for bit; the conv on the repack sums the same products
in another order, so the stem agrees with the direct one within 1e-5 of
its largest |output|, and a resnet18 U-Net with ``s2d_stem: true`` agrees
with ``flairtpu``'s same configuration within 1e-4 (``test_torch_models``'s
bound: the frameworks sum convs in other orders), from one ``.pth``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flairtpu.models.convert import torch_to_flax
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.models.resnet import _s2d, _s2d_kernel
from flairtpu_torch.models.factory import FlairSegmentationModel, create_model
from flairtpu_torch.models.resnet import ResNetEncoder, s2d_input, s2d_kernel, stem_conv
from tests.test_torch_models import random_state_dict


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def nchw(x: np.ndarray) -> torch.Tensor:
    """(B, H, W, C) numpy -> an NCHW view of NHWC memory, as the encoder takes it."""
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("channels,size", [(5, 64), (3, 32), (1, 18)])
def test_repacks_match_flairtpu(channels, size):
    rng = np.random.default_rng(channels)
    x = rng.normal(0, 1, (2, size, size, channels)).astype(np.float32)
    w = rng.normal(0, 1, (64, channels, 7, 7)).astype(np.float32)  # torch (O, C, kh, kw)
    want_x = np.pad(np.asarray(_s2d(jnp.asarray(x))), ((0, 0), (2, 1), (2, 1), (0, 0)))
    np.testing.assert_array_equal(s2d_input(nchw(x)).permute(0, 2, 3, 1).numpy(), want_x)
    want_w = np.asarray(_s2d_kernel(jnp.asarray(w.transpose(2, 3, 1, 0))))  # HWIO
    np.testing.assert_array_equal(s2d_kernel(torch.from_numpy(w)).permute(2, 3, 1, 0).numpy(),
                                  want_w)


@pytest.mark.parametrize("channels,size", [(5, 64), (3, 32), (1, 18)])
def test_s2d_stem_matches_the_direct_stem(channels, size):
    torch.manual_seed(channels)
    stem = ResNetEncoder("resnet18", channels).conv1
    x = nchw(np.random.default_rng(size).uniform(0, 1, (2, size, size, channels))
             .astype(np.float32))
    with torch.inference_mode():
        want = stem_conv(x, stem, torch.float32, False)
        got = stem_conv(x, stem, torch.float32, True)
    assert got.shape == want.shape == (2, 64, size // 2, size // 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_s2d_stem_gradient_reaches_the_7x7_kernel():
    """A train step's gradient lands in the 7 x 7 parameter, as the direct
    stem's does."""
    torch.manual_seed(0)
    stem = ResNetEncoder("resnet18", 5).conv1
    x = nchw(np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 5)).astype(np.float32))
    grads = []
    for s2d in (False, True):
        stem.weight.grad = None
        stem_conv(x, stem, torch.float32, s2d).square().sum().backward()
        grads.append(stem.weight.grad.clone())
    assert grads[1].shape == (64, 5, 7, 7)
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(), rtol=0,
                               atol=1e-5 * float(grads[0].abs().max()))


def test_resnet18_unet_s2d_matches_flairtpu():
    """The config key reaches the port's model; its logits agree with
    flairtpu's s2d model on one .pth at a 64-pixel tile."""
    cfg = {"model_framework": {"model_provider": "SegmentationModelsPytorch",
                               "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
           "n_classes": 4, "channels": [1, 2, 3, 4, 5], "s2d_stem": True}
    port = create_model(cfg).eval()
    assert port.encoder.s2d_stem
    assert not FlairSegmentationModel("resnet18", 4, 5).encoder.s2d_stem
    sd = random_state_dict(port, np.random.default_rng(16))
    port.load_state_dict(sd, strict=True)
    variables = torch_to_flax({k: v.numpy() for k, v in sd.items()})
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 5)).astype(np.float32)
    want = np.asarray(flax_create_model(cfg).apply(variables, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 4)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
