"""One ``flair`` train step of PAN, LinkNet, MAnet and UNet++ against
``flairtpu``'s (``tests/test_torch_train_archs.py`` holds the four
strided-head decoders with dropout, and says how).

None of these four drops out. PAN runs at 128 x 128 (its pyramid pools the
stride-16 map three times; ``flairtpu``'s trainer is initialized there,
its own 64 x 64 init fails for PAN). PAN's six 1-channel BatchNorm sites
and LinkNet's 16- to 128-channel sites run through the port's train-mode
BatchNorm (the narrow entry points for the 1-channel ones on the card);
their conv biases get no gradient (``BIAS_BEFORE_BN``).
"""

import pytest
import torch

from tests.test_torch_train_archs import check_train_step


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (patch size, step_tol, atol, confusion-matrix pixels that may move). Each
# widened bound is at sites whose BatchNorm statistics cover few values at
# batch 4, where float32 sums in another order move the step: the port's own
# step on the batch in reverse order moves the same tensors about as far.
# - pan: fpa.down3's 1-channel BatchNorms see 4 values (1 x 1 maps): 1.7e-2
#   there (reversed order 5.6e-3), 1e-2 in the encoder (reversed 9e-3). Its
#   first step is large (loss 4.14 over 4 classes; a weight moves by up to
#   4.5e-2), so that relative drift is up to 4.3e-4 of a weight's scale
#   after the step (encoder.layer2.0.conv1.weight): atol 1e-3.
# - linknet: layer4's BatchNorms see 16 values (2 x 2 maps): 1.1e-2
#   (reversed 1.3e-2).
# - manet: the same layer4 and the SE gates behind it: 2.5e-2 at
#   blocks.0.SE_ll (reversed 1.3e-2), 1.3e-5 of scale at encoder.conv1.weight
#   after the step; one pixel's argmax moves where the two packages' top-2
#   logits tie within their float32 sums.
# - unetplusplus: its 8 x 8 nodes x_1_*: 7.3e-3 (reversed 3.8e-3).
TOLS = {"pan": (128, 5e-2, 1e-3, 0), "linknet": (64, 3e-2, 1e-5, 0),
        "manet": (64, 5e-2, 3e-5, 2), "unetplusplus": (64, 1.5e-2, 1e-5, 0)}


@pytest.mark.parametrize("arch", list(TOLS))
def test_train_step_matches_flairtpu(arch):
    size, step_tol, atol, moved = TOLS[arch]
    check_train_step(arch, size, step_tol, atol, moved)
