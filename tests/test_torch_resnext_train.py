"""One train step of resnext50_32x4d-unet in flairtpu_torch against
flairtpu's ``_micro_step`` (CPU, float32, 64 x 64 tiles, batch 4).

Both packages step from flairtpu's initial weights. Two ``flairtpu``
programs are compiled: its init and its step.

- The loss within 1e-5 and the confusion matrix exactly, as
  ``tests/test_torch_train.py``; the step's change over all tensors
  together within 5e-3 in relative L2 (``test_torch_train.py``'s
  per-tensor bound).
- Each tensor after the step within 1e-5 of its scale, or within 15 x the
  port's own drift: its largest difference from the port's same step on
  the batch in two other orders. Each tensor's change within 5e-3 relative
  L2, or within 5 x the drift's relative L2.

``test_torch_train.py``'s resnet18 bounds do not hold tensor by tensor
here. The gradients of the weights before each of 50 BatchNorms cancel,
and the port's own float32 step moves them by 2-6% in relative L2 when
only the batch order changes. The factors come from this test's readings.
Of 317 tensors, 61 need the drift in max |error|, at most 6.99 x (median
2.6 x), and 187 need it in relative L2, at most 3.65 x (median 2.4 x).
With one group's weight gradient zeroed at every grouped 3x3, the 16
grouped weights stand at 5.1-33 x their drift in max |error| (11 beyond
both 1e-5 of their scale and 15 x) and at 6.5-9.0 x in relative L2 (all
16 beyond 5 x), and the test fails.
"""

import copy

import numpy as np
import pytest
import torch

from flairtpu import config as fcfg
from flairtpu.train.loop import SegmentationTrainer as FlaxTrainer
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.train.loop import SegmentationTrainer
from tests.test_torch_train import flax_step, host, toy_batch, train_config

ENCODER, SIZE = "resnext50_32x4d", 64
# the batch's two other orders, whose steps give the port's own drift
ORDERS = ([3, 2, 1, 0], [1, 3, 0, 2])


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_step(tr: SegmentationTrainer, state: dict, img, msk) -> tuple[float, dict, np.ndarray]:
    tr.model.load_state_dict(state)
    cm = tr.new_confmat()
    loss = tr.train_step({"img": torch.from_numpy(img), "msk": torch.from_numpy(msk)}, cm)
    return loss.item(), {k: v.clone() for k, v in tr.model.state_dict().items()}, cm.numpy()


def test_train_step_matches_flairtpu():
    cfg = train_config(model_framework={
        "model_provider": "SegmentationModelsPytorch",
        "SegmentationModelsPytorch": {"encoder_decoder": f"{ENCODER}_unet"}})
    ftr = FlaxTrainer(fcfg.validate_train_config(copy.deepcopy(cfg)))
    before = from_flax(host(ftr.params), host(ftr.batch_stats))
    img, msk = toy_batch(11, size=SIZE)
    loss_j, params_j, stats_j, cm_j = flax_step(ftr, img, msk, 1)
    want = from_flax(host(params_j), host(stats_j))
    tr = SegmentationTrainer(cfgmod.validate_train_config(copy.deepcopy(cfg)))
    loss, got, cm = port_step(tr, before, img, msk)
    others = [port_step(tr, before, img[p].copy(), msk[p].copy())[1] for p in ORDERS]

    np.testing.assert_allclose(loss, loss_j, rtol=1e-5)
    assert int(np.abs(cm - cm_j).sum()) == 0
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    gap = sum(float((got[k] - want[k]).norm()) ** 2 for k in keys)
    change = sum(float((want[k] - before[k]).norm()) ** 2 for k in keys)
    assert (gap / change) ** 0.5 < 5e-3
    for key in keys:
        w = want[key]
        drift = max(float((got[key] - o[key]).abs().max()) for o in others)
        err = float((got[key] - w).abs().max())
        assert err <= max(1e-5 * max(float(w.abs().max()), 1.0), 15 * drift), (key, err, drift)
        step_want = w - before[key]
        rel = float((got[key] - w).norm() / step_want.norm())
        self_rel = max(float((got[key] - o[key]).norm() / step_want.norm()) for o in others)
        assert rel <= max(5e-3, 5 * self_rel), (key, rel, self_rel)
