"""``init_encoder_weights`` in the port (CPU) against ``flairtpu``.

smp's first-conv channel rule bit for bit; numpy-seeded torchvision-keyed
resnet18 and resnet50 classifiers loaded into the encoder, equal to
``flairtpu``'s encoder after its init (carried by ``from_flax``) exactly;
the strict cover (a missing key, an extra key, a wrong shape) raising as in
``flairtpu``; the encoders the port does not build; and ``fit``'s order: a
checkpoint given beside ``init_encoder_weights`` wins.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from flairtpu.models import pretrained as fpre
from flairtpu.models.factory import create_model as flax_create_model
from flairtpu.models.factory import init_model
from flairtpu_torch import config as cfgmod
from flairtpu_torch.models import pretrained as ppre
from flairtpu_torch.models.convert import from_flax
from flairtpu_torch.models.factory import FlairSegmentationModel, init_weights
from flairtpu_torch.train.loop import SegmentationTrainer, fit


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads for PyTorch's CPU kernels here: the suite runs
    several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_CLASSES = 4


@pytest.mark.parametrize("in_channels", [1, 3, 4, 5])
def test_adapt_conv_and_patch_first_conv_bit_for_bit(in_channels):
    rng = np.random.default_rng(in_channels)
    w = rng.standard_normal((64, 3, 7, 7)).astype(np.float32)
    got, want = ppre._adapt_conv(w, in_channels, 3), fpre._adapt_conv(w, in_channels, 3)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    sd = {"bn0.weight": np.ones(3, np.float32), "conv1.weight": w,
          "layer1.0.conv1.weight": rng.standard_normal((64, 3, 3, 3)).astype(np.float32)}
    got, want = ppre.patch_first_conv(sd, in_channels), fpre.patch_first_conv(sd, in_channels)
    assert list(got) == list(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k
    with pytest.raises(ValueError, match="no 3-input-channel"):
        ppre.patch_first_conv({"conv1.weight": np.zeros((2, 5, 3, 3))}, in_channels)


def classifier(encoder: str, seed: int) -> dict[str, torch.Tensor]:
    """A torchvision-keyed ImageNet classifier state dict from a numpy seed:
    the encoder's keys at 3 input channels, random BatchNorm statistics, the
    fc head and the BatchNorm counters."""
    rng = np.random.default_rng(seed)
    enc = FlairSegmentationModel(encoder, N_CLASSES, 3).encoder
    sd = {}
    for k, v in enc.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
            continue
        if k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, tuple(v.shape))
        elif v.dim() == 1:
            a = rng.normal(0.0, 0.5, tuple(v.shape))
        else:
            a = rng.standard_normal(tuple(v.shape)) * np.sqrt(2.0 / v[0].numel())
        sd[k] = torch.from_numpy(a.astype(np.float32))
    width = 512 if encoder in ("resnet18", "resnet34") else 2048
    sd["fc.weight"] = torch.from_numpy(rng.standard_normal((1000, width)).astype(np.float32))
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def flax_variables(encoder: str) -> dict:
    model = flax_create_model({
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": f"{encoder}_unet"}},
        "n_classes": N_CLASSES, "channels": [1, 2, 3, 4, 5]})
    params, stats = init_model(model, (1, 64, 64, 5), seed=3)
    return {"params": params, "batch_stats": stats}


def host(tree):
    return jax.tree_util.tree_map(np.array, jax.device_get(tree))


@pytest.fixture(scope="module")
def resnet18_variables():
    return flax_variables("resnet18")


@pytest.mark.parametrize("encoder", ["resnet18", "resnet50"])
def test_encoder_init_equals_flairtpus(encoder, resnet18_variables, tmp_path):
    """The port's encoder after the init equals flairtpu's, carried by
    from_flax, tensor for tensor; the decoder and head keep their values."""
    pth = tmp_path / "classifier.pth"
    torch.save(classifier(encoder, 5), pth)
    variables = resnet18_variables if encoder == "resnet18" else flax_variables(encoder)
    out = fpre.init_encoder_from_classifier(pth, encoder, 5, variables)
    want = from_flax(host(out["params"]), host(out["batch_stats"]))

    model = FlairSegmentationModel(encoder, N_CLASSES, 5)
    init_weights(model, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ppre.init_encoder_from_classifier(pth, model)
    got = model.state_dict()
    enc = [k for k in got if k.startswith("encoder.") and not k.endswith("num_batches_tracked")]
    assert len(enc) == len([k for k in want if k.startswith("encoder.")
                            and not k.endswith("num_batches_tracked")])
    for k in enc:
        assert torch.equal(got[k], want[k]), k
    for k in got:
        if not k.startswith("encoder."):
            assert torch.equal(got[k], before[k]), k


@pytest.mark.parametrize("fault,match", [
    ("missing", "missing"), ("extra", "unexpected"), ("shape", "shape mismatch")])
def test_cover_faults_raise_as_in_flairtpu(fault, match, resnet18_variables, tmp_path):
    sd = classifier("resnet18", 6)
    if fault == "missing":
        del sd["layer2.1.conv2.weight"]
    elif fault == "extra":
        sd["layer5.0.conv1.weight"] = torch.zeros(8, 8, 3, 3)
    else:
        sd["layer3.0.bn1.weight"] = torch.ones(255)
    pth = tmp_path / "classifier.pth"
    torch.save(sd, pth)
    with pytest.raises(ValueError, match=match):
        fpre.init_encoder_from_classifier(pth, "resnet18", 5, resnet18_variables)
    model = FlairSegmentationModel("resnet18", N_CLASSES, 5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=match):
        ppre.init_encoder_from_classifier(pth, model)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_encoders_the_port_does_not_build():
    """A family flairtpu converts but the port does not build raises
    not_ported (slice 6); an unknown family raises as in flairtpu."""
    sd = {"conv1.weight": np.zeros((8, 3, 3, 3), np.float32)}
    with pytest.raises(NotImplementedError, match="slice 6"):
        ppre.classifier_to_encoder_state_dict(sd, "vgg16_bn", 5)
    with pytest.raises(NotImplementedError, match="slice 6"):
        ppre.classifier_to_encoder_state_dict(sd, "se_resnext50_32x4d", 5)
    for pkg in (ppre, fpre):
        with pytest.raises(ValueError, match="no classifier-checkpoint converter"):
            pkg.classifier_to_encoder_state_dict(sd, "squeezenet1_0", 5)


def train_config(tmp_path, **over) -> dict:
    cfg = {
        "paths": {"out_folder": str(tmp_path / "out"), "out_model_name": "enc",
                  "train_csv": "", "val_csv": "", "test_csv": "", "ckpt_model_path": ""},
        "tasks": {"train": True, "train_tasks": {}, "predict": False, "metrics": False},
        "model_framework": {"model_provider": "SegmentationModelsPytorch",
                            "SegmentationModelsPytorch": {"encoder_decoder": "resnet18_unet"}},
        "channels": [1, 2, 3, 4, 5], "batch_size": 2, "num_epochs": 0,
        "classes": {i + 1: [1, f"c{i}"] for i in range(N_CLASSES)}, "accelerator": "cpu",
    }
    cfg.update(over)
    return cfg


def test_config_checks_the_file(tmp_path):
    with pytest.raises(cfgmod.ConfigError, match="init_encoder_weights file not found"):
        cfgmod.validate_train_config(train_config(
            tmp_path, init_encoder_weights=str(tmp_path / "none.pth")))


def test_fit_applies_it_before_a_checkpoint(tmp_path):
    """fit loads the classifier into the encoder; a checkpoint given beside
    it (weights-only init) is applied after it and wins."""
    pth = tmp_path / "classifier.pth"
    torch.save(classifier("resnet18", 7), pth)
    cfg = cfgmod.validate_train_config(train_config(tmp_path, init_encoder_weights=str(pth)))
    empty = {"IMG": [], "MSK": [], "MTD": []}
    logs = []
    tr, _ = fit(copy.deepcopy(cfg), empty, empty, tmp_path / "a", progress=logs.append)
    assert any("encoder initialized from classifier weights" in m for m in logs)
    want = torch.from_numpy(ppre._adapt_conv(classifier("resnet18", 7)["conv1.weight"].numpy(),
                                             5, 3))
    assert torch.equal(tr.model.encoder.conv1.weight, want)

    ckpt = SegmentationTrainer(cfg).model
    init_weights(ckpt, 11)
    torch.save(ckpt.state_dict(), tmp_path / "ckpt.pth")
    cfg["paths"]["ckpt_model_path"] = str(tmp_path / "ckpt.pth")
    cfg["tasks"]["train_tasks"]["init_weights_only_from_ckpt"] = True
    tr, _ = fit(cfg, empty, empty, tmp_path / "b", progress=lambda _: None)
    for k, v in ckpt.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
