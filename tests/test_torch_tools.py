"""``python -m flairtpu_torch.tools make-toy-dataset`` against ``flairtpu``'s:
the same arrays, CSV rows and YAML from one seed (the YAML's
``accelerator`` names the card in the port), a YAML the port's
``validate_train_config`` passes, and the subcommands the port has."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from flairtpu.tools import main as flax_tools_main
from flairtpu_torch import config as cfgmod
from flairtpu_torch.io import TiffReader
from flairtpu_torch.tools import main as tools_main

ROOT = Path(__file__).resolve().parent.parent
ARGS = ["make-toy-dataset", "--size", "64", "--train", "3", "--val", "2", "--test", "2",
        "--classes", "5", "--seed", "7"]


@pytest.fixture(scope="module")
def toys(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    tools_main(ARGS + ["--root", str(tmp / "port")])
    flax_tools_main(ARGS + ["--root", str(tmp / "flairtpu")])
    return tmp / "port", tmp / "flairtpu"


def test_same_arrays_and_rows_as_flairtpu(toys):
    port, ref = toys
    for split, n in (("train", 3), ("val", 2), ("test", 2)):
        rows = (port / f"flair-1-paths-toy-{split}.csv").read_text().splitlines()
        want = (ref / f"flair-1-paths-toy-{split}.csv").read_text().splitlines()
        assert len(rows) == n
        assert [r.replace(str(port), "") for r in rows] == [r.replace(str(ref), "") for r in want]
        for row in rows:
            for path in row.split(","):
                with TiffReader(path) as a, TiffReader(path.replace(str(port), str(ref))) as b:
                    assert (a.crs, a.transform) == (b.crs, b.transform)
                    assert a.read().tobytes() == b.read().tobytes()
    with TiffReader(port / "train" / "msk" / "MSK_000000.tif") as r:
        msk = r.read(1)
    assert (r.width, r.height, r.count) == (64, 64, 1)
    assert 1 <= msk.min() and msk.max() <= 5


def test_yaml_equals_flairtpus_but_the_accelerator(toys):
    port, ref = toys
    got = yaml.safe_load((port / "toy-config.yaml").read_text())
    want = yaml.safe_load((ref / "toy-config.yaml").read_text().replace(str(ref), str(port)))
    assert got.pop("accelerator") == "gpu" and want.pop("accelerator") == "tpu"
    assert got == want
    cfg = cfgmod.validate_train_config(yaml.safe_load((port / "toy-config.yaml").read_text()))
    assert cfg["paths"]["train_csv"] == str(port / "flair-1-paths-toy-train.csv")


def test_module_entry_point(tmp_path):
    out = subprocess.run([sys.executable, "-m", "flairtpu_torch.tools", *ARGS, "--root",
                          str(tmp_path / "t")], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "t" / "toy-config.yaml").exists()
    # make-toy-zone is ported since step 3; export-model is not (slice 8)
    out = subprocess.run([sys.executable, "-m", "flairtpu_torch.tools", "export-model",
                          "--conf", "c.yaml", "--out", "m"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "slice 8" in out.stderr
    out = subprocess.run([sys.executable, "-m", "flairtpu_torch.tools", "make-toy-model"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "invalid choice" in out.stderr
