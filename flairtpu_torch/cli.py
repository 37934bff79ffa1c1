"""Console entry (counterpart of ``flairtpu/cli.py:111-158``).

``python -m flairtpu_torch.cli flair-detect --conf=<yaml> [-c] [-m] [-b]``
reads the same YAML as ``python -m flairtpu.cli flair-detect`` and writes
the same LZW GeoTIFFs (2 bands for argmax, K for class_prob); ``-c`` runs
the compare sweep, ``-m`` adds its metrics, and ``-b`` runs every zone of a
department (``input_path``) with one model and writes the per-method
metrics JSON. ``flair`` (train / predict / metrics) is not ported yet.
"""

from __future__ import annotations

import argparse
import sys

from flairtpu_torch import config as cfgmod
from flairtpu_torch.zone.batch import batch_metrics_pipeline
from flairtpu_torch.zone.engine import run_pipeline


def flair_main(argv=None) -> None:
    raise cfgmod.not_ported("flair train / predict / metrics", "slice 4")


def detect_main(argv=None) -> dict:
    parser = argparse.ArgumentParser(prog="flair-detect")
    parser.add_argument("--conf", help="path to the .yaml config file", required=True)
    parser.add_argument("-c", "--compare", action="store_true",
                        help="compare different methods")
    parser.add_argument("-m", "--metrics", action="store_true",
                        help="compute metrics")
    parser.add_argument("-b", "--batch_mode", action="store_true",
                        help="run on a batch of input images")
    args = parser.parse_args(argv)

    config = cfgmod.read_config(args.conf)
    config["metrics"] = args.metrics
    config["batch_mode"] = args.batch_mode
    config["compare"] = args.compare
    config = cfgmod.validate_detect_config(config)
    if args.batch_mode:
        return batch_metrics_pipeline(config)
    return run_pipeline(config)


def _module_main() -> None:
    """python -m flairtpu_torch.cli {flair|flair-detect} <args...>"""
    if len(sys.argv) > 1 and sys.argv[1] in ("flair", "flair-detect"):
        sub, rest = sys.argv[1], sys.argv[2:]
    elif sys.argv[0].endswith("flair-detect"):
        sub, rest = "flair-detect", sys.argv[1:]
    else:
        sub, rest = "flair", sys.argv[1:]
    (detect_main if sub == "flair-detect" else flair_main)(rest)


if __name__ == "__main__":
    _module_main()
