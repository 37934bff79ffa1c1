"""Console entry (counterpart of ``flairtpu/cli.py:32-158``).

``python -m flairtpu_torch.cli flair --conf=<yaml>`` reads the same YAML as
``python -m flairtpu.cli flair`` and runs its stages train -> predict
(``predictions_<name>/PRED_*.tif``) -> metrics (``metrics/``) per the task
flags, into ``out_folder/out_model_name`` with ``flair-compute.log`` and
``used_csv_and_config/``; ``accelerator: cpu`` runs it on the CPU, any
other value on the CUDA card.

``python -m flairtpu_torch.cli flair-detect --conf=<yaml> [-c] [-m] [-b]``
reads the same YAML as ``python -m flairtpu.cli flair-detect`` and writes
the same LZW GeoTIFFs (2 bands for argmax, K for class_prob); ``-c`` runs
the compare sweep, ``-m`` adds its metrics, and ``-b`` runs every zone of a
department (``input_path``) with one model and writes the per-method
metrics JSON.
"""

from __future__ import annotations

import argparse
import datetime
import shutil
import sys
from pathlib import Path

from flairtpu_torch import config as cfgmod
from flairtpu_torch.utils.logger import tee_stdout, untee_stdout
from flairtpu_torch.utils.recap import print_recap
from flairtpu_torch.zone.batch import batch_metrics_pipeline
from flairtpu_torch.zone.engine import run_pipeline


def flair_main(argv=None) -> dict:
    """The ``flair`` pipeline; returns what each stage ran ({'train':
    fit's info, 'predict': the predict stage's, 'metrics': the metrics
    JSON}), each present where its task ran."""
    parser = argparse.ArgumentParser(prog="flair")
    parser.add_argument("--conf", help="Path to the .yaml config file", required=True)
    args = parser.parse_args(argv)

    config = cfgmod.validate_train_config(cfgmod.read_config(args.conf))
    from flairtpu_torch.train.loop import resolve_device

    resolve_device(config)  # raises before any output without the card it names
    out_dir = Path(config["paths"]["out_folder"], config["paths"]["out_model_name"])
    out_dir.mkdir(parents=True, exist_ok=True)
    tee_stdout(str(out_dir / "flair-compute.log"))
    print(datetime.datetime.now().strftime("Starting : %Y-%m-%d  %H:%M") + "\n")
    try:
        return _flair_run(config, out_dir, args.conf)
    finally:
        untee_stdout()


def _flair_run(config: dict, out_dir: Path, conf_path: str) -> dict:
    from flairtpu_torch.data.manifest import gather_paths
    from flairtpu_torch.eval.metrics import metrics
    from flairtpu_torch.predict.runner import predict
    from flairtpu_torch.train import checkpoints as ckpt_lib
    from flairtpu_torch.train.loop import SegmentationTrainer, fit

    tasks = config["tasks"]
    dict_train = dict_val = dict_test = None
    if tasks["train"]:
        dict_train = gather_paths(config, "train")
        dict_val = gather_paths(config, "val")
    if tasks["predict"]:
        dict_test = gather_paths(config, "test")
    print_recap(config, dict_train, dict_val, dict_test)

    if config.get("cp_csv_and_conf_to_output", True):
        copy_dir = out_dir / "used_csv_and_config"
        copy_dir.mkdir(parents=True, exist_ok=True)
        for key in ("train_csv", "val_csv") if tasks["train"] else ():
            shutil.copy(config["paths"][key], copy_dir)
        if tasks["predict"]:
            shutil.copy(config["paths"]["test_csv"], copy_dir)
        shutil.copy(conf_path, copy_dir)

    result: dict = {}
    trainer = None
    if tasks["train"]:
        trainer, info = fit(config, dict_train, dict_val, out_dir)
        result["train"] = info
        print(f"\n[Training finished in "
              f"{datetime.timedelta(seconds=int(info['seconds']))} HH:MM:SS]")
        print(f"Model path : {info['best_path']}\n")

    if tasks["predict"]:
        if trainer is None:
            trainer = SegmentationTrainer(config)
            ckpt_path = config["paths"].get("ckpt_model_path") or ""
            if not ckpt_path:
                raise SystemExit("predict without train requires paths.ckpt_model_path")
            ckpt_lib.init_weights_with_surgery(ckpt_path, trainer.model)
        out_dir_predict = out_dir / ("predictions_" + config["paths"]["out_model_name"])
        result["predict"] = predict(config, dict_test, out_dir_predict, trainer)

        if tasks["metrics"]:
            result["metrics"] = metrics(config, out_dir_predict,
                                        remove_preds=bool(tasks.get("delete_preds", False)))
    return result


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
