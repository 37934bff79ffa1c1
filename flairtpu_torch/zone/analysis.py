"""Compare-sweep metrics analysis (counterpart of
``flairtpu/zone/analysis.py``; reference test/metrics.py:446-499).

Loads the per-patch / per-method metrics JSON of a compare run, flattens
it to parameter columns, averages a metric by a sweep parameter and draws
the metric-against-parameter curve (matplotlib, imported where it draws).
"""

from __future__ import annotations

import json
import re
from pathlib import Path


def load_metrics_json(json_path: str | Path):
    with open(json_path) as f:
        return json.load(f)


def flatten_metrics(metrics) -> list[dict]:
    """Per-patch records ({key: {...}} dicts or a list of them) -> flat rows:
    the method-string key, the per-class lists, and the named average
    metrics as columns (mIoU, Overall Accuracy, ...)."""
    if isinstance(metrics, dict):
        metrics = [metrics]
    rows = []
    for record in metrics:
        for key, value in record.items():
            row = {"key": key}
            names = value.get("Avg_metrics_name", [])
            avgs = value.get("Avg_metrics", [])
            row.update(dict(zip(names, avgs)))
            row.update({k: v for k, v in value.items()
                        if k not in ("Avg_metrics_name", "Avg_metrics")})
            rows.append(row)
    return rows


def analyze_param(rows: list[dict], param: str, metric: str) -> list[tuple[float, float]]:
    """Mean of ``metric`` grouped by the ``param=<number>`` value in the key."""
    pattern = re.compile(rf"{re.escape(param)}=(\d+(?:\.\d+)?)")
    groups: dict[float, list[float]] = {}
    for row in rows:
        m = pattern.search(str(row.get("key", "")))
        if m is None or metric not in row:
            continue
        groups.setdefault(float(m.group(1)), []).append(float(row[metric]))
    return sorted((value, sum(vs) / len(vs)) for value, vs in groups.items())


def plot_metrics(points: list[tuple[float, float]], param: str, metric: str,
                 out_png: str | Path | None = None) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xs, ys = zip(*points) if points else ((), ())
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.plot(xs, ys, marker="o")
    ax.set_xlabel(param)
    ax.set_ylabel(metric)
    ax.set_title(f"{metric} vs {param}")
    ax.grid(True)
    out = Path(out_png or f"{param}_{metric}.png")
    fig.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(fig)
    print(f"Plot saved to {out}")
    return out
