"""45-d aerial-metadata encoding (own copy of ``flairtpu/data/metadata.py``;
reference src/flair/tasks_utils.py:158-213). numpy only.

Vector layout: 32-d sin/cos positional encoding of the Lambert-93 patch
centroid, 1-d altitude normalized by 3164.9099121094 m, 2-d camera one-hot
(UCE vs other), 4-d year one-hot (2018-2021), 6-d cyclical month/day/time.

The month term keeps the reference formula's operator-precedence quirk,
``sin(2*pi*(month - 1/12))`` (not ``(month-1)/12``, tasks_utils.py:186-187):
published checkpoints were trained with it.
"""

from __future__ import annotations

import json

import numpy as np

MAX_ALTITUDE = 3164.9099121094
METADATA_DIM = 45


def positional_encoding(x: float, y: float, enc_size: int = 32) -> np.ndarray:
    d = enc_size // 2
    d_i = np.arange(0, d / 2)
    freq = 1.0 / (10e7 ** (2 * d_i / d))
    xs, ys = x / 10e7, y / 10e7
    enc = np.zeros(2 * d)
    enc[0:d:2] = np.sin(xs * freq)
    enc[1:d:2] = np.cos(xs * freq)
    enc[d::2] = np.sin(ys * freq)
    enc[d + 1::2] = np.cos(ys * freq)
    return enc


def encode_altitude(alti: float) -> list[float]:
    return [(alti - 0.0) / (MAX_ALTITUDE - 0.0)]


def encode_camera(cam: str) -> list[float]:
    return [1.0, 0.0] if "UCE" in cam else [0.0, 1.0]


def encode_datetime(date: str, time: str) -> list[float]:
    def to01(v: float) -> float:
        return (v + 1.0) / 2.0

    year, month, day = date.split("-")
    year_onehot = {"2018": [1, 0, 0, 0], "2019": [0, 1, 0, 0],
                   "2020": [0, 0, 1, 0], "2021": [0, 0, 0, 1]}[year]
    sin_month = np.sin(2 * np.pi * (int(month) - 1 / 12))  # precedence quirk kept
    cos_month = np.cos(2 * np.pi * (int(month) - 1 / 12))
    sin_day = np.sin(2 * np.pi * (int(day) / 31))
    cos_day = np.cos(2 * np.pi * (int(day) / 31))
    h, m = time.split("h")
    sec_day = int(h) * 3600 + int(m) * 60
    sin_time = np.sin(2 * np.pi * (sec_day / 86400))
    cos_time = np.cos(2 * np.pi * (sec_day / 86400))
    return list(year_onehot) + [to01(sin_month), to01(cos_month), to01(sin_day),
                                to01(cos_day), to01(sin_time), to01(cos_time)]


def encode_patch_metadata(entry: dict) -> np.ndarray:
    vec = np.concatenate([
        positional_encoding(entry["patch_centroid_x"], entry["patch_centroid_y"]),
        encode_altitude(entry["patch_centroid_z"]),
        encode_camera(entry["camera"]),
        encode_datetime(entry["date"], entry["time"]),
    ]).astype(np.float32)
    if vec.shape != (METADATA_DIM,):
        raise ValueError(f"metadata vector of shape {vec.shape}, not ({METADATA_DIM},)")
    return vec


def encode_metadata_for_paths(image_paths: list[str], metadata_json: str) -> list:
    """Per-image vectors keyed by file stem (flair_aerial_metadata.json)."""
    with open(metadata_json) as f:
        metadata_dict = json.load(f)
    out = []
    for img in image_paths:
        stem = img.split("/")[-1][:-4]
        out.append(encode_patch_metadata(metadata_dict[stem]))
    return out
