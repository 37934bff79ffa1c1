"""Method-string and filename conventions (own copy of
``flairtpu/zone/naming.py``; reference zone_detect/utils.py:170-217).

Method strings: ``size=..._stride=..._margin=..._padding=..._stitching=...``;
prediction filenames: ``<dpt>_<zone>_<type>-ARGMAX-S_<method>.tif``.
"""

from __future__ import annotations

from pathlib import Path


def method_string(size: int, stride: int, margin: int, padding: str,
                  stitching: str) -> str:
    return (f"size={size}_stride={stride}_margin={margin}"
            f"_padding={padding}_stitching={stitching}")


def extract_method(method: str, info: dict | None = None) -> dict:
    info = dict(info or {})
    for param in method.split("_"):
        if "=" not in param:
            continue
        key, value = param.split("=", 1)
        if key == "size":
            info["patch_size"] = int(value)
        elif key in ("stride", "margin"):
            info[key] = int(value)
        else:
            info[key] = value
    return info


def info_extract(file: str | Path) -> dict:
    filename = str(file)
    if not filename.endswith(".tif"):
        raise ValueError("Filename should end with .tif what are you doing ?")
    name = filename.split("/")[-1].split(".")[0]
    info: dict = {}
    region_type, method = name.split("-ARGMAX-S_")
    parts = region_type.split("_")
    dpt, zone = parts[:2], parts[2:-1]
    if not dpt[0].startswith("D"):
        info["dpt"] = "D" + "_".join(dpt)
    else:
        info["dpt"] = "_".join(dpt)
    info["zone"] = "_".join(zone)
    info["method"] = method
    return extract_method(method, info)
