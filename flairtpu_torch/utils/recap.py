"""Config recap tree (own copy of ``flairtpu/utils/recap.py``; reference
src/flair/utils.py:10-34)."""

from __future__ import annotations


def print_recap(config: dict, dict_train=None, dict_val=None, dict_test=None) -> None:
    print("\n" + "#" * 60)
    print("#" + " FLAIR-TPU run configuration ".center(58) + "#")
    print("#" * 60)

    def walk(node, indent=1):
        for k, v in node.items():
            if isinstance(v, dict):
                print("  " * indent + f"[{k}]")
                walk(v, indent + 1)
            else:
                print("  " * indent + f"- {k}: {v}")

    walk(config)
    for name, d in (("train", dict_train), ("val", dict_val), ("test", dict_test)):
        if d is not None:
            print(f"  split {name}: {len(d['IMG'])} samples")
    print("#" * 60 + "\n")
