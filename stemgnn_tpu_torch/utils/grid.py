"""Hyperparameter grids and config merges (counterpart of
``stemgnn_tpu/utils/grid.py``; reference STEM-GNN/dataset/gp/utils/
utils.py:224 and its ``combine_dict`` / ``merge_mod``)."""

from __future__ import annotations

import ast
import itertools
from typing import Dict, Iterator, List


def grid_search(space: Dict[str, list]) -> Iterator[dict]:
    """Every combination of the value lists in ``space``, the last key
    varying fastest."""
    keys = list(space.keys())
    for combo in itertools.product(*(space[k] for k in keys)):
        yield dict(zip(keys, combo))


def combine_dict(*dicts: dict) -> dict:
    """One dict of ``dicts``, later ones overriding earlier ones; None or
    empty ones skipped."""
    out: dict = {}
    for d in dicts:
        if d:
            out.update(d)
    return out


def merge_mod(params: dict, mods: List[str]) -> dict:
    """``params`` with each ``"key=value"`` of ``mods`` applied: the value
    a Python literal where it parses as one, else the string."""
    out = dict(params)
    for mod in mods:
        k, v = mod.split("=", 1)
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out
