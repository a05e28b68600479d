"""Checkpoints as ``.npz`` files of flattened key paths (counterpart of
``stemgnn_tpu/utils/checkpoint.py``, same on-disk format).

A nested tree of dicts / lists / arrays flattens to keys like
``params/layers/#0/lin_l/w``: ``#i`` marks a list index and a ``!none``
suffix a ``None`` leaf.  Files written by either package load in both.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np


def _to_numpy(leaf):
    if hasattr(leaf, "detach"):          # torch.Tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}/"))
    elif tree is None:
        out[prefix[:-1] + "!none"] = np.zeros(0)
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def save_pytree(path: str, tree: Any, meta: Optional[dict] = None):
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"          # np.savez appends .npz only if absent
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)


def load_pytree(path: str):
    """Rebuild the nested structure (numpy leaves) from flattened keys."""
    data = np.load(path)
    root: dict = {}
    for key in data.files:
        is_none = key.endswith("!none")
        k = key[:-5] if is_none else key
        parts = k.split("/")
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = None if is_none else data[key]
    return _listify(root)


def _listify(node):
    """Convert {#0: .., #1: ..} dicts back into lists (present children in
    index order)."""
    if not isinstance(node, dict):
        return node
    keys = list(node.keys())
    if keys and all(re.fullmatch(r"#\d+", k) for k in keys):
        return [_listify(node[k])
                for k in sorted(keys, key=lambda s: int(s[1:]))]
    return {k: _listify(v) for k, v in node.items()}


def load_meta(path: str) -> Optional[dict]:
    try:
        with open(path + ".meta.json") as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def latest_checkpoint(ckpt_dir: str, prefix: str) -> Optional[str]:
    """The highest-epoch ``{prefix}_{i}.npz`` in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_i = None, -1
    pat = re.compile(re.escape(prefix) + r"_(\d+)\.npz$")
    for f in os.listdir(ckpt_dir):
        m = pat.match(f)
        if m and int(m.group(1)) > best_i:
            best_i = int(m.group(1))
            best = os.path.join(ckpt_dir, f)
    return best
