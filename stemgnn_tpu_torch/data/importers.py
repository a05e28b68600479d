"""Processed-dataset caches (counterpart of the npz route of
``stemgnn_tpu/data/importers.py``, :20-85).

A dataset round-trips through one ``.npz`` file keyed by (name, text
encoder, feature width): ``<root>/<name>__<encoder>__<dim>.npz`` with the
feature tables, the id arrays, the labels, each split's masks as
``split<i>_{train,valid,test}`` and the JSON-serialisable ``extras``.  The
default root is the repository's ``data_cache/``, which ships the two
knowledge graphs (``WN18RR`` and ``FB15K237``, hash and tfidf features at
768 dims).  Files written by either package load in both.  The PyG-cache
importers and the memory-mapped ``.st`` cache are not ported (ROADMAP
Queue 1 item 8, second half).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional

import numpy as np

from stemgnn_tpu_torch.data.dataset import TAGDataset

DEFAULT_CACHE_ROOT = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "data_cache")


def cache_path(name: str, encoder: str, dim: int,
               root: Optional[str] = None) -> str:
    root = root or DEFAULT_CACHE_ROOT
    return osp.join(root, f"{name}__{encoder}__{dim}.npz")


def save_dataset_cache(ds: TAGDataset, encoder: str = "hash",
                       root: Optional[str] = None) -> str:
    path = cache_path(ds.name, encoder, ds.node_text_feat.shape[1], root)
    os.makedirs(osp.dirname(path), exist_ok=True)
    payload = {
        "node_text_feat": ds.node_text_feat,
        "edge_text_feat": ds.edge_text_feat,
        "x": ds.x, "xe": ds.xe, "edge_index": ds.edge_index,
        "num_classes": np.asarray(ds.num_classes),
        "num_tasks": np.asarray(ds.num_tasks),
    }
    if ds.labels is not None:
        payload["labels"] = np.asarray(ds.labels)
    if ds.class_node_text_feat is not None:
        payload["class_node_text_feat"] = ds.class_node_text_feat
    if ds.splits:
        for i, split in enumerate(ds.splits):
            for k, v in split.items():
                payload[f"split{i}_{k}"] = v
        payload["num_splits"] = np.asarray(len(ds.splits))
    if ds.extras:
        try:
            payload["extras_json"] = np.asarray(json.dumps(ds.extras))
        except TypeError:
            pass            # extras that JSON cannot hold are not cached
    np.savez_compressed(path + ".tmp.npz", **payload)
    os.replace(path + ".tmp.npz", path)
    return path


def load_dataset_cache(name: str, encoder: str = "hash", dim: int = 768,
                       root: Optional[str] = None) -> Optional[TAGDataset]:
    """The cached dataset, or None when its file is missing."""
    path = cache_path(name, encoder, dim, root)
    if not osp.exists(path):
        return None
    z = np.load(path)
    splits = None
    if "num_splits" in z:
        splits = [{k: z[f"split{i}_{k}"] for k in ("train", "valid", "test")}
                  for i in range(int(z["num_splits"]))]
    return TAGDataset(
        name=name,
        node_text_feat=z["node_text_feat"],
        edge_text_feat=z["edge_text_feat"],
        x=z["x"], xe=z["xe"], edge_index=z["edge_index"],
        labels=z["labels"] if "labels" in z else None,
        splits=splits,
        class_node_text_feat=(z["class_node_text_feat"]
                              if "class_node_text_feat" in z else None),
        num_classes=int(z["num_classes"]), num_tasks=int(z["num_tasks"]),
        extras=(json.loads(str(z["extras_json"]))
                if "extras_json" in z else {}))
