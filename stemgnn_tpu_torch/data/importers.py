"""Processed-dataset caches and the reference-cache import (counterpart
of ``stemgnn_tpu/data/importers.py``).

A dataset round-trips through one ``.npz`` file keyed by (name, text
encoder, feature width): ``<root>/<name>__<encoder>__<dim>.npz`` with the
feature tables, the id arrays, the labels, each split's masks as
``split<i>_{train,valid,test}`` and the JSON-serialisable ``extras``.  The
default root is the repository's ``data_cache/``, which ships the two
knowledge graphs (``WN18RR`` and ``FB15K237``, hash and tfidf features at
768 dims).  A huge dataset goes to an ``.st`` directory instead, its
feature tables as raw ``.npy`` files that load memory-mapped.  The
reference's own caches (torch-saved PyG ``Data``) import without PyG:
stub modules absorb the pickled classes.  Files written by either package
load in both.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
import types
from typing import Optional

import numpy as np
import torch

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


class _PygStub:
    """Shape-agnostic stand-in for any pickled torch_geometric class: state
    lands in ``__dict__`` (PyG's BaseStorage/Data pickle protocol is
    ``__getstate__ -> dict``), construction args are ignored."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def _install_pyg_stub_modules():
    """Register stub ``torch_geometric`` modules so that reference caches
    (pickled PyG ``Data`` objects) unpickle without torch_geometric: pickle
    resolves classes by (module, name), and the stubs make any class of
    the package on demand (never a dunder name, which ``inspect`` reads
    off every module).  Nothing is installed where real PyG, or either
    package's stubs, can already be imported.  Returns the names it
    registered."""
    existing = sys.modules.get("torch_geometric")
    if existing is not None and not getattr(existing, "__pyg_stub__", False):
        return []   # real torch_geometric present
    try:
        import torch_geometric  # noqa: F401  (import outside sys.modules)
        return []
    except ImportError:
        pass

    def make_mod(modname):
        m = types.ModuleType(modname)
        m.__pyg_stub__ = True

        def ga(attr, _mod=modname):
            if attr.startswith("__"):
                raise AttributeError(attr)
            cls = type(attr, (_PygStub,), {"__module__": _mod})
            setattr(m, attr, cls)
            return cls
        m.__getattr__ = ga
        return m

    added = []
    for modname in ("torch_geometric", "torch_geometric.data",
                    "torch_geometric.data.data",
                    "torch_geometric.data.storage",
                    "torch_geometric.data.in_memory_dataset"):
        if modname not in sys.modules:
            sys.modules[modname] = make_mod(modname)
            added.append(modname)
    return added


def pyg_mapping(obj):
    """The attributes of an unpickled PyG ``Data``: PyG 2.3 keeps them in
    ``obj._store._mapping`` (a GlobalStorage); plain dicts and namespaces
    pass through."""
    if isinstance(obj, dict):
        return obj
    d = getattr(obj, "__dict__", {})
    store = d.get("_store")
    if store is not None:
        sd = getattr(store, "__dict__", {})
        return sd.get("_mapping", sd)
    return d.get("_mapping", d)


def load_pyg_payload(pt_path: str):
    """``torch.load`` of a PyG pickle, its classes absorbed by the stubs
    (a full unpickle: ``weights_only=False``; read only files you trust).
    The stubs this call registered are gone again when it returns, so
    nothing later takes them for an installed PyG."""
    added = _install_pyg_stub_modules()
    try:
        return torch.load(pt_path, map_location="cpu", weights_only=False)
    finally:
        for modname in added:
            sys.modules.pop(modname, None)


def import_reference_cache(pt_path: str, name: str) -> TAGDataset:
    """A reference ``geometric_data_processed.pt`` cache (a torch-saved
    ``(Data, slices)`` from PyG's ``InMemoryDataset.collate``) as a
    :class:`TAGDataset`.  Missing ``x`` (or a feature matrix in its place)
    becomes ``arange``, missing ``xe`` zeros, missing edge texts one zero
    row."""
    payload = load_pyg_payload(pt_path)
    data = payload[0] if isinstance(payload, (tuple, list)) else payload
    mapping = pyg_mapping(data)

    def _is_tensorlike(v):
        return v is not None and (hasattr(v, "numpy") or
                                  isinstance(v, np.ndarray))

    def get(key, default=None):
        v = getattr(data, key, None) if not isinstance(data, dict) else None
        if not _is_tensorlike(v):
            v = mapping.get(key, default)
        if v is None or not _is_tensorlike(v):
            return None
        return np.asarray(v)

    node_text_feat = get("node_text_feat")
    edge_text_feat = get("edge_text_feat")
    edge_index = get("edge_index")
    if node_text_feat is None or edge_index is None:
        raise ValueError(f"{pt_path} lacks node_text_feat/edge_index")
    x = get("x")
    if x is None or x.ndim > 1:
        x = np.arange(node_text_feat.shape[0])
    xe = get("xe")
    if xe is None:
        xe = np.zeros(edge_index.shape[1], np.int64)
    labels = get("y")
    return TAGDataset(
        name=name, node_text_feat=node_text_feat.astype(np.float32),
        edge_text_feat=(edge_text_feat.astype(np.float32)
                        if edge_text_feat is not None
                        else np.zeros((1, node_text_feat.shape[1]),
                                      np.float32)),
        x=x.astype(np.int64), xe=xe.astype(np.int64),
        edge_index=edge_index.astype(np.int64), labels=labels,
        class_node_text_feat=get("class_node_text_feat"),
        num_classes=int(labels.max()) + 1 if labels is not None and
        labels.size else 0)


# -------------------------------------------------- memmap (".st") cache

def st_cache_path(name: str, encoder: str, dim: int,
                  root: Optional[str] = None) -> str:
    """The directory cache of a huge dataset (the reference's memmap
    variant, ``OFAPygSTDataset``)."""
    root = root or DEFAULT_CACHE_ROOT
    return osp.join(root, f"{name}__{encoder}__{dim}.st")


def save_dataset_cache_memmap(ds: TAGDataset, encoder: str = "hash",
                              root: Optional[str] = None) -> str:
    """The feature tables as raw ``.npy`` files (memmap-loadable), the
    rest in one small ``meta.npz``; ``extras`` are not kept."""
    base = st_cache_path(ds.name, encoder, ds.node_text_feat.shape[1], root)
    os.makedirs(base, exist_ok=True)
    big = {"node_text_feat": ds.node_text_feat,
           "edge_text_feat": ds.edge_text_feat}
    if ds.class_node_text_feat is not None:
        big["class_node_text_feat"] = ds.class_node_text_feat
    for k, v in big.items():
        np.save(osp.join(base, f"{k}.npy"), np.ascontiguousarray(v))
    meta = {"x": ds.x, "xe": ds.xe, "edge_index": ds.edge_index,
            "num_classes": np.asarray(ds.num_classes),
            "num_tasks": np.asarray(ds.num_tasks)}
    if ds.labels is not None:
        meta["labels"] = np.asarray(ds.labels)
    if ds.splits:
        for i, split in enumerate(ds.splits):
            for k, v in split.items():
                meta[f"split{i}_{k}"] = v
        meta["num_splits"] = np.asarray(len(ds.splits))
    np.savez_compressed(osp.join(base, "meta.npz"), **meta)
    return base


def load_dataset_cache_memmap(name: str, encoder: str = "hash",
                              dim: int = 768,
                              root: Optional[str] = None,
                              ) -> Optional[TAGDataset]:
    """An ``.st`` directory cache with its feature tables memory-mapped
    read-only (host memory stays O(edges), not O(nodes x dim)), or None
    when it is missing."""
    base = st_cache_path(name, encoder, dim, root)
    meta_path = osp.join(base, "meta.npz")
    if not osp.exists(meta_path):
        return None
    z = np.load(meta_path)

    def mm(k):
        return np.load(osp.join(base, f"{k}.npy"), mmap_mode="r")
    splits = None
    if "num_splits" in z:
        splits = [{k: z[f"split{i}_{k}"] for k in ("train", "valid", "test")}
                  for i in range(int(z["num_splits"]))]
    cls_path = osp.join(base, "class_node_text_feat.npy")
    return TAGDataset(
        name=name,
        node_text_feat=mm("node_text_feat"),
        edge_text_feat=mm("edge_text_feat"),
        x=z["x"], xe=z["xe"], edge_index=z["edge_index"],
        labels=z["labels"] if "labels" in z else None,
        splits=splits,
        class_node_text_feat=(mm("class_node_text_feat")
                              if osp.exists(cls_path) else None),
        num_classes=int(z["num_classes"]), num_tasks=int(z["num_tasks"]))
