"""Task/dataset registry + splitters (counterpart of
``stemgnn_tpu/ofa/tasks.py``).

Re-design of ``task_constructor.py`` (reference
STEM-GNN/dataset/task_constructor.py): per-dataset split functions and a
``TaskConstructor`` that caches datasets/splits and assembles OFA runtime
datasets for pretraining/eval.

Splitters (operating on :class:`TAGDataset`):
  * arxiv_splitter     — stratified 10-fold, fold 0 as train/test/val
                         rotation
                         (:30-38 via k_fold_ind/k_fold2_split),
  * cite_splitter      — the dataset's first stored mask split (:58-63),
  * cite_link_splitter — random edge split 85/5/10 (:79-87),
  * kg_splitter        — triples by file order (train|valid|test ranges,
                         :90-97),
  * wiki_splitter      — stored split column 0 (:137-143),
  * mol_splitter       — the dataset's published split (:146-147),
  * few-shot variants  — per-class index pools for episode sampling
                         (:41-134) given a class split.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from stemgnn_tpu_torch.data.dataset import TAGDataset
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.utils.splits import k_fold2_split, k_fold_ind


def arxiv_splitter(ds: TAGDataset, seed: int = 10):
    folds = k_fold_ind(np.asarray(ds.labels), 10, seed=seed)
    train, test, valid = k_fold2_split(folds, ds.num_nodes)[0]
    return {"train": train, "valid": valid, "test": test}


def cite_splitter(ds: TAGDataset):
    split = ds.splits[0]
    return {k: np.nonzero(np.asarray(v))[0] for k, v in split.items()}


def cite_link_splitter(ds: TAGDataset, seed: int = 0):
    e = ds.num_edges
    perm = np.random.default_rng(seed).permutation(e)
    tr, va = int(e * 0.85), int(e * 0.9)
    return {"train": perm[:tr], "valid": perm[tr:va], "test": perm[va:]}


def kg_splitter(ds: TAGDataset):
    counts = ds.extras.get("split_counts")
    if counts is None:  # fall back to the stored boolean masks
        return cite_splitter(ds)
    offs = np.cumsum([0] + list(counts))
    return {name: np.arange(offs[i], offs[i + 1])
            for i, name in enumerate(["train", "valid", "test"])}


def wiki_splitter(ds: TAGDataset):
    return cite_splitter(ds)


def mol_splitter(split):
    return {k: np.nonzero(np.asarray(v))[0] for k, v in split.items()}


def low_resource_class_split(name: str, path=None) -> Dict[str, list]:
    """Low-resource class split for few-shot tasks.

    Reference semantics (task_constructor.py:41-47,101-115): a JSON file maps
    dataset name -> [train_classes, valid_classes, test_classes]; episodes
    for a split only sample its classes.  The split shipped with the
    reference (data/low_resource_split.json) is vendored at
    configs/low_resource_split.json.
    """
    import json
    import os
    if path is None:
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "configs", "low_resource_split.json")
    with open(path) as f:
        table = json.load(f)
    if name not in table:
        raise KeyError(f"{name!r} has no low-resource split; "
                       f"available: {sorted(table)}")
    tr, va, te = table[name]
    return {"train": tr, "valid": va, "test": te}


def fs_splitter(ds: TAGDataset, class_split: Dict[str, list] = None):
    """Few-shot splitter: per-class index pools per split.

    With ``class_split`` (e.g. from :func:`low_resource_class_split`) this is
    the ArxivFSSplitter/KGFSTrainSplitter analog (:41-52,101-115) — each
    split owns disjoint classes.  Without it, every split sees all classes
    over all items (CiteFSSplitter, :66-77).
    """
    labels = np.asarray(ds.labels).reshape(-1)
    if class_split is None:
        all_cls = list(range(int(labels.max()) + 1))
        class_split = {k: all_cls for k in ["train", "valid", "test"]}
    return fewshot_class_pools(labels, class_split)


def kg_fs_splitter(ds: TAGDataset):
    """KGFSSplitter analog (:117-135): per-split pools over all relation
    classes, indices restricted to the split's triple range."""
    labels = np.asarray(ds.labels).reshape(-1)
    n_cls = int(labels.max()) + 1
    ranges = kg_splitter(ds)
    out = {}
    for name, idx in ranges.items():
        idx = np.asarray(idx)
        pools = [idx[labels[idx] == c] for c in range(n_cls)]
        out[name] = (np.arange(n_cls), pools)
    return out


def fewshot_class_pools(labels: np.ndarray, class_split: Dict[str, list]):
    """Per-class data-index pools for episode sampling (the FS splitters,
    :41-52,116-134): ``class_split`` maps train/valid/test to class-id lists.
    Returns {split: (class_ids, [indices per class])}."""
    labels = np.asarray(labels)
    out = {}
    for name, classes in class_split.items():
        cls = np.asarray(classes)
        pools = [np.nonzero(labels == c)[0] for c in cls]
        out[name] = (cls, pools)
    return out


SPLITTERS: Dict[str, Callable] = {
    "arxiv": arxiv_splitter, "arxiv_synthetic": arxiv_splitter,
    "cora": cite_splitter, "pubmed": cite_splitter,
    "cora_synthetic": cite_splitter,
    "wikics": wiki_splitter,
    "WN18RR": kg_splitter, "FB15K237": kg_splitter,
    "kg_synthetic": kg_splitter,
}


class TaskConstructor:
    """Caches datasets and their splits; builds OFA runtime datasets
    (UnifiedTaskConstructor analog, task_constructor.py:359-493) over the
    port's ``data.registry.load_dataset``.  ``load_kw`` maps a dataset name
    to further keywords of its load (a generator's size, say)."""

    def __init__(self, feat_dim: int = 768, text_encoder: str = "hash",
                 seed: int = 0, load_kw: Dict[str, dict] = None):
        self.feat_dim = feat_dim
        self.text_encoder = text_encoder
        self.seed = seed
        self.load_kw = load_kw or {}
        self._datasets: Dict[str, TAGDataset] = {}
        self._splits: Dict[str, dict] = {}

    def get_dataset(self, name: str) -> TAGDataset:
        if name not in self._datasets:
            self._datasets[name] = load_dataset(
                name, feat_dim=self.feat_dim, seed=self.seed,
                text_encoder=self.text_encoder,
                **self.load_kw.get(name, {}))
        return self._datasets[name]

    def get_split(self, name: str) -> dict:
        if name not in self._splits:
            splitter = SPLITTERS.get(name, cite_splitter)
            self._splits[name] = splitter(self.get_dataset(name))
        return self._splits[name]

    def make_subgraph_dataset(self, name: str, split: str = "train",
                              hop: int = 2, **kw):
        """Node-task OFA runtime dataset over the given split's node ids."""
        from stemgnn_tpu_torch.ofa.datasets import SubgraphNodeDataset
        ds = self.get_dataset(name)
        idx = self.get_split(name)[split]
        return SubgraphNodeDataset(ds, *_prompt_tables(ds), idx, hop=hop,
                                   seed=self.seed, **kw)

    def make_link_dataset(self, name: str, split: str = "train",
                          hop: int = 2, **kw):
        from stemgnn_tpu_torch.ofa.datasets import SubgraphKGHierDataset
        ds = self.get_dataset(name)
        idx = self.get_split(name)[split]
        pairs = np.asarray(ds.edge_index).T[idx]
        types = np.asarray(ds.labels)[idx]
        return SubgraphKGHierDataset(ds, *_prompt_tables(ds), pairs, types,
                                     hop=hop, seed=self.seed, **kw)


def _prompt_tables(ds: TAGDataset):
    """(class node features, prompt-edge features): the dataset's class
    texts, else one-hot rows; five all-ones prompt-edge rows."""
    d = ds.node_text_feat.shape[1]
    class_emb = ds.class_node_text_feat \
        if ds.class_node_text_feat is not None \
        else np.eye(ds.num_classes, d, dtype=np.float32)
    return class_emb, np.ones((5, d), np.float32)
