"""Dataset registry: name -> loader (counterpart of
``stemgnn_tpu/data/registry.py``).

Covers the datasets that need no downloaded files: the node datasets
``cora_synthetic``, ``arxiv_synthetic``, ``arxiv_synthetic_pl`` (the
power-law arxiv-scale graph: 169,343 nodes, preferential-attachment skew)
and ``arxiv_synthetic_fragile`` (the arxiv-scale graph whose labels the
robustness evaluations can perturb: class signal in 16 feature dims, half
the nodes signal-free); the link datasets ``kg_synthetic`` (a knowledge
graph with 11 relation types; ``num_entities``/``num_edges`` size it) and
``WN18RR`` and ``FB15K237`` from the repository's processed caches
(``data/kg.py``; ``text_encoder`` picks the cache, ``hash`` or ``tfidf``);
and the graph datasets ``mol_synthetic`` and ``smiles:<csv>`` (molecules
featurized by ``data/chem.py``).  Loaders return :class:`TAGDataset` for
node and link tasks and ``(graphs, labels, split)`` for graph tasks.  The
downloaded chem datasets raise ``FileNotFoundError`` as in JAX; every
other name of the JAX registry raises ``NotImplementedError`` until its
loader is ported.
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np

from stemgnn_tpu_torch.data import synthetic
from stemgnn_tpu_torch.data.chem import mol_dataset_from_smiles
from stemgnn_tpu_torch.data.kg import KG_DATASETS, load_kg_dataset
from stemgnn_tpu_torch.data.text_encoder import get_text_encoder


class _Dataset2Task(dict):
    """dict with the 'smiles:<csv>' prefix mapped to the graph task."""

    def __missing__(self, key):
        if isinstance(key, str) and key.startswith("smiles:"):
            return "graph"
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


dataset2task: Dict[str, str] = _Dataset2Task({
    "cora": "node", "pubmed": "node", "arxiv": "node", "wikics": "node",
    "cora_synthetic": "node", "arxiv_synthetic": "node",
    "arxiv_synthetic_fragile": "node", "arxiv_synthetic_pl": "node",
    "WN18RR": "link", "FB15K237": "link", "kg_synthetic": "link",
    "chemhiv": "graph", "chempcba": "graph", "chemblpre": "graph",
    "mol_synthetic": "graph",
})


def load_dataset(name: str, feat_dim: int = 768, seed: int = 0,
                 text_encoder: str = "hash", **kw):
    if name == "cora_synthetic":
        return synthetic.synthetic_node_dataset(
            name=name, feat_dim=feat_dim, seed=seed, **kw)
    if name == "arxiv_synthetic":
        return synthetic.synthetic_node_dataset(
            name=name, num_nodes=kw.pop("num_nodes", 169_343),
            num_classes=kw.pop("num_classes", 40), feat_dim=feat_dim,
            avg_degree=kw.pop("avg_degree", 14), num_splits=1, seed=seed, **kw)
    if name == "arxiv_synthetic_pl":
        # power-law variant: preferential-attachment skew so the degree
        # distribution — and with it the hub-dense aggregation path —
        # matches real citation graphs (ogbn-arxiv is power-law)
        return synthetic.synthetic_node_dataset(
            name=name, num_nodes=kw.pop("num_nodes", 169_343),
            num_classes=kw.pop("num_classes", 40), feat_dim=feat_dim,
            avg_degree=kw.pop("avg_degree", 14), num_splits=1,
            pref_attach=kw.pop("pref_attach", 1.1), seed=seed, **kw)
    if name == "arxiv_synthetic_fragile":
        # perturbation-sensitive variant: a sparse signal subspace and half
        # the nodes signal-free (their class is recoverable only through
        # neighbours), so missing-feature and edge-drop sweeps degrade by
        # degrees instead of reading ~100 everywhere
        return synthetic.synthetic_node_dataset(
            name=name, num_nodes=kw.pop("num_nodes", 169_343),
            num_classes=kw.pop("num_classes", 40), feat_dim=feat_dim,
            avg_degree=kw.pop("avg_degree", 14), num_splits=1,
            signal_dims=kw.pop("signal_dims", 16),
            structure_frac=kw.pop("structure_frac", 0.5),
            train_per_split=kw.pop("train_per_split", 8_000),
            val_per_split=kw.pop("val_per_split", 4_000),
            seed=seed, **kw)
    if name == "kg_synthetic":
        return synthetic.synthetic_link_dataset(name=name, feat_dim=feat_dim,
                                                seed=seed, **kw)
    if name == "mol_synthetic":
        return synthetic.synthetic_graph_dataset(name=name, feat_dim=feat_dim,
                                                 seed=seed, **kw)
    if name in KG_DATASETS:
        return load_kg_dataset(name, text_encoder=text_encoder,
                               feat_dim=feat_dim, **kw)
    if name.startswith("smiles:"):
        # bring-your-own molecules: "smiles:/path/to/file.csv" with columns
        # smiles,split,<task columns...> (empty cells = NaN labels)
        return load_smiles_csv(name[len("smiles:"):], feat_dim=feat_dim,
                               text_encoder=text_encoder, **kw)
    if name in ("chemhiv", "chempcba", "chemblpre"):
        raise FileNotFoundError(
            f"Dataset '{name}' requires downloaded raw data which is not "
            f"available offline; use 'mol_synthetic', a processed cache "
            f"(stemgnn_tpu/data/importers.py), or a local "
            f"'smiles:<csv>' file (data/chem.py featurizes without RDKit)")
    if name in dataset2task:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to stemgnn_tpu_torch yet; the "
            f"port loads cora_synthetic, arxiv_synthetic, "
            f"arxiv_synthetic_pl, arxiv_synthetic_fragile, kg_synthetic, "
            f"WN18RR, FB15K237, mol_synthetic and smiles:<csv>")
    raise KeyError(f"Unknown dataset {name}")


def load_smiles_csv(path: str, feat_dim: int = 768,
                    text_encoder: str = "hash"):
    """CSV -> the indexed graph-task bundle through the RDKit-free
    featurizer (JAX ``load_smiles_csv``).  Expected header:
    ``smiles,split,<task1>[,<task2>...]``; split in train/valid/test; label
    cells 0/1 or empty (NaN)."""
    smiles, splits, labels = [], [], []
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        if header[:2] != ["smiles", "split"]:
            raise ValueError(
                f"{path}: header must start with 'smiles,split', got "
                f"{header[:2]}")
        for row in reader:
            if not row:
                continue
            smiles.append(row[0])
            splits.append(row[1])
            labels.append([float(v) if v.strip() != "" else np.nan
                           for v in row[2:]])
    enc = get_text_encoder(text_encoder, dim=feat_dim)
    return mol_dataset_from_smiles(smiles, np.asarray(labels, float), splits,
                                   encoder=enc, dim=feat_dim, indexed=True)
