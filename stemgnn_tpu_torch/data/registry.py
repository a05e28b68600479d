"""Dataset registry: name -> loader (counterpart of
``stemgnn_tpu/data/registry.py``).

The generated datasets: the node datasets ``cora_synthetic``,
``arxiv_synthetic``, ``arxiv_synthetic_pl`` (the power-law arxiv-scale
graph: 169,343 nodes, preferential-attachment skew) and
``arxiv_synthetic_fragile`` (the arxiv-scale graph whose labels the
robustness evaluations can perturb: class signal in 16 feature dims, half
the nodes signal-free); the link dataset ``kg_synthetic`` (a knowledge
graph with 11 relation types; ``num_entities``/``num_edges`` size it); the
graph dataset ``mol_synthetic``.  The datasets of files: ``cora``,
``pubmed``, ``arxiv`` and ``wikics`` from their processed cache, else
their raw files (``data/raw_parsers.py``, then cached); ``WN18RR`` and
``FB15K237`` likewise (``data/kg.py``; the repository ships their caches
at 768 dims, hash and tfidf); ``smiles:<csv>`` (molecules featurized by
``data/chem.py``).  ``text_encoder`` picks the features (and the cache);
``device`` is where a neural text encoder runs (default: the card).
Loaders return :class:`TAGDataset` for node and link tasks and
``(graphs, labels, split)`` for graph tasks.  The downloaded chem datasets
raise ``FileNotFoundError`` as in JAX.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict

import numpy as np

from stemgnn_tpu_torch.data import importers, synthetic
from stemgnn_tpu_torch.data import raw_parsers as rp
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
                 text_encoder: str = "hash", device=None, **kw):
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
        return load_kg_dataset(name, root=kw.pop("root", None),
                               text_encoder=text_encoder, feat_dim=feat_dim,
                               device=device, **kw)
    if name.startswith("smiles:"):
        # bring-your-own molecules: "smiles:/path/to/file.csv" with columns
        # smiles,split,<task columns...> (empty cells = NaN labels)
        return load_smiles_csv(name[len("smiles:"):], feat_dim=feat_dim,
                               text_encoder=text_encoder, device=device,
                               **kw)
    if name in ("cora", "pubmed", "arxiv", "wikics"):
        return load_single_graph(name, feat_dim, seed, text_encoder, device,
                                 **kw)
    if name in ("chemhiv", "chempcba", "chemblpre"):
        raise FileNotFoundError(
            f"Dataset '{name}' requires downloaded raw data which is not "
            f"available offline; use 'mol_synthetic', a processed cache "
            f"(stemgnn_tpu/data/importers.py), or a local "
            f"'smiles:<csv>' file (data/chem.py featurizes without RDKit)")
    raise KeyError(f"Unknown dataset {name}")


def load_single_graph(name: str, feat_dim: int = 768, seed: int = 0,
                      text_encoder: str = "hash", device=None, **kw):
    """cora / pubmed / arxiv / wikics: the processed npz cache, else the
    raw file tree (``root=``, default under the cache root; the dataset
    is then cached), else ``FileNotFoundError`` with guidance.  The cache
    key has no seed, so a hit draws cora's and pubmed's seeded splits
    again for a nonzero ``seed``."""
    cached = importers.load_dataset_cache(name, text_encoder, feat_dim)
    if cached is not None:
        if name in ("cora", "pubmed") and seed:
            tr_n, va_n = (140, 500) if name == "cora" else (60, 500)
            n_splits = len(cached.splits) if cached.splits else 10
            cached = dataclasses.replace(
                cached, splits=rp._cite_splits(cached.num_nodes, tr_n, va_n,
                                               n_splits, seed=seed))
        return cached
    root = kw.pop("root", None)
    try:
        if name in ("cora", "pubmed"):
            ds = rp.load_citation_raw(name, root=root,
                                      text_encoder=text_encoder,
                                      feat_dim=feat_dim, seed=seed,
                                      device=device, **kw)
        elif name == "arxiv":
            ds = rp.load_arxiv_raw(root=root, text_encoder=text_encoder,
                                   feat_dim=feat_dim, device=device, **kw)
        else:
            ds = rp.load_wikics_raw(root=root, text_encoder=text_encoder,
                                    feat_dim=feat_dim, device=device, **kw)
    except FileNotFoundError as ex:
        raise FileNotFoundError(
            f"Dataset '{name}': no processed cache and the raw file "
            f"tree is incomplete ({ex}).  Supply the raw files "
            f"(data/raw_parsers.py documents the formats: cora.pt/"
            f"pubmed.pt + categories.csv, the OGB csv.gz tree + "
            f"titleabs.tsv, or wikics data.json + metadata.json), "
            f"import a reference PyG cache (data/importers.py), or use "
            f"'{name}_synthetic'") from ex
    importers.save_dataset_cache(ds, text_encoder)
    return ds


def check_feature_width(ds, input_dim: int, text_encoder: str):
    """Raise when the node features of ``ds`` (a TAGDataset's text table,
    or a graph bundle's shared table or first graph's features) are not
    ``input_dim`` wide.  A neural text encoder gives its model's width
    whatever ``--feat_dim`` says (e5 1,024, llama2 4,096 / 5,120); JAX
    fails then at the encoder's first product, the port here, with the
    width to pass."""
    if isinstance(ds, tuple):
        table = getattr(ds[0], "node_table", None)
        width = int((table if table is not None
                     else np.asarray(ds[0][0]["node_feat"])).shape[1])
    else:
        width = int(ds.node_text_feat.shape[1])
    if width != input_dim:
        raise ValueError(
            f"the {text_encoder!r} features are {width} wide but the "
            f"encoder's input is {input_dim} (--feat_dim); pass --feat_dim "
            f"{width}")


def load_smiles_csv(path: str, feat_dim: int = 768,
                    text_encoder: str = "hash", device=None):
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
    enc = get_text_encoder(text_encoder, dim=feat_dim, device=device)
    return mol_dataset_from_smiles(smiles, np.asarray(labels, float), splits,
                                   encoder=enc, dim=feat_dim, indexed=True)
