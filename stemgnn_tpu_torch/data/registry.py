"""Dataset registry: name -> loader (counterpart of
``stemgnn_tpu/data/registry.py``).

Covers the synthetic datasets that need no downloaded files: the node
datasets ``cora_synthetic``, ``arxiv_synthetic``, ``arxiv_synthetic_pl``
(the power-law arxiv-scale graph: 169,343 nodes, preferential-attachment
skew) and ``arxiv_synthetic_fragile`` (the arxiv-scale graph whose labels
the robustness evaluations can perturb: class signal in 16 feature dims,
half the nodes signal-free), and the link dataset ``kg_synthetic`` (a
knowledge graph with 11 relation types; ``num_entities``/``num_edges``
size it), and the link datasets ``WN18RR`` and ``FB15K237`` from the
repository's processed caches (``data/kg.py``; ``text_encoder`` picks the
cache, ``hash`` or ``tfidf``).  Every other name of the JAX registry raises
``NotImplementedError`` until its loader is ported.
"""

from __future__ import annotations

from typing import Dict

from stemgnn_tpu_torch.data import synthetic
from stemgnn_tpu_torch.data.kg import KG_DATASETS, load_kg_dataset

dataset2task: Dict[str, str] = {
    "cora": "node", "pubmed": "node", "arxiv": "node", "wikics": "node",
    "cora_synthetic": "node", "arxiv_synthetic": "node",
    "arxiv_synthetic_fragile": "node", "arxiv_synthetic_pl": "node",
    "WN18RR": "link", "FB15K237": "link", "kg_synthetic": "link",
    "chemhiv": "graph", "chempcba": "graph", "chemblpre": "graph",
    "mol_synthetic": "graph",
}


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
    if name in KG_DATASETS:
        return load_kg_dataset(name, text_encoder=text_encoder,
                               feat_dim=feat_dim, **kw)
    if name in dataset2task:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to stemgnn_tpu_torch yet; the "
            f"port loads cora_synthetic, arxiv_synthetic, "
            f"arxiv_synthetic_pl, arxiv_synthetic_fragile, kg_synthetic, "
            f"WN18RR and FB15K237")
    raise KeyError(f"Unknown dataset {name}")
