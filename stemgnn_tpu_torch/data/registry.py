"""Dataset registry: name -> loader (counterpart of
``stemgnn_tpu/data/registry.py``).

Covers the synthetic node datasets, which need no downloaded files:
``cora_synthetic``, ``arxiv_synthetic`` and ``arxiv_synthetic_pl`` (the
power-law arxiv-scale graph: 169,343 nodes, preferential-attachment skew).
Every other name of the JAX registry raises ``NotImplementedError`` until
its loader is ported.
"""

from __future__ import annotations

from typing import Dict

from stemgnn_tpu_torch.data import synthetic

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
    if name in dataset2task:
        raise NotImplementedError(
            f"dataset {name!r} is not ported to stemgnn_tpu_torch yet; the "
            f"port loads cora_synthetic, arxiv_synthetic and "
            f"arxiv_synthetic_pl")
    raise KeyError(f"Unknown dataset {name}")
