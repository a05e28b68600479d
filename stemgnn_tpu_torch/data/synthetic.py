"""Synthetic text-attributed-graph generators (counterpart of
``stemgnn_tpu/data/synthetic.py``).

Ported: ``synthetic_node_dataset``, an SBM-style citation graph with
class-prototype features and reference-style splits (Cora: 140 train /
500 val / rest test, 10 splits), and ``synthetic_link_dataset``, a typed
knowledge graph whose relation (one of T edge types) is the edge's label.
The numpy draws are the JAX package's, in the same order, so the same seed
gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from stemgnn_tpu_torch.data.dataset import TAGDataset, make_index_splits


def _undirected(src, dst):
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    return np.stack([s, d])


def synthetic_node_dataset(name: str = "cora_synthetic", num_nodes: int = 2708,
                           num_classes: int = 7, feat_dim: int = 768,
                           avg_degree: int = 4, homophily: float = 0.8,
                           noise: float = 1.0, num_splits: int = 10,
                           train_per_split: int = 140, val_per_split: int = 500,
                           signal_dims: int = 0, structure_frac: float = 0.0,
                           pref_attach: float = 0.0,
                           seed: int = 0) -> TAGDataset:
    """``signal_dims > 0`` concentrates ALL class signal in that many
    feature dims (the rest pure noise), and ``structure_frac > 0`` zeroes
    the signal on that fraction of nodes so their class is recoverable only
    through homophilous neighbors — together they make the label
    *perturbation-sensitive*: Bernoulli feature masking kills signal dims
    in proportion to p, and edge drops starve the signal-free nodes
    (r4 VERDICT item 5 — the all-dims default is nearly immune to both).
    """
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, num_nodes)
    if signal_dims and signal_dims < feat_dim:
        protos = np.zeros((num_classes, feat_dim), np.float32)
        # ~3 sigma per signal dim: learnable through the noise, but each
        # masked dim removes a real share of the separation
        protos[:, :signal_dims] = 3.0 * rng.standard_normal(
            (num_classes, signal_dims)).astype(np.float32)
    else:
        protos = rng.standard_normal((num_classes, feat_dim)).astype(
            np.float32)
    feats = (protos[y] + noise * rng.standard_normal(
        (num_nodes, feat_dim)).astype(np.float32))
    if structure_frac > 0.0:
        weak = rng.random(num_nodes) < structure_frac
        # weak nodes: own features carry no class signal at all
        feats[weak] = noise * rng.standard_normal(
            (int(weak.sum()), feat_dim)).astype(np.float32)

    e = num_nodes * avg_degree // 2
    src = rng.integers(0, num_nodes, e)
    same = rng.random(e) < homophily
    # ``pref_attach`` > 0: Zipf popularity weights (rank^-alpha with
    # alpha = pref_attach, random rank assignment) skew DESTINATION
    # choice — within the class for homophilous edges, globally otherwise
    # — so the degree distribution matches real citation graphs
    # (power-law) while homophily survives.  The default 0 keeps the
    # legacy uniform-degree graph (BASELINE r5: without skew the
    # hub-dense aggregation path never engages on synthetic e2e flows).
    wt = None
    if pref_attach > 0:
        ranks = 1.0 + rng.permutation(num_nodes).astype(np.float64)
        wt = ranks ** (-float(pref_attach))
    # homophilous edges: pick a same-class destination; else random —
    # vectorized per class via inverse-CDF sampling
    dst = np.empty(e, dtype=np.int64)
    by_class = [np.where(y == c)[0] for c in range(num_classes)]

    def draw(pool, k):
        if k == 0:
            return np.empty(0, np.int64)
        if wt is None:
            return pool[rng.integers(0, len(pool), k)]
        cdf = np.cumsum(wt[pool])
        return pool[np.searchsorted(cdf / cdf[-1], rng.random(k))]

    src_cls = y[src]
    for c in range(num_classes):
        sel = same & (src_cls == c)
        dst[sel] = draw(by_class[c], int(sel.sum()))
    rnd = ~same
    dst[rnd] = draw(np.arange(num_nodes), int(rnd.sum()))
    edge_index = _undirected(src, dst)

    edge_text_feat = rng.standard_normal((1, feat_dim)).astype(np.float32)
    xe = np.zeros(edge_index.shape[1], dtype=np.int64)

    splits = []
    for s in range(num_splits):
        srng = np.random.default_rng(seed * 1000 + s)
        perm = srng.permutation(num_nodes)
        splits.append(make_index_splits(
            num_nodes, perm[:train_per_split],
            perm[train_per_split:train_per_split + val_per_split]))

    return TAGDataset(
        name=name, node_text_feat=feats, edge_text_feat=edge_text_feat,
        x=np.arange(num_nodes), xe=xe, edge_index=edge_index, labels=y,
        splits=splits, num_classes=num_classes, num_tasks=1)


def synthetic_link_dataset(name: str = "kg_synthetic", num_entities: int = 2000,
                           num_relations: int = 11, num_edges: int = 12000,
                           feat_dim: int = 768, noise: float = 0.7,
                           seed: int = 0) -> TAGDataset:
    """Relation type is predictable from entity features (each relation links
    two latent clusters), mirroring relation classification on WN18RR."""
    rng = np.random.default_rng(seed)
    num_clusters = max(num_relations, 4)
    cluster = rng.integers(0, num_clusters, num_entities)
    protos = rng.standard_normal((num_clusters, feat_dim)).astype(np.float32)
    feats = protos[cluster] + noise * rng.standard_normal(
        (num_entities, feat_dim)).astype(np.float32)

    # Symmetric map: midpoint edge embeddings (task/link.py:7-8) are
    # direction-blind, so the synthetic relation must be too.
    rel_of_pair = rng.integers(0, num_relations, (num_clusters, num_clusters))
    rel_of_pair = np.triu(rel_of_pair) + np.triu(rel_of_pair, 1).T
    src = rng.integers(0, num_entities, num_edges)
    dst = rng.integers(0, num_entities, num_edges)
    rel = rel_of_pair[cluster[src], cluster[dst]]

    edge_text_feat = rng.standard_normal(
        (num_relations, feat_dim)).astype(np.float32)
    edge_index = np.stack([src, dst])

    e = num_edges
    perm = rng.permutation(e)
    n_tr, n_va = int(e * 0.85), int(e * 0.05)
    split = make_index_splits(e, perm[:n_tr], perm[n_tr:n_tr + n_va],
                              perm[n_tr + n_va:])

    return TAGDataset(
        name=name, node_text_feat=feats, edge_text_feat=edge_text_feat,
        x=np.arange(num_entities), xe=rel, edge_index=edge_index,
        labels=rel, splits=[split], num_classes=num_relations, num_tasks=1)
