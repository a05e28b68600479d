"""Synthetic text-attributed-graph generators (counterpart of
``stemgnn_tpu/data/synthetic.py``).

Ported: ``synthetic_node_dataset``, an SBM-style citation graph with
class-prototype features and reference-style splits (Cora: 140 train /
500 val / rest test, 10 splits), ``synthetic_link_dataset``, a typed
knowledge graph whose relation (one of T edge types) is the edge's label,
``synthetic_graph_dataset``, small random graphs with multitask binary
labels, 20% of them NaN (``mol_synthetic``), and ``write_smiles_csv``, a
``smiles:<csv>`` file of random valence-safe molecules (``random_smiles``)
with 128 tasks, 60% NaN, as ``scripts/bench_graph_scale.py`` generates them,
and the benchmark graphs ``random_power_law_graph`` (Zipf in-degree skew)
and ``community_power_law_graph`` (communities with power-law in-degree
inside, node ids shuffled: what the locality relabels recover).
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


def synthetic_graph_dataset(name: str = "mol_synthetic", num_graphs: int = 600,
                            num_tasks: int = 4, feat_dim: int = 768,
                            min_nodes: int = 8, max_nodes: int = 24,
                            nan_frac: float = 0.2, seed: int = 0):
    """Returns (list of graph dicts, labels [G, T] with NaNs, split dict).

    Each graph dict: node_feat/senders/receivers/edge_feat arrays.  Labels
    correlate with mean node feature projections so AUC is learnable.
    """
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((feat_dim, num_tasks)).astype(np.float32)
    graphs, labels = [], []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        feats = rng.standard_normal((n, feat_dim)).astype(np.float32)
        e = max(2 * n, 4)
        src = rng.integers(0, n, e // 2)
        dst = rng.integers(0, n, e // 2)
        ei = _undirected(src, dst)
        ef = rng.standard_normal((ei.shape[1], feat_dim)).astype(np.float32)
        graphs.append({"node_feat": feats, "senders": ei[0],
                       "receivers": ei[1], "edge_feat": ef})
        score = feats.mean(0) @ w
        lab = (score > 0).astype(np.float64)
        lab[rng.random(num_tasks) < nan_frac] = np.nan
        labels.append(lab)
    labels = np.stack(labels)
    perm = rng.permutation(num_graphs)
    n_tr, n_va = int(num_graphs * 0.8), int(num_graphs * 0.1)
    split = make_index_splits(num_graphs, perm[:n_tr],
                              perm[n_tr:n_tr + n_va], perm[n_tr + n_va:])
    return graphs, labels, split


_ATOMS = ["C", "C", "C", "C", "N", "O", "C", "S", "F"]


def random_smiles(rng) -> str:
    """Valence-safe random molecule: a carbon-ish chain of 6-21 heavy atoms
    with branches, single/double bonds and an optional ring closure (the
    generator of ``scripts/bench_graph_scale.py``)."""
    n = int(rng.integers(6, 22))
    out = []
    open_ring = -1
    depth = 0
    for i in range(n):
        a = _ATOMS[rng.integers(0, len(_ATOMS))]
        if i > 0 and a == "C" and rng.random() < 0.12:
            out.append("=")
        out.append(a)
        if a == "C" and open_ring < 0 and 1 < i < n - 4 \
                and rng.random() < 0.15:
            out.append("1")
            open_ring = i
        if a in ("C", "N") and i < n - 2 and depth < 2 \
                and rng.random() < 0.22:
            out.append("(")
            depth += 1
        elif depth > 0 and rng.random() < 0.4:
            out.append(")")
            depth -= 1
    while depth > 0:
        out.append(")")
        depth -= 1
    if open_ring >= 0:
        out.append("C1")
    return "".join(out)


def write_smiles_csv(path: str, num_graphs: int, num_tasks: int = 128,
                     nan_frac: float = 0.6, seed: int = 0):
    """Write a ``smiles:<csv>`` file of ``num_graphs`` :func:`random_smiles`
    molecules with the label scheme of ``scripts/bench_graph_scale.py``:
    ``num_tasks`` binary tasks learnable from the counts of C and of N + O
    + S (each task's median splits it), ``nan_frac`` of the cells empty,
    and an 80/10/10 random split.  The bench parses each string as it draws
    it to reject the bad ones; the generator is valence-safe (every one of
    the 2,000 strings of ``tests/test_torch_port_chem.py`` parses), so here
    the strings are parsed once, when the file is loaded."""
    rng = np.random.default_rng(seed)
    smiles = [random_smiles(rng) for _ in range(num_graphs)]
    n_c = np.asarray([s.count("C") for s in smiles], np.float64)
    n_het = np.asarray([s.count("N") + s.count("O") + s.count("S")
                        for s in smiles], np.float64)
    w = rng.standard_normal((2, num_tasks))
    score = np.stack([n_c, n_het], 1) @ w
    labels = (score > np.median(score, axis=0)).astype(np.float64)
    labels[rng.random(labels.shape) < nan_frac] = np.nan
    split_names = rng.choice(["train", "valid", "test"], len(smiles),
                             p=[0.8, 0.1, 0.1])
    cells = np.where(np.isnan(labels), "",
                     np.nan_to_num(labels).astype(np.int64).astype(str))
    lines = [",".join(["smiles", "split"]
                      + [f"task{t}" for t in range(num_tasks)])]
    lines += [",".join([s, sp, *row]) for s, sp, row in
              zip(smiles, split_names, cells.tolist())]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def random_power_law_graph(num_nodes: int, num_edges: int, feat_dim: int,
                           alpha: float = 1.5, seed: int = 0,
                           with_edge_feat: bool = True):
    """Benchmark graph with Zipf-ish in-degree skew (arxiv-like).  Returns
    host arrays (node_feat, senders, receivers, edge_feat)."""
    rng = np.random.default_rng(seed)
    # receiver popularity ~ power law (inverse-CDF sampling; rng.choice with
    # explicit p is ~100x slower at this scale)
    ranks = np.arange(1, num_nodes + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    receivers = np.searchsorted(cdf, rng.random(num_edges)).astype(np.int32)
    senders = rng.integers(0, num_nodes, num_edges).astype(np.int32)
    node_feat = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    edge_feat = rng.standard_normal((num_edges, feat_dim)).astype(np.float32) \
        if with_edge_feat else None
    return node_feat, senders, receivers, edge_feat


def community_power_law_graph(num_nodes: int, num_edges: int, feat_dim: int,
                              num_communities: int = 64,
                              p_intra: float = 0.9, alpha: float = 1.5,
                              seed: int = 0, shuffle: bool = True,
                              with_edge_feat: bool = False):
    """Community-structured benchmark graph (citation-network-like): nodes
    belong to equal-size communities, ``p_intra`` of edges stay inside the
    endpoint's community (with power-law in-degree skew inside), the rest
    connect uniformly at random across the graph.  Node ids are SHUFFLED by
    default so the raw ordering carries no locality — exactly the situation
    the relabels of ops/reorder.py are meant to recover.
    Returns host arrays (node_feat, senders, receivers, edge_feat)."""
    rng = np.random.default_rng(seed)
    csize = max(num_nodes // num_communities, 1)
    n_eff = csize * num_communities
    intra = rng.random(num_edges) < p_intra
    comm = rng.integers(0, num_communities, num_edges)
    # power-law local offsets inside the community for receivers
    ranks = np.arange(1, csize + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    r_local = np.searchsorted(cdf, rng.random(num_edges))
    s_local = rng.integers(0, csize, num_edges)
    senders = np.where(intra, comm * csize + s_local,
                       rng.integers(0, n_eff, num_edges)).astype(np.int64)
    receivers = np.where(intra, comm * csize + r_local,
                         rng.integers(0, n_eff, num_edges)).astype(np.int64)
    if num_nodes > n_eff:
        pass  # trailing isolated nodes keep the requested count
    if shuffle:
        perm = rng.permutation(num_nodes)
        senders = perm[senders]
        receivers = perm[receivers]
    node_feat = rng.standard_normal((num_nodes, feat_dim)).astype(np.float32)
    edge_feat = (rng.standard_normal((num_edges, feat_dim)).astype(np.float32)
                 if with_edge_feat else None)
    return (node_feat, senders.astype(np.int32),
            receivers.astype(np.int32), edge_feat)
