"""k-hop subgraph sampling with per-hop caps (counterpart of
``stemgnn_tpu/ofa/subgraph.py``).

The reference's ``sample_fixed_hop_size_neighbor`` (the scipy-CSR BFS of
every OFA runtime dataset, STEM-GNN/dataset/gp/utils/graph.py:32-46, cap
100/hop at ofa_datasets.py:175) and induced-subgraph extraction, in plain
numpy over a CSR adjacency: the same ``np.random.Generator`` gives the
same nodes as the JAX package, bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


class CSRAdjacency:
    """Out-neighbor adjacency: neighbors of i are src->dst rows
    ``dst[indptr[i]:indptr[i+1]]``."""

    def __init__(self, edge_index: np.ndarray, num_nodes: int,
                 to_undirected: bool = False):
        src, dst = edge_index[0], edge_index[1]
        if to_undirected:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
        order = np.argsort(src, kind="stable")
        self.sorted_src = src[order]
        self.dst = dst[order]
        self.edge_id = order % edge_index.shape[1]
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        np.add.at(self.indptr, self.sorted_src + 1, 1)
        np.cumsum(self.indptr, out=self.indptr)
        self.num_nodes = num_nodes

    def neighbors(self, nodes: np.ndarray) -> np.ndarray:
        outs = [self.dst[self.indptr[v]: self.indptr[v + 1]] for v in nodes]
        if not outs:
            return np.array([], np.int64)
        return np.concatenate(outs)


def sample_fixed_hop_neighbors(adj: CSRAdjacency, roots: Sequence[int],
                               hop: int, max_nodes_per_hop: int = 100,
                               rng: np.random.Generator = None) -> np.ndarray:
    """BFS with a per-hop random cap; returns the discovered nodes
    (roots excluded).  A fringe over the cap is downsampled with
    replacement, as the reference's ``np.random.choice`` does
    (gp/utils/graph.py:42-43), so a node can come back twice (ROADMAP,
    known behaviours)."""
    rng = rng or np.random.default_rng()
    visited = np.asarray(roots, np.int64)
    fringe = np.asarray(roots, np.int64)
    nodes = np.array([], np.int64)
    for _ in range(hop):
        u = adj.neighbors(fringe)
        fringe = np.setdiff1d(u, visited)
        visited = np.union1d(visited, fringe)
        if len(fringe) > max_nodes_per_hop:
            fringe = rng.choice(fringe, max_nodes_per_hop)
        if len(fringe) == 0:
            break
        nodes = np.concatenate([nodes, fringe])
    return nodes


def induced_edges(adj: CSRAdjacency, nodes: np.ndarray):
    """Edges of the induced subgraph on ``nodes`` with endpoints relabeled
    to local ids (the reference's ``adj[neighbors][:, neighbors].tocoo()``).
    A node listed twice keeps its later local id, and each of its copies
    emits its out-edges.  Returns (src_local, dst_local, edge_id)."""
    node_set = np.full(adj.num_nodes, -1, np.int64)
    node_set[nodes] = np.arange(len(nodes))
    srcs, dsts, eids = [], [], []
    for v in nodes:
        lo, hi = adj.indptr[v], adj.indptr[v + 1]
        d = adj.dst[lo:hi]
        keep = node_set[d] >= 0
        if keep.any():
            srcs.append(np.full(int(keep.sum()), node_set[v]))
            dsts.append(node_set[d[keep]])
            eids.append(adj.edge_id[lo:hi][keep])
    if not srcs:
        z = np.array([], np.int64)
        return z, z, z
    return (np.concatenate(srcs), np.concatenate(dsts),
            np.concatenate(eids))
