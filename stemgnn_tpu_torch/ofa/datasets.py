"""OFA runtime subgraph/prompt datasets (counterpart of
``stemgnn_tpu/ofa/datasets.py``; host numpy, the same samples as the JAX
package's for the same seed).

Re-designs of the reference's runtime dataset classes
(STEM-GNN/dataset/ofa_datasets.py):

  * SubgraphNodeDataset      — k-hop subgraph around one node, NOI prompt
                               (SubgraphDataset:147-208 / SubgraphHierDataset
                               :219-256; ``hier=True`` adds the NOI node),
  * SubgraphLinkHierDataset  — positive edges + sampled negatives, optional
                               target-edge removal (:259-301).  The reference
                               materializes the **dense N x N complement** for
                               negative sampling (:269-275) — re-done here as
                               rejection sampling (SURVEY.md §7.3),
  * SubgraphKGHierDataset    — 2-hop around a triple's endpoints, undirected
                               doubling with inverse-relation edge features
                               (:315-365),
  * GraphListHierDataset     — whole small graphs (molecules), every node
                               links to the NOI (:368-454).

Each ``__getitem__`` returns a prompted-graph dict
(ofa.prompt.build_prompted_graph) ready for ``collate_prompted``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from stemgnn_tpu_torch.ofa.prompt import build_prompted_graph
from stemgnn_tpu_torch.ofa.subgraph import (CSRAdjacency, induced_edges,
                                      sample_fixed_hop_neighbors)


def _one_hot_label(num_classes: int, label) -> np.ndarray:
    b = np.zeros(num_classes, np.float32)
    b[int(label)] = 1.0
    return b


class SubgraphNodeDataset:
    def __init__(self, ds, class_emb, prompt_edge_emb, data_idx,
                 noi_node_emb=None, hop: int = 2, to_undirected: bool = False,
                 max_nodes_per_hop: int = 100, hier: bool = True,
                 no_class_node: bool = False, seed: int = 0):
        self.ds = ds
        self.adj = CSRAdjacency(np.asarray(ds.edge_index), ds.num_nodes,
                                to_undirected=to_undirected)
        self.class_emb = np.asarray(class_emb)
        self.prompt_edge_emb = np.asarray(prompt_edge_emb)
        self.noi_node_emb = None if not hier else (
            np.asarray(noi_node_emb) if noi_node_emb is not None
            else self.prompt_edge_emb[:1])
        self.data_idx = np.asarray(data_idx)
        self.hop = hop
        self.cap = max_nodes_per_hop
        self.no_class_node = no_class_node
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.data_idx)

    def __getitem__(self, index):
        node_id = int(self.data_idx[index])
        nbrs = sample_fixed_hop_neighbors(self.adj, [node_id], self.hop,
                                          self.cap, self.rng)
        nodes = np.r_[np.asarray([node_id]), nbrs].astype(np.int64)
        src, dst, _ = induced_edges(self.adj, nodes)
        feat = self.ds.node_text_feat[self.ds.x[nodes]]
        edge_feat = np.tile(self.ds.edge_text_feat[:1],
                            (len(src), 1))
        label = int(np.asarray(self.ds.labels)[node_id])
        out = build_prompted_graph(
            feat, np.stack([src, dst]), edge_feat, [0], self.class_emb,
            self.prompt_edge_emb,
            _one_hot_label(len(self.class_emb), label),
            noi_node_emb=self.noi_node_emb,
            no_class_node=self.no_class_node)
        out["y"] = label
        return out


class SubgraphLinkHierDataset:
    def __init__(self, ds, class_emb, prompt_edge_emb, edges,
                 noi_node_emb=None, remove_edge: bool = False, hop: int = 2,
                 to_undirected: bool = False, max_nodes_per_hop: int = 100,
                 seed: int = 0):
        """``edges`` [P, 2]: positive pairs.  Negatives: rejection sampling of
        non-adjacent pairs (the reference's dense complement is O(N^2) memory,
        ofa_datasets.py:269-275)."""
        self.ds = ds
        self.adj = CSRAdjacency(np.asarray(ds.edge_index), ds.num_nodes,
                                to_undirected=to_undirected)
        self.class_emb = np.asarray(class_emb)
        self.prompt_edge_emb = np.asarray(prompt_edge_emb)
        self.noi_node_emb = (np.asarray(noi_node_emb)
                             if noi_node_emb is not None
                             else self.prompt_edge_emb[:1])
        self.edges = np.asarray(edges)
        self.remove_edge = remove_edge
        self.hop = hop
        self.cap = max_nodes_per_hop
        self.rng = np.random.default_rng(seed)

        existing = set(map(tuple, np.asarray(ds.edge_index).T.tolist()))
        neg = []
        n = ds.num_nodes
        while len(neg) < len(self.edges):
            u = int(self.rng.integers(0, n))
            v = int(self.rng.integers(0, n))
            if u != v and (u, v) not in existing:
                neg.append((u, v))
        self.neg_edges = np.asarray(neg)
        self.total_edges = np.concatenate([self.edges, self.neg_edges])
        self.pos_index = len(self.edges)

    def __len__(self):
        return len(self.total_edges)

    def __getitem__(self, index):
        u, v = (int(x) for x in self.total_edges[index])
        label = 1 if index < self.pos_index else 0
        nbrs = sample_fixed_hop_neighbors(self.adj, [u, v], self.hop,
                                          self.cap, self.rng)
        nodes = np.r_[np.asarray([u, v]), nbrs].astype(np.int64)
        src, dst, _ = induced_edges(self.adj, nodes)
        if self.remove_edge and index < self.pos_index:
            # drop the target edge 0<->1 from the feature graph (:295-299)
            keep = ~(((src == 0) & (dst == 1)) | ((src == 1) & (dst == 0)))
            src, dst = src[keep], dst[keep]
        feat = self.ds.node_text_feat[self.ds.x[nodes]]
        edge_feat = np.tile(self.ds.edge_text_feat[:1], (len(src), 1))
        out = build_prompted_graph(
            feat, np.stack([src, dst]), edge_feat, [0, 1], self.class_emb,
            self.prompt_edge_emb,
            _one_hot_label(len(self.class_emb), label),
            noi_node_emb=self.noi_node_emb)
        out["y"] = label
        return out


class SubgraphKGHierDataset:
    def __init__(self, ds, class_emb, prompt_edge_emb, edges, edge_types,
                 noi_node_emb=None, remove_edge: bool = False, hop: int = 2,
                 max_nodes_per_hop: int = 100, seed: int = 0):
        """``edges`` [P, 2] endpoint pairs with relation labels
        ``edge_types`` [P].  The feature subgraph keeps real relation features
        and doubles edges with inverse-relation features
        (ofa_datasets.py:346-364): inverse type = type + T."""
        self.ds = ds
        self.edge_index = np.asarray(ds.edge_index)
        self.all_types = np.asarray(ds.labels)
        self.adj = CSRAdjacency(self.edge_index, ds.num_nodes)
        self.class_emb = np.asarray(class_emb)
        self.prompt_edge_emb = np.asarray(prompt_edge_emb)
        self.noi_node_emb = (np.asarray(noi_node_emb)
                             if noi_node_emb is not None
                             else self.prompt_edge_emb[:1])
        self.edges = np.asarray(edges)
        self.edge_types = np.asarray(edge_types)
        self.remove_edge = remove_edge
        self.hop = hop
        self.cap = max_nodes_per_hop
        self.rng = np.random.default_rng(seed)
        # relation-feature table doubled: [T real | T inverse]
        T = int(self.all_types.max()) + 1
        base = np.asarray(ds.class_node_text_feat)[:T] \
            if ds.class_node_text_feat is not None and \
            len(ds.class_node_text_feat) >= T else \
            np.tile(ds.edge_text_feat[:1], (T, 1))
        self.rel_feat = np.concatenate([base, -base], axis=0)
        self.num_rel = T

    def __len__(self):
        return len(self.edges)

    def __getitem__(self, index):
        u, v = (int(x) for x in self.edges[index])
        label = int(self.edge_types[index])
        nbrs = sample_fixed_hop_neighbors(self.adj, [u, v], self.hop,
                                          self.cap, self.rng)
        nodes = np.r_[np.asarray([u, v]), nbrs].astype(np.int64)
        local = np.full(self.adj.num_nodes, -1, np.int64)
        local[nodes] = np.arange(len(nodes))
        em = ((local[self.edge_index[0]] >= 0)
              & (local[self.edge_index[1]] >= 0))
        if self.remove_edge:
            em = em.copy()
            em[index] = False
        src = local[self.edge_index[0][em]]
        dst = local[self.edge_index[1][em]]
        types = self.all_types[em]
        # double with inverses
        src2 = np.concatenate([src, dst])
        dst2 = np.concatenate([dst, src])
        edge_feat = self.rel_feat[np.concatenate([types,
                                                  types + self.num_rel])]
        feat = self.ds.node_text_feat[self.ds.x[nodes]]
        out = build_prompted_graph(
            feat, np.stack([src2, dst2]), edge_feat, [0, 1], self.class_emb,
            self.prompt_edge_emb,
            _one_hot_label(len(self.class_emb), label),
            noi_node_emb=self.noi_node_emb)
        out["y"] = label
        return out


class GraphListHierDataset:
    def __init__(self, graphs: Sequence[dict], labels, class_emb,
                 prompt_edge_emb, data_idx, noi_node_emb=None,
                 no_class_node: bool = False):
        self.graphs = graphs
        self.labels = np.asarray(labels)
        self.class_emb = np.asarray(class_emb)
        self.prompt_edge_emb = np.asarray(prompt_edge_emb)
        self.noi_node_emb = (np.asarray(noi_node_emb)
                             if noi_node_emb is not None
                             else self.prompt_edge_emb[:1])
        self.data_idx = np.asarray(data_idx)
        self.no_class_node = no_class_node

    def __len__(self):
        return len(self.data_idx)

    def __getitem__(self, index):
        gi = int(self.data_idx[index])
        g = self.graphs[gi]
        lab = self.labels[gi]
        # NaNs pass through: build_prompted_graph zeroes the label and drops
        # the class node from bin_valid (multitask chem, gen_data.py:56-59).
        binary = np.asarray(lab, np.float32)
        ei = np.stack([np.asarray(g["senders"]), np.asarray(g["receivers"])])
        out = build_prompted_graph(
            np.asarray(g["node_feat"]), ei, np.asarray(g["edge_feat"]),
            list(range(len(g["node_feat"]))), self.class_emb,
            self.prompt_edge_emb, binary,
            noi_node_emb=self.noi_node_emb,
            no_class_node=self.no_class_node,
            hier_targets_are_all_nodes=True)
        out["y"] = lab
        return out
