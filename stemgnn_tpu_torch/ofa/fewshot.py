"""Few-shot episode sampling + in-context prompted-graph assembly
(counterpart of ``stemgnn_tpu/ofa/fewshot.py``; host numpy, the same
episodes as the JAX package's for the same seeds).

Re-designs of ``SimpleFSManager`` (reference
STEM-GNN/dataset/fs_datamanager.py:10-35) and ``FewShotDataset``
(ofa_datasets.py:457-549): an episode draws n_way classes x (k_shot support +
1 query) samples, builds each sample's NOI-only prompted graph, concatenates
them, appends the n_way class nodes, and wires query-NOI -> every class node
(edge type 2, fs edge feat 0) and each support-NOI -> its true class node
(edge type 4, fs edge feat 1).
"""

from __future__ import annotations

import numpy as np


class SimpleFSManager:
    def __init__(self, class_ind, data_ind, k_shot: int, q_query: int,
                 n_way: int, min_k_shot=None, min_n_way=None, seed: int = 0):
        self.class_ind = np.asarray(class_ind)
        self.data_ind = [np.asarray(d) for d in data_ind]
        self.k_shot = k_shot
        self.q_query = q_query
        self.n_way = n_way
        self.min_k_shot = min_k_shot
        self.min_n_way = min_n_way
        self.rng = np.random.default_rng(seed)

    def get_few_shot_idx(self):
        n_way = self.n_way if self.min_n_way is None else int(
            self.rng.permutation(np.arange(self.min_n_way, self.n_way))[0])
        k_shot = self.k_shot if self.min_k_shot is None else int(
            self.rng.permutation(np.arange(self.min_k_shot, self.k_shot))[0])
        target_cls_ind = self.rng.permutation(len(self.class_ind))[:n_way]
        target_classes = self.class_ind[target_cls_ind]
        samples = [self.rng.choice(self.data_ind[i], k_shot + self.q_query)
                   for i in target_cls_ind]
        return np.asarray(samples), target_classes


class FewShotDataset:
    """Assembles few-shot in-context prompted graphs."""

    def __init__(self, fsmanager: SimpleFSManager, query_dataset,
                 support_dataset, fs_edge_feats: np.ndarray,
                 sample_size: int = 1000, seed: int = 0):
        self.fs = fsmanager
        self.query_dataset = query_dataset
        self.support_dataset = support_dataset
        self.fs_edge_feats = np.asarray(fs_edge_feats)
        self.sample_size = sample_size
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.sample_size

    def _noi_graph(self, dataset, index):
        """Sample's prompted graph with NOI only (no class nodes)."""
        saved = dataset.no_class_node
        dataset.no_class_node = True
        try:
            out = dataset[int(index)]
        finally:
            dataset.no_class_node = saved
        return out

    def __getitem__(self, _):
        node_ids, class_ind = self.fs.get_few_shot_idx()
        n_way = len(class_ind)
        k_shot = node_ids.shape[1] - 1
        class_emb = self.query_dataset.class_emb[class_ind]

        qry_graphs, spt_graphs = [], []
        for ci in range(n_way):
            for si in range(node_ids.shape[1]):
                if si < 1:
                    qry_graphs.append(self._noi_graph(
                        self.query_dataset, node_ids[ci, si]))
                else:
                    spt_graphs.append(self._noi_graph(
                        self.support_dataset, node_ids[ci, si]))

        qry_ind = int(self.rng.integers(0, n_way))
        graphs = [qry_graphs[qry_ind]] + spt_graphs

        n_nodes = np.asarray([len(g["node_feat"]) for g in graphs])
        offsets = np.concatenate([[0], np.cumsum(n_nodes)[:-1]])
        noi_idx = np.cumsum(n_nodes) - 1     # NOI is each graph's last node
        meta_feat = np.concatenate([g["node_feat"] for g in graphs])
        meta_n = len(meta_feat)
        meta_feat = np.concatenate([meta_feat, class_emb])
        class_nodes = np.arange(meta_n, meta_n + n_way)
        spt_class_nodes = np.repeat(class_nodes, k_shot)

        srcs = np.concatenate(
            [g["senders"] + o for g, o in zip(graphs, offsets)])
        dsts = np.concatenate(
            [g["receivers"] + o for g, o in zip(graphs, offsets)])
        qry_e = np.stack([np.full(n_way, noi_idx[0]), class_nodes])
        spt_e = np.stack([noi_idx[1:], spt_class_nodes])
        senders = np.concatenate([srcs, qry_e[0], spt_e[0]])
        receivers = np.concatenate([dsts, qry_e[1], spt_e[1]])
        edge_feat = np.concatenate(
            [g["edge_feat"] for g in graphs]
            + [np.tile(self.fs_edge_feats[0], (n_way, 1)),
               np.tile(self.fs_edge_feats[1], (len(spt_e[0]), 1))])
        edge_type = np.concatenate(
            [g["edge_type"] for g in graphs]
            + [np.full(n_way, 2, np.int64),
               np.full(len(spt_e[0]), 4, np.int64)])

        n_total = len(meta_feat)
        bin_labels = np.zeros(n_total, np.float32)
        bin_labels[n_total - n_way + qry_ind] = 1.0
        true_mask = np.zeros(n_total, bool)
        true_mask[n_total - n_way:] = True
        noi_mask = np.zeros(n_total, bool)
        noi_mask[noi_idx] = True
        return {
            "node_feat": meta_feat.astype(np.float32),
            "senders": senders, "receivers": receivers,
            "edge_feat": edge_feat.astype(np.float32),
            "edge_type": edge_type,
            "bin_labels": bin_labels,
            "bin_valid": true_mask.copy(),
            "true_nodes_mask": true_mask,
            "noi_node_mask": noi_mask,
            "target_node_mask": _mask(n_total, offsets),
            "feat_node_mask": _mask(n_total, offsets),
            "num_classes": n_way,
            "y": qry_ind,
        }


def _mask(n, idx):
    m = np.zeros(n, bool)
    m[np.asarray(idx, np.int64)] = True
    return m
