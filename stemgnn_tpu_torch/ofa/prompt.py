"""Prompted-graph construction (counterpart of ``stemgnn_tpu/ofa/prompt.py``).

The reference's ``GraphTextDataset.make_prompted_graph`` / ``to_pyg``
(STEM-GNN/dataset/ofa_datasets.py:82-130): a feature subgraph is extended
with prompt nodes (optional NOI node + one node per class) and prompt edges
of four kinds — f2n / n2f (feature<->NOI or classes) and n2c / c2n
(NOI<->classes) — each carrying a prompt-edge embedding and an edge type id
(default {"f2n": 1, "n2f": 3, "n2c": 2, "c2n": 4}).

Host-side numpy producing plain dicts, equal to the JAX package's;
:func:`collate_prompted` pads a batch into a :class:`Graph` (the port's
``batch_graphs``: padded nodes carry the dead graph id ``n_graph``) with the
reference's mask/label layout (``bin_labels`` on the trailing class nodes,
``true_nodes_mask``, ``noi_node_mask``, ``target_node_mask``,
``feat_node_mask``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from stemgnn_tpu_torch.core.graph import batch_graphs

DEFAULT_PROMPT_EDGES = {"f2n": (1, 0), "n2f": (3, 0), "n2c": (2, 0),
                        "c2n": (4, 0)}


def build_prompted_graph(feat: np.ndarray, edge_index: np.ndarray,
                         edge_feat: np.ndarray, target_node_id: Sequence[int],
                         class_emb: np.ndarray,
                         prompt_edge_emb: np.ndarray,
                         binary_rep: np.ndarray,
                         noi_node_emb: Optional[np.ndarray] = None,
                         no_class_node: bool = False,
                         prompt_edge_list: Dict = None,
                         hier_targets_are_all_nodes: bool = False) -> dict:
    """Build one prompted graph.

    ``noi_node_emb`` [1, D] selects the hierarchical variant
    (SubgraphHierDataset / GraphListHierDataset): feature nodes -> NOI node ->
    class nodes.  Without it, f2n/n2f edges connect each target node to every
    class node directly (SubgraphDataset:199-208).
    ``hier_targets_are_all_nodes``: GraphList variant where every feature node
    links to the NOI (ofa_datasets.py:439-443).
    """
    if prompt_edge_list is None:
        prompt_edge_list = dict(DEFAULT_PROMPT_EDGES)
        if noi_node_emb is None:
            prompt_edge_list = {k: v for k, v in prompt_edge_list.items()
                                if k in ("f2n", "n2f")}
    n_feat = len(feat)
    n_class = 0 if no_class_node else len(class_emb)
    hier = noi_node_emb is not None

    parts = [feat]
    if hier:
        parts.append(np.asarray(noi_node_emb).reshape(1, -1))
    if not no_class_node:
        parts.append(class_emb)
    full_feat = np.concatenate(parts, axis=0)

    targets = np.asarray(list(target_node_id), np.int64)
    if hier and hier_targets_are_all_nodes:
        targets = np.arange(n_feat, dtype=np.int64)
    noi = n_feat                       # NOI node index (hier only)
    class_base = n_feat + (1 if hier else 0)

    def make_edges(kind):
        if hier:
            if kind == "f2n":
                return np.stack([targets, np.full(len(targets), noi)])
            if kind == "n2f":
                return np.stack([np.full(len(targets), noi), targets])
            if kind == "n2c":
                c = np.arange(n_class) + class_base
                return np.stack([np.full(n_class, noi), c])
            if kind == "c2n":
                c = np.arange(n_class) + class_base
                return np.stack([c, np.full(n_class, noi)])
        else:
            c = np.arange(n_class) + class_base
            if kind == "f2n":
                return np.stack([np.repeat(targets, n_class),
                                 np.tile(c, len(targets))])
            if kind == "n2f":
                return np.stack([np.tile(c, len(targets)),
                                 np.repeat(targets, n_class)])
        raise KeyError(kind)

    e_idx = [edge_index]
    e_type = [np.zeros(edge_index.shape[1], np.int64)]
    e_feat = [edge_feat]
    for kind, (type_id, emb_row) in prompt_edge_list.items():
        pe = make_edges(kind)
        if pe.shape[1] == 0:        # every class edge without class nodes
            continue
        e_idx.append(pe)
        e_type.append(np.full(pe.shape[1], type_id, np.int64))
        emb = prompt_edge_emb if emb_row is None else prompt_edge_emb[emb_row]
        e_feat.append(np.tile(np.asarray(emb).reshape(1, -1),
                              (pe.shape[1], 1)))

    n_total = len(full_feat)
    bin_labels = np.zeros(n_total, np.float32)
    bin_valid = np.zeros(n_total, bool)
    if n_class:
        raw = np.asarray(binary_rep, np.float32).reshape(-1)
        bin_labels[n_total - n_class:] = np.nan_to_num(raw, nan=0.0)
        # NaN class labels (absent multitask chem labels,
        # chemmol/gen_data.py:56-59) are excluded from the loss.
        bin_valid[n_total - n_class:] = ~np.isnan(raw)

    masks = {
        "bin_valid": bin_valid,
        "true_nodes_mask": _mask(n_total, range(n_total - n_class, n_total)),
        "noi_node_mask": _mask(n_total, [n_total - n_class - 1]),
        "target_node_mask": _mask(n_total, targets),
        "feat_node_mask": _mask(n_total, range(n_feat)),
    }
    return {
        "node_feat": full_feat.astype(np.float32),
        "senders": np.concatenate(e_idx, axis=1)[0],
        "receivers": np.concatenate(e_idx, axis=1)[1],
        "edge_feat": np.concatenate(e_feat, axis=0).astype(np.float32),
        "edge_type": np.concatenate(e_type),
        "bin_labels": bin_labels,
        "num_classes": n_class,
        **masks,
    }


def _mask(n, idx):
    m = np.zeros(n, bool)
    m[np.asarray(list(idx), np.int64)] = True
    return m


def collate_prompted(samples: Sequence[dict], node_pad_to=None,
                     edge_pad_to=None, device="cpu"):
    """Disjoint-batch prompted graphs into one padded Graph on ``device``
    plus stacked per-node auxiliary masks/labels, numpy on the host (the
    Collater analog)."""
    g = batch_graphs(samples, node_pad_to=node_pad_to,
                     edge_pad_to=edge_pad_to, device=device)
    n_pad = g.num_nodes_padded
    aux = {}
    for key in ["bin_labels", "bin_valid", "true_nodes_mask",
                "noi_node_mask", "target_node_mask", "feat_node_mask"]:
        flat = np.concatenate([s[key] for s in samples])
        out = np.zeros(n_pad, flat.dtype)
        out[: len(flat)] = flat
        aux[key] = out
    aux["num_classes"] = np.asarray([s["num_classes"] for s in samples])
    return g, aux
