"""Graph manipulation utilities (counterpart of
``stemgnn_tpu/utils/graph_utils.py``; reference STEM-GNN/utils/others.py):

  * :func:`flip_edges` — flip about ``p * E`` adjacency entries
    (others.py:107-127), with JAX's set arithmetic in JAX's order, so the
    same seed gives the same arrays in the same order;
  * :func:`active_code` — the codebook's usage on a graph
    (others.py:152-157);
  * :func:`mask2idx` / :func:`idx2mask` (others.py:180-187).
"""

from __future__ import annotations

import numpy as np
import torch


def flip_edges(edge_index: np.ndarray, num_nodes: int, p: float = 0.2,
               seed: int = 0):
    """Flip ~``p * E`` undirected adjacency entries (present <-> absent);
    returns [2, E'] with both directions of every kept pair."""
    rng = np.random.default_rng(seed)
    e = edge_index.shape[1]
    und = {(min(a, b), max(a, b)) for a, b in edge_index.T.tolist()}
    is_und = all((b, a) in und or (a, b) in und
                 for a, b in edge_index.T.tolist()[:100])
    n_flip = int(e * p / 2) if is_und else int(e * p)
    pairs = rng.integers(0, num_nodes, size=(n_flip, 2))
    for a, b in pairs:
        key = (min(int(a), int(b)), max(int(a), int(b)))
        if key in und:
            und.discard(key)
        else:
            und.add(key)
    src = np.asarray([k[0] for k in und] + [k[1] for k in und])
    dst = np.asarray([k[1] for k in und] + [k[0] for k in und])
    return np.stack([src, dst])


@torch.no_grad()
def active_code(encoder, vq, graph):
    """The codes ``vq`` gives the valid nodes of ``graph`` (a
    ``core.graph.Graph`` without a layout, as JAX reads its arrays) under
    ``encoder``, both in evaluation mode: ``(unique_indices,
    active_fraction)``, the fraction over ``codebook_size * heads``.  The
    modules' modes are restored."""
    modes = encoder.training, vq.training
    encoder.eval()
    vq.eval()
    try:
        z = encoder(graph.node_feat, graph.senders, graph.receivers,
                    edge_feat=graph.edge_feat, edge_mask=graph.edge_mask,
                    node_mask=graph.node_mask)
        idx = vq(z)["indices"]
    finally:
        encoder.train(modes[0])
        vq.train(modes[1])
    idx = idx.cpu().numpy()[graph.node_mask.cpu().numpy()]
    uniq = np.unique(idx)
    return uniq, uniq.size / (vq.cfg.codebook_size * vq.cfg.heads)


def mask2idx(mask: np.ndarray) -> np.ndarray:
    return np.nonzero(np.asarray(mask))[0]


def idx2mask(idx, num_nodes: int) -> np.ndarray:
    m = np.zeros(num_nodes, bool)
    m[np.asarray(idx)] = True
    return m
