"""OOD buckets and stratified splits (counterpart of
``stemgnn_tpu/eval/buckets.py``), numpy on the host.

  * degree buckets    — sort by undirected degree; bottom/top 15% = OOD-low /
                        OOD-high, the middle = ID;
  * homophily buckets — per-node mean cosine similarity of the features to
                        the neighbours' over the undirected, self-loop-free
                        graph; 15/85 cut;
  * alignment buckets — the same statistic, 4 buckets: OOD3 = bottom 10%,
                        OOD2 = 10-20%, OOD1 = 20-30%, ID = 30-80%;
  * stratified_split  — 50/25/25 per class inside ID with the reference's
                        overflow-reduction rules.

The statistics stay numpy on purpose: a device reduction sums in another
order, a node's statistic moves by an ulp, and a stable argsort tie at a
bucket's edge would change which nodes a bucket holds.  Every bucket and
split here holds exactly the JAX package's indices.  One change: the
neighbour similarity is computed over chunks of edges
(:func:`_neighbor_feature_similarity`), which keeps each edge's dot
product bit for bit and bounds the host memory.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

PRIMARY_RATIOS = (0.5, 0.25)
SECONDARY_RATIOS = (0.4, 0.3)
# edges whose gathered feature rows are held at once: 2 x 2,048 x 768 f32
# rows (12.6 MB, about a cache's size) where the whole arxiv graph's 2.3M
# edges would take ~21 GB; the chunk size changes the time, not the bits
SIM_EDGE_CHUNK = 2_048


def _undirected(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Both directions of every edge, duplicates removed, sorted by
    (src, dst)."""
    src = np.concatenate([edge_index[0], edge_index[1]])
    dst = np.concatenate([edge_index[1], edge_index[0]])
    key = src.astype(np.int64) * num_nodes + dst
    _, uniq = np.unique(key, return_index=True)
    return np.stack([src[uniq], dst[uniq]])


def _shrink_counts(n: int, low: int, high: int) -> Tuple[int, int]:
    """The reference's overflow reduction: shrink ``high``, then ``low``,
    until the middle bucket keeps at least one node."""
    if low + high >= n:
        overflow = low + high - (n - 1)
        red = min(overflow, max(0, high - 1))
        high -= red
        overflow -= red
        if overflow > 0:
            red = min(overflow, max(0, low - 1))
            low -= red
    return low, high


def compute_degree_buckets(edge_index: np.ndarray, num_nodes: int):
    """Returns (deg, (low_boundary, high_boundary), bucket_indices)."""
    und = _undirected(edge_index, num_nodes)
    deg = np.bincount(und[0], minlength=num_nodes).astype(np.float32)
    sorted_idx = np.argsort(deg, kind="stable")
    low = max(1, int(math.floor(num_nodes * 0.15)))
    high = max(1, int(math.floor(num_nodes * 0.15)))
    low, high = _shrink_counts(num_nodes, low, high)
    id_count = num_nodes - low - high
    buckets = {
        "OOD-low": sorted_idx[:low],
        "ID": sorted_idx[low:low + id_count],
        "OOD-high": sorted_idx[low + id_count:],
    }
    bounds = (float(deg[buckets["OOD-low"][-1]]),
              float(deg[buckets["OOD-high"][0]]))
    return deg, bounds, buckets


def _neighbor_feature_similarity(x: np.ndarray, edge_index: np.ndarray,
                                 num_nodes: int,
                                 edge_chunk: int = SIM_EDGE_CHUNK):
    """Per-node mean cosine similarity to the neighbours.  Returns (stat,
    valid nodes, nodes without a neighbour, nodes with invalid features).

    Each edge's similarity is the row sum of its two normalized rows'
    product; ``edge_chunk`` edges are gathered at a time.  A row's sum does
    not depend on the other rows of its chunk, so every chunk size gives
    the same bits as the whole edge list at once."""
    if x.ndim == 1:
        x = x[:, None]
    finite = np.isfinite(x).all(axis=1)
    norm = np.linalg.norm(x, axis=1)
    valid_feat = finite & (norm > 0)
    x_norm = x / np.clip(norm, 1e-12, None)[:, None]

    und = _undirected(edge_index, num_nodes)
    keep = und[0] != und[1]
    row, col = und[0][keep], und[1][keep]
    ve = valid_feat[row] & valid_feat[col]
    row, col = row[ve], col[ve]
    sim = np.empty(row.size, x_norm.dtype)
    for lo in range(0, row.size, edge_chunk):
        hi = lo + edge_chunk
        sim[lo:hi] = np.sum(x_norm[row[lo:hi]] * x_norm[col[lo:hi]], axis=1)

    denom = np.zeros(num_nodes, np.float32)
    numer = np.zeros(num_nodes, np.float32)
    np.add.at(denom, row, 1.0)
    np.add.at(numer, row, sim)
    stat = np.zeros(num_nodes, np.float32)
    nz = denom > 0
    stat[nz] = numer[nz] / denom[nz]
    valid_nodes = np.nonzero(nz & valid_feat)[0]
    return stat, valid_nodes, int((~nz).sum()), int((~valid_feat).sum())


def compute_homophily_buckets(x: np.ndarray, edge_index: np.ndarray,
                              num_nodes: int):
    """15/85 buckets over the valid nodes.  Returns (stat, bounds, buckets,
    nodes without a neighbour, nodes with invalid features)."""
    stat, valid_nodes, no_nbrs, invalid = _neighbor_feature_similarity(
        x, edge_index, num_nodes)
    if valid_nodes.size < 3:
        raise ValueError("valid_nodes too small for 3-way split")
    sorted_idx = valid_nodes[np.argsort(stat[valid_nodes], kind="stable")]
    n = sorted_idx.size
    low = max(1, int(math.floor(n * 0.15)))
    high = max(1, int(math.floor(n * 0.15)))
    low, high = _shrink_counts(n, low, high)
    id_count = n - low - high
    buckets = {
        "OOD-low": sorted_idx[:low],
        "ID": sorted_idx[low:low + id_count],
        "OOD-high": sorted_idx[low + id_count:],
    }
    bounds = (float(stat[buckets["OOD-low"][-1]]),
              float(stat[buckets["OOD-high"][0]]))
    return stat, bounds, buckets, no_nbrs, invalid


def compute_alignment_buckets(x: np.ndarray, edge_index: np.ndarray,
                              num_nodes: int):
    """4 buckets by feature-structure alignment; returns as
    :func:`compute_homophily_buckets` does, with five bounds."""
    stat, valid_nodes, no_nbrs, invalid = _neighbor_feature_similarity(
        x, edge_index, num_nodes)
    if valid_nodes.size < 10:
        raise ValueError("valid_nodes too small for 4-way split")
    sorted_idx = valid_nodes[np.argsort(stat[valid_nodes], kind="stable")]
    n = sorted_idx.size
    c3 = max(1, int(math.floor(n * 0.10)))
    c2 = max(c3 + 1, int(math.floor(n * 0.20)))
    c1 = max(c2 + 1, int(math.floor(n * 0.30)))
    id_lo = max(c1, int(math.floor(n * 0.30)))
    id_hi = min(max(id_lo + 1, int(math.floor(n * 0.80))), n)
    if id_lo >= id_hi:
        raise ValueError("valid_nodes too small for ID split (30%-80%).")
    buckets = {
        "OOD3": sorted_idx[:c3],
        "OOD2": sorted_idx[c3:c2],
        "OOD1": sorted_idx[c2:c1],
        "ID": sorted_idx[id_lo:id_hi],
    }
    bounds = (float(stat[buckets["OOD3"][-1]]),
              float(stat[buckets["OOD2"][-1]]),
              float(stat[buckets["OOD1"][-1]]),
              float(stat[buckets["ID"][0]]),
              float(stat[buckets["ID"][-1]]))
    return stat, bounds, buckets, no_nbrs, invalid


def determine_split_counts(class_size: int) -> Tuple[int, int]:
    """(train, val) counts of one class: 50/25, else 40/30, else all but
    two to train."""
    if class_size < 3:
        raise RuntimeError(f"class size {class_size} too small for 3-way split")
    for ratios in (PRIMARY_RATIOS, SECONDARY_RATIOS):
        train = max(1, math.floor(class_size * ratios[0]))
        val = max(1, math.floor(class_size * ratios[1]))
        if train + val >= class_size:
            overflow = train + val - (class_size - 1)
            red = min(overflow, max(0, val - 1))
            val -= red
            overflow -= red
            if overflow > 0:
                red = min(overflow, max(0, train - 1))
                train -= red
        test = class_size - train - val
        if train >= 1 and val >= 1 and test >= 1:
            return train, val
    return max(1, class_size - 2), 1


def stratified_split(id_indices: np.ndarray, labels: np.ndarray, seed: int):
    """Per-class 50/25/25 split inside the ID bucket: sorted (train, val,
    test) node indices."""
    rng = np.random.default_rng(seed)
    id_labels = labels[id_indices]
    train_p, val_p, test_p = [], [], []
    for cls in np.unique(id_labels):
        cls_idx = id_indices[id_labels == cls]
        tr, va = determine_split_counts(cls_idx.size)
        perm = rng.permutation(cls_idx.size)
        cls_idx = cls_idx[perm]
        train_p.append(cls_idx[:tr])
        val_p.append(cls_idx[tr:tr + va])
        test_p.append(cls_idx[tr + va:])
    return (np.sort(np.concatenate(train_p)),
            np.sort(np.concatenate(val_p)),
            np.sort(np.concatenate(test_p)))
