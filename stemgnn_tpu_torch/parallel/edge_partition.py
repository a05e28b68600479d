"""Edge-partitioned full-graph mode, the "v1" scale-out layout (counterpart
of ``stemgnn_tpu/parallel/edge_partition.py``).

One graph is sharded by *edges* over the ranks; node features and
parameters are replicated.  Each rank sums the messages of its own edge
shard into partial per-node sums, and one sum across ranks a layer
combines them: communication O(N x D) a layer, whatever the edge count.

  * :func:`partition_edges_by_destination` (host numpy, equal to JAX's
    arrays element for element): the edges sorted by receiver (a stable
    sort) and cut into ``S`` shards of ``round_up(ceil(E / S), 128)``
    slots, so each shard's receivers form one contiguous range; the tail
    shards may be partly or wholly padding.
  * :func:`sharded_sage_aggregate`: the shard's masked ``relu(x[s] + e)``
    segment sum (a gather and ``index_add_``, no kernel: JAX leaves these
    sums to XLA) and, for the mean, the shard's partial in-degree, each
    summed over the ranks, then ``total / max(deg, 1)``.  The sum of the
    messages goes through ``halo.all_reduce_sum``, whose backward sums the
    ranks' cotangents again (JAX's psum and its transpose); the degree
    needs no gradient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.graph import round_up
from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.parallel.halo import all_reduce_sum


def partition_edges_by_destination(senders: np.ndarray, receivers: np.ndarray,
                                   num_shards: int,
                                   edge_feat: Optional[np.ndarray] = None):
    """Sort the edges by receiver and split them into ``num_shards`` equal
    padded shards (JAX ``partition_edges_by_destination``, :28-61).

    Returns a dict of numpy arrays with a leading shard axis: ``senders``
    / ``receivers`` [S, E_shard] int32, ``edge_mask`` [S, E_shard] bool
    and, with ``edge_feat`` (any per-edge array: features [E, D] or type
    ids [E]), ``edge_feat`` [S, E_shard, ...] in its dtype, zero on the
    padded slots."""
    order = np.argsort(receivers, kind="stable")
    s, r = senders[order], receivers[order]
    ef = edge_feat[order] if edge_feat is not None else None
    e = len(s)
    S = num_shards
    per = round_up((e + S - 1) // S, 128)
    out_s = np.zeros((S, per), np.int32)
    out_r = np.zeros((S, per), np.int32)
    out_m = np.zeros((S, per), bool)
    out_ef = (np.zeros((S, per) + ef.shape[1:], ef.dtype)
              if ef is not None else None)
    for i in range(S):
        lo, hi = i * per, min((i + 1) * per, e)
        k = max(hi - lo, 0)
        if k > 0:
            out_s[i, :k] = s[lo:hi]
            out_r[i, :k] = r[lo:hi]
            out_m[i, :k] = True
            if out_ef is not None:
                out_ef[i, :k] = ef[lo:hi]
    res = {"senders": out_s, "receivers": out_r, "edge_mask": out_m}
    if out_ef is not None:
        res["edge_feat"] = out_ef
    return res


def sharded_sage_aggregate(x, senders, receivers, edge_mask, edge_feat=None,
                           *, ranks, reduce: str = "mean",
                           relu: bool = True):
    """The SAGE aggregation over this rank's edge shard, summed over
    ``ranks`` (JAX ``sharded_sage_aggregate``, :64-88): ``x`` [N, D] the
    replicated node rows, ``senders`` / ``receivers`` / ``edge_mask``
    [E_shard] this rank's shard, ``edge_feat`` its per-edge features
    [E_shard, D] or one row [1, D] that every edge adds (a dataset of one
    edge type).  ``reduce`` is ``"sum"`` or ``"mean"`` (over the valid
    in-degree, at least 1)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"unsupported reduce: {reduce}")
    n = x.shape[0]
    if edge_mask is None:
        edge_mask = torch.ones_like(senders, dtype=torch.bool)
    # one [E_shard, D] array: the gather's output (whose backward keeps
    # only the ids) masked and rectified in place; relu(0) = 0, so masking
    # first gives the masked messages
    msg = x.index_select(0, senders)
    if edge_feat is not None:
        msg = msg.add_(edge_feat.to(msg.dtype))
    msg = msg.masked_fill_(~edge_mask[:, None], 0)
    if relu:
        msg = msg.relu_()
    partial = segment.segment_sum(msg, receivers, n)
    total = all_reduce_sum(partial, ranks)
    if reduce == "sum":
        return total
    deg = segment.segment_sum(edge_mask.to(x.dtype), receivers, n)
    if ranks is not None:
        ranks.all_reduce(deg)
    return total / torch.clamp(deg, min=1.0)[:, None]
