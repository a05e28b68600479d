"""Sparse SAGE aggregation, the framework's message-passing primitive
(counterpart of ``stemgnn_tpu/ops/spmm.py``).

Per destination node i over its valid in-edges (j -> i)::

    out[i] = reduce_{(j,i) in E} relu(x[j] + edge_feat[(j,i)])

(the reference's ``MySAGEConv``, STEM-GNN/model/encoder.py:94-102).  Two
paths behind :func:`sage_aggregate`:

  * :func:`gather_scatter_aggregate` — ``index_select`` + ``index_add_``
    over materialized edge features; any device.
  * ``ops.fused_sage.fused_sage_aggregate`` — the layout path (hub-dense
    matmuls + the ``gathered_scatter_rows_sorted`` or ``scatter_rows_sorted``
    kernel, with its backward), taken whenever the graph carries an
    ``EdgeLayout``.
"""

from __future__ import annotations

from typing import Optional

import torch

from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate


def gather_scatter_aggregate(x, senders, receivers, edge_feat=None,
                             edge_mask=None, num_nodes: Optional[int] = None,
                             reduce: str = "mean", relu: bool = True):
    """Gather + segment-reduce over a padded COO edge list."""
    num_nodes = num_nodes or x.shape[0]
    m = x.index_select(0, senders)
    if edge_feat is not None:
        m = m + edge_feat
    if relu:
        m = torch.relu(m)
    if reduce == "sum":
        return segment.segment_sum(m, receivers, num_nodes, mask=edge_mask)
    if reduce == "mean":
        return segment.segment_mean(m, receivers, num_nodes, mask=edge_mask)
    raise ValueError(f"unsupported reduce: {reduce}")


def sage_aggregate(x, senders, receivers, edge_feat=None, edge_mask=None,
                   num_nodes: Optional[int] = None, reduce: str = "mean",
                   relu: bool = True, layout=None, edge_table=None,
                   bf16_messages: bool = True, plain: bool = False):
    """Dispatching front end: the fused layout path when ``layout`` is given
    (``edge_table`` [T, D] supplies the per-edge-type features), else the
    gather + scatter path over ``edge_feat``.  ``plain`` makes the fused
    path run its kernels' plain versions."""
    if layout is not None:
        if edge_feat is not None and edge_table is None:
            raise ValueError("the layout path takes edge features as "
                             "edge_table + layout ids, not edge_feat")
        return fused_sage_aggregate(x, layout, edge_table, reduce=reduce,
                                    relu=relu, bf16_messages=bf16_messages,
                                    plain=plain)
    return gather_scatter_aggregate(
        x, senders, receivers, edge_feat=edge_feat, edge_mask=edge_mask,
        num_nodes=num_nodes, reduce=reduce, relu=relu)
