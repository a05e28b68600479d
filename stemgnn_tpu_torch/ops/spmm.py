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

The pair-hash edge dropout (``drop_hash=(seed, p)``) rides the layout path
as the fused form; without a layout its per-edge keep is derived from the
same hash and folded into ``edge_mask`` (JAX spmm.py:98-110), so both paths
drop the same edges.
"""

from __future__ import annotations

from typing import Optional

import torch

from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.ops.fused_sage import fused_sage_aggregate
from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep


class _GatherRows(torch.autograd.Function):
    """``x[idx]`` for bf16 ``x``, whose backward sums each row's gradients
    in f32 and rounds once (``index_select``'s own backward adds in bf16:
    on CUDA through atomics in no fixed order)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        dx = torch.zeros((ctx.rows,) + tuple(g.shape[1:]),
                         dtype=torch.float32, device=g.device)
        return dx.index_add_(0, idx, g.float()).to(g.dtype), None


def gather_rows(x, idx):
    """``x.index_select(0, idx)``; differentiable, and for bf16 ``x`` with
    the f32-summed backward of :class:`_GatherRows`."""
    if x.dtype == torch.bfloat16:
        return _GatherRows.apply(x, idx)
    return x.index_select(0, idx)


def gather_scatter_aggregate(x, senders, receivers, edge_feat=None,
                             edge_mask=None, num_nodes: Optional[int] = None,
                             reduce: str = "mean", relu: bool = True):
    """Gather + segment-reduce over a padded COO edge list; bf16 ``x``
    gives bf16 messages, summed in f32 and rounded once."""
    num_nodes = num_nodes or x.shape[0]
    m = gather_rows(x, senders)
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
                   bf16_messages: bool = True, plain: bool = False,
                   drop_hash=None):
    """Dispatching front end: the fused layout path when ``layout`` is given
    (``edge_table`` [T, D] supplies the per-edge-type features), else the
    gather + scatter path over ``edge_feat``.  ``plain`` makes the fused
    path run its kernels' plain versions.  ``drop_hash``: ``(seed, p)`` (or,
    with a layout, an ``ops.fused_sage.DropView``) drops the edge pairs the
    pair hash picks."""
    if layout is not None:
        if edge_feat is not None and edge_table is None:
            raise ValueError("the layout path takes edge features as "
                             "edge_table + layout ids, not edge_feat")
        return fused_sage_aggregate(x, layout, edge_table, reduce=reduce,
                                    relu=relu, bf16_messages=bf16_messages,
                                    plain=plain, drop_hash=drop_hash)
    if drop_hash is not None:
        seed, p = drop_hash
        keep = pair_hash_keep(seed, senders, receivers, p)
        edge_mask = keep if edge_mask is None else edge_mask & keep
    return gather_scatter_aggregate(
        x, senders, receivers, edge_feat=edge_feat, edge_mask=edge_mask,
        num_nodes=num_nodes, reduce=reduce, relu=relu)
