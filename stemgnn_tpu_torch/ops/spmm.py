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


# edges a block of gather_segment_sum: a [block, D] f32 slab is 0.8 GB at
# D = 768, where the whole arxiv edge list's would be 7.3 GB
EDGE_BLOCK = 1 << 18


def _gather_add(x, gather_ids, segment_ids, valid, weight, num_segments):
    """``out[segment_ids[e]] += weight[e] * x[gather_ids[e]]`` over the
    ``valid`` edges, one block of edges at a time; bf16 rows summed in
    f32 and rounded once."""
    acc_dt = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    acc = torch.zeros((num_segments,) + tuple(x.shape[1:]), dtype=acc_dt,
                      device=x.device)
    for i in range(0, gather_ids.shape[0], EDGE_BLOCK):
        sl = slice(i, i + EDGE_BLOCK)
        m = x.index_select(0, gather_ids[sl]).to(acc_dt)
        if weight is not None:
            m = m * weight[sl, None].to(acc_dt)
        if valid is not None:
            m.masked_fill_(~valid[sl, None], 0)
        acc.index_add_(0, segment_ids[sl], m)
    return acc.to(x.dtype)


class _GatherSegmentSum(torch.autograd.Function):
    """:func:`gather_segment_sum`; d/dx is the same sum with the two index
    arrays swapped (the transposed edge list), d/dweight[e] the dot of
    ``g[segment_ids[e]]`` and ``x[gather_ids[e]]``, both in blocks."""

    @staticmethod
    def forward(ctx, x, gather_ids, segment_ids, valid, weight,
                num_segments):
        ctx.save_for_backward(gather_ids, segment_ids, valid, weight,
                              x if ctx.needs_input_grad[4] else None)
        ctx.rows = x.shape[0]
        return _gather_add(x, gather_ids, segment_ids, valid,
                           None if weight is None else weight.detach(),
                           num_segments)

    @staticmethod
    def backward(ctx, g):
        gather_ids, segment_ids, valid, weight, x = ctx.saved_tensors
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _gather_add(g, segment_ids, gather_ids, valid,
                             None if weight is None else weight.detach(),
                             ctx.rows)
        if ctx.needs_input_grad[4]:
            gw = torch.zeros_like(weight)
            for i in range(0, gather_ids.shape[0], EDGE_BLOCK):
                sl = slice(i, i + EDGE_BLOCK)
                gw[sl] = (g.index_select(0, segment_ids[sl])
                          * x.index_select(0, gather_ids[sl])).sum(-1)
            if valid is not None:
                gw.masked_fill_(~valid, 0)
        return gx, None, None, None, gw, None


def gather_segment_sum(x, gather_ids, segment_ids, num_segments: int,
                       mask=None, weight=None):
    """``sum_e weight[e] * x[gather_ids[e]]`` at ``segment_ids[e]`` over the
    edges ``mask`` keeps, [num_segments, D] in ``x``'s dtype (bf16 summed
    in f32, rounded once), differentiable in ``x`` and in ``weight``.
    Edges are gathered and summed in blocks of :data:`EDGE_BLOCK`, forward
    and backward, so no [E, D] array is built: the gin, gcn, gat and
    MoE-SAGE aggregations, which JAX leaves to XLA's gather and segment
    sum."""
    return _GatherSegmentSum.apply(x, gather_ids, segment_ids, mask, weight,
                                   num_segments)


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
