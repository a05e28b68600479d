"""Fused SAGE aggregation over an ``EdgeLayout``, forward (counterpart of
``stemgnn_tpu/ops/fused_sage.py``, its factored branch).

    out[i] = mean_{(j,i) in E} relu(x[j] + t0)

With no per-edge term, or a single-row edge-type table ``t0`` (every
single-edge-text dataset), a message is a pure per-source row
``f(x_j) = relu(x_j + t0)``, which is what makes two shortcuts exact:

  * the hub-dense split (:func:`_hub_split`, fused_sage.py:278-368 of the JAX
    package): ``cnt @ f(x[hub_ids])`` for gather-side hubs and
    ``sc_cnt @ f(x)`` for scatter-side hubs as dense matmuls, the remaining
    tail edges gathered and summed by the ``scatter_rows_sorted`` kernel,
    whose ``init`` epilogue adds the hub partial sums and whose ``scale``
    epilogue applies 1/deg;
  * the plain forward (fused_sage.py:436-448): every edge gathered and
    summed by the kernel, relu and 1/deg fused into it.

The hub split needs bf16 messages (``bf16_messages=True``); with f32
messages the plain forward runs.  Typed edges (T > 1), the backward,
``drop_hash`` and ``drop_mask_layout`` are not ported yet.
"""

from __future__ import annotations

import torch

from stemgnn_tpu_torch.ops.edge_layout import EdgeLayout, HubDense
from stemgnn_tpu_torch.ops.scatter import scatter_rows_sorted


def table_row(edge_table, mdtype):
    """The broadcast single-type table row, or None without a table."""
    return None if edge_table is None else edge_table[0].to(mdtype)[None, :]


def inv_deg(layout: EdgeLayout):
    """[N_pad, 1] f32 1 / in-degree (1 for nodes without in-edges)."""
    return (1.0 / torch.clamp(layout.in_degree, min=1.0)).float()[:, None]


def _mm(a, b):
    """Dense block product with f32 sums.  The bf16 operands are widened
    first (exact), so the result is the f32 sum of exact products, as the
    JAX package's ``preferred_element_type=float32`` gives."""
    return a.float() @ b.float()


def tail_messages(src, lay: EdgeLayout, t0):
    """Receiver-order messages ``src[senders_r] (+ t0)``, zero on padded
    slots (their sentinel sender is clamped to the last row, which may hold
    anything)."""
    m = src.index_select(0, lay.senders_r.clamp(max=src.shape[0] - 1).long())
    if t0 is not None:
        m = m + t0
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return torch.where(lay.mask_r[:, None], m, zero)


def hub_partials(src, hub: HubDense, t0):
    """[N_pad, D] f32 sums of the hub-covered messages: gather-side hubs as
    ``cnt @ f(x[hub_ids])``, scatter-side hubs as ``sc_cnt @ f(x)``."""
    if hub.sc_cnt is not None:
        # one f(x) [N, D] pass feeds both dense blocks
        f_all = torch.relu(src if t0 is None else src + t0)
        out = _mm(hub.cnt, f_all.index_select(0, hub.hub_ids))
        return out.index_add_(0, hub.sc_ids, _mm(hub.sc_cnt, f_all))
    xh = src.index_select(0, hub.hub_ids)
    return _mm(hub.cnt, torch.relu(xh if t0 is None else xh + t0))


def _hub_split(src, hub: HubDense, layout: EdgeLayout, t0, scale, out_dtype,
               scatter):
    """Hub-dense decomposition, final output: dense hub blocks + the kernel
    over the tail edges, the hub sums riding the kernel's ``init``."""
    t = hub.tail
    return scatter(tail_messages(src, t, t0), t.lrow_r, t.block_ptr_r,
                   num_nodes_padded=layout.num_nodes_padded, relu=True,
                   init=hub_partials(src, hub, t0).to(out_dtype), scale=scale,
                   out_dtype=out_dtype)


def fused_sage_aggregate(x, layout: EdgeLayout, edge_table=None, *,
                         reduce: str = "mean", relu: bool = True,
                         bf16_messages: bool = True, scatter=None):
    """Forward aggregation of ``x`` [N_pad, D] over ``layout``.
    ``edge_table`` is None or a single-row [1, D] type table.  ``scatter``
    is the tail summation: the kernel wrapper when None, or its plain
    version (``ops.scatter.scatter_rows_sorted_ref``) to check the kernel
    against on the same device."""
    scatter = scatter or scatter_rows_sorted
    if x.shape[0] != layout.num_nodes_padded:
        raise ValueError(f"x has {x.shape[0]} rows, the layout "
                         f"{layout.num_nodes_padded}")
    if not relu or (edge_table is not None and edge_table.shape[0] != 1):
        raise NotImplementedError(
            "only the factored aggregation (relu messages, at most one edge "
            "type) is ported; typed edges need masked/gathered kernels")
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unsupported reduce: {reduce}")
    mdtype = torch.bfloat16 if bf16_messages else torch.float32
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    src = x.to(mdtype)
    t0 = table_row(edge_table, mdtype)
    scale = inv_deg(layout) if reduce == "mean" else None
    if layout.hub_r is not None and bf16_messages:
        return _hub_split(src, layout.hub_r, layout, t0, scale, out_dtype,
                          scatter)
    return scatter(tail_messages(src, layout, t0), layout.lrow_r,
                   layout.block_ptr_r,
                   num_nodes_padded=layout.num_nodes_padded, relu=True,
                   scale=scale, out_dtype=out_dtype)
