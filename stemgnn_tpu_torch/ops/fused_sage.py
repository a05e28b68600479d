"""Fused SAGE aggregation over an ``EdgeLayout``, forward and backward
(counterpart of ``stemgnn_tpu/ops/fused_sage.py``, its factored branch).

    out[i] = mean_{(j,i) in E} relu(x[j] + t0)

With no per-edge term, or a single-row edge-type table ``t0`` (every
single-edge-text dataset), a message is a pure per-source row
``f(x_j) = relu(x_j + t0)``, which makes three shortcuts exact:

  * the hub-dense split (:func:`_hub_split`, fused_sage.py:278-368 of the JAX
    package): ``cnt @ f(x[hub_ids])`` for gather-side hubs and
    ``sc_cnt @ f(x)`` for scatter-side hubs as dense matmuls, the tail edges
    summed by a kernel whose ``init`` epilogue adds the hub partial sums and
    whose ``scale`` epilogue applies 1/deg;
  * the tail, or a whole direction without hubs (:func:`_tail`), runs
    through ``gathered_scatter_rows_sorted`` — the kernel gathers the rows
    itself — when the layout's ``use_gwin_*`` gate is open, else through an
    ``index_select`` of the [E, D] messages and ``scatter_rows_sorted``;
  * the backward (JAX ``f_bwd``, :546-624) needs no per-edge relu mask: with
    ``gp = g / deg`` rounded to the message dtype, ``dx[j] = 1[x_j + t0 > 0]
    * sum_{(j,i)} gp[i]``, the same decomposition by sender with the relu
    mask as the kernels' ``gate`` epilogue.  The edge table (frozen text
    embeddings) gets a zero gradient.

The hub split and the in-kernel gather need bf16 messages
(``bf16_messages=True``); with f32 messages the gather route runs.  Typed
edges (T > 1), ``edge_keep``, ``drop_hash`` and ``drop_mask_layout`` are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from stemgnn_tpu_torch.ops.edge_layout import EdgeLayout, HubDense
from stemgnn_tpu_torch.ops.scatter import (gathered_scatter_rows_sorted,
                                           gathered_scatter_rows_sorted_ref,
                                           scatter_rows_sorted,
                                           scatter_rows_sorted_ref)


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


def _direction(lay: EdgeLayout, order: str):
    """One direction's kernel-facing arrays: (lrow, block_ptr, gather keys,
    mask, in-kernel gather gate)."""
    if order == "r":
        return (lay.lrow_r, lay.block_ptr_r, lay.senders_r, lay.mask_r,
                lay.use_gwin_r)
    return (lay.lrow_s, lay.block_ptr_s, lay.receivers_s, lay.mask_s,
            lay.use_gwin_s)


def tail_messages(src, lay: EdgeLayout, t0, order: str = "r"):
    """Layout-order messages ``src[keys] (+ t0)`` of one direction, zero on
    padded slots (their sentinel key is clamped to the last row, which may
    hold anything)."""
    _, _, keys, mask, _ = _direction(lay, order)
    m = src.index_select(0, keys.clamp(max=src.shape[0] - 1).long())
    if t0 is not None:
        m = m + t0
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    return torch.where(mask[:, None], m, zero)


def hub_partials(src, hub: HubDense, t0, relu: bool = True):
    """[N_pad, D] f32 sums of the hub-covered messages ``f(src)``, f =
    relu(. + t0) or the identity: gather-side hubs as
    ``cnt @ f(src[hub_ids])``, scatter-side hubs as ``sc_cnt @ f(src)``."""
    def f(a):
        a = a if t0 is None else a + t0
        return torch.relu(a) if relu else a
    if hub.sc_cnt is not None:
        # one f(src) [N, D] pass feeds both dense blocks
        f_all = f(src)
        out = _mm(hub.cnt, f_all.index_select(0, hub.hub_ids))
        return out.index_add_(0, hub.sc_ids, _mm(hub.sc_cnt, f_all))
    return _mm(hub.cnt, f(src.index_select(0, hub.hub_ids)))


def _tail(src, lay: EdgeLayout, order: str, num_nodes_padded: int, *,
          relu: bool, t0, init=None, scale=None, gate=None, out_dtype,
          plain: bool):
    """One direction of ``lay`` summed into [N_pad, D] with the epilogue:
    the in-kernel gather when the direction's gate is open and the messages
    are bf16, else the gathered [E, D] messages through
    ``scatter_rows_sorted``.  ``plain`` runs the kernels' plain versions."""
    lrow, block_ptr, keys, _, use_gather = _direction(lay, order)
    kw = dict(num_nodes_padded=num_nodes_padded, relu=relu, init=init,
              scale=scale, gate=gate, out_dtype=out_dtype)
    if use_gather and src.dtype == torch.bfloat16:
        gathered = (gathered_scatter_rows_sorted_ref if plain
                    else gathered_scatter_rows_sorted)
        return gathered(keys[None, :], lrow, block_ptr, src, t0, **kw)
    scatter = scatter_rows_sorted_ref if plain else scatter_rows_sorted
    return scatter(tail_messages(src, lay, t0, order), lrow, block_ptr, **kw)


def _hub_split(src, hub: HubDense, order: str, layout: EdgeLayout, *,
               relu: bool, t0, scale=None, gate=None, out_dtype, plain):
    """Hub-dense decomposition, final output: dense hub blocks + the tail
    kernel, the hub sums riding the kernel's ``init``."""
    init = hub_partials(src, hub, t0, relu).to(out_dtype)
    return _tail(src, hub.tail, order, layout.num_nodes_padded, relu=relu,
                 t0=t0, init=init, scale=scale, gate=gate,
                 out_dtype=out_dtype, plain=plain)


def _forward(x, layout, edge_table, reduce, mdtype, plain):
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    src = x.to(mdtype)
    kw = dict(relu=True, t0=table_row(edge_table, mdtype),
              scale=inv_deg(layout) if reduce == "mean" else None,
              out_dtype=out_dtype, plain=plain)
    if layout.hub_r is not None and mdtype == torch.bfloat16:
        return _hub_split(src, layout.hub_r, "r", layout, **kw)
    return _tail(src, layout, "r", layout.num_nodes_padded, **kw)


def _backward(g, x, layout, edge_table, reduce, mdtype, plain):
    """dx of the factored aggregation (JAX ``f_bwd``): the sender-order
    decomposition of ``gp = g / deg`` (rounded to the message dtype) with
    the relu gate ``x (+ t0) > 0`` in the kernels' epilogue."""
    gp = g.float()
    if reduce == "mean":
        gp = gp * inv_deg(layout)
    gp = gp.to(mdtype)
    t0 = table_row(edge_table, mdtype)
    # the single-type shift keeps the forward's pre-activation arithmetic
    # (bf16 x + bf16 t0), so the mask matches the forward's relu exactly
    gate = x if t0 is None else x.to(mdtype) + t0
    kw = dict(relu=False, t0=None, gate=gate, out_dtype=x.dtype, plain=plain)
    if layout.hub_s is not None and mdtype == torch.bfloat16:
        return _hub_split(gp, layout.hub_s, "s", layout, **kw)
    return _tail(gp, layout, "s", layout.num_nodes_padded, **kw)


class _FusedSage(torch.autograd.Function):
    """The factored aggregation with its factored VJP (JAX ``custom_vjp``
    ``f``/``f_fwd``/``f_bwd``)."""

    @staticmethod
    def forward(ctx, x, edge_table, layout, reduce, mdtype, plain):
        ctx.save_for_backward(x, edge_table)
        ctx.layout, ctx.reduce, ctx.mdtype, ctx.plain = (layout, reduce,
                                                         mdtype, plain)
        return _forward(x, layout, edge_table, reduce, mdtype, plain)

    @staticmethod
    def backward(ctx, g):
        x, edge_table = ctx.saved_tensors
        dx = dtable = None
        # no launch when x needs no gradient (layer 1's node features),
        # as JAX's jit drops that computation
        if ctx.needs_input_grad[0]:
            dx = _backward(g, x, ctx.layout, edge_table, ctx.reduce,
                           ctx.mdtype, ctx.plain)
        if ctx.needs_input_grad[1]:
            dtable = torch.zeros_like(edge_table)
        return dx, dtable, None, None, None, None


def fused_sage_aggregate(x, layout: EdgeLayout, edge_table=None, *,
                         reduce: str = "mean", relu: bool = True,
                         bf16_messages: bool = True, plain: bool = False,
                         edge_keep=None, drop_hash=None):
    """Aggregation of ``x`` [N_pad, D] over ``layout``, differentiable in
    ``x``.  ``edge_table`` is None or a single-row [1, D] type table.
    ``plain`` runs the kernels' plain versions on the same device (to check
    the kernels against)."""
    if x.shape[0] != layout.num_nodes_padded:
        raise ValueError(f"x has {x.shape[0]} rows, the layout "
                         f"{layout.num_nodes_padded}")
    if not relu or (edge_table is not None and edge_table.shape[0] != 1):
        raise NotImplementedError(
            "only the factored aggregation (relu messages, at most one edge "
            "type) is ported; typed edges need the masked kernel")
    if edge_keep is not None or drop_hash is not None:
        raise NotImplementedError("runtime edge masks (edge_keep, drop_hash, "
                                  "drop_mask_layout) are not ported yet")
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unsupported reduce: {reduce}")
    mdtype = torch.bfloat16 if bf16_messages else torch.float32
    return _FusedSage.apply(x, edge_table, layout, reduce, mdtype, plain)
