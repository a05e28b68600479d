"""Fused SAGE aggregation over an ``EdgeLayout``, forward and backward
(counterpart of ``stemgnn_tpu/ops/fused_sage.py``).

    out[i] = mean_{(j,i) in E} relu(x[j] + T[xe(j,i)])

**Factored branch.**  With no per-edge term, or a single-row edge-type
table ``t0`` (every single-edge-text dataset), a message is a pure
per-source row ``f(x_j) = relu(x_j + t0)``, which makes three shortcuts
exact:

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
(``bf16_messages=True``); with f32 messages the gather route runs.  The
dense hub blocks are bf16 products with f32 output (:func:`_mm`); kernels 2
and 3 get the row plan of the direction they walk (``plan_r``/``plan_s`` of
the layout or hub tail).

**Typed branch** (a [T, D] table, T > 1, picked per edge by the layout's
``xe`` ids; JAX's non-factored branch, fused_sage.py:449-537, 625-667):

  * forward with typed virtual hubs (``HubDense.hub_xe``): the hub
    messages ``relu(bf16 x[hub_ids] + bf16 T[hub_xe])`` as one dense
    ``cnt @ xh`` with f32 sums, the tail through kernel 2's ``xe`` mode
    with the hub sums as ``init`` and 1/deg as ``scale`` (through the
    messages + kernel 1 where the tail's gather gate is shut);
  * forward without hubs: kernel 2 with the table and ``xe``, no epilogue,
    the mean applied outside (``sums * 1/deg``), then the cast; with f32
    messages, or the gate shut, the messages, relu, kernel 1, the mean;
  * backward: ``g / max(deg, 1)`` in f32, rounded to the message dtype and
    gathered per edge in sender order (zero on padding); with bf16 messages
    ``masked_scatter_rows_sorted`` (kernel 3) recomputes the relu mask
    ``bf16 x[snd] + bf16 T[xe] > 0`` inside the scatter; with f32 messages
    the messages are rebuilt and ``pre > 0`` masks the edge gradients
    before kernel 1.  The table gets a zero gradient.

``relu=False``, ``edge_keep``, ``drop_hash`` and ``drop_mask_layout`` are
not ported yet and raise.
"""

from __future__ import annotations

import torch

from stemgnn_tpu_torch.ops.edge_layout import EdgeLayout, HubDense
from stemgnn_tpu_torch.ops.scatter import (gathered_scatter_rows_sorted,
                                           gathered_scatter_rows_sorted_ref,
                                           masked_scatter_rows_sorted,
                                           masked_scatter_rows_sorted_ref,
                                           scatter_rows_sorted,
                                           scatter_rows_sorted_ref)


def table_row(edge_table, mdtype):
    """The broadcast single-type table row, or None without a table."""
    return None if edge_table is None else edge_table[0].to(mdtype)[None, :]


def inv_deg(layout: EdgeLayout):
    """[N_pad, 1] f32 1 / in-degree (1 for nodes without in-edges)."""
    return (1.0 / torch.clamp(layout.in_degree, min=1.0)).float()[:, None]


def _mm(a, b):
    """Dense block product with f32 sums, as the JAX package's
    ``preferred_element_type=float32`` gives: on CUDA a bf16 product with
    f32 output (tensor cores, f32 accumulation); on the CPU, which has no
    such product, the operands are widened first (exact).  Both sum exact
    products in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _direction(lay: EdgeLayout, order: str):
    """One direction's kernel-facing arrays: (lrow, block_ptr, gather keys,
    mask, in-kernel gather gate, row plan)."""
    if order == "r":
        return (lay.lrow_r, lay.block_ptr_r, lay.senders_r, lay.mask_r,
                lay.use_gwin_r, lay.plan_r)
    return (lay.lrow_s, lay.block_ptr_s, lay.receivers_s, lay.mask_s,
            lay.use_gwin_s, lay.plan_s)


def _row_walk(kernel, ref, plain: bool, plan):
    """Kernel 2 or 3 with the direction's row plan, or its plain version
    (which takes no plan)."""
    if plain:
        return ref
    return lambda *a, **kw: kernel(*a, plan=plan, **kw)


def tail_messages(src, lay: EdgeLayout, t0, order: str = "r"):
    """Layout-order messages ``src[keys] (+ t0)`` of one direction, zero on
    padded slots (their sentinel key is clamped to the last row, which may
    hold anything)."""
    _, _, keys, mask, _, _ = _direction(lay, order)
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
    lrow, block_ptr, keys, _, use_gather, plan = _direction(lay, order)
    kw = dict(num_nodes_padded=num_nodes_padded, relu=relu, init=init,
              scale=scale, gate=gate, out_dtype=out_dtype)
    if use_gather and src.dtype == torch.bfloat16:
        gathered = _row_walk(gathered_scatter_rows_sorted,
                             gathered_scatter_rows_sorted_ref, plain, plan)
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


def typed_messages(src, tb, lay: EdgeLayout, order: str):
    """Layout-order pre-activations ``src[senders] + tb[xe]`` (JAX
    ``messages``; ``src`` and ``tb`` in the message dtype), zero on padded
    slots."""
    senders = lay.senders_r if order == "r" else lay.senders_s
    xe = lay.xe_r if order == "r" else lay.xe_s
    mask = lay.mask_r if order == "r" else lay.mask_s
    pre = (src.index_select(0, senders.clamp(max=src.shape[0] - 1).long())
           + tb.index_select(0, xe.long()))
    return torch.where(mask[:, None], pre,
                       torch.zeros((), dtype=pre.dtype, device=pre.device))


def _typed_tail(src, tb, lay: EdgeLayout, num_nodes_padded: int, *,
                init=None, scale=None, out_dtype, plain: bool):
    """Receiver-order relu'd typed sums of ``lay``: kernel 2's ``xe`` mode
    when the gather gate is open and the messages are bf16, else the
    messages through kernel 1."""
    kw = dict(num_nodes_padded=num_nodes_padded, relu=True, init=init,
              scale=scale, out_dtype=out_dtype)
    if lay.use_gwin_r and src.dtype == torch.bfloat16:
        gathered = _row_walk(gathered_scatter_rows_sorted,
                             gathered_scatter_rows_sorted_ref, plain,
                             lay.plan_r)
        return gathered(lay.senders_r[None, :], lay.lrow_r, lay.block_ptr_r,
                        src, tb, lay.xe_r[None, :], **kw)
    scatter = scatter_rows_sorted_ref if plain else scatter_rows_sorted
    return scatter(typed_messages(src, tb, lay, "r"), lay.lrow_r,
                   lay.block_ptr_r, **kw)


def _typed_forward(x, layout, table, reduce, mdtype, plain):
    """The non-factored forward (JAX ``fwd_impl``, :449-537)."""
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    n_pad = layout.num_nodes_padded
    src, tb = x.to(mdtype), table.to(mdtype)
    hub = layout.hub_r
    if hub is not None and hub.hub_xe is not None \
            and mdtype == torch.bfloat16:
        xh = torch.relu(src.index_select(0, hub.hub_ids)
                        + tb.index_select(0, hub.hub_xe))
        return _typed_tail(src, tb, hub.tail, n_pad, init=_mm(hub.cnt, xh),
                           scale=inv_deg(layout) if reduce == "mean"
                           else None, out_dtype=out_dtype, plain=plain)
    # no epilogue: the f32 sums, then the mean, then the cast
    sums = _typed_tail(src, tb, layout, n_pad, out_dtype=torch.float32,
                       plain=plain)
    if reduce == "mean":
        sums = sums * inv_deg(layout)
    return sums.to(out_dtype)


def _typed_backward(g, x, lay, table, reduce, mdtype, plain):
    """dx of the non-factored aggregation (JAX ``f_bwd``, :625-667): the
    per-edge gradient ``g / deg`` in sender order, gated by the recomputed
    relu mask."""
    if reduce == "mean":
        g = g.float() * inv_deg(lay)
    src, tb = x.to(mdtype), table.to(mdtype)
    zero = torch.zeros((), dtype=mdtype, device=g.device)
    dm = g.to(mdtype).index_select(
        0, lay.receivers_s.clamp(max=g.shape[0] - 1).long())
    dm = torch.where(lay.mask_s[:, None], dm, zero)
    kw = dict(num_nodes_padded=lay.num_nodes_padded)
    if mdtype == torch.bfloat16:
        masked = _row_walk(masked_scatter_rows_sorted,
                           masked_scatter_rows_sorted_ref, plain, lay.plan_s)
        return masked(dm, lay.lrow_s, lay.senders_s[None, :],
                      lay.block_ptr_s, src, tb, lay.xe_s[None, :],
                      out_dtype=x.dtype, **kw)
    dm = torch.where(typed_messages(src, tb, lay, "s") > 0, dm, zero)
    scatter = scatter_rows_sorted_ref if plain else scatter_rows_sorted
    return scatter(dm, lay.lrow_s, lay.block_ptr_s, **kw)


def _typed(edge_table) -> bool:
    return edge_table is not None and edge_table.shape[0] > 1


def _forward(x, layout, edge_table, reduce, mdtype, plain):
    if _typed(edge_table):
        return _typed_forward(x, layout, edge_table, reduce, mdtype, plain)
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
    if _typed(edge_table):
        return _typed_backward(g, x, layout, edge_table, reduce, mdtype,
                               plain)
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
    """The aggregation with its VJP, factored or typed (JAX ``custom_vjp``
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
    ``x``.  ``edge_table`` is None, a single-row [1, D] type table, or a
    [T, D] table whose rows the layout's ``xe`` ids pick per edge.
    ``plain`` runs the kernels' plain versions on the same device (to check
    the kernels against)."""
    if x.shape[0] != layout.num_nodes_padded:
        raise ValueError(f"x has {x.shape[0]} rows, the layout "
                         f"{layout.num_nodes_padded}")
    if edge_table is not None and (edge_table.dim() != 2
                                   or edge_table.shape[1] != x.shape[1]):
        raise ValueError(f"edge_table must be [T, {x.shape[1]}], got "
                         f"{tuple(edge_table.shape)}")
    if _typed(edge_table) and (layout.xe_r is None or layout.xe_s is None):
        raise ValueError("a typed table needs a layout built with xe_ids")
    if not relu:
        raise NotImplementedError("relu=False messages are not ported")
    if edge_keep is not None or drop_hash is not None:
        raise NotImplementedError("runtime edge masks (edge_keep, drop_hash, "
                                  "drop_mask_layout) are not ported yet")
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unsupported reduce: {reduce}")
    mdtype = torch.bfloat16 if bf16_messages else torch.float32
    return _FusedSage.apply(x, edge_table, layout, reduce, mdtype, plain)
