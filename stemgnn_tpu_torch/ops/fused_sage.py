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

**Pair-hash edge dropout** (``drop_hash=(seed, p)``, factored branch only;
JAX ``_make``'s drop helpers, fused_sage.py:72-134, 299-301, 354-404,
556-579): an edge is kept when ``pair_hash_uniform(seed, {s, r}) >= p``.

  * with hubs (bf16 messages): the count blocks with the dropped (node,
    hub) pairs zeroed (:func:`masked_hub_blocks`), the tail messages
    gathered, multiplied by their keep and summed by ``scatter_rows_sorted``
    (kernel 1) over the tail's row plan, even where the tail's gather gate
    is open, as JAX does; 1/deg is the kept in-degree (:func:`drop_inv_deg`);
  * without hubs (or with f32 messages): the whole direction's messages
    times their keep through kernel 1;
  * the backward is the same decomposition by sender.

JAX evaluates the keep on the whole dense (node, hub) grid in every call.
A zero count stays zero whatever its keep, so the port hashes only the
blocks' nonzero pairs, which the layout records (``HubDense.cnt_nz``/
``sc_nz``): the masked blocks are equal element for element.  A
:class:`DropView` computes each direction's masked blocks, tail keeps and
the kept degrees once, at first use, and the encoder's layers and their
backward share it (the seed and the layout do not change inside a step).

``relu=False`` and ``edge_keep`` (the runtime-mask route) are not ported
and raise; ``drop_mask_layout`` (the halo path's hoisted form) is not
ported.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from stemgnn_tpu_torch.ops.edge_layout import EdgeLayout, HubDense
from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep
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
    """A kernel with the direction's row plan, or its plain version
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


def hub_partials(src, hub: HubDense, t0, relu: bool = True, blocks=None,
                 out_dtype=torch.float32):
    """[N_pad, D] sums of the hub-covered messages ``f(src)``, f =
    relu(. + t0) or the identity: gather-side hubs as
    ``cnt @ f(src[hub_ids])``, scatter-side hubs as ``sc_cnt @ f(src)``.
    ``blocks`` replaces ``(cnt, sc_cnt)`` (the dropout's masked blocks).

    Each product sums in f32.  With a bf16 ``out_dtype`` the partials are
    rounded as JAX's ``hub_bf16_acc`` rounds them (fused_sage.py:311-328):
    the gather-hub product is stored in bf16, the sc block's product is
    rounded to bf16 and added in bf16; with f32 both stay f32."""
    cnt, sc_cnt = (hub.cnt, hub.sc_cnt) if blocks is None else blocks

    def f(a):
        a = a if t0 is None else a + t0
        return torch.relu(a) if relu else a
    if sc_cnt is not None:
        # one f(src) [N, D] pass feeds both dense blocks
        f_all = f(src)
        out = _mm(cnt, f_all.index_select(0, hub.hub_ids)).to(out_dtype)
        return out.index_add_(0, hub.sc_ids,
                              _mm(sc_cnt, f_all).to(out_dtype))
    return _mm(cnt, f(src.index_select(0, hub.hub_ids))).to(out_dtype)


def direction_keep(lay: EdgeLayout, seed, p: float, order: str):
    """[E_pad] bool pair-hash keep of one direction's edges in layout order
    (JAX ``_keep_edges_dir`` with identity ids: sentinel endpoints clipped to
    the last row; padded slots are masked wherever the keep is used)."""
    _, _, gather, _, _, _ = _direction(lay, order)
    scatter = lay.receivers_r if order == "r" else lay.senders_s
    last = lay.num_nodes_padded - 1
    return pair_hash_keep(seed, gather.clamp(max=last),
                          scatter.clamp(max=last), p)


def _masked_block(blk, nz, seed, p, rows_id, cols_id):
    """``blk`` with the pairs of ``nz`` whose ids (``rows_id[r]``,
    ``cols_id[c]``) the hash drops set to zero, and the kept values at the
    pairs (f32)."""
    r, c = nz
    vals = blk[r, c]
    kept = torch.where(pair_hash_keep(seed, rows_id(r), cols_id(c), p), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device))
    return blk.clone().index_put_((r, c), kept), kept.float()


def masked_hub_blocks(hub: HubDense, seed, p: float):
    """``(cnt, sc_cnt, deg)``: the count blocks with the dropped (node, hub)
    pairs zeroed (JAX ``_masked_hub_mats``: the gather-side block's rows are
    nodes and its columns ``hub_ids``, the scatter-side block's rows are
    ``sc_ids`` and its columns nodes), and the kept count each output row
    gets from them (``cnt`` summed over hubs, ``sc_cnt`` over nodes added at
    ``sc_ids``; f32, exact integers).  Only the recorded nonzero pairs are
    hashed; every other entry is zero and stays so."""
    cnt, kept = _masked_block(hub.cnt, hub.cnt_nz, seed, p, lambda r: r,
                              lambda c: hub.hub_ids[c])
    n_pad = hub.cnt.shape[0]
    deg = torch.zeros(n_pad, dtype=torch.float32, device=cnt.device)
    deg.index_add_(0, hub.cnt_nz[0], kept)
    sc_cnt = hub.sc_cnt
    if sc_cnt is not None:
        sc_cnt, kept = _masked_block(sc_cnt, hub.sc_nz, seed, p,
                                     lambda r: hub.sc_ids[r], lambda c: c)
        deg.index_add_(0, hub.sc_ids[hub.sc_nz[0]], kept)
    return cnt, sc_cnt, deg


def masked_hub_blocks_dense(hub: HubDense, seed, p: float):
    """The plain form of :func:`masked_hub_blocks`' blocks, as JAX forms
    them: the keep hashed over the whole dense (row id, column id) grid of
    each block, multiplied in."""
    dev = hub.cnt.device
    rows = torch.arange(hub.cnt.shape[0], device=dev)
    keep = pair_hash_keep(seed, rows[:, None], hub.hub_ids[None, :], p)
    cnt = hub.cnt * keep.to(hub.cnt.dtype)
    sc_cnt = hub.sc_cnt
    if sc_cnt is not None:
        cols = torch.arange(sc_cnt.shape[1], device=dev)
        keep = pair_hash_keep(seed, hub.sc_ids[:, None], cols[None, :], p)
        sc_cnt = sc_cnt * keep.to(sc_cnt.dtype)
    return cnt, sc_cnt


class DropView:
    """The pair-hash dropout ``(seed, p)`` of one step over one layout: each
    direction's masked hub blocks, each (sub)layout direction's edge keeps
    and the kept in-degrees, computed at first use and then shared by every
    aggregation over the layout in the step and by their backward."""

    def __init__(self, layout: EdgeLayout, seed, p: float):
        self.layout, self.seed, self.p = layout, seed, float(p)
        self._memo = {}

    def _get(self, key, fn):
        if key not in self._memo:
            # one profiler range per kind of mask (profile_pretrain reads
            # their device time)
            kind = key if isinstance(key, str) else key[0]
            with record_function("drop_hash:" + kind):
                self._memo[key] = fn()
        return self._memo[key]

    def hub(self, hub: HubDense):
        """(cnt, sc_cnt, kept hub degrees) of ``hub``, masked."""
        return self._get(("hub", id(hub)),
                         lambda: masked_hub_blocks(hub, self.seed, self.p))

    def keep(self, lay: EdgeLayout, order: str):
        """[E_pad] bool keep of ``lay``'s edges in ``order``."""
        return self._get(("keep", id(lay), order),
                         lambda: direction_keep(lay, self.seed, self.p,
                                                order))

    def inv_deg(self):
        """[N_pad, 1] f32 1 / kept in-degree (JAX ``_drop_inv_deg``)."""
        return self._get("inv_deg", lambda: drop_inv_deg(self))


def drop_inv_deg(view: DropView):
    """1 / (kept in-edges per receiver) under the dropout, assembled from
    the decomposition the forward runs: the masked hub blocks plus the kept
    tail edges, or the kept edges of the whole direction without a hub
    block.  Not ``in_degree``: dropped edges do not count."""
    lay = view.layout
    n_pad = lay.num_nodes_padded
    hub = lay.hub_r
    if hub is not None and hub.hub_xe is None:
        deg = view.hub(hub)[2].clone()
        sub = hub.tail
    else:
        deg = torch.zeros(n_pad, dtype=torch.float32,
                          device=lay.in_degree.device)
        sub = lay
    kept = (sub.mask_r & view.keep(sub, "r")).float()
    deg.index_add_(0, sub.receivers_r.clamp(max=n_pad - 1).long(), kept)
    return (1.0 / torch.clamp(deg, min=1.0))[:, None]


def _tail(src, lay: EdgeLayout, order: str, num_nodes_padded: int, *,
          relu: bool, t0, init=None, scale=None, gate=None, out_dtype,
          plain: bool, keep=None):
    """One direction of ``lay`` summed into [N_pad, D] with the epilogue:
    the in-kernel gather when the direction's gate is open, the messages
    are bf16 and no per-edge ``keep`` applies, else the gathered [E, D]
    messages (times ``keep``: keep * relu(m) == relu(keep * m)) through
    ``scatter_rows_sorted``.  ``plain`` runs the kernels' plain versions."""
    lrow, block_ptr, keys, _, use_gather, plan = _direction(lay, order)
    kw = dict(num_nodes_padded=num_nodes_padded, relu=relu, init=init,
              scale=scale, gate=gate, out_dtype=out_dtype)
    if use_gather and src.dtype == torch.bfloat16 and keep is None:
        gathered = _row_walk(gathered_scatter_rows_sorted,
                             gathered_scatter_rows_sorted_ref, plain, plan)
        return gathered(keys[None, :], lrow, block_ptr, src, t0, **kw)
    m = tail_messages(src, lay, t0, order)
    if keep is not None:
        m = m * keep.to(m.dtype)[:, None]
    scatter = _row_walk(scatter_rows_sorted, scatter_rows_sorted_ref, plain,
                        plan)
    return scatter(m, lrow, block_ptr, **kw)


def _hub_split(src, hub: HubDense, order: str, layout: EdgeLayout, *,
               relu: bool, t0, scale=None, gate=None, out_dtype, plain,
               drop=None):
    """Hub-dense decomposition, final output: dense hub blocks + the tail
    kernel, the hub sums riding the kernel's ``init``.  Under ``drop`` (a
    :class:`DropView`) the blocks are masked and the tail's messages carry
    their keep."""
    blocks = keep = None
    if drop is not None:
        blocks = drop.hub(hub)[:2]
        keep = drop.keep(hub.tail, order)
    init = hub_partials(src, hub, t0, relu, blocks, out_dtype)
    return _tail(src, hub.tail, order, layout.num_nodes_padded, relu=relu,
                 t0=t0, init=init, scale=scale, gate=gate,
                 out_dtype=out_dtype, plain=plain, keep=keep)


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
    scatter = _row_walk(scatter_rows_sorted, scatter_rows_sorted_ref, plain,
                        lay.plan_r)
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
        # bf16 partials under a bf16 output, as JAX's hub_bf16_acc
        return _typed_tail(src, tb, hub.tail, n_pad,
                           init=_mm(hub.cnt, xh).to(out_dtype),
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
    scatter = _row_walk(scatter_rows_sorted, scatter_rows_sorted_ref, plain,
                        lay.plan_s)
    return scatter(dm, lay.lrow_s, lay.block_ptr_s, **kw)


def _typed(edge_table) -> bool:
    return edge_table is not None and edge_table.shape[0] > 1


def _mean_scale(layout, reduce, drop):
    if reduce != "mean":
        return None
    return inv_deg(layout) if drop is None else drop.inv_deg()


def _forward(x, layout, edge_table, reduce, mdtype, plain, drop=None):
    if _typed(edge_table):
        return _typed_forward(x, layout, edge_table, reduce, mdtype, plain)
    out_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    src = x.to(mdtype)
    kw = dict(relu=True, t0=table_row(edge_table, mdtype),
              scale=_mean_scale(layout, reduce, drop), out_dtype=out_dtype,
              plain=plain)
    if layout.hub_r is not None and mdtype == torch.bfloat16:
        return _hub_split(src, layout.hub_r, "r", layout, drop=drop, **kw)
    keep = None if drop is None else drop.keep(layout, "r")
    return _tail(src, layout, "r", layout.num_nodes_padded, keep=keep, **kw)


def _backward(g, x, layout, edge_table, reduce, mdtype, plain, drop=None):
    """dx of the factored aggregation (JAX ``f_bwd``): the sender-order
    decomposition of ``gp = g / deg`` (rounded to the message dtype) with
    the relu gate ``x (+ t0) > 0`` in the kernels' epilogue."""
    if _typed(edge_table):
        return _typed_backward(g, x, layout, edge_table, reduce, mdtype,
                               plain)
    gp = g.float()
    if reduce == "mean":
        gp = gp * _mean_scale(layout, reduce, drop)
    gp = gp.to(mdtype)
    t0 = table_row(edge_table, mdtype)
    # the single-type shift keeps the forward's pre-activation arithmetic
    # (bf16 x + bf16 t0), so the mask matches the forward's relu exactly
    gate = x if t0 is None else x.to(mdtype) + t0
    kw = dict(relu=False, t0=None, gate=gate, out_dtype=x.dtype, plain=plain)
    if layout.hub_s is not None and mdtype == torch.bfloat16:
        return _hub_split(gp, layout.hub_s, "s", layout, drop=drop, **kw)
    keep = None if drop is None else drop.keep(layout, "s")
    return _tail(gp, layout, "s", layout.num_nodes_padded, keep=keep, **kw)


class _FusedSage(torch.autograd.Function):
    """The aggregation with its VJP, factored or typed (JAX ``custom_vjp``
    ``f``/``f_fwd``/``f_bwd``)."""

    @staticmethod
    def forward(ctx, x, edge_table, layout, reduce, mdtype, plain, drop):
        ctx.save_for_backward(x, edge_table)
        ctx.layout, ctx.reduce, ctx.mdtype, ctx.plain, ctx.drop = (
            layout, reduce, mdtype, plain, drop)
        return _forward(x, layout, edge_table, reduce, mdtype, plain, drop)

    @staticmethod
    def backward(ctx, g):
        x, edge_table = ctx.saved_tensors
        dx = dtable = None
        # no launch when x needs no gradient (layer 1's node features),
        # as JAX's jit drops that computation
        if ctx.needs_input_grad[0]:
            dx = _backward(g, x, ctx.layout, edge_table, ctx.reduce,
                           ctx.mdtype, ctx.plain, ctx.drop)
        if ctx.needs_input_grad[1]:
            dtable = torch.zeros_like(edge_table)
        return dx, dtable, None, None, None, None, None


def fused_sage_aggregate(x, layout: EdgeLayout, edge_table=None, *,
                         reduce: str = "mean", relu: bool = True,
                         bf16_messages: bool = True, plain: bool = False,
                         edge_keep=None, drop_hash=None):
    """Aggregation of ``x`` [N_pad, D] over ``layout``, differentiable in
    ``x``.  ``edge_table`` is None, a single-row [1, D] type table, or a
    [T, D] table whose rows the layout's ``xe`` ids pick per edge.
    ``plain`` runs the kernels' plain versions on the same device (to check
    the kernels against).  ``drop_hash`` is ``(seed, p)`` or a
    :class:`DropView` of this layout: the pair-hash edge dropout (module
    docstring); factored aggregations only."""
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
    if edge_keep is not None:
        raise NotImplementedError("the runtime edge mask route (edge_keep) "
                                  "is not ported; use drop_hash")
    if reduce not in ("mean", "sum"):
        raise ValueError(f"unsupported reduce: {reduce}")
    drop = drop_hash
    if drop is not None:
        if _typed(edge_table):
            # JAX refuses it too (an assert): typed messages do not factor
            raise NotImplementedError("drop_hash needs the factored (relu, "
                                      "T <= 1) aggregation")
        if not isinstance(drop, DropView):
            drop = DropView(layout, *drop)
        elif drop.layout is not layout:
            raise ValueError("the DropView was made for another layout")
    mdtype = torch.bfloat16 if bf16_messages else torch.float32
    return _FusedSage.apply(x, edge_table, layout, reduce, mdtype, plain,
                            drop)
