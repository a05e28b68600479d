"""Halo-exchange node-sharded full-graph mode (counterpart of
``stemgnn_tpu/parallel/halo.py``).

Rank ``i`` of a 1-D set of ``S`` ranks owns the node block ``[i*Nb,
(i+1)*Nb)`` of the padded id space and every in-edge of its nodes, so every
segment reduction and every in-degree is local.  Per layer the only traffic
between ranks is the boundary: the features of remote *sender* nodes that
local edges read, shipped by one ``all_to_all`` of [S, R, D] blocks, R the
largest per-peer boundary (:func:`halo_exchange`).

Host side, in numpy: :func:`build_halo_partition` (the split of the edge
list by owner and the static exchange plan, equal to JAX's arrays bit for
bit), :func:`degree_balanced_relabel` / :func:`relabel_dataset_balanced`
(the snake deal of nodes by in-degree that balances the ranks' edge load)
and :func:`build_halo_layouts` (each shard's ``EdgeLayout`` pair for the
fused aggregation; the remote one over the halo buffer's node space).

Device side: the exchange as an autograd function (forward the gather of
the rows each peer asked for and the all_to_all, backward the reverse
all_to_all and an ``index_add_`` into the sender rows), the SAGE
aggregation on the plain route (:func:`halo_sage_aggregate`) and on the
fused kernels (:func:`halo_sage_aggregate_fused`: kernel 2 over the local
and the remote layout), the MoE-SAGE, gcn, gin and gat layers, BatchNorm
with statistics summed across ranks, and the encoder
(:func:`halo_encoder_apply`).

Sums across ranks that the loss reads go through :func:`all_reduce_sum`,
whose backward is again a sum across ranks (JAX's psum and its transpose):
every rank back-propagates the same replicated loss, so a parameter's
gradients summed over the ranks are ``S`` times the single-device gradient
and the step averages them (JAX's ``pmean``, full_graph.py:244-250).

The halo pretrain's edge dropout (JAX halo.py:389-503, 658-800): the
pair-hash dropout over global node ids (``drop_hash`` with ``gids``, the
tables :func:`build_halo_drop_gids` builds; on the fused route a
:class:`~stemgnn_tpu_torch.ops.fused_sage.DropView` a layout, shared by the
layers), or runtime keeps per partition edge (``keep_loc`` / ``keep_rem``:
the fused route's ``edge_keep``, folded into the partition masks on the
plain route).  Either way the mean divides by the kept in-degree.  The
pretrain's statistics run over a larger set of ranks than the exchange
(its data x edge grid): ``stat_ranks``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stemgnn_tpu_torch.nn.layers import dropout
from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.ops.fused_sage import (DropView, EdgeKeep,
                                              fused_sage_aggregate)
from stemgnn_tpu_torch.ops.spmm import gather_segment_sum


def _round_up(v: int, m: int) -> int:
    return ((max(v, 1) + m - 1) // m) * m


# ------------------------------------------------------------------ host

def build_halo_partition(senders, receivers, num_nodes: int, num_shards: int,
                         edge_feat=None, pad_multiple: int = 128,
                         xe_ids=None):
    """Split the edges by receiver ownership and precompute the exchange
    plan (JAX ``build_halo_partition``, halo.py:48-155): returns ``(part,
    nb, R)``, ``part`` a dict of numpy arrays with a leading shard axis.

    Shard ``i``'s local-source edges (sender owned by ``i``) keep their
    order with ids in ``[0, nb)`` (``s_loc``, ``r_loc``, ``m_loc``); its
    remote-source edges read halo slot ``owner * R + k``, ``k`` the rank of
    the sender among the distinct senders shard ``i`` asks ``owner`` for
    (``s_rem``, ``r_rem``, ``m_rem``).  ``send_idx[j, i]`` lists the local
    rows shard ``j`` ships to shard ``i`` (zero-padded to R; padded slots
    are read by no edge).  ``ef_*`` / ``xe_*`` carry the per-edge features
    or type ids."""
    S = num_shards
    nb = _round_up(-(-num_nodes // S), pad_multiple)
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    if xe_ids is not None:
        xe_ids = np.asarray(xe_ids, np.int32)
    owner = receivers // nb
    src_owner = senders // nb

    sides, requests = [], {}
    for i in range(S):
        sel = owner == i
        s_i, r_i = senders[sel], receivers[sel] - i * nb
        is_loc = src_owner[sel] == i
        s_rem = s_i[~is_loc]
        # the distinct remote senders, ascending: grouped by owner, each
        # owner's in ascending id order (JAX's per-owner np.unique)
        uniq = np.unique(s_rem)
        first = np.searchsorted(uniq // nb, np.arange(S + 1))
        for j in range(S):
            if j != i:
                requests[(i, j)] = uniq[first[j]:first[j + 1]]
        so_rem = s_rem // nb
        slot = np.searchsorted(uniq, s_rem) - first[so_rem]
        # per side: (sender column before the R factor, receivers, the
        # edges' positions in the shard's selection)
        sides.append({"loc": (s_i[is_loc] - i * nb, None, r_i[is_loc],
                              is_loc),
                      "rem": (so_rem, slot, r_i[~is_loc], ~is_loc),
                      "sel": sel})

    R = _round_up(max([len(v) for v in requests.values()] + [1]),
                  min(pad_multiple, 8))
    el = _round_up(max(max(len(t["loc"][2]) for t in sides), 1),
                   pad_multiple)
    er = _round_up(max(max(len(t["rem"][2]) for t in sides), 1),
                   pad_multiple)

    out = {
        "s_loc": np.zeros((S, el), np.int32),
        "r_loc": np.zeros((S, el), np.int32),
        "m_loc": np.zeros((S, el), bool),
        "s_rem": np.zeros((S, er), np.int32),
        "r_rem": np.zeros((S, er), np.int32),
        "m_rem": np.zeros((S, er), bool),
        "send_idx": np.zeros((S, S, R), np.int32),
    }
    if edge_feat is not None:
        d = edge_feat.shape[1]
        out["ef_loc"] = np.zeros((S, el, d), edge_feat.dtype)
        out["ef_rem"] = np.zeros((S, er, d), edge_feat.dtype)
    if xe_ids is not None:
        out["xe_loc"] = np.zeros((S, el), np.int32)
        out["xe_rem"] = np.zeros((S, er), np.int32)

    for i in range(S):
        sel = sides[i]["sel"]
        for side in ("loc", "rem"):
            a, slot, r_col, keep = sides[i][side]
            k = len(r_col)
            out[f"s_{side}"][i, :k] = a if slot is None else a * R + slot
            out[f"r_{side}"][i, :k] = r_col
            out[f"m_{side}"][i, :k] = True
            if edge_feat is not None:
                out[f"ef_{side}"][i, :k] = edge_feat[sel][keep]
            if xe_ids is not None:
                out[f"xe_{side}"][i, :k] = xe_ids[sel][keep]
        for j in range(S):
            if j != i:
                req = requests[(i, j)]
                out["send_idx"][j, i, :len(req)] = req - j * nb
    return out, nb, R


def shard_of(part: dict, i: int) -> dict:
    """Shard ``i``'s arrays of a partition (the leading axis dropped)."""
    return {k: v[i] for k, v in part.items()}


def degree_balanced_relabel(receivers, num_nodes: int, num_shards: int,
                            pad_multiple: int = 128):
    """Node relabelling that balances the shards' edge load under the
    contiguous ownership of :func:`build_halo_partition` (JAX
    ``degree_balanced_relabel``, halo.py:163-193): nodes dealt by
    descending in-degree (stable) into the S ranges, snaking every other
    round.  Returns ``(new_of_old [num_nodes] int64, nb)``.

    JAX deals one node at a time and spills into the emptiest range when a
    range is full; a round gives every range one node, so a range holds at
    most ``ceil(num_nodes / S) <= nb`` nodes and never fills: the deal is
    the closed form below, equal to JAX's bit for bit."""
    S = num_shards
    nb = _round_up(-(-num_nodes // S), pad_multiple)
    deg = np.bincount(np.asarray(receivers, np.int64), minlength=num_nodes)
    by_deg = np.argsort(-deg, kind="stable")
    r, c = np.divmod(np.arange(num_nodes, dtype=np.int64), S)
    b = np.where(r % 2 == 0, c, S - 1 - c)
    new_of_old = np.empty(num_nodes, np.int64)
    new_of_old[by_deg] = b * nb + r
    return new_of_old, nb


def relabel_dataset_balanced(ds, num_shards: int, pad_multiple: int = 128):
    """``(ds_new, new_of_old)``: ``ds`` with its nodes relabelled by
    :func:`degree_balanced_relabel` and ghost slots padded in (JAX
    ``relabel_dataset_balanced``, halo.py:196-225).  Per-node arrays
    scatter into the new ids; ghosts get text id 0, label 0 and no split
    (they count as nodes, as in JAX)."""
    ei = np.asarray(ds.edge_index)
    new_of_old, nb = degree_balanced_relabel(ei[1], ds.num_nodes,
                                             num_shards, pad_multiple)
    n_eff = num_shards * nb

    def scatter(arr, fill=0):
        a = np.asarray(arr)
        out = np.full((n_eff,) + a.shape[1:], fill, a.dtype)
        out[new_of_old] = a
        return out

    splits = None
    if ds.splits is not None:
        splits = [{k: scatter(v, fill=False) for k, v in s.items()}
                  for s in ds.splits]
    return dataclasses.replace(
        ds, x=scatter(ds.x),
        edge_index=np.stack([new_of_old[ei[0]], new_of_old[ei[1]]]),
        labels=None if ds.labels is None else scatter(ds.labels),
        splits=splits), new_of_old


def remote_nodes(nb: int, R: int, num_shards: int,
                 node_block: int = 128) -> int:
    """The remote layouts' node space: the halo buffer's ``S * R`` slots
    and the owned block, padded (JAX ``m_rem``, halo.py:262)."""
    return _round_up(max(num_shards * R, nb), node_block)


_HUBS = ("hub_r", "hub_s")


def _stats(lays_family, masks):
    """One row a shard of what :func:`build_halo_layouts`' cross-shard
    decisions read: for each hub side its presence, coverage times valid
    edges and the gather gates of its tail; then the valid edges and the
    layout's gather gates; then each hub side's scatter-side block rows
    (0 without one)."""
    rows = []
    for lay, m in zip(lays_family, masks):
        e = float(np.asarray(m).sum())
        row = []
        for side in _HUBS:
            h = getattr(lay, side)
            row += [float(h is not None),
                    0.0 if h is None else float(h.coverage) * e]
            row += ([float(h.tail.use_gwin_r), float(h.tail.use_gwin_s)]
                    if h is not None else [0.0, 0.0])
        row += [e, float(lay.use_gwin_r), float(lay.use_gwin_s)]
        for side in _HUBS:
            h = getattr(lay, side)
            row.append(0.0 if h is None or h.sc_cnt is None
                       else float(h.sc_cnt.shape[0]))
        rows.append(row)
    return np.asarray(rows, np.float64)


def _gathered(rows_mine, shard_ids, num_shards, ranks):
    """The [S, K] matrix of every shard's stats row: all here, or each
    rank's own summed across ranks."""
    if ranks is None:
        return rows_mine
    full = torch.zeros((num_shards, rows_mine.shape[1]), dtype=torch.float64,
                       device=ranks.device)
    full[shard_ids[0]] = torch.from_numpy(rows_mine[0])
    ranks.all_reduce(full)
    return full.cpu().numpy()


def build_halo_layouts(part, nb: int, R: int, num_shards: int, *,
                       ranks=None, node_block: int = 128,
                       edge_chunk: int = 512, hub_size: int = 0,
                       hub_min_coverage: float = 0.1, sc_hub_size: int = 0,
                       feat_dim_hint: int = 768, num_edge_types: int = 1,
                       device="cpu"):
    """Every shard's ``(lay_loc, lay_rem)`` (JAX ``build_halo_layouts``,
    halo.py:228-386), or with ``ranks`` this rank's shard's alone, as a
    list.  ``sc_hub_size`` (the halo pretrain's, single-type tables only)
    adds the hubs' scatter-side blocks; where the shards of a family do not
    all build the same block, the family is rebuilt without it, as in JAX
    (:287-300: the two forms carry different tails).

    ``lay_loc`` covers the local-source edges over the owned block
    ``[0, nb)``; ``lay_rem`` the remote-source edges, senders in the halo
    buffer and receivers in the owned block, over ``remote_nodes`` rows.
    Each rank's layouts are its own, so JAX's stacking uniformity (windows,
    padded tail sizes, zeroed coverage metadata) has no counterpart; its
    decisions across shards stay, as they change which edges the hub
    blocks carry and so the rounding: hubs are built on every shard, and a
    side keeps them only where every shard has one and the edge-weighted
    coverage over the shards clears ``hub_min_coverage``; a direction
    gathers inside the kernel only where every shard's gate opened it.
    With ``ranks`` each rank builds its own shard and one small all_reduce
    of every shard's statistics gives every rank the same decisions."""
    S = num_shards
    if nb % node_block:
        raise ValueError(f"nodes-per-shard {nb} must be a multiple of "
                         f"node_block {node_block} (pick pad_multiple "
                         f"accordingly in build_halo_partition)")
    if ranks is not None and ranks.world != S:
        raise ValueError(f"{ranks.world} ranks for {S} shards")
    shards = [ranks.rank] if ranks is not None else list(range(S))
    m_rem = remote_nodes(nb, R, S, node_block)

    sc_size = sc_hub_size if hub_size and num_edge_types <= 1 else 0

    def family(pre, n_pad):
        xes = part.get(f"xe_{pre}")
        masks = [part[f"m_{pre}"][i] for i in shards]

        def build(sc):
            return [build_edge_layout(
                part[f"s_{pre}"][i], part[f"r_{pre}"][i], n_pad,
                xe_ids=None if xes is None else xes[i],
                edge_mask=part[f"m_{pre}"][i], node_block=node_block,
                edge_chunk=edge_chunk, hub_size=hub_size,
                hub_min_coverage=-1.0, sc_hub_size=sc,
                feat_dim_hint=feat_dim_hint, num_edge_types=num_edge_types,
                device=device) for i in shards]
        lays = build(sc_size)
        st = _gathered(_stats(lays, masks), shards, S, ranks)
        if sc_size and any(len(np.unique(st[:, c])) > 1 for c in (11, 12)):
            lays = build(0)
            st = _gathered(_stats(lays, masks), shards, S, ranks)
        keep = {}
        for k, side in enumerate(_HUBS):
            cov = st[:, 4 * k + 1].sum() / max(st[:, 8].sum(), 1.0)
            keep[side] = bool(hub_size) and bool(st[:, 4 * k].all()) \
                and cov >= hub_min_coverage
        gates = st[:, 9:11].all(0)
        for lay in lays:
            lay.use_gwin_r = bool(lay.use_gwin_r and gates[0])
            lay.use_gwin_s = bool(lay.use_gwin_s and gates[1])
            for k, side in enumerate(_HUBS):
                if not keep[side]:
                    setattr(lay, side, None)
                    continue
                t_gates = st[:, 4 * k + 2:4 * k + 4].all(0)
                tail = getattr(lay, side).tail
                tail.use_gwin_r = bool(tail.use_gwin_r and t_gates[0])
                tail.use_gwin_s = bool(tail.use_gwin_s and t_gates[1])
        return lays

    loc = family("loc", nb)
    rem = family("rem", m_rem)
    return list(zip(loc, rem))


def build_halo_drop_gids(part, nb: int, R: int, num_shards: int,
                         m_rem: int):
    """Global node ids of the layouts' rows, per shard, for the pair-hash
    dropout (JAX ``build_halo_drop_gids``, halo.py:389-418): ``gid_loc``
    [S, nb] (shard ``i``'s block, ``i * nb + row``), ``gid_rem_src`` [S,
    m_rem] (halo slot ``j * R + k`` of shard ``me``: owner ``j``'s
    ``send_idx[j, me, k]``) and ``gid_rem_dst`` [S, m_rem] (the owned
    block), both padded with the sentinel ``S * nb``.  int32 numpy."""
    S = num_shards
    sentinel = np.int32(S * nb)
    gid_loc = (np.arange(S, dtype=np.int64)[:, None] * nb
               + np.arange(nb, dtype=np.int64)[None, :]).astype(np.int32)
    send_idx = np.asarray(part["send_idx"])
    gid_rem_src = np.full((S, m_rem), sentinel, np.int32)
    gid_rem_dst = np.full((S, m_rem), sentinel, np.int32)
    for me in range(S):
        for j in range(S):
            gid_rem_src[me, j * R:(j + 1) * R] = j * nb + send_idx[j, me]
        gid_rem_dst[me, :nb] = gid_loc[me]
    return gid_loc, gid_rem_src, gid_rem_dst


def part_to_device(shard: dict, device) -> dict:
    """One shard's partition arrays as tensors on ``device``: edge ids as
    int64, masks bool, ``send_idx`` [S, R] this shard's rows, ``ef_*`` as
    they are; ``xe_*`` stay behind (the layouts carry the types)."""
    out = {}
    for k, v in shard.items():
        if k.startswith("xe_"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device)
    return out


# --------------------------------------------------------------- device

class _AllReduce(torch.autograd.Function):
    """A sum across ranks whose backward is again a sum across ranks (the
    transpose of a replicated sum, JAX's psum)."""

    @staticmethod
    def forward(ctx, t, ranks):
        ctx.ranks = ranks
        return ranks.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.ranks.all_reduce(g.clone()), None


def all_reduce_sum(t, ranks):
    """``t`` summed over the ranks, differentiable (module docstring); the
    identity at world size 1."""
    if ranks is None or ranks.world == 1:
        return t
    return _AllReduce.apply(t, ranks)


class _Exchange(torch.autograd.Function):
    """Forward: the rows each peer asked for, [S, R, D], through the
    all_to_all; backward: the halo rows' gradient home through the reverse
    all_to_all, summed into the sender rows."""

    @staticmethod
    def forward(ctx, x_local, send_idx, ranks):
        ctx.save_for_backward(send_idx)
        ctx.ranks, ctx.num_rows = ranks, x_local.shape[0]
        blocks = x_local.index_select(0, send_idx.reshape(-1))
        blocks = blocks.reshape(send_idx.shape + (x_local.shape[1],))
        return ranks.all_to_all(blocks).reshape(-1, x_local.shape[1])

    @staticmethod
    def backward(ctx, g):
        send_idx, = ctx.saved_tensors
        back = ctx.ranks.all_to_all(
            g.reshape(send_idx.shape + (g.shape[1],)))
        dx = torch.zeros((ctx.num_rows, g.shape[1]), dtype=g.dtype,
                         device=g.device)
        return dx.index_add_(0, send_idx.reshape(-1),
                             back.reshape(-1, g.shape[1])), None, None


def halo_exchange(x_local, send_idx, ranks):
    """The halo buffer [S*R, D]: slot ``j*R + k`` holds owner ``j``'s row
    ``send_idx[j, me, k]`` (JAX ``halo_exchange``, halo.py:506-515).
    ``send_idx`` is this rank's [S, R] rows of the plan (int64).  At world
    size 1 the gather alone, as JAX skips the collective.  The slots of a
    rank's own block, which no edge reads, are zero: that block does not
    travel (JAX sends it to itself)."""
    if ranks is None or ranks.world == 1:
        return x_local.index_select(0, send_idx.reshape(-1))
    return _Exchange.apply(x_local, send_idx, ranks)


def _messages(src, s, m, ef, relu):
    v = src.index_select(0, s)
    if ef is not None:
        v = v + ef.to(v.dtype)
    if relu:
        v = torch.relu(v)
    return torch.where(m[:, None], v, torch.zeros((), dtype=v.dtype,
                                                  device=v.device))


def _in_degree(part, nb):
    """[nb] f32 valid in-edges of every owned node, local and remote."""
    return (segment.segment_sum(part["m_loc"].float(), part["r_loc"], nb)
            + segment.segment_sum(part["m_rem"].float(), part["r_rem"], nb))


def halo_sage_aggregate(x_local, part, ranks, *, reduce: str = "mean",
                        relu: bool = True):
    """SAGE aggregation over the halo partition on the plain route (JAX
    ``halo_sage_aggregate``, halo.py:518-551): the gathered messages
    ``relu(x_j + ef)`` of the local and the remote edges summed per owned
    receiver, over the combined in-degree for the mean.  Without ``relu``
    and edge features the sums run by blocks of edges (no [E, D]
    messages)."""
    nb = x_local.shape[0]
    halo = halo_exchange(x_local, part["send_idx"], ranks)
    if relu or "ef_loc" in part:
        agg = segment.segment_sum(
            _messages(x_local, part["s_loc"], part["m_loc"],
                      part.get("ef_loc"), relu), part["r_loc"], nb)
        agg = agg + segment.segment_sum(
            _messages(halo, part["s_rem"], part["m_rem"],
                      part.get("ef_rem"), relu), part["r_rem"], nb)
    else:
        agg = gather_segment_sum(x_local, part["s_loc"], part["r_loc"], nb,
                                 mask=part["m_loc"])
        agg = agg + gather_segment_sum(halo, part["s_rem"], part["r_rem"],
                                       nb, mask=part["m_rem"])
    if reduce == "sum":
        return agg
    deg = _in_degree(part, nb)
    return agg / torch.clamp(deg, min=1.0).to(agg.dtype)[:, None]


def halo_drop_views(lay_loc, lay_rem, drop_hash=None, gids=None,
                    keep_loc=None, keep_rem=None):
    """The dropout of one step over both layouts, as a pair (local, remote)
    of the masks ``fused_sage_aggregate`` takes: the :class:`DropView` of
    the pair hash ``drop_hash=(seed, p)`` over the global ids ``gids=((src,
    dst)_loc, (src, dst)_rem)`` a layout, or the :class:`EdgeKeep` of
    ``keep_loc`` / ``keep_rem``; None without either."""
    if (keep_loc is None) != (keep_rem is None):
        raise ValueError("runtime edge masks must cover both edge shards: "
                         "pass keep_loc AND keep_rem")
    if keep_loc is not None:
        if drop_hash is not None:
            raise ValueError("drop_hash and keep_* are exclusive")
        return EdgeKeep(lay_loc, keep_loc), EdgeKeep(lay_rem, keep_rem)
    if drop_hash is None:
        return None
    if gids is None:
        raise ValueError("drop_hash in halo mode needs gids")
    seed, p = drop_hash
    return (DropView(lay_loc, seed, p, ids=gids[0]),
            DropView(lay_rem, seed, p, ids=gids[1]))


def halo_sage_aggregate_fused(x_local, part, lay_loc, lay_rem,
                              edge_table=None, ranks=None, *,
                              reduce: str = "mean", relu: bool = True,
                              bf16_messages: bool = True, drop=None):
    """The aggregation on the fused kernels (JAX
    ``halo_sage_aggregate_fused``, halo.py:427-503): two
    ``fused_sage_aggregate(reduce="sum")`` calls, one over ``x_local`` with
    ``lay_loc``, one over the halo buffer padded to ``lay_rem``'s node
    space, added in f32 and divided by the combined (kept) in-degree.  The
    fused backward of the remote call returns the halo rows' gradient,
    which the exchange's backward ships home.  A single rank has no remote
    edge and skips the remote call (JAX runs it over its empty layout).
    ``drop`` is the step's dropout, the pair of masks of
    :func:`halo_drop_views`, or None."""
    views = (None, None) if drop is None else drop
    nb = x_local.shape[0]
    kw = dict(reduce="sum", relu=relu, bf16_messages=bf16_messages)

    def call(x, lay, view):
        return fused_sage_aggregate(x, lay, edge_table, drop_hash=view, **kw)
    agg = call(x_local, lay_loc, views[0]).float()
    if ranks is not None and ranks.world > 1:
        halo = halo_exchange(x_local, part["send_idx"], ranks)
        m_rem = lay_rem.num_nodes_padded
        halo_p = torch.cat([halo, halo.new_zeros((m_rem - halo.shape[0],
                                                  halo.shape[1]))])
        agg = agg + call(halo_p, lay_rem, views[1])[:nb].float()
    if reduce == "sum":
        return agg
    deg = sum((lay.in_degree if v is None else v.kept_deg())[:nb]
              for lay, v in zip((lay_loc, lay_rem), views))
    return agg / torch.clamp(deg, min=1.0)[:, None]


def halo_moe_sage_aggregate(z_local, part_rev, conv, weights, ranks):
    """An MoE-SAGE layer over the halo partition of the *reversed* edges
    (JAX ``halo_moe_sage_aggregate``, halo.py:554-570): the receivers'
    features averaged at each sender, ``cat[agg, z]`` through each expert
    (+ ``z`` where in = out), mixed by the router ``weights`` [Nb, K]."""
    agg = halo_sage_aggregate(z_local, part_rev, ranks, reduce="mean",
                              relu=False)
    combined = torch.cat([agg, z_local], dim=-1)
    out = torch.einsum("nd,kdo->nko", combined,
                       conv.weights.to(combined.dtype))
    if out.shape[-1] == z_local.shape[-1]:
        out = out + z_local[:, None, :]
    return (weights[:, :, None] * out).sum(1)


def _edge_sums(h, halo, part, nb, w_loc=None, w_rem=None):
    """``sum_e w[e] * src[s[e]]`` per owned receiver over the local
    (``h``) and remote (``halo``) edges, by blocks of edges."""
    return (gather_segment_sum(h, part["s_loc"], part["r_loc"], nb,
                               mask=part["m_loc"], weight=w_loc)
            + gather_segment_sum(halo, part["s_rem"], part["r_rem"], nb,
                                 mask=part["m_rem"], weight=w_rem))


def halo_gcn_apply(conv, z_local, part, ranks):
    """GCN over the halo partition (JAX ``halo_gcn_apply``,
    halo.py:579-602): the sender-side 1/sqrt(deg + 1) rides the exchange
    beside the projected features; receiver degrees are local."""
    nb = z_local.shape[0]
    h = conv.lin(z_local)
    inv = torch.rsqrt(_in_degree(part, nb).to(h.dtype) + 1.0)
    buf = halo_exchange(torch.cat([h, inv[:, None]], dim=-1),
                        part["send_idx"], ranks)
    h_halo, inv_halo = buf[:, :-1], buf[:, -1]
    w_loc = inv.index_select(0, part["s_loc"]) * inv.index_select(
        0, part["r_loc"])
    w_rem = inv_halo.index_select(0, part["s_rem"]) * inv.index_select(
        0, part["r_rem"])
    out = _edge_sums(h, h_halo, part, nb, w_loc, w_rem)
    return out + h * (inv ** 2)[:, None] + conv.bias


def halo_gin_apply(conv, z_local, part, ranks):
    """GIN over the halo partition (JAX ``halo_gin_apply``)."""
    nb = z_local.shape[0]
    halo = halo_exchange(z_local, part["send_idx"], ranks)
    agg = _edge_sums(z_local, halo, part, nb)
    return conv.lin((1.0 + conv.eps) * z_local + agg)


def halo_gat_apply(conv, z_local, part, ranks):
    """One-head GAT over the halo partition (JAX ``halo_gat_apply``,
    halo.py:617-655): the sender terms (projected rows and their
    ``att_src`` logits) ride one exchange; the receiver softmax runs over
    the local and remote in-edges together."""
    neg = -1e30
    nb = z_local.shape[0]
    h = conv.lin(z_local)
    a_src = h.mv(conv.att_src)
    buf = halo_exchange(torch.cat([h, a_src[:, None]], dim=-1),
                        part["send_idx"], ranks)
    h_halo, a_src_halo = buf[:, :-1], buf[:, -1]
    a_dst = h.mv(conv.att_dst)
    lrelu = torch.nn.functional.leaky_relu
    s_l, r_l, m_l = part["s_loc"], part["r_loc"], part["m_loc"]
    s_r, r_r, m_r = part["s_rem"], part["r_rem"], part["m_rem"]
    e_loc = lrelu(a_src.index_select(0, s_l) + a_dst.index_select(0, r_l),
                  conv.negative_slope)
    e_rem = lrelu(a_src_halo.index_select(0, s_r)
                  + a_dst.index_select(0, r_r), conv.negative_slope)
    e_loc = torch.where(m_l, e_loc, torch.full_like(e_loc, neg))
    e_rem = torch.where(m_r, e_rem, torch.full_like(e_rem, neg))
    mx = torch.full((nb,), neg, dtype=h.dtype, device=h.device)
    mx = mx.scatter_reduce(0, r_l, e_loc, "amax").scatter_reduce(
        0, r_r, e_rem, "amax").detach()
    mx = torch.where(mx <= neg / 2, torch.zeros_like(mx), mx)
    zero = torch.zeros((), dtype=h.dtype, device=h.device)
    exp_l = torch.where(m_l, torch.exp(e_loc - mx.index_select(0, r_l)),
                        zero)
    exp_r = torch.where(m_r, torch.exp(e_rem - mx.index_select(0, r_r)),
                        zero)
    den = (segment.segment_sum(exp_l, r_l, nb)
           + segment.segment_sum(exp_r, r_r, nb))
    den = torch.clamp(den, min=1e-16)
    out = _edge_sums(h, h_halo, part, nb, exp_l / den.index_select(0, r_l),
                     exp_r / den.index_select(0, r_r))
    return out + conv.bias


def rank_sum(ranks):
    """The differentiable sum across ``ranks`` as a function of a tensor
    (what BatchNorm's and the VQ's ``reduce`` take)."""
    return lambda t: all_reduce_sum(t, ranks)


def mean_across(tensors, ranks):
    """Replace each tensor by its mean over the ranks (one all_reduce)."""
    if not tensors or ranks.world == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    ranks.all_reduce(flat)
    flat /= ranks.world
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def broadcast_module(module, ranks, src: int = 0):
    """Every parameter and buffer of ``module`` from rank ``src``, in place
    (a bool buffer through a float copy)."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.dtype == torch.bool:
            flag = t.to(torch.float32)
            ranks.broadcast(flag, src)
            t.copy_(flag > 0)
        else:
            ranks.broadcast(t.data, src)


def _router_stats(layer, w, node_mask, ranks):
    """One MoE layer's router usage over the ``node_mask`` rows, summed
    across ranks (JAX halo.py:759-774)."""
    k = w.shape[1]
    top1 = torch.nn.functional.one_hot(w.argmax(-1), k).to(w.dtype)
    if node_mask is None:
        count = torch.tensor(float(w.shape[0]), device=w.device)
    else:
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        w = torch.where(node_mask[:, None], w, zero)
        top1 = torch.where(node_mask[:, None], top1, zero)
        count = node_mask.sum().float()
    sums = torch.cat([w.sum(0).float(), top1.sum(0).float(),
                      count.reshape(1)])
    if ranks is not None:
        ranks.all_reduce(sums)
    return {"layer": layer, "sum_prob": sums[:k], "sum_top1": sums[k:2 * k],
            "count": sums[2 * k]}


def halo_encoder_apply(encoder, x_local, part, ranks=None, *,
                       node_mask=None, part_rev=None, lay_loc=None,
                       lay_rem=None, edge_table=None, generator=None,
                       gumbel=None, keep_loc=None, keep_rem=None,
                       drop_hash=None, gids=None, stat_ranks=None,
                       compute_dtype=None):
    """The encoder's forward over this rank's node block (JAX
    ``halo_encoder_apply``, halo.py:658-815), training or evaluation by
    the module's mode: a halo exchange of the activations in every layer,
    BatchNorm statistics summed across ranks.  Returns ``(z, aux)``, aux
    with the MoE regularizer (a global mean: the ranks' sums over their
    row counts) and each MoE layer's router statistics summed across
    ranks.

    sage layers aggregate on the fused kernels when ``lay_loc`` /
    ``lay_rem`` are given (edge types from ``edge_table`` through the
    layouts), else on the plain route (``ef_*`` of ``part``); gcn, gin and
    gat take their plain halo forms; MoE layers need ``part_rev``, the
    partition of the reversed edges.  bf16 compute (sage only) makes bf16
    exchanges; ``compute_dtype`` overrides the config's (the EMA teacher
    under ``teacher_bf16``).  Dropout and the Gumbel draws come from
    ``generator``, or ``gumbel`` (one [Nb, K] tensor an MoE layer).

    The edge dropout of the sage layers (module docstring): ``drop_hash=
    (seed, p)`` with ``gids`` on the fused route (one :class:`DropView` a
    layout for every layer), or ``keep_loc`` / ``keep_rem``, on the fused
    route or folded into the partition's masks on the plain one.
    ``stat_ranks`` (default ``ranks``) are the ranks BatchNorm's moments
    and the MoE terms are summed over."""
    cfg = encoder.cfg
    flags = list(encoder.flags)
    if cfg.backbone != "sage":
        lay_loc = lay_rem = None
    if any(flags) and part_rev is None:
        raise ValueError("MoE layers in halo mode need part_rev (a halo "
                         "partition of the reversed edge list)")
    if drop_hash is not None and lay_loc is None:
        raise ValueError("drop_hash needs the fused halo layouts; use "
                         "keep_loc/keep_rem on the plain halo path")
    drop = None
    if lay_loc is not None:
        drop = halo_drop_views(lay_loc, lay_rem, drop_hash, gids, keep_loc,
                               keep_rem)
    elif keep_loc is not None:
        part = dict(part, m_loc=part["m_loc"] & keep_loc.bool(),
                    m_rem=part["m_rem"] & keep_rem.bool())
    stat_ranks = ranks if stat_ranks is None else stat_ranks
    bf16 = (compute_dtype or cfg.compute_dtype) == "bfloat16"
    if bf16 and cfg.backbone != "sage":
        raise ValueError("compute_dtype=bfloat16 supports the sage backbone")
    z = x_local.to(torch.bfloat16 if bf16 else torch.float32)
    env_reg, stats, j = None, [], 0
    training = encoder.training
    for i, layer in enumerate(encoder.layers):
        if flags[i]:
            w, logits = encoder.route(
                j, z, None if gumbel is None else gumbel[j], generator)
            if training:
                log_pi = torch.log_softmax(logits, dim=-1)
                num = all_reduce_sum((w * log_pi).sum(-1).sum(), stat_ranks)
                rows = z.shape[0] * (1 if stat_ranks is None
                                     else stat_ranks.world)
                term = num / rows
                env_reg = term if env_reg is None else env_reg + term
            stats.append(_router_stats(i, w.detach(), node_mask,
                                       stat_ranks))
            z = halo_moe_sage_aggregate(z, part_rev, layer, w, ranks)
            j += 1
        elif cfg.backbone == "gcn":
            z = halo_gcn_apply(layer, z, part, ranks)
        elif cfg.backbone == "gin":
            z = halo_gin_apply(layer, z, part, ranks)
        elif cfg.backbone == "gat":
            z = halo_gat_apply(layer, z, part, ranks)
        else:
            ef = part.get("ef_loc")
            if ef is not None and ef.shape[-1] != z.shape[-1]:
                raise ValueError("edge feature dim must equal layer input "
                                 "dim")
            if lay_loc is not None:
                agg = halo_sage_aggregate_fused(
                    z, part, lay_loc, lay_rem, edge_table, ranks,
                    bf16_messages=cfg.fused_bf16_messages or bf16,
                    drop=drop).to(z.dtype)
            else:
                agg = halo_sage_aggregate(z, part, ranks)
            z = layer.lin_l(agg) + layer.lin_r(z)
        if cfg.normalize != "none":
            # the batch moments summed across ranks (JAX's axis_name)
            z = encoder.norms[i](z, node_mask, reduce=rank_sum(stat_ranks))
        if i < cfg.num_layers - 1:
            z = dropout(encoder._act(z), cfg.dropout, training=training,
                        generator=generator)
    env_reg = (env_reg / j if env_reg is not None
               else torch.zeros((), device=z.device))
    return z, {"env_reg": env_reg.float(), "moe_stats": stats}
