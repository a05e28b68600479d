"""Precomputed edge layouts for the fused aggregation kernels (counterpart of
``stemgnn_tpu/ops/edge_layout.py``).

Host-side, once per graph, in numpy: sort the COO edge list by receiver
(forward scatter) and by sender (backward scatter), record per-node-block
edge offsets (``block_ptr``) so a kernel walks each output block's
contiguous edge range, and, with ``hub_size > 0``, split the top
gather-frequency "hub" nodes off into dense count blocks (:class:`HubDense`).
The finished arrays become tensors on the requested device (pinned,
non-blocking copies off the CPU); the dense count blocks are built there
from small index arrays.

``gwin`` decides per direction (``use_gwin_r``/``use_gwin_s``, on the
layout and on each hub tail) whether the aggregation gathers its rows inside
the ``gathered_scatter_rows_sorted`` kernel instead of through an [E, D]
message tensor (:func:`_gwin_decide`).  The TPU kernel needed per-chunk
gather windows; the GPU kernel reads rows at any address, so the window
arrays (``gwin_lo_*``, ``gwin_nsub_*``) stay ``None`` and ``gwin_w`` 0.

Typed graphs (T > 1 edge types, T <= 32) get *typed virtual hubs* on the
forward side: a hub is a (sender, type) pair (``HubDense.hub_xe``).

Always ``None`` here: the masked kernel's x-windows (``win_*``; the GPU
``masked_scatter_rows_sorted`` reads the node block's own rows and needs
none).

``loc_split`` builds a per-direction local/stray split (:class:`LocSplit`,
JAX ``_build_loc_split``/``_build_merged_split``) where the whole
direction's gather gate is shut but the edges near their scatter block's
median gather key clear it: "auto" as JAX gates it (so never under the
H100 profile, whose gate is open on every graph), "on" forced.  A direction
with a hub block gets the split on its hub tail instead.

Port-only fields: ``plan_r``/``plan_s``, the :class:`RowPlan` of each
direction (the row walk of the GPU kernels), on every layout, hub tail and
split sub-layout; ``LocSplit.m_plan``, the plan of the merged order;
``HubDense.cnt_nz``/``sc_nz``, the nonzero pairs of the count blocks (the
pair-hash dropout's masks).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.graph import host_to_device, round_up
from stemgnn_tpu_torch.ops.chip_profile import ChipProfile, current_profile

# Edges per work item of the row walk at most: a longer row is cut into
# consecutive items whose f32 partial sums a second pass adds in order.
ROW_CHUNK = 256


@dataclasses.dataclass
class RowPlan:
    """The row walk of ``scatter_rows_sorted``,
    ``gathered_scatter_rows_sorted`` and ``masked_scatter_rows_sorted`` on
    the GPU over one direction of a layout, built once per graph on the host
    (:func:`row_plan`).

    The counted edges (``local_row`` in [0, 128) and inside their node
    block's ``block_ptr`` range) in a stable order by output row ``block *
    128 + local_row``: inside a row they keep the layout's order, so an
    unsplit row is summed in the order of the plain version's
    ``index_add_``.  Work item ``i`` is output row ``item_row[i]`` and plan
    positions ``[item_start[i], item_start[i + 1])``, at most ``chunk`` of
    them; every output row has at least one item (an empty row an empty
    one), so every row gets its epilogue.  A row longer than ``chunk`` is
    *split*: its items write f32 partial sums to slots ``item_slot`` (-1 on
    the items of unsplit rows), and the second pass sums split row
    ``split_row[k]``'s slots ``[split_ptr[k], split_ptr[k + 1])`` in item
    order and applies the epilogue."""
    pos: torch.Tensor                  # [E_cnt] int32 layout position
    item_row: torch.Tensor             # [I] int32
    item_start: torch.Tensor           # [I + 1] int32
    item_slot: torch.Tensor            # [I] int32
    split_row: torch.Tensor            # [S] int32
    split_ptr: torch.Tensor            # [S + 1] int32
    keys: Optional[torch.Tensor] = None     # [E_cnt] int32 keys[pos]
    senders: Optional[torch.Tensor] = None  # [E_cnt] int32 senders[pos]
    xe: Optional[torch.Tensor] = None       # [E_cnt] int32 xe[pos]
    # [E_cnt] int32 stray_idx[pos] of a merged LocSplit order, and the
    # stray rows it reads (max + 1)
    stray_idx: Optional[torch.Tensor] = None
    stray_rows: int = 0
    chunk: int = ROW_CHUNK
    num_slots: int = 0
    # the arrays it was built from, each with its version counter then; the
    # kernel wrappers refuse a plan that other arrays are passed beside
    sources: dict = dataclasses.field(default_factory=dict, repr=False)
    # launches over this plan by kernel name (the wrappers count them)
    launches: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_items(self) -> int:
        return self.item_row.shape[0]

    @property
    def num_split(self) -> int:
        return self.split_row.shape[0]

    def built_from(self, name: str, t) -> bool:
        """Whether ``t`` is (a view of) the unchanged array ``name`` that
        the plan was built from; both None counts as a match."""
        src = self.sources.get(name)
        if src is None or t is None:
            return src is None and t is None
        base, version = src
        return (t.device == base.device and t.data_ptr() == base.data_ptr()
                and t.numel() == base.numel() and base._version == version)


def _plan_arrays(local_row: np.ndarray, block_ptr: np.ndarray, chunk: int):
    """numpy work of :func:`row_plan`: (pos, item_row, item_start,
    item_slot, split_row, split_ptr), all int32."""
    lrow = np.asarray(local_row).reshape(-1).astype(np.int64)
    bp = np.asarray(block_ptr).astype(np.int64)
    n_pad = (bp.shape[0] - 1) * 128
    pos = np.arange(lrow.shape[0], dtype=np.int64)
    # the plain version's rule (ops.scatter._edge_rows)
    blk = np.searchsorted(bp, pos, side="right") - 1
    ok = (blk >= 0) & (pos < bp[-1]) & (lrow >= 0) & (lrow < 128)
    rows = blk[ok] * 128 + lrow[ok]
    order = np.argsort(rows, kind="stable")
    pos = pos[ok][order]
    deg = np.bincount(rows, minlength=n_pad)
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    n_it = np.maximum(1, -(-deg // chunk))
    item_row = np.repeat(np.arange(n_pad), n_it)
    first = np.concatenate([[0], np.cumsum(n_it)[:-1]])
    k = np.arange(item_row.shape[0]) - np.repeat(first, n_it)
    item_start = np.concatenate([row_ptr[item_row] + k * chunk,
                                 [pos.shape[0]]])
    split = n_it > 1
    in_split = split[item_row]
    item_slot = np.full(item_row.shape[0], -1, np.int64)
    item_slot[in_split] = np.arange(int(in_split.sum()))
    split_row = np.nonzero(split)[0]
    split_ptr = np.concatenate([[0], np.cumsum(n_it[split])])
    return tuple(a.astype(np.int32) for a in (pos, item_row, item_start,
                                              item_slot, split_row,
                                              split_ptr))


def row_plan(local_row, block_ptr, keys=None, senders=None, xe=None, *,
             stray_idx=None, stray_off=None, stray_cnt=None,
             chunk: int = ROW_CHUNK) -> RowPlan:
    """The :class:`RowPlan` of one direction: ``local_row`` [1, E_pad] and
    ``block_ptr`` [N_pad/128 + 1] int32 tensors, and the per-edge arrays
    the kernels read in row order (``keys`` for kernel 2, ``senders`` for
    kernel 3, ``xe`` for either, ``stray_idx`` for kernel 2's merged
    LocSplit), each [E_pad] or [1, E_pad] int32.  ``stray_off`` /
    ``stray_cnt`` (the TPU kernel's per-chunk metadata, which no GPU kernel
    reads) come with ``stray_idx`` and are checked against it here.  Built
    with numpy on the host; the plan's tensors live on ``local_row``'s
    device."""
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if (stray_idx is None) != (stray_off is None) \
            or (stray_off is None) != (stray_cnt is None):
        raise ValueError("stray_idx, stray_off and stray_cnt come together")
    arrays = dict(local_row=local_row, block_ptr=block_ptr, keys=keys,
                  senders=senders, xe=xe, stray_idx=stray_idx,
                  stray_off=stray_off, stray_cnt=stray_cnt)
    host = {k: None if t is None else t.detach().cpu().numpy()
            for k, t in arrays.items()}
    plan = _plan_from_numpy(host, chunk, local_row.device)
    plan.sources = {k: (t, t._version) for k, t in arrays.items()
                    if t is not None}
    return plan


def _plan_from_numpy(host: dict, chunk: int, device) -> RowPlan:
    pos, item_row, item_start, item_slot, split_row, split_ptr = \
        _plan_arrays(host["local_row"], host["block_ptr"], chunk)
    stray_rows = 0
    if host.get("stray_idx") is not None:
        stray_rows = check_stray_metadata(host["stray_idx"],
                                          host["stray_off"],
                                          host["stray_cnt"])

    def t(a):
        return host_to_device(np.ascontiguousarray(a), device)

    def permuted(name):
        a = host.get(name)
        return None if a is None else t(
            np.asarray(a).reshape(-1)[pos].astype(np.int32))
    return RowPlan(pos=t(pos), item_row=t(item_row), item_start=t(item_start),
                   item_slot=t(item_slot), split_row=t(split_row),
                   split_ptr=t(split_ptr), keys=permuted("keys"),
                   senders=permuted("senders"), xe=permuted("xe"),
                   stray_idx=permuted("stray_idx"), stray_rows=stray_rows,
                   chunk=chunk, num_slots=int(split_ptr[-1]))


def check_stray_metadata(stray_idx, stray_off, stray_cnt) -> int:
    """Check the TPU kernel's per-chunk stray metadata against the per-edge
    ranks (numpy or CPU tensors): chunk c of ``E_pad / C`` edges holds
    ``stray_cnt[c]`` stray edges (``stray_idx >= 0``), each with a rank in
    ``[stray_off[c], stray_off[c] + E_pad / C)`` (the one buffer slice the
    TPU kernel reads a chunk).  Returns the stray rows the ranks read (max
    rank + 1, 0 without strays); raises ValueError on a mismatch."""
    sidx = np.asarray(stray_idx).reshape(-1).astype(np.int64)
    soff = np.asarray(stray_off).reshape(-1).astype(np.int64)
    scnt = np.asarray(stray_cnt).reshape(-1).astype(np.int64)
    c = soff.shape[0]
    if scnt.shape[0] != c or c == 0 or sidx.shape[0] % c:
        raise ValueError(f"stray_off / stray_cnt must be [C] with C "
                         f"dividing E_pad = {sidx.shape[0]}, got "
                         f"{soff.shape} / {scnt.shape}")
    eb = sidx.shape[0] // c
    chunk_of = np.arange(sidx.shape[0]) // eb
    stray = sidx >= 0
    if not np.array_equal(np.bincount(chunk_of[stray], minlength=c), scnt):
        raise ValueError("stray_cnt does not count the stray edges of each "
                         "chunk")
    rel = sidx[stray] - soff[chunk_of[stray]]
    if rel.size and (rel.min() < 0 or rel.max() >= eb):
        raise ValueError("a stray rank lies outside its chunk's slice "
                         "[stray_off, stray_off + E_pad / C)")
    return int(sidx.max(initial=-1)) + 1


@dataclasses.dataclass
class HubDense:
    """Hub-dense decomposition of one scatter direction.

    On power-law graphs a few high-gather-frequency hub nodes source a large
    fraction of messages.  In the factored-relu path each message is a pure
    per-source row, so all hub contributions collapse into a dense matmul

        out_hub = CNT @ f(x[hub_ids]),   CNT[n, h] = #edges hub_h -> n

    and the remaining "tail" edges run through the scatter kernel over a
    tail-only sub-layout.  CNT is bf16, exact while every (node, hub)
    multiplicity is < 256 (checked while building).  The optional scatter-side
    block covers tail edges whose *scatter* key is a hub:

        out[sc_ids] += sc_cnt @ f(x)        sc_cnt[k, j] = #edges j -> sc_k

    Typed hubs (T in (1, 32] edge types) are (gather node, edge type)
    pairs: virtual hub k's dense operand row is f(x[hub_ids[k]] +
    T[hub_xe[k]]).  Forward direction only (the typed relu mask is per
    edge, so the backward has no per-source factoring) and without a
    scatter-side block.
    """
    hub_ids: torch.Tensor              # [H_pad] int64 (padding -> row 0)
    cnt: torch.Tensor                  # [N_pad, H_pad] bf16
    tail: "EdgeLayout"                 # sub-layout over the non-hub edges
    sc_ids: Optional[torch.Tensor] = None   # [H2_pad] int64
    sc_cnt: Optional[torch.Tensor] = None   # [H2_pad, N_pad] bf16
    hub_xe: Optional[torch.Tensor] = None   # [H_pad] int64 type per virtual
                                            #   hub (typed hubs), else None
    hub_size: int = 2048
    coverage: float = 0.0
    sc_size: int = 0
    sc_coverage: float = 0.0
    # port-only: the (row, column) pairs where ``cnt`` / ``sc_cnt`` are not
    # zero, each pair once ([P] int64 each): the pair-hash dropout masks the
    # blocks there (ops.fused_sage.masked_hub_blocks)
    cnt_nz: Optional[tuple] = None
    sc_nz: Optional[tuple] = None


@dataclasses.dataclass
class LocSplit:
    """Per-direction local/stray edge split (JAX ``LocSplit``).

    Edges whose gather key lies within ``loc_reach`` rows of their scatter
    block's median gather key go into the ``loc`` sub-layout (in-kernel
    gather), the rest into the ``stray`` sub-layout (gathered messages
    through ``scatter_rows_sorted``).  The two kernels chain through the
    epilogue's additive ``init``: the stray sums feed the local call.  Only
    the named direction of each sub-layout is used.

    The ``m_*`` fields are the single-launch variant (``loc_merge``): all
    edges in one (scatter block, stray class, gather key) order; stray edges
    carry the sentinel key and a stray rank ``m_sidx`` into the compact
    buffer of rows ``x[m_stray_keys]``.  ``m_win_*``, ``m_gwin_w``,
    ``m_soff`` and ``m_scnt`` are the TPU kernel's window and DMA metadata,
    kept equal to JAX's; ``m_plan`` (port only) is the merged order's
    :class:`RowPlan` with the ranks in row order."""
    loc: "EdgeLayout"
    stray: "EdgeLayout"
    m_keys: Optional[torch.Tensor] = None       # [1, E_pad] int32 (stray:
                                                #   the sentinel)
    m_lrow: Optional[torch.Tensor] = None       # [1, E_pad] int32
    m_block_ptr: Optional[torch.Tensor] = None  # [N_pad/NB + 1] int32
    m_win_lo: Optional[torch.Tensor] = None     # [C] int32 (local edges)
    m_win_nsub: Optional[torch.Tensor] = None   # [C] int32
    m_sidx: Optional[torch.Tensor] = None       # [1, E_pad] int32 (-1 local)
    m_soff: Optional[torch.Tensor] = None       # [C] int32
    m_scnt: Optional[torch.Tensor] = None       # [C] int32
    m_stray_keys: Optional[torch.Tensor] = None  # [S_pad] int32
    loc_frac: float = 0.0
    m_gwin_w: int = 0
    m_plan: Optional[RowPlan] = None


@dataclasses.dataclass
class EdgeLayout:
    """Static per graph.  Edge arrays are padded to a multiple of
    ``edge_chunk``; padded slots carry the sentinel ``num_nodes_padded`` in
    both endpoints and mask False."""
    # receiver-sorted (forward scatter)
    senders_r: torch.Tensor            # [E_pad] int32
    receivers_r: torch.Tensor          # [E_pad] int32
    xe_r: Optional[torch.Tensor]       # [E_pad] int32 edge-type ids or None
    mask_r: torch.Tensor               # [E_pad] bool
    block_ptr_r: torch.Tensor          # [N_pad/NB + 1] int32
    lrow_r: torch.Tensor               # [1, E_pad] int32: receiver mod NB,
                                       #   NB (sentinel) for padding
    # sender-sorted (backward scatter)
    senders_s: torch.Tensor
    receivers_s: torch.Tensor
    xe_s: Optional[torch.Tensor]
    mask_s: torch.Tensor
    block_ptr_s: torch.Tensor
    lrow_s: torch.Tensor
    in_degree: torch.Tensor            # [N_pad] float32 valid in-edges
    # sender-sorted position -> receiver-sorted position, and sorted
    # position -> original edge index per direction (runtime per-edge
    # values of the training path permute through these)
    perm_s2r: Optional[torch.Tensor] = None
    perm_r2o: Optional[torch.Tensor] = None
    perm_s2o: Optional[torch.Tensor] = None
    # the masked kernel's x-windows and the TPU gather windows have no GPU
    # counterpart: always None here (see module doc)
    win_lo_s: Optional[torch.Tensor] = None
    win_nsub_s: Optional[torch.Tensor] = None
    gwin_lo_r: Optional[torch.Tensor] = None
    gwin_nsub_r: Optional[torch.Tensor] = None
    gwin_lo_s: Optional[torch.Tensor] = None
    gwin_nsub_s: Optional[torch.Tensor] = None
    hub_r: Optional[HubDense] = None
    hub_s: Optional[HubDense] = None
    # local/stray splits per direction (build_edge_layout loc_split)
    split_r: Optional[LocSplit] = None
    split_s: Optional[LocSplit] = None
    node_block: int = 128
    edge_chunk: int = 512
    win_w: int = 0
    gwin_w: int = 0
    use_gwin_r: bool = False
    use_gwin_s: bool = False
    # the GPU row walk of each direction (port only, no JAX counterpart):
    # receiver order with keys = senders_r, sender order with keys =
    # receivers_s and the senders; each with its direction's xe
    plan_r: Optional[RowPlan] = None
    plan_s: Optional[RowPlan] = None

    @property
    def num_edges_padded(self) -> int:
        return self.senders_r.shape[0]

    @property
    def num_nodes_padded(self) -> int:
        return self.in_degree.shape[0]


def _block_ptr(sorted_keys: np.ndarray, n_pad: int, nb: int) -> np.ndarray:
    # keys are BLOCK-grouped (within-block order is by the gather key), so
    # searchsorted compares block indices, not raw node ids
    blocks = np.asarray(sorted_keys, np.int64) // nb
    bounds = np.arange(0, n_pad // nb + 1)
    return np.searchsorted(blocks, bounds, side="left").astype(np.int32)


def _chunk_windows(keys: np.ndarray, mask: np.ndarray, edge_chunk: int,
                   sentinel: int):
    """Per-chunk node-id window of ``keys``: (lo [C] 8-aligned, span [C]).
    Only the TPU profile's gate reads them."""
    num_chunks = keys.shape[0] // edge_chunk
    k = keys.reshape(num_chunks, edge_chunk)
    m = mask.reshape(num_chunks, edge_chunk)
    valid = m.any(axis=1)
    lo = np.where(valid, np.where(m, k, np.int64(sentinel)).min(axis=1), 0)
    lo = lo - lo % 8
    hi = np.where(valid, np.where(m, k, -1).max(axis=1), -1)
    span = np.maximum(hi - lo + 1, 0)
    return lo.astype(np.int64), span.astype(np.int64)


def _gwin_decide(keys_r, mask_r, keys_s, mask_s, num_nodes_padded: int,
                 edge_chunk: int, feat_dim: int, prof: ChipProfile):
    """Gate of the in-kernel row gather, per direction: ``(use_r, use_s)``.
    ``keys_*`` are the gather-side ids in each direction's scatter order.
    The gather route it replaces costs per valid edge a row gather + the
    [E, D] bf16 message write + the scatter kernel's re-read.

    On a profile that gathers rows inside the kernel (the GPU) the in-kernel
    route does the same row reads and skips the write and re-read, so it
    opens wherever there is an edge.  On the TPU profile the JAX package's
    formula stays (JAX ``_gwin_decide``): sequential window DMAs + one-hot
    matrix products over the chunks' gather windows, one window width shared
    by both directions, must beat the gather route by 20%."""
    d = feat_dim
    n_valid = int(mask_r.sum())
    row = prof.gather_fixed_s + d * 2.0 / prof.gather_bps
    gather = n_valid * (row + d * 2.0 / prof.stream_bps
                        + d * 2.0 / prof.seq_bps)
    if prof.row_gather_in_kernel:
        return (n_valid * row < gather,) * 2
    spans = [_chunk_windows(k, m, edge_chunk, num_nodes_padded)[1]
             for k, m in ((keys_r, mask_r), (keys_s, mask_s))]
    gmax = max(int(sp.max(initial=0)) for sp in spans)
    gwin_w = min(max(round_up(gmax, 128), 128), 512, num_nodes_padded)

    def windowed(span):
        nsub = np.where(span > 0, -(-span // gwin_w), 0)
        return float(nsub.sum()) * (gwin_w * d * 2.0 / prof.seq_bps
                                    + 2.0 * edge_chunk * gwin_w * d
                                    / prof.mxu_bf16_flops)
    return tuple(windowed(sp) * 1.2 < gather for sp in spans)


def _per_edge_gather_saving(d: int, prof: ChipProfile) -> float:
    """Modeled cost a hub-covered edge avoids: the row gather + the [E, D]
    bf16 message write + the kernel's re-read."""
    return (prof.gather_fixed_s + d * 2.0 / prof.gather_bps
            + d * 2.0 / prof.stream_bps + d * 2.0 / prof.seq_bps)


def _auto_hub_size(freq: np.ndarray, cap: int, num_nodes_padded: int,
                   d: int, prof: ChipProfile) -> int:
    """Pick the hub size minimizing modeled cost: dense-block cost grows
    linearly in H while coverage is concave.  ``freq`` is the (unsorted)
    gather-key frequency array; returns 0 when no H wins with >= 20%
    margin."""
    csum = np.cumsum(np.sort(freq)[::-1])
    per_edge = _per_edge_gather_saving(d, prof)
    best_h, best_score = 0, 0.0
    cap = min(cap, len(csum))
    grid = sorted(set(list(range(128, cap + 1, 128)) + [cap]) - {0})
    for h in grid:
        h_pad = round_up(h, 128)
        # the effective matrix rate saturates with the contraction size
        mxu_eff = prof.mxu_bf16_flops * min(1.0, h_pad / 512.0)
        dense = (2.0 * num_nodes_padded * h_pad * d / mxu_eff
                 + num_nodes_padded * h_pad * 2.0 / prof.hbm_bps)
        score = float(csum[h - 1]) * per_edge - 1.2 * dense
        if score > best_score:
            best_h, best_score = h, score
    return best_h


def _dense_counts(rows: np.ndarray, cols: np.ndarray, shape, device):
    """[R, C] bf16 count block built on ``device`` from index arrays (one
    accumulate), so only the small int arrays cross to the device."""
    cnt = torch.zeros(shape, dtype=torch.float32, device=device)
    if rows.size:
        r = host_to_device(rows, device)
        c = host_to_device(cols, device)
        cnt.index_put_((r, c), torch.ones(r.shape[0], device=device),
                       accumulate=True)
    return cnt.to(torch.bfloat16)


def _pairs(keys: np.ndarray, width: int, device):
    """(rows, cols) int64 tensors of unique ``row * width + col`` keys."""
    return (host_to_device(keys // width, device),
            host_to_device(keys % width, device))


def _build_loc_split(senders, receivers, edge_mask, xe_ids, direction: str,
                     enabled_already: bool, num_nodes_padded: int,
                     node_block: int, edge_chunk: int, feat_dim_hint: int,
                     loc_split: str, loc_reach: int, loc_merge: bool,
                     prof: ChipProfile, device) -> Optional[LocSplit]:
    """One direction's LocSplit (JAX ``_build_loc_split``), or None when it
    would not pay: the whole direction's gate is open already, fewer than
    80% of the edges are local, or the local subset's own gate is shut.
    ``loc_split="on"`` forces it past every gate."""
    force = loc_split == "on"
    if enabled_already and not force:
        return None
    scatter_key, gather_key = ((receivers, senders) if direction == "r"
                               else (senders, receivers))
    # "local" is measured from each scatter block's median gather key
    blk = scatter_key.astype(np.int64) // node_block
    g64 = gather_key.astype(np.int64)
    valid = np.nonzero(edge_mask)[0]
    order = valid[np.lexsort((g64[valid], blk[valid]))]
    sb, sg = blk[order], g64[order]
    nblocks = num_nodes_padded // node_block + 1
    lo = np.searchsorted(sb, np.arange(nblocks))
    hi = np.searchsorted(sb, np.arange(nblocks), side="right")
    med = np.zeros(nblocks, np.int64)
    nz = hi > lo
    if len(sg):
        mid = np.minimum((lo + hi) // 2, len(sg) - 1)
        med[nz] = sg[mid[nz]]
    dist = g64 - med[np.minimum(blk, nblocks - 1)]
    local = edge_mask & (np.abs(dist) <= loc_reach)
    frac = float(local.sum()) / max(int(edge_mask.sum()), 1)
    # the stray pass amortizes only when strays are a small minority
    if not force and frac < 0.8:
        return None
    stray_mask = edge_mask & ~local
    sub_kw = dict(node_block=node_block, edge_chunk=edge_chunk,
                  feat_dim_hint=feat_dim_hint, profile=prof, device=device)
    loc_lay = build_edge_layout(
        senders[local], receivers[local], num_nodes_padded,
        xe_ids=None if xe_ids is None else xe_ids[local],
        gwin="on" if force else "auto", **sub_kw)
    if not (loc_lay.use_gwin_r if direction == "r" else loc_lay.use_gwin_s):
        return None
    stray_lay = build_edge_layout(
        senders[stray_mask], receivers[stray_mask], num_nodes_padded,
        xe_ids=None if xe_ids is None else xe_ids[stray_mask],
        gwin="off", **sub_kw)
    merged = {}
    if loc_merge:
        merged = _build_merged_split(scatter_key, gather_key, local,
                                     stray_mask, num_nodes_padded,
                                     node_block, edge_chunk)
        host = dict(local_row=merged["m_lrow"],
                    block_ptr=merged["m_block_ptr"], keys=merged["m_keys"],
                    stray_idx=merged["m_sidx"], stray_off=merged["m_soff"],
                    stray_cnt=merged["m_scnt"])
        plan = (_plan_from_numpy(host, ROW_CHUNK, device)
                if node_block == 128 else None)
        merged = {k: host_to_device(np.ascontiguousarray(v), device)
                  if isinstance(v, np.ndarray) else v
                  for k, v in merged.items()}
        if plan is not None:
            names = dict(local_row="m_lrow", block_ptr="m_block_ptr",
                         keys="m_keys", stray_idx="m_sidx",
                         stray_off="m_soff", stray_cnt="m_scnt")
            plan.sources = {k: (merged[v], merged[v]._version)
                            for k, v in names.items()}
        merged["m_plan"] = plan
    return LocSplit(loc=loc_lay, stray=stray_lay, loc_frac=frac, **merged)


def _build_merged_split(scatter_key, gather_key, local, stray_mask,
                        num_nodes_padded: int, node_block: int,
                        edge_chunk: int) -> dict:
    """Single-launch LocSplit metadata (JAX ``_build_merged_split``), numpy:
    all valid edges in one (scatter block, stray class, gather key) order.
    Local edges keep their gather keys; stray edges carry the sentinel key
    and consecutive ranks, each chunk's first rank 8-aligned (the TPU
    kernel's slice alignment; the gaps are dead buffer rows)."""
    sentinel = num_nodes_padded
    valid = local | stray_mask
    idx = np.nonzero(valid)[0]
    blk = scatter_key[idx].astype(np.int64) // node_block
    cls = stray_mask[idx].astype(np.int64)
    g = gather_key[idx].astype(np.int64)
    idx = idx[np.lexsort((g, cls, blk))]
    e = len(idx)
    e_pad = round_up(max(e, edge_chunk), edge_chunk)
    num_chunks = e_pad // edge_chunk

    sk = np.full(e_pad, sentinel, np.int64)
    sk[:e] = scatter_key[idx]
    gk = np.full(e_pad, sentinel, np.int64)
    gk[:e] = gather_key[idx]
    is_stray = np.zeros(e_pad, bool)
    is_stray[:e] = stray_mask[idx]
    is_local = np.zeros(e_pad, bool)
    is_local[:e] = ~stray_mask[idx]

    lrow = np.where(is_local | is_stray, sk % node_block,
                    node_block).astype(np.int32)[None, :]
    block_ptr = _block_ptr(sk, num_nodes_padded, node_block)

    # window metadata over the local edges only
    keys = np.where(is_local, gk, sentinel).astype(np.int32)
    lo, span = _chunk_windows(keys, is_local, edge_chunk, sentinel)
    max_span = int(span.max()) if len(span) else 0
    gwin_w = min(max(round_up(max_span, 128), 128), 512, num_nodes_padded)
    nsub = np.where(span > 0, -(-span // gwin_w), 0).astype(np.int32)

    ch = np.arange(e_pad) // edge_chunk
    scnt = np.bincount(ch[is_stray], minlength=num_chunks).astype(np.int32)
    soff = np.zeros(num_chunks, np.int32)
    sidx = np.full(e_pad, -1, np.int32)
    next_rank = 0
    for c in np.nonzero(scnt)[0]:
        next_rank = -(-next_rank // 8) * 8
        soff[c] = next_rank
        rows = np.nonzero(is_stray[c * edge_chunk:(c + 1) * edge_chunk])[0]
        sidx[c * edge_chunk + rows] = next_rank + np.arange(len(rows))
        next_rank += len(rows)
    stray_keys = np.zeros(round_up(next_rank + edge_chunk, 8), np.int32)
    stray_keys[sidx[is_stray]] = gk[is_stray].astype(np.int32)

    return dict(m_keys=keys[None, :], m_lrow=lrow, m_block_ptr=block_ptr,
                m_win_lo=lo.astype(np.int32), m_win_nsub=nsub,
                m_sidx=sidx[None, :], m_soff=soff, m_scnt=scnt,
                m_stray_keys=stray_keys, m_gwin_w=gwin_w)


def _build_hub_dense(senders, receivers, edge_mask, gather_by: str,
                     num_nodes_padded: int, hub_size: int, node_block: int,
                     edge_chunk: int, min_coverage: float, tail_e_pad_to: int,
                     feat_dim_hint: int, sc_hub_size: int, xe_ids,
                     gwin: str, prof: ChipProfile, device,
                     num_edge_types: int = 1, loc_split: str = "off",
                     loc_reach: int = 256) -> Optional[HubDense]:
    """Hub-dense decomposition for one direction.  ``gather_by`` names which
    endpoint the gather indexes (the scatter key is the other one): the
    forward scatters by receiver and gathers senders.

    Typed mode (``num_edge_types`` in (1, 32] with ``xe_ids``): hubs are
    (gather node, edge type) pairs, ``hub_xe`` their types; the receiver
    side and T > 32 get None, and there is no scatter-side block.

    With ``min_coverage >= 0`` (auto mode) ``hub_size`` is a cap and the
    break-even model picks H (0 = no hub pays); a negative ``min_coverage``
    bypasses all gating and keeps exactly ``hub_size``."""
    gidx = senders if gather_by == "sender" else receivers
    sidx = receivers if gather_by == "sender" else senders
    typed = num_edge_types > 1 and xe_ids is not None
    if typed and (num_edge_types > 32 or gather_by != "sender"):
        return None
    # the gather key: the node, or the (node, type) pair of a typed hub
    gkey = (gidx.astype(np.int64) * num_edge_types + xe_ids if typed
            else gidx)
    n_keys = num_nodes_padded * (num_edge_types if typed else 1)
    freq = np.bincount(gkey[edge_mask], minlength=n_keys)
    h = min(hub_size, n_keys)
    if min_coverage >= 0:
        h = _auto_hub_size(freq, h, num_nodes_padded, feat_dim_hint, prof)
        if h == 0:
            return None
    hub_keys = np.argsort(-freq, kind="stable")[:h]
    hub_ids = (hub_keys // num_edge_types if typed else hub_keys
               ).astype(np.int32)
    coverage = float(freq[hub_keys].sum()) / max(edge_mask.sum(), 1)
    if min_coverage >= 0 and coverage < min_coverage:
        return None
    rank = np.full(n_keys, 2 ** 30, np.int64)
    rank[hub_keys] = np.arange(h)
    edge_rank = rank[gkey]
    is_hub = edge_mask & (edge_rank < h)
    tail = edge_mask & ~is_hub

    # scatter-side hub block over the remaining edges, gated like the
    # gather side with the extra f(x) [N, D] pass charged to the dense cost
    sc_ids_pad = cnt_sc = sc_nz = None
    h2 = 0
    sc_cov = 0.0
    if sc_hub_size and not typed:   # typed messages are per (source, type):
        # the transposed block does not factor
        freq_sc = np.bincount(sidx[tail], minlength=num_nodes_padded)
        h2 = min(sc_hub_size, num_nodes_padded)
        if min_coverage >= 0:
            d = feat_dim_hint
            h2 = _auto_hub_size(freq_sc, h2, num_nodes_padded, d, prof)
            if h2:
                csum = np.cumsum(np.sort(freq_sc)[::-1])
                fx_pass = num_nodes_padded * d * 4.0 / prof.stream_bps
                h2_pad_est = round_up(h2, 128)
                dense = (2.0 * num_nodes_padded * h2_pad_est * d
                         / prof.mxu_bf16_flops
                         + num_nodes_padded * h2_pad_est * 2.0
                         / prof.hbm_bps)
                if (float(csum[h2 - 1]) * _per_edge_gather_saving(d, prof)
                        < 1.2 * (dense + fx_pass)):
                    h2 = 0
        sc_ids = np.argsort(-freq_sc, kind="stable")[:h2].astype(np.int32)
        sc_cov = float(freq_sc[sc_ids].sum()) / max(edge_mask.sum(), 1)
        if min_coverage >= 0 and sc_cov < min_coverage:
            h2 = 0
        if h2 == 0:
            sc_cov = 0.0
        else:
            sc_rank = np.full(num_nodes_padded, 2 ** 30, np.int64)
            sc_rank[sc_ids] = np.arange(h2)
            is_sc = tail & (sc_rank[sidx] < h2)
            sc_rows = sc_rank[sidx[is_sc]].astype(np.int64)
            sc_cols = gidx[is_sc].astype(np.int64)
            sc_pairs, mult = np.unique(sc_rows * (num_nodes_padded + 1)
                                       + sc_cols, return_counts=True)
            ok = mult.max(initial=0) < 256       # exact-bf16 counts
            if not ok:
                h2 = 0
                sc_cov = 0.0
            else:
                tail = tail & ~is_sc
                h2_pad = round_up(h2, 128)
                cnt_sc = _dense_counts(sc_rows, sc_cols,
                                       (h2_pad, num_nodes_padded), device)
                sc_nz = _pairs(sc_pairs, num_nodes_padded + 1, device)
                sc_ids_pad = np.zeros(h2_pad, np.int64)
                sc_ids_pad[:h2] = sc_ids

    h_pad = round_up(h, 128)
    hub_rows = sidx[is_hub].astype(np.int64)
    hub_cols = edge_rank[is_hub].astype(np.int64)
    hub_pairs, mult = np.unique(hub_rows * h_pad + hub_cols,
                                return_counts=True)
    if mult.max(initial=0) >= 256:
        # multiplicity beyond exact bf16 integers: skip the decomposition
        # rather than aggregate inexactly
        return None
    cnt = _dense_counts(hub_rows, hub_cols, (num_nodes_padded, h_pad), device)
    hub_ids_pad = np.zeros(h_pad, np.int64)
    hub_ids_pad[:h] = hub_ids
    hub_xe_pad = None
    if typed:
        hub_xe_pad = np.zeros(h_pad, np.int64)
        hub_xe_pad[:h] = hub_keys % num_edge_types

    tail_layout = build_edge_layout(
        senders[tail], receivers[tail], num_nodes_padded,
        xe_ids=None if xe_ids is None else xe_ids[tail],
        node_block=node_block, edge_chunk=edge_chunk,
        e_pad_to=tail_e_pad_to, feat_dim_hint=feat_dim_hint, gwin=gwin,
        loc_split=loc_split, loc_reach=loc_reach, profile=prof,
        device=device)
    return HubDense(
        hub_ids=host_to_device(hub_ids_pad, device), cnt=cnt,
        tail=tail_layout, hub_size=h, coverage=coverage,
        sc_ids=(None if sc_ids_pad is None
                else host_to_device(sc_ids_pad, device)),
        sc_cnt=cnt_sc, sc_size=h2, sc_coverage=sc_cov,
        cnt_nz=_pairs(hub_pairs, h_pad, device), sc_nz=sc_nz,
        hub_xe=(None if hub_xe_pad is None
                else host_to_device(hub_xe_pad, device)))


def build_edge_layout(senders, receivers, num_nodes_padded: int,
                      xe_ids=None, edge_mask=None, node_block: int = 128,
                      edge_chunk: int = 512, hub_size: int = 0,
                      hub_min_coverage: float = 0.1, e_pad_to: int = 0,
                      hub_tail_e_pad_to: int = 0, feat_dim_hint: int = 768,
                      sc_hub_size: int = 0, num_edge_types: int = 1,
                      gwin: str = "auto", loc_split: str = "off",
                      loc_reach: int = 256, loc_merge: bool = False,
                      profile: Optional[ChipProfile] = None,
                      device="cpu") -> EdgeLayout:
    """Host numpy prep, tensors on ``device`` out.  ``senders``/``receivers``
    may include padded slots (``edge_mask`` False); they are re-pointed at
    the sentinel and sorted last.

    ``hub_size > 0`` also builds hub-dense decompositions per direction
    (``hub_r``/``hub_s``).  ``gwin`` sets the in-kernel row gather of each
    direction, here and on the hub tails: "auto" by :func:`_gwin_decide`,
    "on" forced (tests), "off" never.  ``loc_split`` ("off", "auto",
    "on"), ``loc_reach`` and ``loc_merge`` build the local/stray splits
    (:class:`LocSplit`; only with ``gwin`` not "off"): on the layout's
    directions without a hub block, and on the hub tails.  ``profile``
    fixes the break-even models' device profile (default:
    :func:`~stemgnn_tpu_torch.ops.chip_profile.current_profile`)."""
    prof = profile or current_profile()
    if gwin not in ("auto", "on", "off"):
        raise ValueError(f"gwin must be auto, on or off, got {gwin!r}")
    if loc_split not in ("auto", "on", "off"):
        raise ValueError(f"loc_split must be auto, on or off, got "
                         f"{loc_split!r}")
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    e = senders.shape[0]
    edge_mask = (np.ones(e, bool) if edge_mask is None
                 else np.asarray(edge_mask, bool))
    if num_nodes_padded % node_block != 0:
        raise ValueError(f"num_nodes_padded {num_nodes_padded} not a multiple "
                         f"of node_block {node_block}")
    xe_ids = None if xe_ids is None else np.asarray(xe_ids, np.int32)

    sentinel = num_nodes_padded
    s = np.where(edge_mask, senders, sentinel)
    r = np.where(edge_mask, receivers, sentinel)
    e_pad = round_up(max(e, edge_chunk, e_pad_to), edge_chunk)

    def pack(sort_key, a, b, xe, mask):
        order = np.argsort(sort_key, kind="stable")
        out = {}
        for name, arr, fill in (("a", a[order], sentinel),
                                ("b", b[order], sentinel),
                                ("m", mask[order], False)):
            full = np.full(e_pad, fill, dtype=arr.dtype)
            full[:e] = arr
            out[name] = full
        out["xe"] = None
        if xe is not None:
            out["xe"] = np.zeros(e_pad, np.int32)
            out["xe"][:e] = xe[order]
        return out, order

    # Edges are grouped per scatter node block (block_ptr granularity) and
    # sorted by the gather-side node id inside each block: the kernels only
    # need the grouping, and the secondary key keeps consecutive edges on
    # ascending gather rows.
    kb = np.int64(num_nodes_padded + 2)
    fw, order_r = pack((r.astype(np.int64) // node_block) * kb + s,
                       s, r, xe_ids, edge_mask)
    bw, order_s = pack((s.astype(np.int64) // node_block) * kb + r,
                       s, r, xe_ids, edge_mask)

    inv_r = np.empty(e, np.int32)
    inv_r[order_r] = np.arange(e, dtype=np.int32)
    perm = np.full(e_pad, e_pad - 1, np.int32)   # padded slots -> padded slot
    perm[:e] = inv_r[order_s]

    def sorted_to_orig(order):
        out = np.full(e_pad, max(min(e, e_pad - 1), 0), np.int32)
        out[:e] = order
        return out

    def lrow(keys, mask):
        # local row within the owning node block; the sentinel node_block
        # never matches a block row, masking padded edges
        return np.where(mask, keys % node_block,
                        node_block).astype(np.int32)[None, :]

    deg = np.zeros(num_nodes_padded, np.float32)
    np.add.at(deg, receivers[edge_mask], 1.0)

    use_gwin = (False, False)
    if gwin == "on":
        use_gwin = (True, True)
    elif gwin == "auto":
        use_gwin = _gwin_decide(fw["a"], fw["m"], bw["b"], bw["m"],
                                num_nodes_padded, edge_chunk, feat_dim_hint,
                                prof)

    hub_r = hub_s = None
    if hub_size:
        hub_kw = dict(num_nodes_padded=num_nodes_padded, hub_size=hub_size,
                      node_block=node_block, edge_chunk=edge_chunk,
                      min_coverage=hub_min_coverage,
                      tail_e_pad_to=hub_tail_e_pad_to,
                      feat_dim_hint=feat_dim_hint, sc_hub_size=sc_hub_size,
                      xe_ids=xe_ids, gwin=gwin, prof=prof, device=device,
                      num_edge_types=num_edge_types, loc_split=loc_split,
                      loc_reach=loc_reach)
        hub_r = _build_hub_dense(senders, receivers, edge_mask, "sender",
                                 **hub_kw)
        hub_s = _build_hub_dense(senders, receivers, edge_mask, "receiver",
                                 **hub_kw)

    # a direction with a hub block gets its split on the hub tail instead
    split = {"r": None, "s": None}
    if loc_split != "off" and gwin != "off":
        for order, hub in (("r", hub_r), ("s", hub_s)):
            if hub is None:
                split[order] = _build_loc_split(
                    senders, receivers, edge_mask, xe_ids, order,
                    bool(use_gwin[0 if order == "r" else 1]),
                    num_nodes_padded, node_block, edge_chunk, feat_dim_hint,
                    loc_split, loc_reach, loc_merge, prof, device)

    def t(a):
        return None if a is None else host_to_device(
            np.ascontiguousarray(a), device)

    host = dict(lrow_r=lrow(fw["b"], fw["m"]),
                block_ptr_r=_block_ptr(fw["b"], num_nodes_padded, node_block),
                lrow_s=lrow(bw["a"], bw["m"]),
                block_ptr_s=_block_ptr(bw["a"], num_nodes_padded, node_block))
    lay = EdgeLayout(
        senders_r=t(fw["a"]), receivers_r=t(fw["b"]), xe_r=t(fw["xe"]),
        mask_r=t(fw["m"]), block_ptr_r=t(host["block_ptr_r"]),
        lrow_r=t(host["lrow_r"]),
        senders_s=t(bw["a"]), receivers_s=t(bw["b"]), xe_s=t(bw["xe"]),
        mask_s=t(bw["m"]), block_ptr_s=t(host["block_ptr_s"]),
        lrow_s=t(host["lrow_s"]),
        in_degree=t(deg), perm_s2r=t(perm),
        perm_r2o=t(sorted_to_orig(order_r)),
        perm_s2o=t(sorted_to_orig(order_s)),
        hub_r=hub_r, hub_s=hub_s, split_r=split["r"], split_s=split["s"],
        node_block=node_block, edge_chunk=edge_chunk,
        use_gwin_r=bool(use_gwin[0]), use_gwin_s=bool(use_gwin[1]))
    if node_block == 128:
        # from the host arrays (no copy back from the device)
        for order, per_edge in (
                ("r", dict(keys=(fw["a"], lay.senders_r),
                           xe=(fw["xe"], lay.xe_r))),
                ("s", dict(keys=(bw["b"], lay.receivers_s),
                           senders=(bw["a"], lay.senders_s),
                           xe=(bw["xe"], lay.xe_s)))):
            srcs = dict(local_row=(host["lrow_" + order],
                                   getattr(lay, "lrow_" + order)),
                        block_ptr=(host["block_ptr_" + order],
                                   getattr(lay, "block_ptr_" + order)),
                        **per_edge)
            plan = _plan_from_numpy({k: a for k, (a, _) in srcs.items()},
                                    ROW_CHUNK, device)
            plan.sources = {k: (v, v._version) for k, (_, v) in srcs.items()
                            if v is not None}
            setattr(lay, "plan_" + order, plan)
    return lay


def gwin_gate(senders, receivers, num_nodes_padded: int, edge_mask=None,
              feat_dim_hint: int = 768,
              profile: Optional[ChipProfile] = None):
    """``(use_gwin_r, use_gwin_s)`` that ``build_edge_layout(gwin="auto")``
    would give these edges.  On a profile that gathers rows inside the
    kernel no layout is built: the gate reads only the edge count."""
    prof = profile or current_profile()
    mask = (np.ones(len(senders), bool) if edge_mask is None
            else np.asarray(edge_mask, bool))
    if prof.row_gather_in_kernel:
        return _gwin_decide(None, mask, None, mask, num_nodes_padded, 512,
                            feat_dim_hint, prof)
    lay = build_edge_layout(senders, receivers, num_nodes_padded,
                            edge_mask=mask, feat_dim_hint=feat_dim_hint,
                            profile=prof)
    return lay.use_gwin_r, lay.use_gwin_s

