"""Precomputed edge layouts for the fused aggregation kernels (counterpart of
``stemgnn_tpu/ops/edge_layout.py``).

Host-side, once per graph, in numpy: sort the COO edge list by receiver
(forward scatter) and by sender (backward scatter), record per-node-block
edge offsets (``block_ptr``) so a kernel walks each output block's
contiguous edge range, and, with ``hub_size > 0``, split the top
gather-frequency "hub" nodes off into dense count blocks (:class:`HubDense`).
The finished arrays become tensors on the requested device; the dense count
blocks are built there from small index arrays.

``gwin`` decides per direction (``use_gwin_r``/``use_gwin_s``, on the
layout and on each hub tail) whether the aggregation gathers its rows inside
the ``gathered_scatter_rows_sorted`` kernel instead of through an [E, D]
message tensor (:func:`_gwin_decide`).  The TPU kernel needed per-chunk
gather windows; the GPU kernel reads rows at any address, so the window
arrays (``gwin_lo_*``, ``gwin_nsub_*``) stay ``None`` and ``gwin_w`` 0.

Not ported yet, and so always ``None`` here: the local/stray splits
(``split_*``, JAX ``_build_loc_split``/``_build_merged_split``) and the
masked kernel's x-windows (``win_*``, for ``masked_scatter_rows_sorted``).
Typed (T > 1) hub blocks come with the typed-edge slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.graph import round_up
from stemgnn_tpu_torch.ops.chip_profile import ChipProfile, current_profile


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
    """
    hub_ids: torch.Tensor              # [H_pad] int64 (padding -> row 0)
    cnt: torch.Tensor                  # [N_pad, H_pad] bf16
    tail: "EdgeLayout"                 # sub-layout over the non-hub edges
    sc_ids: Optional[torch.Tensor] = None   # [H2_pad] int64
    sc_cnt: Optional[torch.Tensor] = None   # [H2_pad, N_pad] bf16
    hub_size: int = 2048
    coverage: float = 0.0
    sc_size: int = 0
    sc_coverage: float = 0.0


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
    # masked-kernel x-windows (not ported) and the TPU gather windows (no
    # GPU counterpart): always None here (see module doc)
    win_lo_s: Optional[torch.Tensor] = None
    win_nsub_s: Optional[torch.Tensor] = None
    gwin_lo_r: Optional[torch.Tensor] = None
    gwin_nsub_r: Optional[torch.Tensor] = None
    gwin_lo_s: Optional[torch.Tensor] = None
    gwin_nsub_s: Optional[torch.Tensor] = None
    hub_r: Optional[HubDense] = None
    hub_s: Optional[HubDense] = None
    split_r: Optional[object] = None
    split_s: Optional[object] = None
    node_block: int = 128
    edge_chunk: int = 512
    win_w: int = 0
    gwin_w: int = 0
    use_gwin_r: bool = False
    use_gwin_s: bool = False

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
        r = torch.from_numpy(rows).to(device)
        c = torch.from_numpy(cols).to(device)
        cnt.index_put_((r, c), torch.ones(r.shape[0], device=device),
                       accumulate=True)
    return cnt.to(torch.bfloat16)


def _build_hub_dense(senders, receivers, edge_mask, gather_by: str,
                     num_nodes_padded: int, hub_size: int, node_block: int,
                     edge_chunk: int, min_coverage: float, tail_e_pad_to: int,
                     feat_dim_hint: int, sc_hub_size: int, xe_ids,
                     gwin: str, prof: ChipProfile,
                     device) -> Optional[HubDense]:
    """Hub-dense decomposition for one direction.  ``gather_by`` names which
    endpoint the gather indexes (the scatter key is the other one): the
    forward scatters by receiver and gathers senders.

    With ``min_coverage >= 0`` (auto mode) ``hub_size`` is a cap and the
    break-even model picks H (0 = no hub pays); a negative ``min_coverage``
    bypasses all gating and keeps exactly ``hub_size``."""
    gidx = senders if gather_by == "sender" else receivers
    sidx = receivers if gather_by == "sender" else senders
    freq = np.bincount(gidx[edge_mask], minlength=num_nodes_padded)
    h = min(hub_size, num_nodes_padded)
    if min_coverage >= 0:
        h = _auto_hub_size(freq, h, num_nodes_padded, feat_dim_hint, prof)
        if h == 0:
            return None
    hub_ids = np.argsort(-freq, kind="stable")[:h].astype(np.int32)
    coverage = float(freq[hub_ids].sum()) / max(edge_mask.sum(), 1)
    if min_coverage >= 0 and coverage < min_coverage:
        return None
    rank = np.full(num_nodes_padded, 2 ** 30, np.int64)
    rank[hub_ids] = np.arange(h)
    edge_rank = rank[gidx]
    is_hub = edge_mask & (edge_rank < h)
    tail = edge_mask & ~is_hub

    # scatter-side hub block over the remaining edges, gated like the
    # gather side with the extra f(x) [N, D] pass charged to the dense cost
    sc_ids_pad = cnt_sc = None
    h2 = 0
    sc_cov = 0.0
    if sc_hub_size:
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
            ok = True
            if sc_rows.size:
                _, mult = np.unique(sc_rows * (num_nodes_padded + 1)
                                    + sc_cols, return_counts=True)
                ok = mult.max(initial=0) < 256   # exact-bf16 counts
            if not ok:
                h2 = 0
                sc_cov = 0.0
            else:
                tail = tail & ~is_sc
                h2_pad = round_up(h2, 128)
                cnt_sc = _dense_counts(sc_rows, sc_cols,
                                       (h2_pad, num_nodes_padded), device)
                sc_ids_pad = np.zeros(h2_pad, np.int64)
                sc_ids_pad[:h2] = sc_ids

    h_pad = round_up(h, 128)
    hub_rows = sidx[is_hub].astype(np.int64)
    hub_cols = edge_rank[is_hub].astype(np.int64)
    if hub_rows.size:
        _, mult = np.unique(hub_rows * h_pad + hub_cols, return_counts=True)
        if mult.max(initial=0) >= 256:
            # multiplicity beyond exact bf16 integers: skip the
            # decomposition rather than aggregate inexactly
            return None
    cnt = _dense_counts(hub_rows, hub_cols, (num_nodes_padded, h_pad), device)
    hub_ids_pad = np.zeros(h_pad, np.int64)
    hub_ids_pad[:h] = hub_ids

    tail_layout = build_edge_layout(
        senders[tail], receivers[tail], num_nodes_padded,
        xe_ids=None if xe_ids is None else xe_ids[tail],
        node_block=node_block, edge_chunk=edge_chunk,
        e_pad_to=tail_e_pad_to, feat_dim_hint=feat_dim_hint, gwin=gwin,
        profile=prof, device=device)
    return HubDense(
        hub_ids=torch.from_numpy(hub_ids_pad).to(device), cnt=cnt,
        tail=tail_layout, hub_size=h, coverage=coverage,
        sc_ids=(None if sc_ids_pad is None
                else torch.from_numpy(sc_ids_pad).to(device)),
        sc_cnt=cnt_sc, sc_size=h2, sc_coverage=sc_cov)


def build_edge_layout(senders, receivers, num_nodes_padded: int,
                      xe_ids=None, edge_mask=None, node_block: int = 128,
                      edge_chunk: int = 512, hub_size: int = 0,
                      hub_min_coverage: float = 0.1, e_pad_to: int = 0,
                      hub_tail_e_pad_to: int = 0, feat_dim_hint: int = 768,
                      sc_hub_size: int = 0, num_edge_types: int = 1,
                      gwin: str = "auto",
                      profile: Optional[ChipProfile] = None,
                      device="cpu") -> EdgeLayout:
    """Host numpy prep, tensors on ``device`` out.  ``senders``/``receivers``
    may include padded slots (``edge_mask`` False); they are re-pointed at
    the sentinel and sorted last.

    ``hub_size > 0`` also builds hub-dense decompositions per direction
    (``hub_r``/``hub_s``).  ``gwin`` sets the in-kernel row gather of each
    direction, here and on the hub tails: "auto" by :func:`_gwin_decide`,
    "on" forced (tests), "off" never.  ``profile`` fixes the break-even
    models' device profile (default: :func:`~stemgnn_tpu_torch.ops.
    chip_profile.current_profile`)."""
    prof = profile or current_profile()
    if gwin not in ("auto", "on", "off"):
        raise ValueError(f"gwin must be auto, on or off, got {gwin!r}")
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    e = senders.shape[0]
    edge_mask = (np.ones(e, bool) if edge_mask is None
                 else np.asarray(edge_mask, bool))
    if num_nodes_padded % node_block != 0:
        raise ValueError(f"num_nodes_padded {num_nodes_padded} not a multiple "
                         f"of node_block {node_block}")
    if hub_size and num_edge_types > 1 and xe_ids is not None:
        raise NotImplementedError(
            "typed hub blocks (T > 1 edge types) are not ported yet")
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
                      xe_ids=xe_ids, gwin=gwin, prof=prof, device=device)
        hub_r = _build_hub_dense(senders, receivers, edge_mask, "sender",
                                 **hub_kw)
        hub_s = _build_hub_dense(senders, receivers, edge_mask, "receiver",
                                 **hub_kw)

    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(device)

    return EdgeLayout(
        senders_r=t(fw["a"]), receivers_r=t(fw["b"]), xe_r=t(fw["xe"]),
        mask_r=t(fw["m"]),
        block_ptr_r=t(_block_ptr(fw["b"], num_nodes_padded, node_block)),
        lrow_r=t(lrow(fw["b"], fw["m"])),
        senders_s=t(bw["a"]), receivers_s=t(bw["b"]), xe_s=t(bw["xe"]),
        mask_s=t(bw["m"]),
        block_ptr_s=t(_block_ptr(bw["a"], num_nodes_padded, node_block)),
        lrow_s=t(lrow(bw["a"], bw["m"])),
        in_degree=t(deg), perm_s2r=t(perm),
        perm_r2o=t(sorted_to_orig(order_r)),
        perm_s2o=t(sorted_to_orig(order_s)),
        hub_r=hub_r, hub_s=hub_s,
        node_block=node_block, edge_chunk=edge_chunk,
        use_gwin_r=bool(use_gwin[0]), use_gwin_s=bool(use_gwin[1]))


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
