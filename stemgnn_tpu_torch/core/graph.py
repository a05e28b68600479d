"""Fixed-shape padded graph containers (counterpart of
``stemgnn_tpu/core/graph.py``).

A graph is flat tensors padded to a bucket size, with validity masks:
padded edges carry ``senders = receivers = 0`` and ``edge_mask = False``;
rows of ``node_feat`` beyond ``n_node`` are zero.  PyTorch runs eagerly, so
the JAX package's pytree machinery (``flax.struct``) becomes a plain
dataclass of tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


@dataclass
class Graph:
    """A padded, fixed-shape graph on one device."""

    node_feat: torch.Tensor             # [N_pad, D] float
    senders: torch.Tensor               # [E_pad] int64
    receivers: torch.Tensor             # [E_pad] int64
    node_mask: torch.Tensor             # [N_pad] bool
    edge_mask: torch.Tensor             # [E_pad] bool
    n_node: int
    n_edge: int
    edge_feat: Optional[torch.Tensor] = None    # [E_pad, D] or None
    # Precomputed kernel layout (ops.edge_layout.EdgeLayout) + the per-edge-
    # type feature table [T, D]: with both present the encoder runs the fused
    # scatter-kernel aggregation instead of materializing [E_pad, D] features.
    layout: Optional[object] = None
    edge_table: Optional[torch.Tensor] = None
    # Disjoint-batch segment ids (graph id per node) for graph-level
    # pooling; padded nodes point at the dead slot ``n_graph``.
    node_graph_id: Optional[torch.Tensor] = None    # [N_pad] int64
    n_graph: Optional[int] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.node_feat.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]


def make_graph(node_feat, senders, receivers, edge_feat=None,
               node_pad_to: Optional[int] = None,
               edge_pad_to: Optional[int] = None,
               node_multiple: int = 8, edge_multiple: int = 128,
               device="cpu", node_graph_id=None,
               n_graph: Optional[int] = None) -> Graph:
    """Build a padded :class:`Graph` on ``device`` from host (numpy) arrays,
    with the JAX package's padding defaults (nodes to 8, edges to 128).
    ``node_graph_id`` [n] makes a disjoint batch of ``n_graph`` graphs
    (default: the largest id + 1); padded nodes get the id ``n_graph``."""
    node_feat = np.asarray(node_feat)
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    n, e = node_feat.shape[0], senders.shape[0]
    n_pad = node_pad_to if node_pad_to is not None else round_up(
        max(n, 1), node_multiple)
    e_pad = edge_pad_to if edge_pad_to is not None else round_up(
        max(e, 1), edge_multiple)
    if n_pad < n or e_pad < e:
        raise ValueError(f"pad sizes ({n_pad},{e_pad}) smaller than data "
                         f"({n},{e})")

    def pad(a, width):
        out = np.zeros((width,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        return torch.from_numpy(out).to(device)

    ef = None if edge_feat is None else pad(np.asarray(edge_feat), e_pad)
    gid = None
    if node_graph_id is not None:
        node_graph_id = np.asarray(node_graph_id, np.int64)
        if n_graph is None:
            n_graph = int(node_graph_id.max()) + 1 if n else 0
        gid = np.full(n_pad, n_graph, np.int64)
        gid[:n] = node_graph_id
        gid = torch.from_numpy(gid).to(device)
    return Graph(
        node_feat=pad(node_feat, n_pad),
        senders=pad(senders.astype(np.int64), e_pad),
        receivers=pad(receivers.astype(np.int64), e_pad),
        node_mask=pad(np.ones(n, bool), n_pad),
        edge_mask=pad(np.ones(e, bool), e_pad),
        n_node=n, n_edge=e, edge_feat=ef, node_graph_id=gid,
        n_graph=None if gid is None else int(n_graph))


@dataclass
class IndexedGraph:
    """A padded graph that carries feature-table indices instead of
    features (JAX ``IndexedGraph``): the batch format of the minibatch
    pretrain.  The node table [N_global, D] and the edge-type table [T, D]
    stay on the device; a batch moves only its id arrays, which are numpy on
    the host (:func:`make_indexed_graph`) and tensors after
    :func:`indexed_to_device`."""

    node_ids: object                    # [N_pad] int32 into the node table
    senders: object                     # [E_pad] int32 (batch-local)
    receivers: object                   # [E_pad] int32 (batch-local)
    node_mask: object                   # [N_pad] bool
    edge_mask: object                   # [E_pad] bool
    n_node: int
    n_edge: int
    xe_ids: object = None               # [E_pad] int32 into the edge table
    # graph id per node of a disjoint batch (graph-task pooling); padded
    # nodes carry the out-of-range id ``n_graph``
    node_graph_id: object = None        # [N_pad] int32
    n_graph: Optional[int] = None

    @property
    def num_nodes_padded(self) -> int:
        return self.node_ids.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.senders.shape[0]


def make_indexed_graph(node_ids, senders, receivers, xe_ids=None,
                       node_pad_to: Optional[int] = None,
                       edge_pad_to: Optional[int] = None,
                       node_multiple: int = 8,
                       edge_multiple: int = 128, node_graph_id=None,
                       n_graph: Optional[int] = None) -> IndexedGraph:
    """Host prep of an :class:`IndexedGraph` (numpy in, numpy out): padded
    slots hold id 0 and mask False; with ``node_graph_id`` padded nodes
    take the graph id ``n_graph`` (1 when it is None or 0)."""
    node_ids = np.asarray(node_ids, np.int32)
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    n, e = node_ids.shape[0], senders.shape[0]
    n_pad = node_pad_to if node_pad_to is not None else round_up(
        max(n, 1), node_multiple)
    e_pad = edge_pad_to if edge_pad_to is not None else round_up(
        max(e, 1), edge_multiple)
    if n_pad < n or e_pad < e:
        raise ValueError(f"pad sizes ({n_pad},{e_pad}) < data ({n},{e})")

    def pad1(a, width):
        out = np.zeros(width, np.int32)
        out[:len(a)] = a
        return out

    nm = np.arange(n_pad) < n
    gid = None
    if node_graph_id is not None:
        gid = pad1(np.asarray(node_graph_id, np.int32), n_pad) + np.where(
            nm, 0, np.int32(n_graph if n_graph else 1))
    return IndexedGraph(
        node_ids=pad1(node_ids, n_pad), senders=pad1(senders, e_pad),
        receivers=pad1(receivers, e_pad), node_mask=nm,
        edge_mask=np.arange(e_pad) < e, n_node=n, n_edge=e,
        xe_ids=None if xe_ids is None else pad1(xe_ids, e_pad),
        node_graph_id=gid, n_graph=n_graph)


def host_to_device(a, device):
    """A numpy array (or CPU tensor) as a tensor on ``device``.  Off the CPU
    it goes through pinned memory with ``non_blocking=True``, so the host
    does not wait for the kernels already queued (a pageable copy
    synchronizes the stream); the caching host allocator keeps the pinned
    block until the copy is done."""
    t = torch.as_tensor(a)
    if torch.device(device).type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def indexed_to_device(ig: IndexedGraph, device) -> IndexedGraph:
    """``ig`` with tensor leaves on ``device`` (:func:`host_to_device`)."""
    def move(a):
        return None if a is None else host_to_device(a, device)
    return IndexedGraph(node_ids=move(ig.node_ids), senders=move(ig.senders),
                        receivers=move(ig.receivers),
                        node_mask=move(ig.node_mask),
                        edge_mask=move(ig.edge_mask), n_node=ig.n_node,
                        n_edge=ig.n_edge, xe_ids=move(ig.xe_ids),
                        node_graph_id=move(ig.node_graph_id),
                        n_graph=ig.n_graph)


def graph_to_device(g: Graph, device) -> Graph:
    """A host :class:`Graph` (CPU tensors) with its tensors on ``device``
    (:func:`host_to_device`); layouts are not carried."""
    def move(a):
        return None if a is None else host_to_device(a, device)
    return Graph(node_feat=move(g.node_feat), senders=move(g.senders),
                 receivers=move(g.receivers), node_mask=move(g.node_mask),
                 edge_mask=move(g.edge_mask), n_node=g.n_node,
                 n_edge=g.n_edge, edge_feat=move(g.edge_feat),
                 node_graph_id=move(g.node_graph_id), n_graph=g.n_graph)


def materialize_graph(ig: IndexedGraph, node_table,
                      edge_table=None) -> Graph:
    """Device-side feature gather (JAX ``materialize_graph``): an
    :class:`IndexedGraph` with tensor leaves and the resident tables ->
    :class:`Graph`.  Padded rows gather row 0 (ids clipped into the table)
    and are zeroed; edge features come from the edge table by ``xe_ids``,
    zeroed on padded edges."""
    def gather(table, ids, mask):
        rows = table.index_select(
            0, ids.long().clamp(0, table.shape[0] - 1))
        return torch.where(mask[:, None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
    ef = None
    if edge_table is not None and ig.xe_ids is not None:
        ef = gather(edge_table, ig.xe_ids, ig.edge_mask)
    gid = None if ig.node_graph_id is None else ig.node_graph_id.long()
    return Graph(node_feat=gather(node_table, ig.node_ids, ig.node_mask),
                 senders=ig.senders.long(), receivers=ig.receivers.long(),
                 node_mask=ig.node_mask, edge_mask=ig.edge_mask,
                 n_node=ig.n_node, n_edge=ig.n_edge, edge_feat=ef,
                 node_graph_id=gid, n_graph=ig.n_graph)


def pad_graph(g: Graph, node_pad_to: int, edge_pad_to: int) -> Graph:
    """Re-pad an already-padded graph to larger bucket sizes (zeros and
    False in the new slots, as JAX ``pad_graph``)."""
    n_pad, e_pad = g.num_nodes_padded, g.num_edges_padded
    if node_pad_to < n_pad or edge_pad_to < e_pad:
        raise ValueError("cannot shrink padding")

    def padn(x, width):
        if x is None:
            return None
        return torch.cat([x, x.new_zeros((width,) + tuple(x.shape[1:]))])
    dn, de = node_pad_to - n_pad, edge_pad_to - e_pad
    return Graph(node_feat=padn(g.node_feat, dn),
                 senders=padn(g.senders, de), receivers=padn(g.receivers, de),
                 node_mask=padn(g.node_mask, dn),
                 edge_mask=padn(g.edge_mask, de), n_node=g.n_node,
                 n_edge=g.n_edge, edge_feat=padn(g.edge_feat, de),
                 layout=g.layout, edge_table=g.edge_table,
                 node_graph_id=padn(g.node_graph_id, dn), n_graph=g.n_graph)


class IndexedGraphList:
    """List-like bundle of id-based graph dicts (keys ``x`` / ``senders`` /
    ``receivers`` / ``xe``) and the shared feature tables (JAX
    ``IndexedGraphList``): the graph-task dataset format for large molecule
    corpora, O(atoms) ints on the host instead of O(atoms x D) floats, whose
    batches stay ids until the device-side gather."""

    def __init__(self, items, node_table, edge_table=None):
        self.items = items
        self.node_table = node_table
        self.edge_table = edge_table

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def __iter__(self):
        return iter(self.items)


def _disjoint(graphs, count):
    """Offset senders/receivers and per-node graph ids of a disjoint union
    of graph dicts with ``count(g)`` nodes each."""
    sizes = [count(g) for g in graphs]
    offsets = np.cumsum([0] + sizes)
    senders = np.concatenate([np.asarray(g["senders"], np.int32) + offsets[i]
                              for i, g in enumerate(graphs)])
    receivers = np.concatenate(
        [np.asarray(g["receivers"], np.int32) + offsets[i]
         for i, g in enumerate(graphs)])
    gid = np.concatenate([np.full(s, i, np.int32)
                          for i, s in enumerate(sizes)])
    return senders, receivers, gid


def batch_indexed_graphs(graphs, node_pad_to: Optional[int] = None,
                         edge_pad_to: Optional[int] = None) -> IndexedGraph:
    """Disjoint union of id-based host graphs (dicts with keys x / senders /
    receivers / [xe]) into one padded host :class:`IndexedGraph` with
    per-node graph ids (JAX ``batch_indexed_graphs``)."""
    senders, receivers, gid = _disjoint(
        graphs, lambda g: np.asarray(g["x"]).shape[0])
    node_ids = np.concatenate([np.asarray(g["x"], np.int32) for g in graphs])
    xe = None
    if graphs and graphs[0].get("xe") is not None:
        xe = np.concatenate([np.asarray(g["xe"], np.int32) for g in graphs])
    return make_indexed_graph(node_ids, senders, receivers, xe_ids=xe,
                              node_pad_to=node_pad_to,
                              edge_pad_to=edge_pad_to,
                              node_graph_id=gid, n_graph=len(graphs))


def batch_graphs(graphs, node_pad_to: Optional[int] = None,
                 edge_pad_to: Optional[int] = None, device="cpu") -> Graph:
    """Disjoint union of host graphs (dicts with keys node_feat / senders /
    receivers / [edge_feat]) into one padded :class:`Graph` on ``device``
    with per-node graph ids (JAX ``batch_graphs``; the reference's
    ``Batch.from_data_list``)."""
    senders, receivers, gid = _disjoint(
        graphs, lambda g: np.asarray(g["node_feat"]).shape[0])
    node_feat = np.concatenate([np.asarray(g["node_feat"]) for g in graphs])
    edge_feat = None
    if graphs and graphs[0].get("edge_feat") is not None:
        edge_feat = np.concatenate([np.asarray(g["edge_feat"])
                                    for g in graphs])
    return make_graph(node_feat, senders, receivers, edge_feat=edge_feat,
                      node_pad_to=node_pad_to, edge_pad_to=edge_pad_to,
                      device=device, node_graph_id=gid, n_graph=len(graphs))
