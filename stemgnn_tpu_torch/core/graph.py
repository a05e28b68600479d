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
               device="cpu") -> Graph:
    """Build a padded :class:`Graph` on ``device`` from host (numpy) arrays,
    with the JAX package's padding defaults (nodes to 8, edges to 128)."""
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
    return Graph(
        node_feat=pad(node_feat, n_pad),
        senders=pad(senders.astype(np.int64), e_pad),
        receivers=pad(receivers.astype(np.int64), e_pad),
        node_mask=pad(np.ones(n, bool), n_pad),
        edge_mask=pad(np.ones(e, bool), e_pad),
        n_node=n, n_edge=e, edge_feat=ef)


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
                       edge_multiple: int = 128) -> IndexedGraph:
    """Host prep of an :class:`IndexedGraph` (numpy in, numpy out): padded
    slots hold id 0 and mask False."""
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

    return IndexedGraph(
        node_ids=pad1(node_ids, n_pad), senders=pad1(senders, e_pad),
        receivers=pad1(receivers, e_pad), node_mask=np.arange(n_pad) < n,
        edge_mask=np.arange(e_pad) < e, n_node=n, n_edge=e,
        xe_ids=None if xe_ids is None else pad1(xe_ids, e_pad))


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
                        n_edge=ig.n_edge, xe_ids=move(ig.xe_ids))


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
    return Graph(node_feat=gather(node_table, ig.node_ids, ig.node_mask),
                 senders=ig.senders.long(), receivers=ig.receivers.long(),
                 node_mask=ig.node_mask, edge_mask=ig.edge_mask,
                 n_node=ig.n_node, n_edge=ig.n_edge, edge_feat=ef)
