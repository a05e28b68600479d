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
