"""Multi-layer GNN stack with jumping knowledge and a virtual node
(counterpart of ``stemgnn_tpu/zoo/stack.py``; reference
``MultiLayerMessagePassing`` / ``...VN``, STEM-GNN/dataset/gp/nn/models/
GNN.py:16-198).

Per layer: conv -> BatchNorm over the valid nodes -> relu (except the
last) -> dropout; JK ``last`` / ``sum`` / ``mean`` / ``list`` (the layers'
outputs).  The virtual-node variant keeps one global node a graph of a
disjoint batch, added to its nodes before every layer and updated from
their sum between layers through an MLP whose BatchNorm statistics JAX
never carries forward (its new state is dropped), so neither does this.
Padded nodes carry the dead graph id ``n_graphs``: their sum is dropped
and their gather clamped (with no gradient back through it), as JAX's
segment ops and gathers do.

Convs: ``rgcn`` / ``rgat`` (``zoo.convs_rel``) and ``gine`` (``sum_j
relu(x_j + xe)`` through an MLP, PyGGINE, gp/nn/models/pyg.py:51).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.nn.layers import BatchNorm, dropout
from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.zoo.convs_rel import RGATEdgeConv, RGCNEdgeConv
from stemgnn_tpu_torch.zoo.mlp import MLP


class GINEConv(nn.Module):
    """``{"mlp", "eps"}``: ``mlp((1 + eps) x + sum_j relu(x_j + xe))``,
    the inner MLP without BatchNorm, ``eps`` a 0-dim parameter from 0."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.mlp = MLP([in_dim, 2 * in_dim, out_dim], batch_norm=False,
                       generator=generator)
        self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, x, xe, senders, receivers, edge_mask=None):
        msg = F.relu(x.index_select(0, senders) + xe)
        agg = segment.segment_sum(msg, receivers, x.shape[0], mask=edge_mask)
        return self.mlp((1 + self.eps) * x + agg)


def _conv(kind, in_dim, out_dim, num_relations, heads, generator):
    if kind == "rgcn":
        return RGCNEdgeConv(in_dim, out_dim, num_relations,
                            generator=generator)
    if kind == "rgat":
        return RGATEdgeConv(in_dim, out_dim, num_relations, heads=heads,
                            generator=generator)
    if kind == "gine":
        return GINEConv(in_dim, out_dim, generator=generator)
    raise ValueError(kind)


class GNNStack(nn.Module):
    """``{"convs", "norms"[, "vn_mlp", "vn_embed"]}`` as JAX's
    ``gnn_stack_init`` trees (BatchNorm statistics and the virtual node's
    MLP state as buffers)."""

    def __init__(self, kind: str, num_layers: int, dim: int,
                 num_relations: int = 1, heads: int = 8,
                 batch_norm: bool = True, virtual_node: bool = False,
                 generator=None):
        super().__init__()
        self.kind = kind
        self.convs = nn.ModuleList(
            _conv(kind, dim, dim, num_relations, heads, generator)
            for _ in range(num_layers))
        self.norms = nn.ModuleList(
            BatchNorm(dim) for _ in range(num_layers)) if batch_norm \
            else nn.ModuleList()
        self.virtual_node = virtual_node
        if virtual_node:
            self.vn_mlp = MLP([dim, 2 * dim, dim], generator=generator)
            self.vn_embed = nn.Parameter(torch.zeros(1, dim))

    def forward(self, x, xe, senders, receivers, edge_type=None,
                edge_mask=None, node_mask=None, node_graph_id=None,
                n_graphs: Optional[int] = None, *, JK: str = "last",
                drop: float = 0.0, generator=None):
        """JAX ``gnn_stack_apply`` in the module's mode (``train()``: the
        batch statistics, which update the running ones).  ``edge_type``
        None is relation 0 everywhere; ``generator`` draws the dropout."""
        if edge_type is None:
            edge_type = torch.zeros_like(senders)
        num_layers = len(self.convs)
        if self.virtual_node:
            assert node_graph_id is not None and n_graphs is not None
            gid = node_graph_id.long()
            vn = self.vn_embed.expand(n_graphs, -1)
        h_list = []
        h = x
        for i, conv in enumerate(self.convs):
            if self.virtual_node:
                h = h + segment.take_clamped(vn, gid)
            if self.kind == "gine":
                h = conv(h, xe, senders, receivers, edge_mask=edge_mask)
            else:
                h = conv(h, xe, senders, receivers, edge_type,
                         edge_mask=edge_mask)
            if len(self.norms):
                h = self.norms[i](h, mask=node_mask)
            if i != num_layers - 1:
                h = F.relu(h)
            if drop > 0:
                h = dropout(h, drop, training=self.training,
                            generator=generator)
            if self.virtual_node and i != num_layers - 1:
                pooled = segment.segment_sum(h, gid, n_graphs,
                                             mask=node_mask, drop_oob=True)
                vn = self.vn_mlp(vn + pooled, update=False)
            h_list.append(h)
        if JK == "last":
            return h_list[-1]
        if JK == "sum":
            return sum(h_list)
        if JK == "mean":
            return sum(h_list) / num_layers
        return h_list
