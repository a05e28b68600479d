"""OFA prompted-graph prediction heads (counterpart of
``stemgnn_tpu/ofa/heads.py``).

The reference's ``BinGraphModel`` / ``BinGraphAttModel``
(STEM-GNN/dataset/models/model.py:72-163) and ``SingleHeadAtt`` (:55-70):
one input projection shared by node and edge text features, a relational
GNN stack over the prompted graph, and a binary MLP scoring every class
node, optionally over the per-layer embeddings pooled by single-head
attention whose query is the projected input feature (the "Att" variant).

Random-walk positional encodings (``AddRandomWalkPE`` + a learnable edge
prior, model.py:79-87,104-110) are concatenated after a BatchNorm that the
reference runs under ``no_grad``: it normalizes with the batch statistics
of the valid nodes in training and updates its running ones, and no
gradient reaches its input, output or parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.nn.layers import BatchNorm, Linear
from stemgnn_tpu_torch.zoo.mlp import MLP
from stemgnn_tpu_torch.zoo.stack import GNNStack


def random_walk_pe(senders, receivers, num_nodes: int, walk_length: int,
                   edge_mask=None) -> np.ndarray:
    """Landing-probability diagonals of the random walk, host-side numpy
    (``scipy_rwpe``, STEM-GNN/dataset/data_utils.py:243-261): pe[v, k] =
    P^k[v, v] for k = 1..walk_length, with P the row-normalized adjacency.
    Dense [N, N] propagation: prompted subgraphs are small (hop-capped at
    100/hop), so build it a sample at a time."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    if edge_mask is not None:
        keep = np.asarray(edge_mask, bool)
        s, r = s[keep], r[keep]
    a = np.zeros((num_nodes, num_nodes), np.float64)
    np.add.at(a, (s, r), 1.0)
    deg = a.sum(1, keepdims=True)
    p = np.divide(a, deg, out=np.zeros_like(a), where=deg > 0)
    out = np.zeros((num_nodes, walk_length), np.float32)
    m = p
    for k in range(walk_length):
        out[:, k] = np.diag(m)
        if k + 1 < walk_length:
            m = m @ p
    return out


class SingleHeadAtt(nn.Module):
    """``{"Wk", "Wq"}`` [dim, dim], xavier-uniform."""

    def __init__(self, dim: int, generator=None):
        super().__init__()
        self.Wk = nn.Parameter(inits.xavier_uniform((dim, dim),
                                                    generator=generator))
        self.Wq = nn.Parameter(inits.xavier_uniform((dim, dim),
                                                    generator=generator))

    def forward(self, key, query, value):
        """softmax(q kᵀ / sqrt(d)) v over the middle axis (model.py:55-70):
        key/value [N, L, D], query [N, 1, D] -> context [N, 1, D]."""
        score = torch.einsum("nqd,nld->nql", query @ self.Wq,
                             key @ self.Wk) / math.sqrt(key.shape[-1])
        return torch.einsum("nql,nld->nqd", torch.softmax(score, dim=-1),
                            value)


class BinGraphHead(nn.Module):
    """``{"in_proj", "enc", "mlp"[, "att"][, "edge_rwpe_prior",
    "rwpe_norm"]}`` as JAX's ``bin_graph_init`` trees.  ``att_pool`` is the
    BinGraphAttModel variant; ``walk_length`` adds the RWPE concat."""

    def __init__(self, kind: str, num_layers: int, in_dim: int, out_dim: int,
                 task_dim: int = 1, num_relations: int = 1,
                 att_pool: bool = False, walk_length: Optional[int] = None,
                 generator=None):
        super().__init__()
        d_stack = out_dim + (walk_length or 0)
        self.in_proj = Linear(in_dim, out_dim, generator=generator)
        self.enc = GNNStack(kind, num_layers, d_stack,
                            num_relations=num_relations, generator=generator)
        self.mlp = MLP([d_stack, 2 * out_dim, out_dim, task_dim],
                       batch_norm=False, generator=generator)
        self.att = SingleHeadAtt(d_stack, generator=generator) \
            if att_pool else None
        if walk_length:
            self.edge_rwpe_prior = nn.Parameter(inits.xavier_uniform(
                (1, walk_length), generator=generator))
            self.rwpe_norm = BatchNorm(walk_length)

    def forward(self, g, true_nodes_mask, *, dropout: float = 0.0,
                rwpe=None, generator=None):
        """Scores [N] of a collated prompted batch ``g``: the class nodes'
        logits, -inf elsewhere (``true_nodes_mask`` [N] bool on the
        device)."""
        x = self.in_proj(g.node_feat)
        xe = self.in_proj(g.edge_feat)
        if rwpe is not None:
            with torch.no_grad():
                pe = self.rwpe_norm(rwpe, mask=g.node_mask)
            x = torch.cat([x, pe], dim=-1)
            xe = torch.cat([xe, self.edge_rwpe_prior.expand(xe.shape[0], -1)],
                           dim=-1)
        h = self.enc(x, xe, g.senders, g.receivers, edge_mask=g.edge_mask,
                     node_mask=g.node_mask, JK="list", drop=dropout,
                     generator=generator)
        if self.att is not None:
            emb = torch.stack(h, dim=1)                       # [N, L, D]
            z = self.att(emb, x[:, None, :], emb)[:, 0]
        else:
            z = h[-1]
        logit = self.mlp(z)[:, 0]
        return torch.where(true_nodes_mask, logit,
                           torch.full((), -torch.inf, dtype=logit.dtype,
                                      device=logit.device))


def bin_graph_apply(head: BinGraphHead, g, aux, *, dropout: float = 0.0,
                    rwpe=None, generator=None):
    """JAX ``bin_graph_apply`` in the head's mode: ``aux`` is the collate
    dict (its ``true_nodes_mask`` numpy or a tensor)."""
    mask = torch.as_tensor(aux["true_nodes_mask"], device=g.node_feat.device)
    return head(g, mask, dropout=dropout, rwpe=rwpe, generator=generator)
