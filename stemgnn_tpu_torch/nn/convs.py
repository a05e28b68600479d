"""Graph convolution layers (counterpart of ``stemgnn_tpu/nn/convs.py``).

The reference's conv zoo (STEM-GNN/model/encoder.py):

  * ``sage`` — MySAGEConv (encoder.py:17-106): ``relu(x_j + xe)``
    messages, mean aggregation, root weight;
  * ``moe_sage`` — MixtureSageLayer (encoder.py:109-129): K experts whose
    neighbour aggregation is the reference's ``scatter_mean(x[col], row)``,
    the *receivers'* features averaged at each *sender* (the out-edge
    mean), with no edge features and no message relu;
  * ``gcn`` / ``gin`` / ``gat`` — the parity backbones (encoder.py:191-200),
    which take no edge features (the JAX package's note: the reference
    passes them positionally where PyG expects edge weights).

All layers run on padded COO edge lists with validity masks; the MoE and
the gcn / gin / gat aggregations are gathers and ``index_add_`` segment
sums (no kernel: the JAX package builds layouts for sage alone).
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.ops.spmm import gather_segment_sum, sage_aggregate


class SAGEConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        # PyG Linear's default initializer is glorot (encoder.py:58-60)
        self.lin_l = Linear(in_dim, out_dim, bias=True, weight_init="glorot",
                            generator=generator)
        self.lin_r = Linear(in_dim, out_dim, bias=False,
                            weight_init="glorot", generator=generator)

    def forward(self, x, senders, receivers, edge_feat=None, edge_mask=None,
                layout=None, edge_table=None, bf16_messages: bool = True,
                plain: bool = False, drop_hash=None):
        """out = lin_l(mean_j relu(x_j + xe)) + lin_r(x)
        (encoder.py:82-87)."""
        agg = sage_aggregate(x, senders, receivers, edge_feat=edge_feat,
                             edge_mask=edge_mask, num_nodes=x.shape[0],
                             reduce="mean", relu=True, layout=layout,
                             edge_table=edge_table,
                             bf16_messages=bf16_messages, plain=plain,
                             drop_hash=drop_hash)
        return self.lin_l(agg) + self.lin_r(x)


class MoESAGEConv(nn.Module):
    """K-expert SAGE: ``weights`` [K, 2*in, out], xavier-uniform
    (encoder.py:120)."""

    def __init__(self, in_dim: int, out_dim: int, num_experts: int,
                 generator=None):
        super().__init__()
        self.weights = nn.Parameter(inits.xavier_uniform(
            (num_experts, 2 * in_dim, out_dim), generator=generator))

    def forward(self, x, senders, receivers, edge_mask=None,
                residual: bool = True):
        """Expert outputs [N, K, out] (encoder.py:122-129): ``cat[agg, x]``
        through each expert, plus ``x`` where in = out.  ``agg[i]`` is the
        mean of ``x[r]`` over the valid edges (i -> r): the receivers'
        features at the sender, divided by the out-degree."""
        agg = reverse_mean(x, senders, receivers, edge_mask)
        combined = torch.cat([agg, x], dim=-1)
        out = torch.einsum("nd,kdo->nko", combined,
                           self.weights.to(combined.dtype))
        if residual and x.shape[-1] == out.shape[-1]:
            out = out + x[:, None, :]
        return out


def reverse_mean(x, senders, receivers, edge_mask=None):
    """The MoE layer's aggregation: the gather runs over the receivers and
    the segments are the senders (the reference's ``scatter_mean(x[col],
    row)``), so each sender averages over its out-edges; the count is
    ``segment_mean``'s (JAX's stalled count in bf16)."""
    n = x.shape[0]
    total = gather_segment_sum(x, receivers, senders, n, mask=edge_mask)
    return total / segment.segment_count(senders, n, edge_mask,
                                         total.dtype)[:, None]


class GCNConv(nn.Module):
    """Symmetric-normalized GCN with an implicit self-loop on every row:
    ``{"lin": {"w"}, "bias"}``."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.lin = Linear(in_dim, out_dim, bias=False, weight_init="glorot",
                          generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, senders, receivers, edge_mask=None):
        """``out[i] = sum_(j->i) h_j / sqrt(d_j d_i) + h_i / d_i + bias``,
        ``h = lin(x)``, ``d`` the valid in-degree + 1 of every row, padded
        ones included (the node mask is not read)."""
        n = x.shape[0]
        h = self.lin(x)
        ones = (edge_mask.to(h.dtype) if edge_mask is not None
                else torch.ones(senders.shape[0], dtype=h.dtype,
                                device=h.device))
        deg = segment.segment_sum(ones, receivers, n) + 1.0
        inv_sqrt = torch.rsqrt(deg)
        w = inv_sqrt[senders] * inv_sqrt[receivers]
        if edge_mask is not None:
            w = torch.where(edge_mask, w, torch.zeros((), dtype=w.dtype,
                                                      device=w.device))
        out = gather_segment_sum(h, senders, receivers, n, weight=w)
        return out + h * (inv_sqrt ** 2)[:, None] + self.bias


class GINConv(nn.Module):
    """``lin((1 + eps) x + sum_j x_j)``: ``{"lin": {"w", "b"}, "eps"}``,
    the linear with the torch init (GINConv(nn.Linear(in, out)),
    encoder.py:199), ``eps`` a trainable 0-dim parameter from 0."""

    def __init__(self, in_dim: int, out_dim: int, generator=None):
        super().__init__()
        self.lin = Linear(in_dim, out_dim, bias=True, weight_init="torch",
                          generator=generator)
        self.eps = nn.Parameter(torch.zeros(()))

    def forward(self, x, senders, receivers, edge_mask=None):
        agg = gather_segment_sum(x, senders, receivers, x.shape[0],
                                 mask=edge_mask)
        return self.lin((1.0 + self.eps) * x + agg)


class GATConv(nn.Module):
    """One-head GAT: ``{"lin": {"w"}, "att_src", "att_dst", "bias"}``, the
    attention vectors [out] glorot-drawn as [out, 1] columns."""

    def __init__(self, in_dim: int, out_dim: int, generator=None,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin = Linear(in_dim, out_dim, bias=False, weight_init="glorot",
                          generator=generator)
        self.att_src = nn.Parameter(inits.glorot_uniform(
            (out_dim, 1), generator=generator).reshape(out_dim))
        self.att_dst = nn.Parameter(inits.glorot_uniform(
            (out_dim, 1), generator=generator).reshape(out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, senders, receivers, edge_mask=None):
        """``out[i] = sum_(j->i) softmax_i(leaky_relu(a_s.h_j + a_d.h_i))
        h_j + bias`` over the valid in-edges, ``h = lin(x)``."""
        n = x.shape[0]
        h = self.lin(x)
        # index_select: its backward is an index_add_ (indexing's sorts)
        e = (h.mv(self.att_src).index_select(0, senders)
             + h.mv(self.att_dst).index_select(0, receivers))
        e = torch.nn.functional.leaky_relu(e, self.negative_slope)
        att = segment.segment_softmax(e, receivers, n, mask=edge_mask)
        return gather_segment_sum(h, senders, receivers, n, mask=edge_mask,
                                  weight=att) + self.bias
