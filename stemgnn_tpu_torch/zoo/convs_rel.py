"""Relational graph convolutions with edge features (counterpart of
``stemgnn_tpu/zoo/convs_rel.py``; reference ``RGCNEdgeConv`` /
``RGATEdgeConv``, STEM-GNN/dataset/gp/nn/layer/pyg.py:16-159).

  * RGCN: per-relation mean of ``relu(x_j + xe)`` messages, the relation
    weight applied to the aggregate, plus a root weight and a bias.
  * RGAT: multi-head attention per relation: logits ``<leaky_relu(x_j +
    xe'), att_r>`` [E, H] softmax-normalized over each receiver's in-edges
    within the relation, messages ``(x_j + xe') * alpha``, ``xe' =
    lin_edge(xe)``.

Relations are one pass, as in JAX: the segments are ``edge_type * n +
receiver`` over ``num_rel * n``, and the relation product is one einsum.
The sums are ``ops.segment`` reductions (``index_add_``), which XLA
compiles in the JAX package: no Pallas kernel, so no CUDA kernel here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import segment


class RGCNEdgeConv(nn.Module):
    """``{"weight" [R, in, out], "root" [in, out], "bias" [out]}``."""

    def __init__(self, in_dim: int, out_dim: int, num_relations: int,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(inits.glorot_uniform(
            (num_relations, in_dim, out_dim), generator=generator))
        self.root = nn.Parameter(inits.glorot_uniform(
            (in_dim, out_dim), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x, xe, senders, receivers, edge_type, edge_mask=None,
                aggr: str = "mean"):
        """``sum_r agg_{(j,i) in E_r} relu(x_j + xe) @ W_r + x @ root +
        b``, ``agg`` the mean (or sum) over the valid edges."""
        n = x.shape[0]
        num_rel = self.weight.shape[0]
        msg = F.relu(x.index_select(0, senders) + xe)
        seg = edge_type.long() * n + receivers
        fn = segment.segment_mean if aggr == "mean" else segment.segment_sum
        per_rel = fn(msg, seg, num_rel * n, mask=edge_mask)
        per_rel = per_rel.reshape(num_rel, n, -1)
        out = torch.einsum("rni,rio->no", per_rel, self.weight)
        return out + x @ self.root + self.bias


class RGATEdgeConv(nn.Module):
    """``{"weight", "root", "bias", "lin_edge": {"w", "b"}, "att" [R or 1,
    H, in / H]}``."""

    def __init__(self, in_dim: int, out_dim: int, num_relations: int,
                 heads: int = 8, share_att: bool = False, generator=None,
                 negative_slope: float = 0.2):
        super().__init__()
        assert in_dim % heads == 0
        d_model = in_dim // heads
        r_att = 1 if share_att else num_relations
        self.negative_slope = negative_slope
        self.weight = nn.Parameter(inits.glorot_uniform(
            (num_relations, in_dim, out_dim), generator=generator))
        self.root = nn.Parameter(inits.glorot_uniform(
            (in_dim, out_dim), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        self.lin_edge = Linear(in_dim, in_dim, generator=generator)
        self.att = nn.Parameter(inits.glorot_uniform(
            (r_att, heads * d_model), generator=generator).reshape(
                r_att, heads, d_model))

    def forward(self, x, xe, senders, receivers, edge_type, edge_mask=None):
        n, in_dim = x.shape
        num_rel = self.weight.shape[0]
        heads, d_model = self.att.shape[1:]
        x_h = x.index_select(0, senders).reshape(-1, heads, d_model)
        xe_h = self.lin_edge(xe).reshape(-1, heads, d_model)
        pre = x_h + xe_h                                     # [E, H, dm]
        edge_type = edge_type.long()
        att_e = (self.att[0] if self.att.shape[0] == 1
                 else self.att.index_select(0, edge_type))
        alpha = (F.leaky_relu(pre, self.negative_slope) * att_e).sum(-1)
        seg = edge_type * n + receivers
        alpha = segment.segment_softmax(alpha, seg, num_rel * n,
                                        mask=edge_mask)      # [E, H]
        msg = (pre * alpha[..., None]).reshape(-1, in_dim)
        per_rel = segment.segment_sum(msg, seg, num_rel * n, mask=edge_mask)
        per_rel = per_rel.reshape(num_rel, n, in_dim)
        out = torch.einsum("rni,rio->no", per_rel, self.weight)
        return out + x @ self.root + self.bias
