"""The pretrain decoders (counterpart of ``stemgnn_tpu/nn/decoders.py``
and ``stemgnn_tpu/ops/sddmm.py``): the inner-product edge decoder with its
projection (STEM-GNN/model/encoder.py:336-380, as the pretrain model builds
it), per queried pair or dense over all pairs; the feature and topo-sem
heads are plain ``Linear`` layers (pretrain.py:121-123)."""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops.spmm import gather_rows


class InnerProductDecoder(nn.Module):
    """``sigma(lin(z)_u . lin(z)_v)`` per queried pair.  Parameters mirror
    ``inner_product_decoder_init(key, hidden_dim, output_dim)``:
    ``{"lin": {"w", "b"}}`` with the torch default initializer."""

    def __init__(self, hidden_dim: int, output_dim: int, generator=None):
        super().__init__()
        self.lin = Linear(hidden_dim, output_dim, bias=True,
                          weight_init="torch", generator=generator)

    def forward(self, z, senders, receivers, edge_mask=None,
                sigmoid: bool = True):
        return edge_inner_product(self.lin(z), senders, receivers,
                                  edge_mask=edge_mask, sigmoid=sigmoid)

    def decode_all(self, z, sigmoid: bool = True):
        """The dense [N, N] decode (JAX ``inner_product_decode_all``,
        encoder.py:368-380)."""
        return inner_product_decode_all(self.lin(z), sigmoid=sigmoid)


def edge_inner_product(z, senders, receivers, edge_mask=None,
                       sigmoid: bool = True):
    """Per-pair ``z[u] . z[v]``, through a sigmoid by default (JAX
    ``ops/sddmm.edge_inner_product``), in ``z``'s dtype (a bf16 ``z`` under
    ``loss_bf16``: the products rounded to bf16, summed in f32).  A pair
    outside ``edge_mask`` scores exactly 0.5 under the sigmoid, else 0."""
    score = (gather_rows(z, senders) * gather_rows(z, receivers)).sum(-1)
    if sigmoid:
        score = torch.sigmoid(score)
    if edge_mask is not None:
        score = torch.where(edge_mask, score, torch.full(
            (), 0.5 if sigmoid else 0.0, dtype=score.dtype,
            device=score.device))
    return score


def inner_product_decode_all(z, sigmoid: bool = True):
    """``z @ z.T`` over every pair of rows, through a sigmoid by
    default."""
    adj = z @ z.T
    return torch.sigmoid(adj) if sigmoid else adj
