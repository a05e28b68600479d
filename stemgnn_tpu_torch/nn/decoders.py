"""The pretrain decoders (counterpart of ``stemgnn_tpu/nn/decoders.py``):
the inner-product edge decoder with its projection (STEM-GNN/model/
encoder.py:336-366, as the pretrain model builds it); the feature and
topo-sem heads are plain ``Linear`` layers (pretrain.py:121-123)."""

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

    def forward(self, z, senders, receivers):
        return edge_inner_product(self.lin(z), senders, receivers)


def edge_inner_product(z, senders, receivers):
    """Per-pair ``sigmoid(z[u] . z[v])`` (JAX ``ops/sddmm.
    edge_inner_product`` with its defaults), in ``z``'s dtype (a bf16
    ``z`` under ``loss_bf16``: the products rounded to bf16, summed in
    f32)."""
    return torch.sigmoid((gather_rows(z, senders)
                          * gather_rows(z, receivers)).sum(-1))
