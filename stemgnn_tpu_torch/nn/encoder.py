"""The GNN encoder stack (counterpart of ``stemgnn_tpu/nn/encoder.py``).

``num_layers`` SAGE convolutions, each followed by BatchNorm (for any
``normalize`` other than 'none', encoder.py:173,313-314), with activation
and dropout between layers.  Ported: the sage backbone in f32 compute, in
eval and in training (BatchNorm batch statistics over the ``node_mask``
rows, dropout from an explicit ``torch.Generator``), with the pair-hash edge
dropout (``drop_hash``).  Other backbones, MoE
layers and bf16 compute raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import EncoderConfig
from stemgnn_tpu_torch.nn.convs import SAGEConv
from stemgnn_tpu_torch.nn.layers import BatchNorm, dropout
from stemgnn_tpu_torch.ops.fused_sage import DropView


class Encoder(nn.Module):
    """Parameters mirror the JAX pytree ``{"layers": [...], "norms":
    [...]}``; BatchNorm running statistics are buffers."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        if cfg.backbone != "sage":
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not "
                                      f"ported; only sage")
        if cfg.moe_enabled and cfg.moe_layers != "none":
            raise NotImplementedError("MoE-SAGE layers are not ported")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("bf16 compute_dtype is not ported")
        self.cfg = cfg
        dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.num_layers
        self.layers = nn.ModuleList(
            SAGEConv(i, o, generator=generator)
            for i, o in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(BatchNorm(o) for o in dims[1:])

    def _act(self, z):
        if self.cfg.activation == "relu":
            return torch.relu(z)
        # torch nn.LeakyReLU default negative_slope = 0.01 (pretrain.py:85)
        return torch.nn.functional.leaky_relu(z, 0.01)

    def forward(self, x, senders, receivers, edge_feat=None, edge_mask=None,
                node_mask=None, layout=None, edge_table=None,
                plain: bool = False, generator=None, drop_hash=None):
        """Forward pass (encoder.py:283-323).  In training mode BatchNorm
        takes its statistics over the ``node_mask`` rows and dropout draws
        from ``generator``.  ``plain`` makes the fused path run its kernels'
        plain versions (see ops.fused_sage).  ``drop_hash=(seed, p)`` drops
        the edge pairs the pair hash picks in every layer; over a layout its
        masks are computed once and shared by the layers
        (``ops.fused_sage.DropView``)."""
        cfg = self.cfg
        if drop_hash is not None and layout is not None:
            drop_hash = DropView(layout, *drop_hash)
        z = x.float()
        for i, layer in enumerate(self.layers):
            if edge_feat is not None and edge_feat.shape[-1] != z.shape[-1]:
                raise ValueError(
                    f"edge feature dim {edge_feat.shape[-1]} must equal "
                    f"every layer's input dim (layer {i} gets "
                    f"{z.shape[-1]})")
            z = layer(z, senders, receivers, edge_feat=edge_feat,
                      edge_mask=edge_mask, layout=layout,
                      edge_table=edge_table,
                      bf16_messages=cfg.fused_bf16_messages, plain=plain,
                      drop_hash=drop_hash)
            if cfg.normalize != "none":
                z = self.norms[i](z, mask=node_mask)
            if i < cfg.num_layers - 1:
                z = dropout(self._act(z), cfg.dropout, training=self.training,
                            generator=generator)
        return z
