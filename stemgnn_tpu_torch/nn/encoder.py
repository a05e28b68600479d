"""The GNN encoder stack (counterpart of ``stemgnn_tpu/nn/encoder.py``).

``num_layers`` SAGE convolutions, each followed by BatchNorm (for any
``normalize`` other than 'none', encoder.py:173,313-314), with activation
and dropout between layers.  Ported: the sage backbone in eval and in
training (BatchNorm batch statistics over the ``node_mask`` rows, dropout
from an explicit ``torch.Generator``), with the pair-hash edge dropout
(``drop_hash``), in f32 or bf16 compute (``compute_dtype``: the input and
the edge features cast to bf16, bf16 messages forced on, the parameters
and BatchNorm statistics f32; JAX encoder.py:94-99, 149-150).  Other
backbones and MoE layers raise ``NotImplementedError``.
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
        if cfg.compute_dtype == "bfloat16" and cfg.backbone != "sage":
            raise ValueError("compute_dtype=bfloat16 supports the sage "
                             "backbone")
        if cfg.backbone != "sage":
            raise NotImplementedError(f"backbone {cfg.backbone!r} is not "
                                      f"ported; only sage")
        if cfg.moe_enabled and cfg.moe_layers != "none":
            raise NotImplementedError("MoE-SAGE layers are not ported")
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
                plain: bool = False, generator=None, drop_hash=None,
                compute_dtype=None):
        """Forward pass (encoder.py:283-323).  In training mode BatchNorm
        takes its statistics over the ``node_mask`` rows and dropout draws
        from ``generator``.  ``plain`` makes the fused path run its kernels'
        plain versions (see ops.fused_sage).  ``drop_hash=(seed, p)`` drops
        the edge pairs the pair hash picks in every layer; over a layout its
        masks are computed once and shared by the layers
        (``ops.fused_sage.DropView``).  ``compute_dtype`` runs this pass
        at another compute dtype than the config's on the same parameters
        (the EMA teacher under ``teacher_bf16``, the graph task's
        evaluation under ``eval_bf16``)."""
        cfg = self.cfg
        bf16 = (compute_dtype or cfg.compute_dtype) == "bfloat16"
        dt = torch.bfloat16 if bf16 else torch.float32
        if drop_hash is not None and layout is not None:
            drop_hash = DropView(layout, *drop_hash)
        z = x.to(dt)
        if edge_feat is not None:
            edge_feat = edge_feat.to(dt)
        for i, layer in enumerate(self.layers):
            if edge_feat is not None and edge_feat.shape[-1] != z.shape[-1]:
                raise ValueError(
                    f"edge feature dim {edge_feat.shape[-1]} must equal "
                    f"every layer's input dim (layer {i} gets "
                    f"{z.shape[-1]})")
            z = layer(z, senders, receivers, edge_feat=edge_feat,
                      edge_mask=edge_mask, layout=layout,
                      edge_table=edge_table,
                      bf16_messages=cfg.fused_bf16_messages or bf16,
                      plain=plain,
                      drop_hash=drop_hash)
            if cfg.normalize != "none":
                z = self.norms[i](z, mask=node_mask)
            if i < cfg.num_layers - 1:
                z = dropout(self._act(z), cfg.dropout, training=self.training,
                            generator=generator)
        return z
