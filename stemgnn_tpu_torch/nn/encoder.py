"""The GNN encoder stack (counterpart of ``stemgnn_tpu/nn/encoder.py``).

``num_layers`` graph convolutions (sage / gcn / gin / gat, or a K-expert
MoE-SAGE layer where ``moe_layer_flags`` says so), each followed by
BatchNorm (for any ``normalize`` other than 'none', encoder.py:173,313-314),
with activation and dropout between layers.  In training BatchNorm takes
batch statistics over the ``node_mask`` rows and dropout draws from an
explicit ``torch.Generator``.  The sage backbone takes the pair-hash edge
dropout (``drop_hash``) and runs in f32 or bf16 compute
(``compute_dtype``: the input and the edge features cast to bf16, bf16
messages forced on, the parameters and BatchNorm statistics f32; JAX
encoder.py:94-99, 149-150); the other backbones are f32 only, as in JAX.

An MoE layer (encoder.py:109-129, 202-204, 230-277) routes each node over
its experts with ``softmax(env_encoder(z))`` in evaluation and a Gumbel
softmax at ``tau`` in training; the forward's aux holds the environment
regularizer ``env_reg`` (``mean(sum(w * log_softmax(logits)))`` over every
row, padded ones too, averaged over the MoE layers; 0 outside training)
and each MoE layer's router statistics over the ``node_mask`` rows.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import EncoderConfig
from stemgnn_tpu_torch.nn.convs import (GATConv, GCNConv, GINConv,
                                        MoESAGEConv, SAGEConv)
from stemgnn_tpu_torch.nn.layers import BatchNorm, Linear, dropout
from stemgnn_tpu_torch.ops.fused_sage import DropView

_CONVS = {"sage": SAGEConv, "gcn": GCNConv, "gin": GINConv, "gat": GATConv}


def gumbel_noise(shape, generator=None, device=None):
    """Standard Gumbel draws ``-log(-log(u))``, ``u`` uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


class Encoder(nn.Module):
    """Parameters mirror the JAX pytree ``{"layers": [...], "norms":
    [...], "env_encoders": [...]}``; BatchNorm running statistics are
    buffers."""

    def __init__(self, cfg: EncoderConfig, generator=None):
        super().__init__()
        if cfg.compute_dtype == "bfloat16" and cfg.backbone != "sage":
            raise ValueError("compute_dtype=bfloat16 supports the sage "
                             "backbone")
        if cfg.backbone not in _CONVS:
            raise ValueError(f"Unsupported backbone: {cfg.backbone}")
        self.cfg = cfg
        self.flags = tuple(f and cfg.backbone == "sage"
                           for f in cfg.moe_layer_flags())
        dims = [cfg.input_dim] + [cfg.hidden_dim] * cfg.num_layers
        layers, env = [], []
        for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
            if self.flags[i]:
                layers.append(MoESAGEConv(d_in, d_out, cfg.num_experts,
                                          generator=generator))
                env.append(Linear(d_in, cfg.num_experts, bias=True,
                                  weight_init="torch", generator=generator))
            else:
                layers.append(_CONVS[cfg.backbone](d_in, d_out,
                                                   generator=generator))
        self.layers = nn.ModuleList(layers)
        self.norms = nn.ModuleList(BatchNorm(o) for o in dims[1:])
        self.env_encoders = nn.ModuleList(env)

    def _act(self, z):
        if self.cfg.activation == "relu":
            return torch.relu(z)
        # torch nn.LeakyReLU default negative_slope = 0.01 (pretrain.py:85)
        return torch.nn.functional.leaky_relu(z, 0.01)

    def route(self, j: int, z, gumbel=None, generator=None):
        """The router of the ``j``-th MoE layer on its input ``z``:
        ``(weights [N, K], logits)``; in training a Gumbel softmax at
        ``tau`` over ``logits + gumbel`` (``gumbel`` drawn from
        ``generator`` when None), else a softmax."""
        logits = self.env_encoders[j](z)
        if not self.training:
            return torch.softmax(logits, dim=-1), logits
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        g = gumbel.to(logits.device, logits.dtype)
        return torch.softmax((logits + g) / self.cfg.tau, dim=-1), logits

    def forward(self, x, senders, receivers, edge_feat=None, edge_mask=None,
                node_mask=None, layout=None, edge_table=None,
                plain: bool = False, generator=None, drop_hash=None,
                compute_dtype=None, gumbel=None, return_aux: bool = False):
        """Forward pass (encoder.py:283-323): ``z``, or ``(z, aux)`` with
        ``return_aux``.  ``plain`` makes the fused path run its kernels'
        plain versions (see ops.fused_sage).  ``drop_hash=(seed, p)`` drops
        the edge pairs the pair hash picks in every sage layer; over a
        layout its masks are computed once and shared by the layers
        (``ops.fused_sage.DropView``).  An MoE layer reads ``edge_mask``,
        which carries a materialized dropout.  ``compute_dtype`` runs this
        pass at another compute dtype than the config's on the same
        parameters (the EMA teacher under ``teacher_bf16``, the graph
        task's evaluation under ``eval_bf16``).  ``gumbel`` hands the MoE
        layers their training noise, one [N, K] tensor a layer (drawn from
        ``generator`` when None)."""
        cfg = self.cfg
        bf16 = (compute_dtype or cfg.compute_dtype) == "bfloat16"
        if bf16 and cfg.backbone != "sage":
            raise ValueError("compute_dtype=bfloat16 supports the sage "
                             "backbone")
        dt = torch.bfloat16 if bf16 else torch.float32
        if drop_hash is not None and layout is not None:
            drop_hash = DropView(layout, *drop_hash)
        z = x.to(dt)
        if edge_feat is not None:
            edge_feat = edge_feat.to(dt)
        env_reg, stats, j = None, [], 0
        for i, layer in enumerate(self.layers):
            if self.flags[i]:
                w, logits = self.route(
                    j, z, None if gumbel is None else gumbel[j], generator)
                if self.training:
                    log_pi = torch.log_softmax(logits, dim=-1)
                    term = (w * log_pi).sum(-1).mean()
                    env_reg = term if env_reg is None else env_reg + term
                stats.append(_router_stats(i, w.detach(), node_mask))
                expert_out = layer(z, senders, receivers,
                                   edge_mask=edge_mask)
                z = (w[:, :, None] * expert_out).sum(1)
                j += 1
            elif cfg.backbone == "sage":
                if edge_feat is not None and \
                        edge_feat.shape[-1] != z.shape[-1]:
                    raise ValueError(
                        f"edge feature dim {edge_feat.shape[-1]} must equal "
                        f"every layer's input dim (layer {i} gets "
                        f"{z.shape[-1]})")
                z = layer(z, senders, receivers, edge_feat=edge_feat,
                          edge_mask=edge_mask, layout=layout,
                          edge_table=edge_table,
                          bf16_messages=cfg.fused_bf16_messages or bf16,
                          plain=plain, drop_hash=drop_hash)
            else:
                z = layer(z, senders, receivers, edge_mask=edge_mask)
            if cfg.normalize != "none":
                z = self.norms[i](z, mask=node_mask)
            if i < cfg.num_layers - 1:
                z = dropout(self._act(z), cfg.dropout, training=self.training,
                            generator=generator)
        if not return_aux:
            return z
        env_reg = (env_reg / j if env_reg is not None
                   else torch.zeros((), device=z.device))
        return z, {"env_reg": env_reg.float(), "moe_stats": stats}


def _router_stats(layer: int, w, node_mask):
    """One MoE layer's router usage (encoder.py:244-255): the summed
    probabilities and top-1 one-hots over the ``node_mask`` rows, and their
    count."""
    k = w.shape[1]
    top1 = torch.nn.functional.one_hot(w.argmax(-1), k).to(w.dtype)
    if node_mask is None:
        count = torch.tensor(w.shape[0], device=w.device)
    else:
        keep = node_mask[:, None]
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        w = torch.where(keep, w, zero)
        top1 = torch.where(keep, top1, zero)
        count = node_mask.sum()
    return {"layer": layer, "sum_prob": w.sum(0), "sum_top1": top1.sum(0),
            "count": count}
