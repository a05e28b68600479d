"""The full-graph pretrain step (counterpart of ``make_pretrain_step`` in
``stemgnn_tpu/train/pretrain_loop.py``, :37-88, with a fused layout; the
reference's pretrain.py:25-167 per batch).

One step: draw the augmentation (a column feature mask and the pair-hash
edge dropout's seed, pretrain.py:41-45), run :func:`~stemgnn_tpu_torch.
models.pretrain.pretrain_forward` (the dropout reaches the fused
aggregation as ``drop_hash``), backpropagate, clip the global gradient norm
and take an AdamW step with the cosine schedule (``train.optim``), then
move the EMA teacher towards the student.  Every random draw comes from one
``torch.Generator``; a caller may hand the step its draws instead (the
parity tests hand it JAX's).

The JAX package's CLI and ``run_pretrain`` run the minibatch loop over the
unported neighbour sampler; they are not ported.
"""

from __future__ import annotations

import dataclasses

from stemgnn_tpu_torch.core.config import FinetuneConfig, PretrainConfig
from stemgnn_tpu_torch.models.pretrain import (ema_update_teacher,
                                               negative_edges,
                                               pretrain_forward,
                                               sample_edge_slots,
                                               topo_num_slots)
from stemgnn_tpu_torch.train import augment
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.train.optim import Optimizer
from stemgnn_tpu_torch.vq.codebook import orthogonal_subset


def pretrain_graph(ds, cfg: PretrainConfig, device="cuda"):
    """The padded full graph of ``ds`` with the fused layout (hub blocks of
    up to 2,048 nodes a side, as the JAX step probe builds it) where
    ``fused_full_graph`` gives one (on CUDA)."""
    return fused_full_graph(ds, FinetuneConfig(encoder=cfg.encoder),
                            device=device)


def make_pretrain_optimizer(model, cfg: PretrainConfig):
    """AdamW over every student parameter with the clip and the schedule of
    ``cfg``, the schedule stepping once a step (JAX ``run_pretrain``,
    pretrain_loop.py:214-216)."""
    return Optimizer(model.parameters(), cfg.lr, cfg.weight_decay,
                     grad_clip=cfg.grad_clip, use_scheduler=cfg.use_scheduler,
                     epochs=cfg.epochs)


def draw_step(cfg: PretrainConfig, graph, generator=None) -> dict:
    """One step's random draws from ``generator`` (on the graph's device):
    ``feat_keep`` [D] bool, ``drop_seed`` (0-dim int64), the topo-recon
    ``slots`` and ``neg`` pairs, and ``ortho_ids`` (None when the
    orthogonal term covers every code)."""
    dev = graph.node_feat.device
    num = topo_num_slots(cfg, graph.num_edges_padded)
    return dict(
        feat_keep=augment.feature_keep(graph.node_feat.shape[1], cfg.feat_p,
                                       generator, dev),
        drop_seed=augment.dropout_edge_seed(generator, dev),
        slots=sample_edge_slots(graph.edge_mask, num, generator)[0],
        neg=negative_edges(num, graph.n_node, generator, dev),
        ortho_ids=orthogonal_subset(cfg.vq.codebook_size,
                                    cfg.vq.orthogonal_reg_max_codes,
                                    generator, dev))


def augmented(cfg: PretrainConfig, graph, draws: dict):
    """The augmented view: masked feature columns, and the dropout's edge
    mask (read off the layout path; the fused path takes the seed)."""
    return dataclasses.replace(
        graph, node_feat=augment.mask_feature(graph.node_feat,
                                              draws["feat_keep"]),
        edge_mask=augment.dropout_edges_undirected_seeded(
            draws["drop_seed"], graph.senders, graph.receivers,
            graph.edge_mask, cfg.edge_p))


def make_pretrain_step(cfg: PretrainConfig, bs: int, generator=None):
    """``step(model, teacher, opt, graph, draws=None)`` -> the step's losses
    (detached 0-dim tensors, ``loss`` the total).  ``model`` is a
    :class:`~stemgnn_tpu_torch.models.pretrain.PretrainModel`, ``teacher``
    its EMA encoder, ``opt`` from :func:`make_pretrain_optimizer`; ``bs``
    the seed-node count of the losses (the padded node count for the full
    graph).  ``draws`` (see :func:`draw_step`) replaces the step's own
    draws; ``generator`` feeds them and the encoders' dropout."""

    def step(model, teacher, opt, graph, draws=None):
        if draws is None:
            draws = draw_step(cfg, graph, generator)
        opt.zero_grad()
        loss, losses, _ = pretrain_forward(
            model, teacher, cfg, augmented(cfg, graph, draws), graph, bs=bs,
            draws=draws, drop_seed=draws["drop_seed"], generator=generator)
        loss.backward()
        opt.step()
        ema_update_teacher(teacher, model.encoder, cfg.sem_encoder_decay)
        return {**{k: v.detach() for k, v in losses.items()},
                "loss": loss.detach()}

    return step
