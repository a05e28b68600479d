"""Finetune task head (counterpart of ``stemgnn_tpu/models/task.py``):
the (pretrained) encoder + VQ backbone with a small linear decoder
(STEM-GNN/model/ft_model.py:23-107).

  * ``separate_decoder_for_each_head``: Linear(code_dim*H -> C*H) over the
    pre-project_out codes, reshaped to [N, H, C] (ft_model.py:40-43,93-94);
    otherwise Linear(dim -> C) over the post-project_out ``quantize``
    (ft_model.py:96);
  * ``use_vq=0`` bypass decodes ``vq.project_in(z)`` (ft_model.py:98-103);
  * decoder Jacobian penalty = coeff * ||W||_F^2 (ft_model.py:45-50);
  * the activation loss: head-mean logits -> masked cross entropy, or the
    multitask masked BCE of the graph tasks with y in {-1, +1} and the
    NaN labels masked (ft_model.py:7-20);
  * graph-level pooling mean/sum/max over a disjoint batch
    (ft_model.py:61-69).

Parameter names follow the JAX pytree ``{"encoder", "vq", "decoder"}``; a
graph task's decoder has ``num_classes = num_tasks`` outputs a head.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops import segment
from stemgnn_tpu_torch.vq.quantize import VectorQuantize, vq_kmeans_init


class TaskModel(nn.Module):
    def __init__(self, encoder: Encoder, vq: VectorQuantize,
                 decoder: Linear):
        super().__init__()
        self.encoder, self.vq, self.decoder = encoder, vq, decoder


def task_model_init(cfg: FinetuneConfig, encoder: Encoder = None,
                    vq: VectorQuantize = None, generator=None) -> TaskModel:
    """A task model around the (pretrained) ``encoder`` and ``vq`` — fresh
    ones when None — with a new decoder drawn from ``generator``."""
    encoder = encoder if encoder is not None else Encoder(
        cfg.encoder, generator=generator)
    vq = vq if vq is not None else VectorQuantize(cfg.vq, generator=generator)
    h = cfg.vq.num_codebooks
    if cfg.separate_decoder_for_each_head:
        dec = Linear(cfg.vq.codebook_dim * h, cfg.num_classes * h,
                     generator=generator)
    else:
        dec = Linear(cfg.vq.dim, cfg.num_classes, generator=generator)
    return TaskModel(encoder, vq, dec)


def encode(model: TaskModel, g, *, generator=None, plain: bool = False,
           compute_dtype=None, gumbel=None, return_aux: bool = False):
    """Encoder forward on a padded graph (train or eval by the module's
    mode); the graph's layout and edge table are used when present.
    ``compute_dtype`` overrides the encoder config's for this pass;
    ``gumbel`` hands the MoE layers their training noise; ``return_aux``
    returns ``(z, aux)`` with the MoE regularizer and router statistics
    (``nn.encoder.Encoder.forward``)."""
    return model.encoder(g.node_feat, g.senders, g.receivers,
                         edge_feat=g.edge_feat, edge_mask=g.edge_mask,
                         node_mask=g.node_mask, layout=g.layout,
                         edge_table=g.edge_table, plain=plain,
                         generator=generator, compute_dtype=compute_dtype,
                         gumbel=gumbel, return_aux=return_aux)


def maybe_kmeans_init_vq(model: TaskModel, cfg: FinetuneConfig, g, *,
                         generator=None, means=None, plain: bool = False):
    """k-means-init the VQ codebook from the eval-mode encoding of the graph
    ``g`` when the task uses the VQ and the codebook is not initted yet (JAX
    ``maybe_kmeans_init_vq``; the reference's lazy init on the first
    forward, vq.py:646).  A host check; call once before training.  Returns
    the bins [h, c] of the init, or None when nothing was done.  ``plain``
    encodes through the aggregation kernels' plain versions."""
    if not cfg.use_vq or bool(model.vq.initted):
        return None
    was_training = model.training
    model.eval()
    with torch.no_grad():
        z = encode(model, g, plain=plain)
    model.train(was_training)
    return vq_kmeans_init(model.vq, z, mask=g.node_mask, generator=generator,
                          means=means)


def pool_graph(z, g, pool: str = "mean", num_segments: int = None):
    """Graph-level readout over the disjoint batch ``g`` (JAX
    ``pool_graph``, ft_model.py:61-69): [num_segments, D].  Padded nodes
    (and any graph id past ``num_segments``) contribute nothing, as JAX's
    masked segment ops with their out-of-range ids give."""
    if g.node_graph_id is None:
        raise ValueError("graph pooling needs node_graph_id")
    if num_segments is None:
        num_segments = int(g.node_graph_id.shape[0])
    ids = g.node_graph_id.long()
    keep = g.node_mask & (ids < num_segments)
    ids = torch.where(keep, ids, torch.zeros((), dtype=ids.dtype,
                                             device=ids.device))
    fn = {"mean": segment.segment_mean, "sum": segment.segment_sum,
          "max": segment.segment_max}[pool]
    return fn(z, ids, num_segments, mask=keep)


def task_logits(model: TaskModel, cfg: FinetuneConfig, z, mask=None):
    """get_lin_logits (ft_model.py:90-103) -> ([N, H or 1, C],
    commitment loss).  ``mask`` [N] marks the rows the VQ loss covers."""
    h = cfg.vq.num_codebooks
    n = z.shape[0]
    if cfg.use_vq:
        separate = cfg.separate_decoder_for_each_head
        res = model.vq(z, mask=mask, freeze_codebook=cfg.freeze_vq,
                       with_quantize=not separate)
        if separate:
            pred = model.decoder(res["codes"]).reshape(n, h, cfg.num_classes)
        else:
            pred = model.decoder(res["quantize"]).reshape(n, 1,
                                                          cfg.num_classes)
        return pred, res["loss"]
    if cfg.separate_decoder_for_each_head:
        codes = (model.vq.project_in(z) if cfg.vq.requires_projection
                 else z)
        pred = model.decoder(codes).reshape(n, h, cfg.num_classes)
    else:
        pred = model.decoder(z).reshape(n, 1, cfg.num_classes)
    return pred, torch.zeros((), device=z.device)


def decoder_jacobian_penalty(model: TaskModel, cfg: FinetuneConfig):
    """coeff * ||W||_F^2 (ft_model.py:45-50)."""
    if cfg.decoder_jac_coeff <= 0:
        return torch.zeros((), device=model.decoder.w.device)
    return cfg.decoder_jac_coeff * (model.decoder.w ** 2).sum()


def multitask_bce(pred, y, valid):
    """Masked multitask BCE (ft_model.py:7-20, JAX ``multitask_bce``):
    ``y`` in {-1, +1} on the ``valid`` entries; the sum of the elementwise
    BCE with logits over them, divided by their count."""
    target = (y + 1.0) / 2.0
    per = (torch.clamp(pred, min=0) - pred * target
           + torch.log1p(torch.exp(-pred.abs())))
    per = torch.where(valid, per, torch.zeros((), dtype=per.dtype,
                                              device=per.device))
    return per.sum() / torch.clamp(valid.sum().to(per.dtype), min=1.0)


def activation_loss(logits, y, task: str = "single", mask=None, valid=None):
    """compute_activation_loss (ft_model.py:82-88): head-mean logits ->
    cross entropy averaged over the ``mask`` rows ("single"), or the
    multitask BCE over the ``valid`` labels of the ``mask`` rows
    ("multi")."""
    mean_logits = logits.mean(1)
    if task == "single":
        logp = torch.log_softmax(mean_logits, dim=-1)
        nll = -logp.gather(1, y[:, None].long())[:, 0]
        if mask is None:
            return nll.mean()
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if task == "multi":
        if valid is None:
            valid = torch.ones_like(mean_logits, dtype=torch.bool)
        if mask is not None:
            valid = valid & mask[:, None]
        return multitask_bce(mean_logits, y, valid)
    raise ValueError('task must be "single" or "multi"')
