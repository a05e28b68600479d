"""Finetune task head (counterpart of ``stemgnn_tpu/models/task.py``):
the (pretrained) encoder + VQ backbone with a small linear decoder
(STEM-GNN/model/ft_model.py:23-107).

  * ``separate_decoder_for_each_head``: Linear(code_dim*H -> C*H) over the
    pre-project_out codes, reshaped to [N, H, C] (ft_model.py:40-43,93-94);
    otherwise Linear(dim -> C) over the post-project_out ``quantize``
    (ft_model.py:96);
  * ``use_vq=0`` bypass decodes ``vq.project_in(z)`` (ft_model.py:98-103);
  * decoder Jacobian penalty = coeff * ||W||_F^2 (ft_model.py:45-50);
  * the activation loss: head-mean logits -> masked cross entropy.

Parameter names follow the JAX pytree ``{"encoder", "vq", "decoder"}``.
Graph pooling and the multitask BCE come with the graph-task slice.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
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


def encode(model: TaskModel, g, *, generator=None, plain: bool = False):
    """Encoder forward on a padded graph (train or eval by the module's
    mode); the graph's layout and edge table are used when present."""
    return model.encoder(g.node_feat, g.senders, g.receivers,
                         edge_feat=g.edge_feat, edge_mask=g.edge_mask,
                         node_mask=g.node_mask, layout=g.layout,
                         edge_table=g.edge_table, plain=plain,
                         generator=generator)


def maybe_kmeans_init_vq(model: TaskModel, cfg: FinetuneConfig, g, *,
                         generator=None, means=None):
    """k-means-init the VQ codebook from the eval-mode encoding of the graph
    ``g`` when the task uses the VQ and the codebook is not initted yet (JAX
    ``maybe_kmeans_init_vq``; the reference's lazy init on the first
    forward, vq.py:646).  A host check; call once before training.  Returns
    the bins [h, c] of the init, or None when nothing was done."""
    if not cfg.use_vq or bool(model.vq.initted):
        return None
    was_training = model.training
    model.eval()
    with torch.no_grad():
        z = encode(model, g)
    model.train(was_training)
    return vq_kmeans_init(model.vq, z, mask=g.node_mask, generator=generator,
                          means=means)


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


def activation_loss(logits, y, task: str = "single", mask=None):
    """compute_activation_loss (ft_model.py:82-88) for single-label tasks:
    head-mean logits -> cross entropy, averaged over the ``mask`` rows."""
    if task != "single":
        raise NotImplementedError("the multitask BCE comes with the graph "
                                  "task")
    logp = torch.log_softmax(logits.mean(1), dim=-1)
    nll = -logp.gather(1, y[:, None].long())[:, 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
