"""The pretraining objective (counterpart of
``stemgnn_tpu/models/pretrain.py``; the reference's ``PretrainModel``,
STEM-GNN/model/pt_model.py:11-142): encoder -> VQ -> four reconstruction
losses + the EMA teacher.

  * feat_recon — MSE of a linear decode of the quantized codes against the
    original features on the first ``bs`` seed nodes (42-43);
  * topo_recon — the pos/neg log-loss of the inner-product edge decoder
    over a random subsample of the edges and as many random node pairs
    (46-65);
  * topo_sem — MSE of the edge features rebuilt from ``cat[q_u, q_v]``
    (68-83);
  * sem_recon — cosine alignment of a projection of the quantized codes to
    the teacher's encoding of the clean graph, detached (86-102);
  * plus the VQ's commitment and orthogonal terms and the encoder's MoE
    environment regularizer (``env_reg_loss``, 0 without MoE layers).

The teacher is a second :class:`~stemgnn_tpu_torch.nn.encoder.Encoder`
outside the optimizer, advanced by :func:`ema_update_teacher` (decay 0.99,
pt_model.py:104-106); it runs in training mode, so its BatchNorm normalizes
with batch statistics and its running statistics update, as the
reference's teacher does.

Mixed precision (JAX models/pretrain.py:146-208): a bf16 encoder hands its
bf16 ``z`` to the VQ; ``loss_bf16`` gives the four decoders a bf16 copy of
the quantized codes, while targets, sigmoids' logs and reductions stay
f32; ``teacher_bf16`` runs the teacher's pass at a bf16 compute dtype on
its f32 parameters.

The topo-sem target: JAX reads ``orig_g.edge_feat`` and scores 0 on a
layout graph, which carries no materialized edge features.  The port reads
the same values from the graph's edge-type table by each edge's type
instead (``edge_table[xe]``, what ``edge_feat`` holds), as the JAX halo
pretrain does (parallel/halo_pretrain.py), so the full-graph step trains
all four losses.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from stemgnn_tpu_torch.core.config import PretrainConfig
from stemgnn_tpu_torch.nn.decoders import InnerProductDecoder
from stemgnn_tpu_torch.nn.encoder import Encoder
from stemgnn_tpu_torch.nn.layers import Linear
from stemgnn_tpu_torch.ops.spmm import gather_rows
from stemgnn_tpu_torch.vq.quantize import VectorQuantize

EPS = 1e-15


class PretrainModel(nn.Module):
    """The student: parameters named as the JAX ``pretrain_init`` params
    tree (``encoder``, ``vq``, ``feat_dec``, ``topo_dec``, ``topo_sem_dec``,
    ``sem_projector``)."""

    def __init__(self, cfg: PretrainConfig, generator=None):
        super().__init__()
        h, d_in = cfg.encoder.hidden_dim, cfg.encoder.input_dim
        self.encoder = Encoder(cfg.encoder, generator=generator)
        self.vq = VectorQuantize(cfg.vq, generator=generator)
        self.feat_dec = Linear(h, d_in, generator=generator)
        self.topo_dec = InnerProductDecoder(h, h, generator=generator)
        self.topo_sem_dec = Linear(2 * h, h, generator=generator)
        self.sem_projector = Linear(h, h, generator=generator)


def make_teacher(model: PretrainModel) -> Encoder:
    """The teacher: an exact copy of the student's encoder (pt_model.py:22)
    that takes no gradients."""
    teacher = copy.deepcopy(model.encoder)
    for p in teacher.parameters():
        p.requires_grad_(False)
    return teacher


@torch.no_grad()
def ema_update_teacher(teacher: Encoder, student: Encoder,
                       decay: float = 0.99):
    """param_k = decay * param_k + (1 - decay) * param_q over the
    parameters (pt_model.py:104-106); the teacher's BatchNorm statistics are
    its own."""
    for k, q in zip(teacher.parameters(), student.parameters()):
        k.copy_(decay * k + (1.0 - decay) * q)


def sample_edge_slots(edge_mask, num: int, generator=None):
    """``num`` edge slots drawn uniformly with replacement and their validity
    weights (JAX ``_sample_edge_slots``; the reference's randperm edge
    subsample, pt_model.py:53-57)."""
    slots = torch.randint(0, edge_mask.shape[0], (num,), generator=generator,
                          device=edge_mask.device)
    return slots, edge_mask[slots].float()


def negative_edges(num: int, n_node: int, generator=None, device=None):
    """Uniform random node pairs over the valid nodes as negatives (JAX
    ``_negative_edges``; PyG ``negative_sampling``, pt_model.py:59-60)."""
    hi = max(n_node, 1)
    return tuple(torch.randint(0, hi, (num,), generator=generator,
                               device=device) for _ in range(2))


def topo_num_slots(cfg: PretrainConfig, num_edges_padded: int) -> int:
    return max(int(num_edges_padded * cfg.topo_recon_ratio), 1)


def edge_types(graph):
    """[E_pad] original-order edge-type ids of a layout graph (0 where the
    layout has no type stream)."""
    lay = graph.layout
    e = graph.num_edges_padded
    if lay.xe_r is None:
        return torch.zeros(e, dtype=torch.long, device=graph.senders.device)
    out = torch.zeros(e, dtype=torch.long, device=lay.xe_r.device)
    out[lay.perm_r2o[:e].long()] = lay.xe_r[:e].long()
    return out


def _edge_targets(graph, slots):
    """The edge features of ``slots`` (f32), or None when the graph has
    none."""
    if graph.edge_feat is not None:
        return graph.edge_feat[slots].float()
    if graph.edge_table is None or graph.layout is None:
        return None
    return graph.edge_table[edge_types(graph)[slots]].float()


def _l2n(t):
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def pretrain_forward(model: PretrainModel, teacher: Encoder,
                     cfg: PretrainConfig, aug_g, orig_g, *, bs: int,
                     draws: dict, drop_seed=None, generator=None,
                     plain: bool = False):
    """The training-mode pretrain forward (JAX ``pretrain_forward``,
    pt_model.py:116-142): ``(total_loss, losses, vq result)``.

    ``aug_g`` is ``orig_g`` with masked features and, off the layout path,
    the dropout's edge mask.  With a layout and ``drop_seed``, the encoder
    takes the dropout as ``drop_hash`` (the fused form).  ``draws`` holds
    the step's random draws: ``slots`` and ``neg`` (the topo-recon edges)
    and ``ortho_ids`` (the orthogonal term's codes, or None for all), and
    optionally the MoE layers' Gumbel noise of the student (``gumbel``) and
    of the teacher (``teacher_gumbel``), one [N, K] tensor a layer;
    ``generator`` feeds the encoders' dropout and any Gumbel noise not
    handed in.  ``plain`` runs the aggregation kernels' plain versions.
    The third value is the aux: the VQ's result (``vq``) and the student's
    MoE router statistics (``moe_stats``)."""
    model.train()
    teacher.train()
    use_hash = (orig_g.layout is not None and cfg.edge_p > 0
                and drop_seed is not None)
    # the sage layers take the dropout as drop_hash over the layout; an MoE
    # layer reads the augmented view's edge mask, which carries it
    z, enc_aux = model.encoder(
        aug_g.node_feat, aug_g.senders, aug_g.receivers,
        edge_feat=aug_g.edge_feat, edge_mask=aug_g.edge_mask,
        node_mask=aug_g.node_mask, layout=aug_g.layout,
        edge_table=aug_g.edge_table, plain=plain, generator=generator,
        drop_hash=(drop_seed, cfg.edge_p) if use_hash else None,
        gumbel=draws.get("gumbel"), return_aux=True)
    vq_res = model.vq(z, mask=aug_g.node_mask,
                      ortho_ids=draws.get("ortho_ids"), generator=generator)
    query = vq_res["quantize"]
    seed_mask = orig_g.node_mask[:bs].float()
    # loss_bf16: the decoders read a bf16 copy of the query
    query_l = query.to(torch.bfloat16) if cfg.loss_bf16 else query

    # feat recon (pt_model.py:42-43): MSE over the first bs seed nodes
    recon = model.feat_dec(query_l[:bs]).float()
    se = (recon - orig_g.node_feat[:bs].float()) ** 2
    denom = torch.clamp(seed_mask.sum() * se.shape[-1], min=1.0)
    feat = (se * seed_mask[:, None]).sum() / denom

    zero = torch.zeros((), device=query.device)
    topo = topo_sem = zero
    if cfg.topo_recon_ratio > 0.0:
        slots = draws["slots"]
        w = orig_g.edge_mask[slots].float()
        w_sum = torch.clamp(w.sum(), min=1.0)
        pos_s, pos_r = orig_g.senders[slots], orig_g.receivers[slots]
        pos_p = model.topo_dec(query_l, pos_s, pos_r).float()
        neg_s, neg_r = draws["neg"]
        neg_p = model.topo_dec(query_l, neg_s, neg_r).float()
        pos_loss = -(w * torch.log(pos_p + EPS)).sum() / w_sum
        neg_loss = -torch.log(1.0 - neg_p + EPS).mean()
        topo = pos_loss + neg_loss
        # topo-sem recon (pt_model.py:68-83): edge-feature MSE
        target = _edge_targets(orig_g, slots)
        if target is not None:
            zz = torch.cat([gather_rows(query_l, pos_s),
                            gather_rows(query_l, pos_r)], dim=-1)
            pred = model.topo_sem_dec(zz).float()
            se_e = ((pred - target) ** 2).mean(-1)
            topo_sem = (w * se_e).sum() / w_sum

    # sem recon (pt_model.py:86-102): cosine alignment to the teacher's
    # encoding of the clean graph, detached
    with torch.no_grad():
        tz = teacher(orig_g.node_feat, orig_g.senders, orig_g.receivers,
                     edge_feat=orig_g.edge_feat, edge_mask=orig_g.edge_mask,
                     node_mask=orig_g.node_mask, layout=orig_g.layout,
                     edge_table=orig_g.edge_table, plain=plain,
                     generator=generator,
                     compute_dtype=("bfloat16" if cfg.teacher_bf16
                                    else None),
                     gumbel=draws.get("teacher_gumbel")).float()
    hproj = model.sem_projector(query_l).float()
    cos = 1.0 - (_l2n(tz[:bs]) * _l2n(hproj[:bs])).sum(-1)
    sem = (cos * seed_mask).sum() / torch.clamp(seed_mask.sum(), min=1.0)

    commit = vq_res["loss"]
    env = enc_aux["env_reg"]
    losses = {"feat_recon_loss": feat, "topo_recon_loss": topo,
              "topo_sem_recon_loss": topo_sem, "sem_recon_loss": sem,
              "commit_loss": commit, "env_reg_loss": env}
    total = (cfg.feat_lambda * feat + cfg.topo_lambda * topo
             + cfg.topo_sem_lambda * topo_sem + cfg.sem_lambda * sem
             + commit + cfg.lamda_env * env)
    return total, losses, {"vq": vq_res,
                           "moe_stats": enc_aux["moe_stats"]}
