"""Plain reference of ``stemgnn-pretrain-sage768-vq4x128``: STEM-GNN's
pretrain step on the full graph (model/pt_model.py, pretrain.py), in plain
PyTorch from ``benchmark.plain``.

One step: the column feature mask and the undirected pair-hash edge
dropout give the augmented view; the student (2-layer SAGE with
BatchNorm, relu and inverted dropout) encodes it; the 4-head cosine VQ
quantizes it (straight-through codes, commitment and orthogonal terms);
four losses decode the quantized codes (feature MSE, the inner-product
edge log-loss over sampled edges and random pairs, the edge-feature MSE
from ``cat[q_u, q_v]``, and the cosine alignment to the EMA teacher's
encoding of the clean graph); then the global clip, AdamW with the cosine
schedule, and the teacher's EMA.  The dropout's uniforms are drawn again
from the generator state the program's step started from, student first,
then teacher.

``fault="half_batch"`` leaves every other row (and sampled edge) out of
the losses and takes their means over the rest: a fault the comparison
has to see.  ``fault="flip<k>"`` gives the first step's ``k`` (row, head)
pairs nearest to a code tie their second-best code: what a rounding
difference does to a near-tie, which the comparison has to tolerate;
``fault="hubflip<k>"`` does so among the 64 nodes of the largest
in-degree, whose codes reach the most sampled edges.
"""

from __future__ import annotations

import torch

from benchmark import plain

EPS = 1e-15


def _losses(p, teacher, conf, data, draws, u_student, u_teacher, fault):
    enc, vq = conf["encoder"], conf["vq"]
    x, mask = data["x"], data["node_mask"]
    n_pad = x.shape[0]
    g = dict(senders=data["senders"], receivers=data["receivers"],
             t0=data["t0"], node_mask=mask,
             edge_order=data.get("edge_order"))
    keep_col = draws["feat_keep"]
    xa = torch.where(keep_col[None, :], x, torch.zeros((), device=x.device))
    kept = data["edge_valid"] & plain.pair_keep(
        draws["drop_seed"], g["senders"], g["receivers"], conf["edge_p"])
    z = plain.encoder(p, "encoder.", xa, g, kept,
                      plain.inv_in_degree(g["receivers"], kept, n_pad),
                      num_layers=enc["num_layers"], batch_norm_on=True,
                      keep_u=[u_student], dropout=enc["dropout"])
    flip, flip_rows = plain.flip_rows(fault, data, mask)
    xh, q, scores = plain.quantize(p, z, heads=vq["heads"],
                                   code_dim=vq["codebook_dim"], flip=flip,
                                   rows=flip_rows)
    margin = plain.code_margin(scores.detach())[mask]
    rows = mask.clone()
    if fault == "half_batch":
        rows &= torch.arange(n_pad, device=x.device) % 2 == 0
    rf = rows.float()
    commit = (((q - xh) ** 2) * rf[None, :, None]).sum() / (
        rf.sum() * q.shape[0] * q.shape[-1]).clamp(min=1.0)
    vq_loss = (vq["commitment_weight"] * commit
               + vq["orthogonal_reg_weight"]
               * plain.orthogonal_loss(p["vq.embed"], draws["ortho_ids"]))
    codes = plain.from_heads(xh + (q - xh).detach())
    query = plain.linear(p, "vq.project_out", codes)

    recon = plain.linear(p, "feat_dec", query)
    se = ((recon - x) ** 2 * rf[:, None]).sum()
    feat = se / (rf.sum() * x.shape[1]).clamp(min=1.0)

    slots = draws["slots"]
    w = data["edge_valid"][slots].float()
    if fault == "half_batch":
        w = w * (torch.arange(slots.shape[0], device=x.device) % 2 == 0)
    w_sum = w.sum().clamp(min=1.0)
    ps, pr = g["senders"][slots], g["receivers"][slots]
    lq = plain.linear(p, "topo_dec.lin", query)
    pos = torch.sigmoid((lq[ps] * lq[pr]).sum(-1))
    ns, nr = draws["neg"]
    neg = torch.sigmoid((lq[ns] * lq[nr]).sum(-1))
    topo = (-(w * torch.log(pos + EPS)).sum() / w_sum
            - torch.log(1.0 - neg + EPS).mean())
    pred = plain.linear(p, "topo_sem_dec", torch.cat([query[ps], query[pr]],
                                                     dim=-1))
    topo_sem = (w * ((pred - data["t0"]) ** 2).mean(-1)).sum() / w_sum

    with torch.no_grad():
        tz = plain.encoder(teacher, "teacher.", x, g, data["edge_valid"],
                           plain.inv_in_degree(g["receivers"],
                                               data["edge_valid"], n_pad),
                           num_layers=enc["num_layers"], batch_norm_on=True,
                           keep_u=[u_teacher], dropout=enc["dropout"])
    hproj = plain.linear(p, "sem_projector", query)
    cos = 1.0 - (plain.l2norm(tz) * plain.l2norm(hproj)).sum(-1)
    sem = (cos * rf).sum() / rf.sum().clamp(min=1.0)
    parts = dict(feat_recon_loss=feat, topo_recon_loss=topo,
                 topo_sem_recon_loss=topo_sem, sem_recon_loss=sem,
                 commit_loss=vq_loss)
    return (conf["feat_lambda"] * feat + conf["topo_lambda"] * topo
            + conf["topo_sem_lambda"] * topo_sem + conf["sem_lambda"] * sem
            + vq_loss), margin, parts


def run(conf: dict, data: dict, init: dict, steps: list, *, tf32=False,
        fault=None) -> dict:
    """The reference's ``len(steps)`` steps from ``init`` (the student's
    leaves by the program's names, the teacher's as ``teacher.<name>``):
    ``losses`` [float] a step, ``grads1`` the first step's clipped
    gradients, ``params`` every leaf after the last step, ``parts`` each
    step's loss terms, ``margins`` each step's smallest code-score margin a
    valid row."""
    student = {k: v.detach().clone() for k, v in init.items()
               if not k.startswith("teacher.")}
    teacher = {k: v.detach().clone() for k, v in init.items()
               if k.startswith("teacher.")}
    opt = plain.AdamW(student, conf["lr"], conf["weight_decay"])
    losses, grads1, margins, parts = [], None, [], []
    fault = fault or ""
    shape = tuple(data["x"].shape)
    with plain.matmul_precision(tf32):
        for t, st in enumerate(steps):
            u_s, u_t = plain.dropout_draws(st["rng_state"], shape, 2,
                                           data["x"].device)
            leaves = {k: v.requires_grad_(True) for k, v in student.items()}
            loss, margin, part = _losses(
                leaves, teacher, conf, data, st["draws"], u_s, u_t,
                fault if t == 0 or "flip" not in fault else None)
            margins.append(margin)
            parts.append({k: float(v.detach()) for k, v in part.items()})
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            grads = {k: (torch.zeros_like(v) if gr is None else gr)
                     for (k, v), gr in zip(leaves.items(), got)}
            grads = plain.clip_global(grads, conf["grad_clip"])
            if t == 0:
                grads1 = grads
            losses.append(float(loss.detach()))
            factor = (plain.cosine_factor(t, conf["epochs"])
                      if conf["use_scheduler"] else 1.0)
            student = opt.step({k: v.detach() for k, v in student.items()},
                               grads, factor)
            d = conf["sem_encoder_decay"]
            teacher = {k: d * v + (1.0 - d) * student[
                "encoder." + k[len("teacher."):]]
                for k, v in teacher.items()}
            del leaves, loss, got
    return dict(losses=losses, grads1=grads1, params={**student, **teacher},
                margins=margins, parts=parts)
