"""Full-graph pretraining on a ``('data', 'edge')`` grid of ranks
(counterpart of ``stemgnn_tpu/parallel/halo_pretrain.py``).

The merged pretrain graph is node-sharded over the S ranks of the edge axis
(the halo partition and layouts of ``parallel.halo``), and each of the
``num_data`` replicas of the data axis runs its own augmented view (a
column feature mask the same on every edge rank of the replica, and the
pair-hash edge dropout over global node ids) over its own share of the
epoch's seed nodes.  Every loss is a global masked mean, the ranks' sums
over the sum of their counts across both axes, so the step optimizes the
pooled objective; the VQ's statistics and its commitment term are summed
across both axes too, and BatchNorm's moments.

Per loss (the reference's pt_model.py): feat recon over this replica's seed
weights (42-43); topo recon from positives sampled per shard from the
shard's combined edge view (the local edges, then the remote ones reading
the halo buffer) and negatives pairing ``u`` of this shard with ``v`` of
the previous edge rank's (each rank ships its ``v`` rows to the next, JAX's
``ppermute`` by one) (46-65); topo-sem recon against the edge-type table by
each sampled edge's type (68-83); sem recon against the EMA teacher's
encoding of the clean graph, detached (86-102).  As JAX's docstring says,
the two topo estimators differ from the single-device ones by design.

The dropout on the fused route is a ``DropView`` a layout over global ids
(the local layout's rows are the rank's block, an offset; the remote
layout's senders are halo slots, a table) for single-type tables, and
runtime keeps per partition edge (``edge_keep``) for typed tables, as
JAX's routes (:162-210).  The student's dropped tails run kernel 1, the
teacher's clean pass kernel 2 where a tail's gather gate is open.

The step (:func:`halo_pretrain_step`): the forward, its backward, the
gradients and the float buffers (BatchNorm's running statistics, the VQ's)
averaged over all ranks (JAX's ``pmean``: the global sums' backward already
carries the rank factor), AdamW with clip and the cosine schedule, the EMA
codebook adopted, the teacher moved.  :func:`run_pretrain_halo` is the
runner: one step an epoch over the epoch's weighted seed multiset, split
round-robin into the replicas' weights, checkpoints in the JAX layout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import PretrainConfig
from stemgnn_tpu_torch.data.sampler import get_train_node_idx
from stemgnn_tpu_torch.models.pretrain import (EPS, PretrainModel,
                                               make_teacher, topo_num_slots)
from stemgnn_tpu_torch.ops.fused_sage import (DropView, direction_keep,
                                              global_ids)
from stemgnn_tpu_torch.ops.pairhash import pair_hash_keep
from stemgnn_tpu_torch.parallel import mesh
from stemgnn_tpu_torch.parallel.data_parallel import replicated_update
from stemgnn_tpu_torch.parallel.full_graph import (layout_launches,
                                                   layout_plans, take_spans)
from stemgnn_tpu_torch.parallel.halo import (broadcast_module,
                                             build_halo_drop_gids,
                                             build_halo_layouts,
                                             build_halo_partition,
                                             halo_drop_views,
                                             halo_encoder_apply,
                                             halo_exchange, part_to_device,
                                             rank_sum,
                                             remote_nodes, shard_of)
from stemgnn_tpu_torch.train import augment
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.vq.codebook import orthogonal_subset


@dataclasses.dataclass
class HaloPretrainGraph:
    """One rank's share of the pretrain graph: its partition tensors with
    the combined edge view and the global-id tables, its node block, its
    layouts and the edge-type table; sizes and the build's host
    seconds."""
    part: dict
    x: torch.Tensor                    # [nb, D] f32 node features
    node_mask: torch.Tensor            # [nb] bool
    nb: int
    R: int
    offset: int = 0                    # the block's first global id
    lay_loc: object = None
    lay_rem: object = None
    edge_table: Optional[torch.Tensor] = None
    partition_s: float = 0.0
    layout_s: float = 0.0


def halo_pretrain_arrays(node_feat, edge_index, num_shards: int,
                         xe_ids=None, *, pad_multiple: int = 128,
                         node_block: int = 128):
    """Every shard's arrays of JAX's ``prepare_halo_pretrain_graph``
    (:47-135; numpy, a leading shard axis): the partition without the
    per-edge types and features, the global-id tables
    (:func:`~stemgnn_tpu_torch.parallel.halo.build_halo_drop_gids`), the
    combined edge view ``cs`` / ``cr`` (senders into ``[z_local; z_halo]``,
    remote ones offset by ``nb``) / ``cm`` / ``cxe``, its original global
    endpoints ``cgs`` / ``cgr`` (int32), ``node_feat`` [S, nb, D] and
    ``node_mask`` [S, nb].  Returns ``(sg, nb, R, part)``, ``part`` the
    whole partition (with the types, for the layouts)."""
    ei = np.asarray(edge_index)
    senders = ei[0].astype(np.int64)
    receivers = ei[1].astype(np.int64)
    n = node_feat.shape[0]
    S = num_shards
    part, nb, R = build_halo_partition(
        senders, receivers, n, S, pad_multiple=max(pad_multiple, node_block),
        xe_ids=(xe_ids if xe_ids is not None
                else np.zeros(len(senders), np.int32)))
    el = part["s_loc"].shape[1]
    sg = {k: v for k, v in part.items()
          if k not in ("xe_loc", "xe_rem", "ef_loc", "ef_rem")}
    sg["cs"] = np.concatenate([part["s_loc"], part["s_rem"] + nb], axis=1)
    sg["cr"] = np.concatenate([part["r_loc"], part["r_rem"]], axis=1)
    sg["cm"] = np.concatenate([part["m_loc"], part["m_rem"]], axis=1)
    sg["cxe"] = np.concatenate([part["xe_loc"], part["xe_rem"]], axis=1)
    # the original endpoints per combined slot, in the partition's order:
    # each shard's edges by receiver owner, local senders first
    owner, src_owner = receivers // nb, senders // nb
    cgs = np.zeros_like(sg["cs"])
    cgr = np.zeros_like(sg["cr"])
    for i in range(S):
        sel = owner == i
        is_loc = src_owner[sel] == i
        s_i, r_i = senders[sel], receivers[sel]
        kl, kr = int(is_loc.sum()), int((~is_loc).sum())
        cgs[i, :kl], cgr[i, :kl] = s_i[is_loc], r_i[is_loc]
        cgs[i, el:el + kr], cgr[i, el:el + kr] = s_i[~is_loc], r_i[~is_loc]
    sg["cgs"], sg["cgr"] = cgs.astype(np.int32), cgr.astype(np.int32)
    sg["gid_loc"], sg["gid_rem_src"], sg["gid_rem_dst"] = \
        build_halo_drop_gids(part, nb, R, S,
                             remote_nodes(nb, R, S, node_block))
    d = node_feat.shape[1]
    feats = np.zeros((S * nb, d), np.float32)
    feats[:n] = node_feat
    node_mask = np.zeros(S * nb, bool)
    node_mask[:n] = True
    sg["node_feat"] = feats.reshape(S, nb, d)
    sg["node_mask"] = node_mask.reshape(S, nb)
    return sg, nb, R, part


def prepare_halo_pretrain_graph(node_feat, edge_index, ranks, xe_ids=None,
                                edge_table=None, *, pad_multiple: int = 128,
                                node_block: int = 128, edge_chunk: int = 512,
                                hub_size: int = 0,
                                fused: bool = True) -> HaloPretrainGraph:
    """This edge rank's :class:`HaloPretrainGraph` (JAX
    ``prepare_halo_pretrain_graph``): the arrays of
    :func:`halo_pretrain_arrays`, its shard's on its device, and with
    ``fused`` its layouts (hub blocks of ``hub_size`` for at most 32 edge
    types, and scatter-side blocks of the same size for single-type
    tables), built with the decisions across the edge ranks."""
    S, me, dev = ranks.world, ranks.rank, ranks.device
    t0 = time.perf_counter()
    sg, nb, R, part = halo_pretrain_arrays(
        node_feat, edge_index, S, xe_ids, pad_multiple=pad_multiple,
        node_block=node_block)
    mine = shard_of(sg, me)
    x, node_mask = mine.pop("node_feat"), mine.pop("node_mask")
    hg = HaloPretrainGraph(
        part=part_to_device(mine, dev), x=torch.from_numpy(x).to(dev),
        node_mask=torch.from_numpy(node_mask).to(dev), nb=nb, R=R,
        offset=me * nb, partition_s=time.perf_counter() - t0)
    if edge_table is not None:
        hg.edge_table = torch.as_tensor(np.asarray(edge_table),
                                        dtype=torch.float32).to(dev)
    if fused:
        t0 = time.perf_counter()
        num_types = 1 if edge_table is None else int(np.shape(edge_table)[0])
        (hg.lay_loc, hg.lay_rem), = build_halo_layouts(
            part, nb, R, S, ranks=ranks, node_block=node_block,
            edge_chunk=edge_chunk,
            hub_size=hub_size if num_types <= 32 else 0,
            sc_hub_size=hub_size if num_types <= 1 else 0,
            num_edge_types=num_types, feat_dim_hint=int(node_feat.shape[1]),
            device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        hg.layout_s = time.perf_counter() - t0
    return hg


def draw_halo_step(cfg: PretrainConfig, hg: HaloPretrainGraph, gen_data,
                   gen_rank) -> dict:
    """One step's draws on one rank: from the replica's ``gen_data`` (the
    same on every edge rank of a replica) the feature keep [D] and the
    dropout seed; from the rank's own ``gen_rank`` the topo-recon slots,
    the negative pairs' ``u`` and ``v`` rows and the orthogonal term's
    codes (JAX folds those keys by the edge index)."""
    dev = hg.x.device
    # the ratio of the shard's combined edge slots (JAX :233-234)
    e_comb = hg.part["cs"].shape[0]
    num = topo_num_slots(cfg, e_comb)
    return dict(
        feat_keep=augment.feature_keep(hg.x.shape[1], cfg.feat_p, gen_data,
                                       dev),
        drop_seed=augment.dropout_edge_seed(gen_data, dev),
        slots=torch.randint(0, e_comb, (num,), generator=gen_rank,
                            device=dev),
        neg=tuple(torch.randint(0, hg.nb, (num,), generator=gen_rank,
                                device=dev) for _ in range(2)),
        ortho_ids=orthogonal_subset(cfg.vq.codebook_size,
                                    cfg.vq.orthogonal_reg_max_codes,
                                    gen_rank, dev))


def step_dropout(cfg: PretrainConfig, hg: HaloPretrainGraph, drop_seed):
    """The encoder's dropout arguments of a step (JAX :162-202): with the
    layouts and a single-type table the pair hash over global ids (the
    local layout's rows offset by the rank's block, the remote senders
    through the halo-slot table); otherwise keeps per partition edge from
    the hash of the original endpoints; none at ``edge_p`` 0."""
    if cfg.edge_p <= 0:
        return {}
    part = hg.part
    if hg.lay_loc is not None and (hg.edge_table is None
                                   or hg.edge_table.shape[0] == 1):
        off = hg.offset
        return dict(drop_hash=(drop_seed, cfg.edge_p),
                    gids=((off, off), (part["gid_rem_src"], off)))
    keep = pair_hash_keep(drop_seed, part["cgs"], part["cgr"], cfg.edge_p)
    el = part["s_loc"].shape[0]
    return dict(keep_loc=keep[:el], keep_rem=keep[el:])


class _Shift(torch.autograd.Function):
    """:meth:`Ranks.shift` by one, with the shift back as its backward."""

    @staticmethod
    def forward(ctx, t, ranks):
        ctx.ranks = ranks
        return ranks.shift(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.ranks.shift(g, -1), None


def _l2n(t):
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                           min=1e-12)


def halo_pretrain_forward(model: PretrainModel, teacher, cfg: PretrainConfig,
                          hg: HaloPretrainGraph, seed_w, draws: dict, ranks,
                          stat_ranks=None, generator=None):
    """The training-mode pretrain forward on one (replica, edge shard)
    rank (JAX ``halo_pretrain_forward``, :138-326): ``(total, losses,
    aux)``, every loss a global value over ``stat_ranks`` (default
    ``ranks``, the edge axis).  ``seed_w`` [nb] this replica's seed weights
    on the block; ``draws`` as :func:`draw_halo_step` makes them (``neg``
    the ``u`` and ``v`` rows, ``v`` shipped to the next edge rank);
    ``generator`` feeds the encoders' dropout and any VQ draw not handed
    in.  ``aux``: the VQ's result and the student's MoE statistics."""
    stat_ranks = ranks if stat_ranks is None else stat_ranks
    gsum = rank_sum(stat_ranks)
    model.train()
    teacher.train()
    part, x_loc, nm = hg.part, hg.x, hg.node_mask
    x_aug = (augment.mask_feature(x_loc, draws["feat_keep"])
             if cfg.feat_p > 0 else x_loc)
    enc_kw = dict(node_mask=nm, lay_loc=hg.lay_loc, lay_rem=hg.lay_rem,
                  edge_table=hg.edge_table, generator=generator,
                  stat_ranks=stat_ranks)
    z, enc_aux = halo_encoder_apply(
        model.encoder, x_aug, part, ranks,
        **step_dropout(cfg, hg, draws.get("drop_seed")), **enc_kw)
    vq_res = model.vq(z, mask=nm, ortho_ids=draws.get("ortho_ids"),
                      generator=generator, gumbel=draws.get("vq_gumbel"),
                      expire_idx=draws.get("vq_expire"), reduce=gsum,
                      commit_reduce=gsum)
    query = vq_res["quantize"]
    seed_f = seed_w.float()
    query_l = query.to(torch.bfloat16) if cfg.loss_bf16 else query
    # every loss is a ratio of sums over the ranks: this rank's sums,
    # then one collective for all of them
    local = {"seeds": seed_f.sum().detach()}

    recon = model.feat_dec(query_l).float()
    se = ((recon - x_loc.float()) ** 2).sum(-1)
    local["feat"] = (se * seed_f).sum()

    if cfg.topo_recon_ratio > 0.0:
        slots = draws["slots"]
        w = part["cm"][slots].float()
        q_halo = halo_exchange(query_l, part["send_idx"], ranks)
        q_full = torch.cat([query_l, q_halo])
        pos_s, pos_r = part["cs"][slots], part["cr"][slots]
        pos_p = model.topo_dec(q_full, pos_s, pos_r).float()
        local["w"] = w.sum()
        local["pos"] = -(w * torch.log(pos_p + EPS)).sum()
        neg_u, neg_v = draws["neg"]
        q_proj = model.topo_dec.lin(query_l).float()
        pu, mu = q_proj[neg_u], nm[neg_u].float()
        pv, mv = q_proj[neg_v], nm[neg_v].float()
        if ranks is not None and ranks.world > 1:
            pv, mv = _Shift.apply(pv, ranks), ranks.shift(mv)
        neg_p = torch.sigmoid((pu * pv).sum(-1))
        wn = mu * mv
        local["neg"] = -(wn * torch.log(1.0 - neg_p + EPS)).sum()
        local["wn"] = wn.sum()
        if hg.edge_table is not None:
            zz = torch.cat([q_full[pos_s], q_full[pos_r]], dim=-1)
            pred = model.topo_sem_dec(zz).float()
            target = hg.edge_table[part["cxe"][slots]].float()
            local["topo_sem"] = (w * ((pred - target) ** 2).mean(-1)).sum()

    with torch.no_grad():
        tz, _ = halo_encoder_apply(
            teacher, x_loc, part, ranks,
            compute_dtype="bfloat16" if cfg.teacher_bf16 else None, **enc_kw)
        tz = tz.float()
    hproj = model.sem_projector(query_l).float()
    local["sem"] = ((1.0 - (_l2n(tz) * _l2n(hproj)).sum(-1)) * seed_f).sum()

    keys = list(local)
    g = dict(zip(keys, gsum(torch.stack([local[k] for k in keys])).unbind()))
    n_seed = torch.clamp(g["seeds"], min=1.0)
    feat = g["feat"] / torch.clamp(g["seeds"] * recon.shape[-1], min=1.0)
    sem = g["sem"] / n_seed
    zero = torch.zeros((), device=query.device)
    topo = topo_sem = zero
    if cfg.topo_recon_ratio > 0.0:
        w_sum = torch.clamp(g["w"], min=1.0)
        topo = g["pos"] / w_sum + g["neg"] / torch.clamp(g["wn"], min=1.0)
        if "topo_sem" in g:
            topo_sem = g["topo_sem"] / w_sum

    commit = vq_res["loss"]
    env = enc_aux["env_reg"]
    losses = {"feat_recon_loss": feat, "topo_recon_loss": topo,
              "topo_sem_recon_loss": topo_sem, "sem_recon_loss": sem,
              "commit_loss": commit, "env_reg_loss": env}
    total = (cfg.feat_lambda * feat + cfg.topo_lambda * topo
             + cfg.topo_sem_lambda * topo_sem + cfg.sem_lambda * sem
             + commit + cfg.lamda_env * env)
    return total, losses, {"vq": vq_res, "moe_stats": enc_aux["moe_stats"]}


def halo_pretrain_step(model, teacher, opt, cfg: PretrainConfig,
                       hg: HaloPretrainGraph, seed_w, draws, ranks,
                       stat_ranks=None, generator=None, grads_out=None):
    """One step on this rank (JAX ``make_halo_pretrain_step``, :328-399):
    the forward and its backward, the gradients and every float buffer of
    the student and the teacher averaged over ``stat_ranks``, AdamW with
    the clip and the schedule, the EMA codebook adopted, the teacher moved.
    Returns the losses (detached, ``loss`` the total).  ``grads_out``, a
    dict, receives the averaged gradients by parameter name before the
    clip."""
    stat_ranks = ranks if stat_ranks is None else stat_ranks
    opt.zero_grad()
    total, losses, _ = halo_pretrain_forward(
        model, teacher, cfg, hg, seed_w, draws, ranks, stat_ranks, generator)
    total.backward()
    replicated_update(model, teacher, opt, cfg, stat_ranks, grads_out)
    return {**{k: v.detach() for k, v in losses.items()},
            "loss": total.detach()}


def seed_weights(seeds, n_pad: int, num_data: int, data: int):
    """Replica ``data``'s float seed weights [n_pad]: its round-robin share
    of the epoch's seed multiset, each seed's repetitions its weight (JAX
    :460-467)."""
    w = np.zeros(n_pad, np.float32)
    np.add.at(w, np.asarray(seeds)[data::num_data], 1.0)
    return w


def params_digest(*modules) -> str:
    """A SHA-256 of the parameters' bytes (equal digests: bit-equal
    parameters)."""
    h = hashlib.sha256()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _cpu_sub(lay):
    """The arrays of ``lay`` that the keep reads, on the CPU."""
    return dataclasses.replace(
        lay, senders_r=lay.senders_r.cpu(), receivers_r=lay.receivers_r.cpu(),
        senders_s=lay.senders_s.cpu(), receivers_s=lay.receivers_s.cpu(),
        in_degree=lay.in_degree.cpu())


def keep_report(view: DropView) -> dict:
    """``view``'s pair-hash keeps on its device against the same hash over
    the same global ids on the CPU: every (sub)layout direction's valid
    edges and every count block's nonzero (node, hub) pairs, with the
    counts kept and the counts that differ.  The blocks' pairs are hashed
    where they are, without masked copies of the blocks."""
    ids = tuple(d if d is None or isinstance(d, int) else d.cpu()
                for d in view.ids)
    seed, p = torch.as_tensor(view.seed), view.p
    out = {"edges": 0, "kept": 0, "differ": 0, "hub_pairs": 0,
           "hub_differ": 0}
    lay = view.layout
    subs = [lay] + [h.tail for h in (lay.hub_r, lay.hub_s) if h is not None]
    for sub in subs:
        for order in ("r", "s"):
            mask = (sub.mask_r if order == "r" else sub.mask_s).cpu()
            got = direction_keep(sub, seed, p, order, view.ids).cpu()[mask]
            want = direction_keep(_cpu_sub(sub), seed.cpu(), p, order,
                                  ids)[mask]
            out["edges"] += int(mask.sum())
            out["kept"] += int(got.sum())
            out["differ"] += int((got != want).sum())
    for order, hub in (("r", lay.hub_r), ("s", lay.hub_s)):
        if hub is None:
            continue
        for nz, rows, cols in ((hub.cnt_nz, None, hub.hub_ids),
                               (hub.sc_nz, hub.sc_ids, None)):
            if nz is None:
                continue
            keeps = []
            for dev_ids, sd in ((view.ids, seed), (ids, seed.cpu())):
                src, dst = dev_ids
                row_dom, col_dom = (dst, src) if order == "r" else (src, dst)
                r, c = (t.to(sd.device) for t in nz)
                if rows is not None:
                    r = rows.to(sd.device)[r]
                if cols is not None:
                    c = cols.to(sd.device)[c]
                keeps.append(pair_hash_keep(sd, global_ids(row_dom, r),
                                            global_ids(col_dom, c), p).cpu())
            out["hub_pairs"] += int(keeps[0].numel())
            out["hub_differ"] += int((keeps[0] != keeps[1]).sum())
    return out


def run_pretrain_halo(merged, cfg: PretrainConfig, ranks, num_shards: int,
                      *, weights, save_root: Optional[str] = None,
                      verbose: bool = True, hub_size: int = 0,
                      pad_multiple: int = 128, node_block: int = 128,
                      edge_chunk: int = 512, model=None, teacher=None,
                      draw_fn=None, record: bool = False):
    """Full-graph halo pretraining on this rank of the grid of ``ranks``
    (all of them) over ``num_shards`` edge ranks (JAX
    ``run_pretrain_halo``, :401-509); every rank calls it with the same
    arguments.  ``merged``: ``data.merge.merge_datasets``' payload.

    The initial weights come from ``cfg.seed`` (or ``model`` / ``teacher``);
    a ``kmeans_init`` codebook is seeded on rank 0 by
    ``train.pretrain_loop.maybe_kmeans_seed_vq`` and broadcast.  Each epoch
    draws the seed multiset (``get_train_node_idx`` from
    ``default_rng(cfg.seed)``), takes one step and prints JAX's line (rank
    0); checkpoints (rank 0, synchronous) go to ``save_root`` every
    ``cfg.save_every`` epochs and at the last, in the layout ``finetune``
    reads.  ``draw_fn(hg, data, edge)`` replaces a step's draws.  The fused
    route (layouts) is taken by the sage backbone.

    Returns this rank's record: its grid position, sizes and build seconds,
    per epoch the losses, wall, step and exchange ms (CUDA events), idle
    share and peak device GB, the kernels' launches on each layout by
    epoch; with ``record`` also the parameters' digest after each step and
    the first step's :func:`keep_report` of each layout; ``model`` and
    ``teacher`` (on the CPU) and the history of rank 0's losses."""
    from stemgnn_tpu_torch.train.pretrain_loop import (
        make_pretrain_optimizer, maybe_kmeans_seed_vq, save_checkpoint)
    t_entry = time.time()
    S = num_shards
    edge, data, nd = mesh.grid(ranks, S)
    dev = ranks.device
    me = ranks.rank
    rng_np = np.random.default_rng(cfg.seed)
    if model is None:
        model = PretrainModel(
            cfg, generator=torch.Generator().manual_seed(cfg.seed))
    if teacher is None:
        teacher = make_teacher(model)
    model.to(dev)
    teacher.to(dev)
    if cfg.vq.kmeans_init and not bool(model.vq.initted):
        if me == 0:
            node_table = torch.from_numpy(np.asarray(
                merged["node_text_feat"], np.float32)).to(dev)
            etf = merged.get("edge_text_feat")
            maybe_kmeans_seed_vq(
                model, cfg, merged, weights, node_table,
                None if etf is None else torch.from_numpy(
                    np.asarray(etf, np.float32)).to(dev),
                generator=torch.Generator(device=dev).manual_seed(cfg.seed))
        broadcast_module(model.vq, ranks)

    node_feat = np.asarray(merged["node_text_feat"],
                           np.float32)[np.asarray(merged["x"])]
    xe = merged.get("xe")
    t0 = time.perf_counter()
    hg = prepare_halo_pretrain_graph(
        node_feat, np.asarray(merged["edge_index"]), edge,
        xe_ids=None if xe is None else np.asarray(xe, np.int32),
        edge_table=merged.get("edge_text_feat"), pad_multiple=pad_multiple,
        node_block=node_block, edge_chunk=edge_chunk, hub_size=hub_size,
        fused=cfg.encoder.backbone == "sage")
    build_s = time.perf_counter() - t0
    nb = hg.nb
    n_pad = S * nb
    opt = make_pretrain_optimizer(model, cfg)
    timer = trace.Recorder(dev)
    timed = dataclasses.replace(edge, timer=timer)
    base = cfg.seed * 65_536 + data
    gen_data = torch.Generator(device=dev).manual_seed(base)
    gen_rank = torch.Generator(device=dev).manual_seed(
        base * 65_536 + edge.rank)
    rec = dict(rank=me, world=ranks.world, data=data, edge=edge.rank,
               num_data=nd, backend=ranks.backend, device=str(dev), nb=nb,
               R=hg.R, m_rem=(hg.lay_rem.num_nodes_padded
                              if hg.lay_rem is not None
                              else remote_nodes(nb, hg.R, S)),
               edges_loc=int(hg.part["m_loc"].sum()),
               edges_rem=int(hg.part["m_rem"].sum()),
               partition_s=hg.partition_s, layout_s=hg.layout_s,
               build_s=build_s, digests=[], keeps=None)
    lays = {"loc": hg.lay_loc, "rem": hg.lay_rem}
    for lay in lays.values():
        for p in layout_plans(lay):
            p.launches.clear()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    t_seed = t_step = t_read = t_save = 0.0
    t_train0 = time.time()
    for epoch in range(cfg.epochs):
        t_ep = time.perf_counter()
        seeds = get_train_node_idx(np.asarray(merged["ptr"]), weights,
                                   rng_np)
        w = seed_weights(seeds, n_pad, nd, data)[edge.rank * nb:
                                                 (edge.rank + 1) * nb]
        seed_w = torch.from_numpy(w).to(dev)
        draws = (draw_fn(hg, data, edge.rank) if draw_fn is not None
                 else draw_halo_step(cfg, hg, gen_data, gen_rank))
        t1 = time.perf_counter()
        with trace.span("sg:pretrain.step", timer):
            losses = halo_pretrain_step(model, teacher, opt, cfg, hg, seed_w,
                                        draws, timed, ranks, gen_rank)
        t2 = time.perf_counter()
        keys = list(losses)
        vals = torch.stack([losses[k].float() for k in keys]).cpu().tolist()
        metrics = dict(zip(keys, vals))
        t3 = time.perf_counter()
        metrics["epoch_s"] = t3 - t_ep
        t_seed += t1 - t_ep
        t_step += t2 - t1
        t_read += t3 - t2
        spans = take_spans(timer)[0]
        entry = dict(losses=metrics, epoch_ms=metrics["epoch_s"] * 1e3,
                     launches={k: layout_launches(v) for k, v in lays.items()},
                     **spans)
        if dev.type == "cuda":
            busy = spans.get("step_ms", 0.0) - spans.get("exchange_ms", 0.0)
            entry["idle"] = 1.0 - busy / entry["epoch_ms"]
            entry["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        for lay in lays.values():
            for p in layout_plans(lay):
                p.launches.clear()
        history.append(entry)
        if record:
            rec["digests"].append(params_digest(model, teacher))
            drop = step_dropout(cfg, hg, draws["drop_seed"])
            if epoch == 0 and "drop_hash" in drop:
                views = halo_drop_views(hg.lay_loc, hg.lay_rem, **drop)
                rec["keeps"] = {k: keep_report(v) for k, v in
                                zip(("loc", "rem"), views)
                                if k == "loc" or S > 1}
        if verbose and me == 0:
            print(f"[halo-pretrain] epoch {epoch + 1}/{cfg.epochs} "
                  f"({metrics['epoch_s']:.2f}s) "
                  + " ".join(f"{k}={v:.4f}" for k, v in sorted(
                      metrics.items()) if k != "epoch_s"), flush=True)
        if save_root is not None and me == 0 and (
                (epoch + 1) % max(cfg.save_every, 1) == 0
                or epoch + 1 == cfg.epochs):
            t4 = time.perf_counter()
            save_checkpoint(save_root, epoch + 1, model, teacher, opt,
                            gen_rank)
            t_save += time.perf_counter() - t4
    if verbose and me == 0 and cfg.epochs:
        print(f"[halo-pretrain] per-epoch phase means: seed-build "
              f"{t_seed / cfg.epochs * 1e3:.0f} ms, dispatch "
              f"{t_step / cfg.epochs * 1e3:.0f} ms, metric readback "
              f"{t_read / cfg.epochs * 1e3:.0f} ms, checkpoint "
              f"{t_save / cfg.epochs * 1e3:.0f} ms", flush=True)
    rec.update(history=history, span=(t_entry, t_train0, time.time()),
               gwin={k: _tail_gates(v) for k, v in lays.items()
                     if v is not None})
    if me == 0:
        rec["model"], rec["teacher"] = model.cpu(), teacher.cpu()
    return rec


def _tail_gates(lay) -> dict:
    """Each direction's gather gate where its tail runs (a hub tail, else
    the layout), and whether it has a hub block: what the launches of a
    step follow."""
    out = {}
    for order, hub in (("r", lay.hub_r), ("s", lay.hub_s)):
        sub = lay if hub is None else hub.tail
        out[order] = dict(hub=hub is not None,
                          gwin=bool(getattr(sub, f"use_gwin_{order}")))
    return out


def _halo_rank(ranks, merged, cfg, num_shards, kw):
    """One rank of :func:`launch_halo_pretrain`."""
    return run_pretrain_halo(merged, cfg, ranks, num_shards, **kw)


def launch_halo_pretrain(merged, cfg: PretrainConfig, num_shards: int,
                         device_type: str, world: Optional[int] = None,
                         **kw) -> list:
    """Run :func:`run_pretrain_halo` on ``world`` ranks (default
    :func:`~stemgnn_tpu_torch.parallel.mesh.halo_world`) over
    ``num_shards`` edge ranks and return the records in rank order (this
    process's alone under torchrun); prints the grid, the backend and each
    rank's device first."""
    world = mesh.halo_world(num_shards, device_type) if world is None \
        else world
    if world % num_shards:
        raise ValueError(f"a world of {world} ranks is not a multiple of "
                         f"{num_shards} edge shards")
    env = mesh.env_world()
    if env is None or env["rank"] == 0:
        print(f"Full-graph halo pretrain on a {world // num_shards}x"
              f"{num_shards} (data x edge) mesh: "
              f"{mesh.describe_world(world, device_type)}", flush=True)
    return mesh.launch(_halo_rank, world, device_type, merged, cfg,
                       num_shards, kw)
