"""The full-graph node finetunes over ``torch.distributed`` ranks
(counterpart of ``stemgnn_tpu/parallel/full_graph.py``): the v1
edge-partitioned finetune (``prepare_sharded_graph`` :34,
``make_edge_parallel_steps`` :68-121, ``run_finetune_edge_parallel``
:478-539) and the halo finetune (``prepare_halo_graph`` :124,
``make_halo_steps`` :186-332, ``run_finetune_halo_parallel`` :334-475).

**v1** (:func:`run_finetune_edge_parallel`): every rank holds every node
and the parameters and one receiver-sorted shard of the edges
(``parallel.edge_partition``); each sage layer sums the shards' partial
aggregations over the ranks, so ``z`` and the loss are the same on every
rank.  The step is JAX's: AdamW (``optax.adamw(lr, weight_decay=0.01)``),
the head-mean cross entropy over the train nodes plus the decoder's
Jacobian penalty, the gradients and the float buffers averaged across
ranks (JAX's ``pmean``).  A weight after the aggregation gets the same
gradient on every rank; the aggregation's backward sums the ranks'
identical cotangents again, so a rank's gradient before it is ``S`` times
its shard's share, and the mean over the ranks is the single-device
gradient.  Dropout and the VQ's draws come from a generator seeded alike
on every rank (JAX hands every device the same key), so the ranks'
parameters stay bit-equal.  A codebook that is not initted is
k-means-initialized on rank 0 from ``train.graph_setup.fused_full_graph``
(on CUDA its layout: kernel 2 once an encoder layer) and broadcast; the
shards' sums themselves are gathers and ``index_add_``, no kernel, as
JAX leaves them to XLA.  The entry point is the library function (no CLI
reaches it in JAX): :func:`launch_edge_parallel_finetune`.

**Halo** (:func:`run_finetune_halo_parallel`):

Every rank runs :func:`run_finetune_halo_parallel` on the whole dataset:
it builds the partition (all shards, numpy) and its own shard's tensors and
layouts, trains a full-graph step an epoch over its node block with one
halo exchange a layer, and evaluates on the device (the ranks' masked
correct counts summed, no [N, C] readback).

  * The loss is the global masked mean: the ranks' sums of the train rows'
    cross entropy over the sum of their counts, plus the MoE regularizer
    (a global mean) and the decoder's Jacobian penalty.  Every rank
    back-propagates that replicated value through sums across ranks whose
    backward sums again (``halo.all_reduce_sum``), so the ranks' gradients
    of a parameter add up to ``S`` times the single-device gradient: the
    step averages them (one all_reduce of all gradients), which reproduces
    the single-device step, as JAX's ``pmean`` does (:244-250).
  * An unfrozen VQ sums its statistics across ranks (the ``reduce`` the
    step hands it); the float buffers (BatchNorm's running statistics, the
    VQ's) are then averaged across ranks, as JAX averages the state
    (:255), and an EMA codebook is adopted after the optimizer's step.
  * The fused route (the layouts, kernel 2 on both the local and the remote
    layout of every rank) is the default on a CUDA device with
    ``use_fused_layout``, where JAX's is "on the TPU" (:352-354);
    gcn / gin / gat and the CPU take the plain route.
  * Node orders (:359-375): ``balance`` relabels by the degree-balanced
    snake deal (ghost slots padded in), ``rcm`` / ``community`` by
    ``train.graph_setup.reorder_dataset``.
  * A codebook that is not initted is k-means-initialized from the
    evaluation-mode encoding of every rank's block, gathered on rank 0,
    which broadcasts the result (JAX encodes the fused full graph on one
    device; the encoding is the same function of the same weights).

Per epoch each rank records its wall, the training step's and the
evaluation's device time and the exchanges' (CUDA events), and the idle
share ``1 - (step + evaluation - exchange) / wall`` of its device.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import round_up
from stemgnn_tpu_torch.models.task import (activation_loss,
                                           decoder_jacobian_penalty,
                                           maybe_kmeans_init_vq, task_logits,
                                           task_model_init)
from stemgnn_tpu_torch.ops import scatter
from stemgnn_tpu_torch.parallel.edge_partition import \
    partition_edges_by_destination
from stemgnn_tpu_torch.parallel.halo import (all_reduce_sum,
                                             broadcast_module,
                                             build_halo_layouts,
                                             build_halo_partition,
                                             halo_encoder_apply, mean_across,
                                             part_to_device,
                                             relabel_dataset_balanced,
                                             remote_nodes, shard_of)
from stemgnn_tpu_torch.train.finetune_loop import (SPAN_KEYS, _split_params,
                                                   make_optimizer)
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.utils.early_stop import EarlyStopping
from stemgnn_tpu_torch.utils.logger import Logger
from stemgnn_tpu_torch.utils.metrics import evaluate, task2metric
from stemgnn_tpu_torch.vq.quantize import adopt_ema_embed, vq_kmeans_init


@dataclasses.dataclass
class HaloGraph:
    """One rank's share of the graph: its partition arrays and node block
    on its device, the reversed-edge partition (MoE), its layouts (fused
    route) and the edge-type table; sizes and the host seconds of the
    build."""
    part: dict
    x: torch.Tensor                    # [nb, D] f32 node features
    node_mask: torch.Tensor            # [nb] bool
    nb: int
    R: int
    part_rev: Optional[dict] = None
    lay_loc: object = None
    lay_rem: object = None
    edge_table: Optional[torch.Tensor] = None
    partition_s: float = 0.0
    layout_s: float = 0.0


def prepare_halo_graph(ds, ranks, *, pad_multiple: int = 128,
                       with_reversed: bool = False, fused: bool = False,
                       hub_size: int = 0, node_block: int = 128,
                       edge_chunk: int = 512,
                       with_edge_feat: bool = True) -> HaloGraph:
    """This rank's :class:`HaloGraph` (JAX ``prepare_halo_graph``, :124):
    the partition of ``ds``'s edges over ``ranks.world`` shards, and with
    ``fused`` its shard's layouts (hub blocks when the dataset has at most
    32 edge types) with edge features from the [T, D] type table;
    otherwise the per-edge features ride the partition (``ef_*``, unless
    ``with_edge_feat`` is False: gcn / gin / gat read none)."""
    S, me, dev = ranks.world, ranks.rank, ranks.device
    ei = np.asarray(ds.edge_index)
    t0 = time.perf_counter()
    pm = max(pad_multiple, node_block) if fused else pad_multiple
    if fused:
        part, nb, R = build_halo_partition(
            ei[0], ei[1], ds.num_nodes, S, pad_multiple=pm,
            xe_ids=np.asarray(ds.xe, np.int32))
    else:
        part, nb, R = build_halo_partition(
            ei[0], ei[1], ds.num_nodes, S, pad_multiple=pm,
            edge_feat=(ds.edge_features().astype(np.float32)
                       if with_edge_feat else None))
    part_rev = None
    if with_reversed:
        rev, nb2, _ = build_halo_partition(ei[1], ei[0], ds.num_nodes, S,
                                           pad_multiple=pm)
        assert nb2 == nb
        part_rev = part_to_device(shard_of(rev, me), dev)
    mine = shard_of(part, me)
    partition_s = time.perf_counter() - t0
    hg = HaloGraph(part=part_to_device(mine, dev), x=None, node_mask=None,
                   nb=nb, R=R, part_rev=part_rev,
                   partition_s=partition_s)
    rows = np.arange(me * nb, (me + 1) * nb)
    valid = rows < ds.num_nodes
    feats = np.zeros((nb, ds.node_text_feat.shape[1]), np.float32)
    feats[valid] = ds.node_text_feat[np.asarray(ds.x)[rows[valid]]]
    hg.x = torch.from_numpy(feats).to(dev)
    hg.node_mask = torch.from_numpy(valid).to(dev)
    if fused:
        t0 = time.perf_counter()
        num_types = int(ds.edge_text_feat.shape[0])
        (hg.lay_loc, hg.lay_rem), = build_halo_layouts(
            part, nb, R, S, ranks=ranks, node_block=node_block,
            edge_chunk=edge_chunk,
            hub_size=hub_size if num_types <= 32 else 0,
            num_edge_types=num_types,
            feat_dim_hint=int(ds.node_text_feat.shape[1]), device=dev)
        hg.edge_table = torch.as_tensor(np.asarray(ds.edge_text_feat),
                                        dtype=torch.float32).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        hg.layout_s = time.perf_counter() - t0
    return hg


def layout_plans(lay):
    """Every row plan of a layout: its directions', its hub tails' and
    their splits' (each launch over a plan counts on it)."""
    if lay is None:
        return
    for p in (lay.plan_r, lay.plan_s):
        if p is not None:
            yield p
    for side in ("hub_r", "hub_s"):
        h = getattr(lay, side)
        if h is not None:
            yield from layout_plans(h.tail)
    for side in ("split_r", "split_s"):
        sp = getattr(lay, side)
        if sp is not None:
            yield from layout_plans(sp.loc)
            yield from layout_plans(sp.stray)
            if sp.m_plan is not None:
                yield sp.m_plan


def layout_launches(lay) -> dict:
    """Kernel launches by name over ``lay``'s plans."""
    out = {}
    for p in layout_plans(lay):
        for k, v in p.launches.items():
            out[k] = out.get(k, 0) + v
    return out


def take_spans(timer: trace.Recorder):
    """``(ms, calls)`` of the spans ``timer`` recorded since the last take,
    by history key (``SPAN_KEYS``): the device ms (CUDA only) and the
    calls (on any device)."""
    spans = timer.take()
    ms = {SPAN_KEYS[k]: t["device_ms"] for k, t in spans.items()
          if t["device_ms"] is not None}
    return ms, {SPAN_KEYS[k]: t["calls"] for k, t in spans.items()}


def _encode(model, hg: HaloGraph, ranks, generator=None):
    """The encoder over this rank's block, in the model's mode."""
    return halo_encoder_apply(
        model.encoder, hg.x, hg.part, ranks, node_mask=hg.node_mask,
        part_rev=hg.part_rev, lay_loc=hg.lay_loc, lay_rem=hg.lay_rem,
        edge_table=hg.edge_table, generator=generator)


def make_halo_steps(cfg: FinetuneConfig, hg: HaloGraph, ranks, y):
    """``(train_step, eval_probs, metrics_step)`` over this rank's block
    (JAX ``make_halo_steps``, :186-332).  ``y`` [nb] this block's labels."""
    reduce = (None if ranks.world == 1
              else (lambda t: all_reduce_sum(t, ranks)))

    def train_step(model, opt, train_mask, generator=None):
        """One step; returns the loss parts, the same on every rank (the
        MoE layers' router statistics under ``moe_stats``)."""
        model.train()
        z, aux = _encode(model, hg, ranks, generator)
        logits, _ = task_logits(model, cfg, z, mask=hg.node_mask,
                                generator=generator, reduce=reduce)
        logp = torch.log_softmax(logits.mean(1), dim=-1)
        nll = -logp.gather(1, y[:, None].long())[:, 0]
        w = train_mask.to(nll.dtype)
        num = all_reduce_sum((nll * w).sum(), ranks)
        den = ranks.all_reduce(w.sum().detach().clone())
        act = num / torch.clamp(den, min=1.0)
        env = cfg.lamda_env * aux["env_reg"]
        jac = decoder_jacobian_penalty(model, cfg)
        loss = act + env + jac
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if ranks.world > 1:
            # the ranks' gradients sum to S times the single-device one
            mean_across([p.grad for p in params], ranks)
            mean_across([b for b in model.buffers()
                         if b.is_floating_point()], ranks)
        opt.step()
        if cfg.use_vq and not cfg.freeze_vq and cfg.vq.ema_update:
            adopt_ema_embed(model.vq)
        parts = {k: v.detach() for k, v in (("loss", loss), ("act_loss", act),
                                            ("jac_loss", jac),
                                            ("env_loss", env))}
        if aux["moe_stats"]:
            parts["moe_stats"] = aux["moe_stats"]
        return parts

    def eval_probs(model):
        """[nb, C] class probabilities of this block (evaluation mode)."""
        model.eval()
        with torch.no_grad():
            z, _ = _encode(model, hg, ranks)
            logits, _ = task_logits(model, cfg, z, mask=hg.node_mask)
            return torch.softmax(logits.mean(1), dim=-1)

    def metrics_step(model, masks3):
        """Accuracies [3] (train, valid, test) x100: the ranks' masked
        correct counts over their masked counts, summed across ranks."""
        pred = eval_probs(model).argmax(-1)
        hit = (pred == y).float()
        m = masks3.float()
        sums = torch.cat([(m * hit[None, :]).sum(1), m.sum(1)])
        ranks.all_reduce(sums)
        return 100.0 * sums[:3] / torch.clamp(sums[3:], min=1.0)

    return train_step, eval_probs, metrics_step


def _kmeans_init(model, cfg, hg, ranks, idx):
    """k-means-initialize a codebook that is not initted from every
    block's evaluation-mode encoding, on rank 0, broadcast to the rest."""
    if not cfg.use_vq or bool(model.vq.initted):
        return
    model.eval()
    with torch.no_grad():
        z_loc, _ = _encode(model, hg, ranks)
    n_all = hg.nb * ranks.world
    z = torch.zeros((n_all, z_loc.shape[1]), dtype=torch.float32,
                    device=z_loc.device)
    mask = torch.zeros(n_all, dtype=torch.float32, device=z_loc.device)
    sl = slice(ranks.rank * hg.nb, (ranks.rank + 1) * hg.nb)
    z[sl] = z_loc.float()
    mask[sl] = hg.node_mask.float()
    ranks.all_reduce(z)
    ranks.all_reduce(mask)
    if ranks.rank == 0:
        gen = torch.Generator(device=z.device).manual_seed(idx)
        vq_kmeans_init(model.vq, z, mask=mask > 0, generator=gen)
    broadcast_module(model.vq, ranks)


def run_finetune_halo_parallel(ds, cfg: FinetuneConfig, ranks,
                               pretrained=None, verbose: bool = False,
                               pad_multiple: int = 128, edge_chunk: int = 512,
                               balance: bool = False, order: str = "none",
                               keep_z: bool = False):
    """Full-graph node finetune of ``cfg.repeat`` splits on this rank's
    block (JAX ``run_finetune_halo_parallel``, :334-475); every rank calls
    it with the same arguments.  ``pretrained`` is None or ``{"encoder",
    "vq"}`` modules (copied per split).  Returns this rank's record: the
    Logger; per epoch the loss parts, accuracies, wall, device times and
    idle share; the kernels' launches by name, counted on the rank's
    layouts' row plans (every launch of the run goes over one), in all and
    by layout (``loc`` / ``rem``); the build's host seconds; the
    exchange's sizes; the host clock (``time.time``) at entry, at the first
    epoch and after training (``span``); with ``keep_z`` the last split's
    final evaluation-mode ``z`` of the block (a numpy array).  The fused
    route runs where the device is CUDA, ``cfg.use_fused_layout`` is set and
    the backbone is sage; its hub blocks take ``cfg.hub_size``."""
    t_entry = time.time()
    device = ranks.device
    if cfg.task != "node":
        raise ValueError("the halo finetune supports the node task")
    fused = (device.type == "cuda" and cfg.use_fused_layout
             and cfg.encoder.backbone == "sage")
    S = ranks.world
    if balance or order == "balance":
        ds, _ = relabel_dataset_balanced(ds, S, pad_multiple=pad_multiple)
    elif order in ("rcm", "community"):
        from stemgnn_tpu_torch.train.graph_setup import reorder_dataset
        ds = reorder_dataset(ds, order, task=cfg.task)
    elif order != "none":
        raise ValueError(f"unknown halo order {order!r}")
    moe = any(cfg.encoder.moe_layer_flags())
    t_build0 = time.perf_counter()
    hg = prepare_halo_graph(
        ds, ranks, pad_multiple=pad_multiple, with_reversed=moe, fused=fused,
        hub_size=cfg.hub_size, node_block=min(128, pad_multiple),
        edge_chunk=edge_chunk,
        with_edge_feat=cfg.encoder.backbone == "sage")
    t_build = time.perf_counter() - t_build0
    nb, me = hg.nb, ranks.rank
    n = ds.num_nodes
    rows = np.arange(me * nb, (me + 1) * nb)
    valid = rows < n

    def block(arr):
        out = np.zeros(nb, np.asarray(arr).dtype)
        out[valid] = np.asarray(arr)[rows[valid]]
        return out

    y = torch.from_numpy(block(ds.labels).astype(np.int64)).to(device)
    timer = trace.Recorder(device)
    timed = dataclasses.replace(ranks, timer=timer, owns_group=False)
    train_step, _, metrics_step = make_halo_steps(cfg, hg, timed, y)
    d_in = hg.x.shape[1]
    elem = 2 if cfg.encoder.compute_dtype == "bfloat16" else 4
    widths = [d_in] + [cfg.encoder.hidden_dim] * (cfg.encoder.num_layers - 1)
    if cfg.encoder.backbone in ("gcn", "gat"):
        widths = [cfg.encoder.hidden_dim + 1] * cfg.encoder.num_layers
    rec = dict(rank=me, world=S, device=str(device), backend=ranks.backend,
               nb=nb, R=hg.R, fused=bool(fused),
               m_rem=(hg.lay_rem.num_nodes_padded if hg.lay_rem is not None
                      else remote_nodes(nb, hg.R, S)),
               edges_loc=int(hg.part["m_loc"].sum()),
               edges_rem=int(hg.part["m_rem"].sum()),
               partition_s=hg.partition_s, layout_s=hg.layout_s,
               build_s=t_build,
               exchange_bytes=[(S - 1) * hg.R * w * elem for w in widths])
    logger = Logger()
    splits = ds.splits[:cfg.repeat]
    for p in list(layout_plans(hg.lay_loc)) + list(layout_plans(hg.lay_rem)):
        p.launches.clear()
    history = []
    model, t_train0 = None, None
    for idx, split in enumerate(splits):
        model = task_model_init(
            cfg, None if pretrained is None
            else copy.deepcopy(pretrained["encoder"]),
            None if pretrained is None else copy.deepcopy(pretrained["vq"]),
            generator=torch.Generator().manual_seed(idx))
        model.to(device)
        _kmeans_init(model, cfg, hg, ranks, idx)
        trainable, _ = _split_params(model, cfg)
        opt = make_optimizer(trainable, cfg)
        stopper = EarlyStopping(patience=cfg.early_stop)
        masks = {k: block(split[k]).astype(bool)
                 for k in ("train", "valid", "test")}
        train_mask = torch.from_numpy(masks["train"]).to(device)
        masks3 = torch.from_numpy(np.stack(
            [masks[k] for k in ("train", "valid", "test")])).to(device)
        # dropout and Gumbel draws: seeded by split and rank (JAX folds
        # the rank into the step's key)
        gen = torch.Generator(device=device).manual_seed(idx * 65_536 + me)
        eval_every = max(int(cfg.eval_every or 1), 1)
        walls = []
        t_train0 = t_train0 or time.time()
        for epoch in range(cfg.epochs):
            t_ep = time.perf_counter()
            with trace.span("sg:finetune.train_step", timer):
                parts = train_step(model, opt, train_mask, gen)
            parts.pop("moe_stats", None)
            if (epoch + 1) % eval_every and epoch + 1 < cfg.epochs:
                walls.append(time.perf_counter() - t_ep)
                continue
            with trace.span("sg:finetune.eval", timer):
                accs = metrics_step(model, masks3)
            accs = accs.cpu().tolist()
            loss = {k: float(v) for k, v in parts.items()}
            wall = time.perf_counter() - t_ep
            walls.append(wall)
            spans = take_spans(timer)[0]
            busy = (spans.get("step_ms", 0.0) + spans.get("eval_ms", 0.0)
                    - spans.get("exchange_ms", 0.0))
            result = {"train": accs[0], "val": accs[1], "test": accs[2],
                      "metric": task2metric[cfg.task]}
            logger.log(idx, epoch, {"loss": loss["loss"]}, result)
            history.append(dict(
                split=idx, epoch=epoch, losses=loss, accs=accs,
                epoch_ms=wall * 1e3, idle=(1.0 - busy / (wall * 1e3)
                                           if device.type == "cuda"
                                           else None), **spans))
            if verbose and me == 0:
                print(f"[halo split {idx}] epoch {epoch}: loss "
                      f"{loss['loss']:.4f} | train {accs[0]:.2f} val "
                      f"{accs[1]:.2f} test {accs[2]:.2f} | "
                      f"{wall * 1e3:.1f} ms", flush=True)
            if stopper(result):
                break
        if verbose and me == 0 and walls:
            b = logger.get_single_best(idx)
            timing = f"first epoch {walls[0]:.2f}s"
            if len(walls) > 4:
                timing += (f", steady median "
                           f"{np.median(walls[2:]) * 1e3:.0f} ms/epoch")
            print(f"[halo split {idx}] best val={b['val']:.2f} "
                  f"test={b['test']:.2f} | build {t_build:.2f}s, "
                  f"{timing} ({len(walls)} epochs)", flush=True)
    loc, rem = layout_launches(hg.lay_loc), layout_launches(hg.lay_rem)
    rec.update(logger=logger, history=history, launches_loc=loc,
               launches_rem=rem,
               launches={k: loc.get(k, 0) + rem.get(k, 0)
                         for k in set(loc) | set(rem)})
    rec["span"] = (t_entry, t_train0, time.time())
    if keep_z and model is not None:
        model.eval()
        with torch.no_grad():
            z, _ = _encode(model, hg, ranks)
        # numpy: pickled as one buffer on its way back to the caller
        rec["z"] = z.float().cpu().numpy()
    return rec


def _halo_rank(ranks, ds, cfg, pretrained, kw):
    """One spawned rank of :func:`launch_halo_finetune`."""
    return run_finetune_halo_parallel(ds, cfg, ranks, pretrained=pretrained,
                                      **kw)


def launch_halo_finetune(ds, cfg: FinetuneConfig, num_ranks: int,
                         device_type: str, pretrained=None, **kw) -> list:
    """Run :func:`run_finetune_halo_parallel` on ``num_ranks`` ranks and
    return their records in rank order: this process as one rank of
    torchrun's world when its environment is set (a list of one record),
    else ranks spawned here (``mesh.spawn``; one rank runs in this
    process).  The first line printed names the backend, the world size
    and each rank's device."""
    from stemgnn_tpu_torch.parallel import mesh
    env = mesh.env_world()
    if env is not None and env["world"] != num_ranks:
        raise ValueError(f"--halo_shards {num_ranks} under a torchrun world "
                         f"of {env['world']}")
    mesh.check_world(num_ranks if env is None else env["local_world"],
                     device_type)
    if env is None or env["rank"] == 0:
        print(f"Halo full-graph finetune: "
              f"{mesh.describe_world(num_ranks, device_type)}", flush=True)
    return mesh.launch(_halo_rank, num_ranks, device_type, ds, cfg,
                       pretrained, kw)


# ------------------------------------------------------------------- v1

@dataclasses.dataclass
class ShardedGraph:
    """This rank's share of the edge-partitioned graph: every node
    (replicated, padded to a multiple of 128) and its own edge shard, on
    its device, with the host seconds of the build."""
    node_feat: torch.Tensor            # [n_pad, D] f32
    node_mask: torch.Tensor            # [n_pad] bool
    senders: torch.Tensor              # [E_shard] int64
    receivers: torch.Tensor            # [E_shard] int64
    edge_mask: torch.Tensor            # [E_shard] bool
    edge_feat: Optional[torch.Tensor]  # [E_shard, D], or [1, D]: one type
    n_pad: int
    build_s: float = 0.0


def prepare_sharded_graph(ds, ranks) -> ShardedGraph:
    """This rank's :class:`ShardedGraph` (JAX ``prepare_sharded_graph``,
    :34-55): the partition of ``ds``'s edges over ``ranks.world`` shards
    (all of them, numpy, then this rank's), the padded features and node
    mask.  The edge features are the type table's rows of the shard's edge
    types, ``ds.edge_features()``'s values: one row that every edge adds
    when the dataset has one edge type, else gathered per edge."""
    t0 = time.perf_counter()
    dev = ranks.device
    n = ds.num_nodes
    n_pad = round_up(n, 128)
    feats = np.zeros((n_pad, ds.node_text_feat.shape[1]), np.float32)
    feats[:n] = ds.node_features()
    ei = np.asarray(ds.edge_index)
    shards = partition_edges_by_destination(
        ei[0].astype(np.int32), ei[1].astype(np.int32), ranks.world,
        edge_feat=np.asarray(ds.xe, np.int32))
    me = ranks.rank

    def mine(key, dtype):
        return torch.from_numpy(np.ascontiguousarray(
            shards[key][me])).to(dtype).to(dev)
    table = torch.as_tensor(np.asarray(ds.edge_text_feat),
                            dtype=torch.float32).to(dev)
    edge_feat = (table[:1] if table.shape[0] == 1
                 else table.index_select(0, mine("edge_feat", torch.long)))
    sg = ShardedGraph(
        node_feat=torch.from_numpy(feats).to(dev),
        node_mask=(torch.arange(n_pad) < n).to(dev),
        senders=mine("senders", torch.long),
        receivers=mine("receivers", torch.long),
        edge_mask=mine("edge_mask", torch.bool), edge_feat=edge_feat,
        n_pad=n_pad)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sg.build_s = time.perf_counter() - t0
    return sg


def _encode_sharded(model, sg: ShardedGraph, ranks, generator=None):
    """The encoder over this rank's shard, in the model's mode (JAX
    ``_encode_sharded``, :58-66)."""
    return model.encoder(sg.node_feat, sg.senders, sg.receivers,
                         edge_feat=sg.edge_feat, edge_mask=sg.edge_mask,
                         node_mask=sg.node_mask, generator=generator,
                         edge_shard_ranks=ranks)


def make_edge_parallel_steps(cfg: FinetuneConfig, sg: ShardedGraph, ranks,
                             y):
    """``(train_step, eval_step)`` over this rank's shard (JAX
    ``make_edge_parallel_steps``, :68-121); ``y`` [n_pad] the labels."""

    def train_step(model, opt, train_mask, generator=None):
        """One AdamW step; the loss parts, equal on every rank."""
        model.train()
        z = _encode_sharded(model, sg, ranks, generator)
        logits, _ = task_logits(model, cfg, z, mask=sg.node_mask,
                                generator=generator)
        act = activation_loss(logits, y, "single", mask=train_mask)
        jac = decoder_jacobian_penalty(model, cfg)
        loss = act + jac
        opt.zero_grad(set_to_none=True)
        loss.backward()
        params = [p for g in opt.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        # one all_reduce of every gradient, one of the float buffers
        mean_across([p.grad for p in params], ranks)
        mean_across([b for b in model.buffers() if b.is_floating_point()],
                    ranks)
        opt.step()
        return {"loss": loss.detach(), "act_loss": act.detach(),
                "jac_loss": jac.detach()}

    def eval_step(model):
        """[n_pad, C] class probabilities from the head-mean logits."""
        model.eval()
        with torch.no_grad():
            z = _encode_sharded(model, sg, ranks)
            logits, _ = task_logits(model, cfg, z, mask=sg.node_mask)
            return torch.softmax(logits.mean(1), dim=-1)

    return train_step, eval_step


def run_finetune_edge_parallel(ds, cfg: FinetuneConfig, ranks,
                               pretrained=None, verbose: bool = False,
                               model=None):
    """Full-graph node finetune of ``cfg.repeat`` splits with the edges
    sharded over ``ranks`` (JAX ``run_finetune_edge_parallel``, :478-539);
    every rank calls it with the same arguments.  ``pretrained`` is None
    or ``{"encoder", "vq"}`` modules; ``model`` a task model that every
    split starts from in place of a new one (both copied per split).

    Returns this rank's record: the Logger; per epoch the loss parts,
    accuracies, wall, the step's and the evaluation's device ms and their
    all-reduces' count and ms (CUDA events), and the idle share ``1 -
    (step + evaluation - all-reduces) / wall``; the shard's sizes and the
    build's host seconds; rank 0's k-means inits (host seconds and the
    kernels' launches on the full graph's layout); the
    parameters' digest after training; on CUDA the peak device GB; the
    host clock (``time.time``) at entry, at the first epoch and after
    training (``span``)."""
    from stemgnn_tpu_torch.parallel.halo_pretrain import params_digest
    from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
    t_entry = time.time()
    device = ranks.device
    if cfg.task != "node":
        raise ValueError("the edge-parallel finetune supports the node task")
    timer = trace.Recorder(device)
    timed = dataclasses.replace(ranks, timer=timer, owns_group=False)
    sg = prepare_sharded_graph(ds, ranks)
    n, n_pad = ds.num_nodes, sg.n_pad
    y_np = np.zeros(n_pad, np.int64)
    y_np[:n] = np.asarray(ds.labels)[:n]
    y = torch.from_numpy(y_np).to(device)
    train_step, eval_step = make_edge_parallel_steps(cfg, sg, timed, y)
    rec = dict(rank=ranks.rank, world=ranks.world, device=str(device),
               backend=ranks.backend, n_pad=n_pad,
               edges_shard=int(sg.senders.shape[0]),
               edges=int(sg.edge_mask.sum()), build_s=sg.build_s,
               kmeans=[])
    logger = Logger()
    history = []
    full_graph, t_train0, m = None, None, None
    for idx, split in enumerate(ds.splits[:cfg.repeat]):
        if model is not None:
            m = copy.deepcopy(model)
        else:
            m = task_model_init(
                cfg, None if pretrained is None
                else copy.deepcopy(pretrained["encoder"]),
                None if pretrained is None
                else copy.deepcopy(pretrained["vq"]),
                generator=torch.Generator().manual_seed(idx))
        m.to(device)
        if cfg.use_vq and not bool(m.vq.initted):
            # rank 0 encodes the full graph, as JAX's one process does
            if ranks.rank == 0:
                t0 = time.perf_counter()
                if full_graph is None:
                    full_graph = fused_full_graph(ds, cfg, device=device)
                plans = list(layout_plans(full_graph.layout))
                for p in plans:
                    p.launches.clear()
                gen = torch.Generator(device=device).manual_seed(idx)
                maybe_kmeans_init_vq(m, cfg, full_graph, generator=gen)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                rec["kmeans"].append(dict(
                    split=idx, host_s=time.perf_counter() - t0,
                    launches=layout_launches(full_graph.layout)))
            broadcast_module(m.vq, ranks)
        trainable, _ = _split_params(m, cfg)
        opt = make_optimizer(trainable, cfg)
        stopper = EarlyStopping(patience=cfg.early_stop)
        masks = {}
        for k in ("train", "valid", "test"):
            mk = np.zeros(n_pad, bool)
            mk[:n] = np.asarray(split[k])[:n]
            masks[k] = mk
        train_mask = torch.from_numpy(masks["train"]).to(device)
        # the same draws on every rank (JAX hands every device one key)
        gen = torch.Generator(device=device).manual_seed(idx)
        t_train0 = t_train0 or time.time()
        for epoch in range(cfg.epochs):
            t_ep = time.perf_counter()
            with trace.span("sg:finetune.train_step", timer):
                parts = train_step(m, opt, train_mask, gen)
            step, calls = take_spans(timer)
            step["step_allreduces"] = calls.get("allreduce_ms", 0)
            step["step_allreduce_ms"] = step.pop("allreduce_ms", 0.0)
            with trace.span("sg:finetune.eval", timer):
                pred = eval_step(m)
            pred = pred.cpu().numpy()
            loss = {k: float(v) for k, v in parts.items()}
            wall = time.perf_counter() - t_ep
            ms, calls = take_spans(timer)
            spans = dict(step, **ms)
            spans["eval_allreduces"] = calls.get("allreduce_ms", 0)
            spans["eval_allreduce_ms"] = spans.pop("allreduce_ms", 0.0)
            result = {"train": evaluate(pred, y_np, masks["train"], cfg.task),
                      "val": evaluate(pred, y_np, masks["valid"], cfg.task),
                      "test": evaluate(pred, y_np, masks["test"], cfg.task),
                      "metric": task2metric[cfg.task]}
            logger.log(idx, epoch, {"loss": loss["loss"]}, result)
            busy = (spans.get("step_ms", 0.0) + spans.get("eval_ms", 0.0)
                    - spans["step_allreduce_ms"]
                    - spans["eval_allreduce_ms"])
            history.append(dict(
                split=idx, epoch=epoch, losses=loss,
                accs=[result["train"], result["val"], result["test"]],
                epoch_ms=wall * 1e3,
                idle=(1.0 - busy / (wall * 1e3) if device.type == "cuda"
                      else None), **spans))
            if verbose and ranks.rank == 0:
                print(f"[edge-parallel split {idx}] epoch {epoch}: loss "
                      f"{loss['loss']:.4f} | train {result['train']:.2f} "
                      f"val {result['val']:.2f} test {result['test']:.2f} "
                      f"| {wall * 1e3:.1f} ms", flush=True)
            if stopper(result):
                break
        if verbose and ranks.rank == 0:
            b = logger.get_single_best(idx)
            print(f"[edge-parallel split {idx}] best val={b['val']:.2f} "
                  f"test={b['test']:.2f}", flush=True)
    rec.update(logger=logger, history=history,
               span=(t_entry, t_train0, time.time()),
               digest=None if m is None else params_digest(m))
    if device.type == "cuda":
        rec["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return rec


def _edge_rank(ranks, ds, cfg, pretrained, kw):
    """One rank of :func:`launch_edge_parallel_finetune`, with the kernels'
    launches of its run (``ops.scatter.launch_counts``, zeroed before it)."""
    for name in scatter.launch_counts:
        scatter.launch_counts[name] = 0
    rec = run_finetune_edge_parallel(ds, cfg, ranks, pretrained=pretrained,
                                     **kw)
    rec["launches"] = dict(scatter.launch_counts)
    return rec


def launch_edge_parallel_finetune(ds, cfg: FinetuneConfig, num_ranks: int,
                                  device_type: str = "cuda", pretrained=None,
                                  **kw) -> list:
    """Run :func:`run_finetune_edge_parallel` on ``num_ranks`` ranks and
    return their records in rank order: this process as one rank of
    torchrun's world when its environment is set (a list of one record),
    else ranks spawned here (``mesh.spawn``; one rank runs in this
    process; ``mesh.launch`` checks the world).  On the card unless
    ``device_type="cpu"``: without CUDA a CUDA run raises.  The first line
    printed names the backend, the world size and each rank's device."""
    from stemgnn_tpu_torch.parallel import mesh
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the edge-parallel finetune runs on CUDA and "
                           "CUDA is not available; pass device_type='cpu' "
                           "to run its ranks on the CPU")
    env = mesh.env_world()
    if env is None or env["rank"] == 0:
        print(f"Edge-parallel full-graph finetune: "
              f"{mesh.describe_world(num_ranks, device_type)}", flush=True)
    return mesh.launch(_edge_rank, num_ranks, device_type, ds, cfg,
                       pretrained, kw)
