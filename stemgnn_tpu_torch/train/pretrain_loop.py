"""The pretrain step and the minibatch pretrain loop (counterpart of
``stemgnn_tpu/train/pretrain_loop.py``; the reference's pretrain.py:25-167).

One step (:func:`make_pretrain_step`): draw the augmentation (a column
feature mask and the pair-hash edge dropout's seed, pretrain.py:41-45), run
:func:`~stemgnn_tpu_torch.models.pretrain.pretrain_forward` (the dropout
reaches the fused aggregation as ``drop_hash``), backpropagate, clip the
global gradient norm and take an AdamW step with the cosine schedule
(``train.optim``), then move the EMA teacher towards the student.  Every
random draw comes from one ``torch.Generator``; a caller may hand the step
its draws instead (the parity tests hand it JAX's).

The loop (:func:`run_pretrain`): per epoch, weighted seed resampling over
the merged multi-dataset graph, neighbour-sampled padded batches of ids
(``data.sampler``), materialized on the device from the resident node and
edge tables, one step a batch (a call of :class:`MinibatchPretrain`), the
losses summed on the device and read once an epoch, and encoder/VQ
checkpoints in the JAX package's format plus the port's own resume bundle.
With ``fused_minibatch="on"`` each batch also gets its own edge layout,
built on the host (no hubs), so the student's dropout tails run
``scatter_rows_sorted`` and the teacher's clean pass
``gathered_scatter_rows_sorted``; ``"auto"`` resolves to off, as in JAX,
and the step gathers and scatters with ``index_select``/``index_add_``.
The host never waits for the device inside an epoch: batches reach the card
through pinned buffers with non-blocking copies.  With ``mesh`` (the ranks
of ``--data_parallel``) each rank takes its own batch of each group of
``world`` and runs ``parallel.data_parallel``'s step.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig, PretrainConfig
from stemgnn_tpu_torch.core.graph import (indexed_to_device,
                                          materialize_graph)
from stemgnn_tpu_torch.data.sampler import (CSCGraph, NeighborBatchIterator,
                                            batch_counts, get_train_node_idx,
                                            padded_row_share)
from stemgnn_tpu_torch.models.pretrain import (PretrainModel,
                                               ema_update_teacher,
                                               make_teacher, negative_edges,
                                               pretrain_forward,
                                               sample_edge_slots,
                                               topo_num_slots)
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout
from stemgnn_tpu_torch.train import augment
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.train.optim import Optimizer
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.utils.convert import (load_pretrain_trees,
                                             pretrain_to_jax)
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.utils.observability import PreemptionHandler
from stemgnn_tpu_torch.vq.codebook import orthogonal_subset
from stemgnn_tpu_torch.vq.quantize import adopt_ema_embed, vq_kmeans_init


def pretrain_graph(ds, cfg: PretrainConfig, device="cuda"):
    """The padded full graph of ``ds`` with the fused layout (hub blocks of
    up to 2,048 nodes a side, as the JAX step probe builds it) where
    ``fused_full_graph`` gives one (on CUDA sage encoders), else with its
    edge features materialized (the topo-sem targets)."""
    return fused_full_graph(ds, FinetuneConfig(encoder=cfg.encoder),
                            device=device, edge_feat=True)


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
    draws; ``generator`` feeds them and the encoders' dropout.  With
    ``ema_update`` the VQ's EMA codebook replaces ``embed`` after the
    optimizer's step (JAX's step, pretrain_loop.py:79-82).

    The step runs in an ``sg:pretrain.step`` span (``utils.trace``) whose
    children partition it: ``sg:pretrain.student`` (the draws and the
    augmented view here, the student encoder in ``pretrain_forward``),
    ``sg:vq``, ``sg:pretrain.losses``, ``sg:pretrain.teacher``,
    ``sg:train.backward`` and ``sg:train.update`` (the zero fill, clip,
    AdamW, schedule, EMA codebook and EMA teacher)."""

    def step(model, teacher, opt, graph, draws=None):
        with trace.span("sg:pretrain.step"):
            with trace.span("sg:pretrain.student"):
                if draws is None:
                    draws = draw_step(cfg, graph, generator)
                opt.zero_grad()
                aug = augmented(cfg, graph, draws)
            loss, losses, _ = pretrain_forward(
                model, teacher, cfg, aug, graph, bs=bs, draws=draws,
                drop_seed=draws["drop_seed"], generator=generator)
            with trace.span("sg:train.backward"):
                loss.backward()
            with trace.span("sg:train.update"):
                opt.step()
                if cfg.vq.ema_update:
                    adopt_ema_embed(model.vq)
                ema_update_teacher(teacher, model.encoder,
                                   cfg.sem_encoder_decay)
            return {**{k: v.detach() for k, v in losses.items()},
                    "loss": loss.detach()}

    return step


def batch_layouts_on(cfg: PretrainConfig) -> bool:
    """Whether each minibatch gets its own fused layout:
    ``fused_minibatch="on"`` with the sage backbone (JAX takes them only on
    its TPU; the port on any device, the CPU running the kernels' plain
    versions).  ``"auto"`` resolves to off, as in JAX
    (pretrain_loop.py:300-304)."""
    if cfg.fused_minibatch not in ("auto", "on", "off"):
        raise ValueError(f"fused_minibatch must be auto, on or off, got "
                         f"{cfg.fused_minibatch!r}")
    return cfg.fused_minibatch == "on" and cfg.encoder.backbone == "sage"


def batch_graph(ig, node_table, edge_table, device, with_layout: bool,
                recorder: Optional[trace.Recorder] = None):
    """One sampled batch (an ``IndexedGraph`` of numpy ids) as a padded
    ``Graph`` on ``device``: ids moved in pinned non-blocking copies,
    features gathered from the resident tables.  ``with_layout`` also builds
    the batch's edge layout on the host (``build_edge_layout`` with no hubs,
    as JAX's ``batch_layout``), its tensors copied to ``device`` the same
    way.  Spans (``utils.trace``, into ``recorder`` too where given):
    ``sg:batch.layout`` (build and copies) and ``sg:batch.transfer`` (the
    ids and the feature gather)."""
    lay = None
    with trace.span("sg:batch.layout", recorder):
        if with_layout:
            lay = build_edge_layout(ig.senders, ig.receivers,
                                    ig.num_nodes_padded, xe_ids=ig.xe_ids,
                                    edge_mask=ig.edge_mask,
                                    feat_dim_hint=int(node_table.shape[1]),
                                    device=device)
    with trace.span("sg:batch.transfer", recorder):
        graph = materialize_graph(indexed_to_device(ig, device), node_table,
                                  edge_table)
    if lay is not None:
        graph = dataclasses.replace(graph, layout=lay, edge_table=edge_table)
    return graph


def _tables(merged, device, dtype=torch.float32):
    """The node table and the edge-type table (or None) on ``device``, in
    ``dtype`` (rounded from f32)."""
    node_table = torch.from_numpy(np.asarray(
        merged["node_text_feat"], np.float32)).to(device).to(dtype)
    etf = merged.get("edge_text_feat")
    edge_table = None if etf is None else torch.from_numpy(
        np.asarray(etf, np.float32)).to(device).to(dtype)
    return node_table, edge_table


def table_dtype(cfg: PretrainConfig):
    """The resident feature tables' dtype: bf16 under a bf16 encoder (JAX
    pretrain_loop.py:237-244: it halves the batches' feature gathers and
    the encoder computes in bf16 anyway), so the feature-reconstruction
    target and the k-means init read the bf16-rounded features."""
    return (torch.bfloat16 if cfg.encoder.compute_dtype == "bfloat16"
            else torch.float32)


def _batches(merged, cfg: PretrainConfig, csc, seeds, batch_size, rng,
             drop_last: bool):
    return NeighborBatchIterator(
        csc, merged["x"], merged.get("xe"), seeds, batch_size,
        [cfg.fanout] * cfg.encoder.num_layers, rng, drop_last=drop_last)


def maybe_kmeans_seed_vq(model: PretrainModel, cfg: PretrainConfig, merged,
                         weights, node_table, edge_table=None, csc=None,
                         generator=None, means=None):
    """Seed the VQ codebook by k-means over one sampled batch's eval-mode
    encoder embeddings when ``cfg.vq.kmeans_init`` and the codebook is not
    initted yet (JAX ``maybe_kmeans_seed_vq``; the reference's lazy init on
    the first forward, vq.py:646).  The batch is the first of a fresh
    ``default_rng(cfg.seed)`` draw, as in JAX; ``generator`` draws the
    initial means unless ``means`` are handed in.  Returns the bins, or
    None when nothing was done."""
    if not cfg.vq.kmeans_init or bool(model.vq.initted):
        return None
    if csc is None:
        csc = CSCGraph.from_edge_index(np.asarray(merged["edge_index"]),
                                       merged["x"].shape[0])
    seeds0 = get_train_node_idx(np.asarray(merged["ptr"]), weights,
                                np.random.default_rng(cfg.seed))
    it0 = _batches(merged, cfg, csc, seeds0,
                   min(cfg.batch_size, len(seeds0)),
                   np.random.default_rng(cfg.seed), drop_last=False)
    g = batch_graph(next(iter(it0))[0], node_table, edge_table,
                    node_table.device, with_layout=False)
    enc = model.encoder
    was_training = enc.training
    enc.eval()
    with torch.no_grad():
        z0 = enc(g.node_feat, g.senders, g.receivers, edge_feat=g.edge_feat,
                 edge_mask=g.edge_mask, node_mask=g.node_mask)
    enc.train(was_training)
    return vq_kmeans_init(model.vq, z0, mask=g.node_mask,
                          generator=generator, means=means)


class MinibatchPretrain:
    """One minibatch pretrain step a call: the body of :func:`run_pretrain`'s
    epoch, which the loop and any other caller (a benchmark) share.

    A call takes the epoch's next group of ``world`` seed batches
    (``sg:batch.sample``), makes batch ``rank`` of it a padded graph on the
    device (:func:`batch_graph`: ``sg:batch.layout``, ``sg:batch.transfer``)
    and runs ``step`` on it (``sg:pretrain.step``), all into ``recorder``
    where given.  It returns the step's losses, or None when the epoch has
    no full group left; with ``roll_over`` it then starts the next epoch
    itself and steps on that epoch's first batch.

    ``merged`` is the payload of ``data.merge`` (``x``, ``xe``, ``ptr``;
    its feature arrays are not read) and ``csc`` its graph by destination:
    ``node_table`` and ``edge_table`` (or None) are the resident feature
    tables the batches gather from, made by the caller.  ``rng`` (numpy)
    draws each epoch's seeds (:meth:`new_epoch`: ``get_train_node_idx`` by
    ``weights``, batches of ``cfg.batch_size`` with ``drop_last``) and the
    sampler's neighbours.  ``draw_fn(graph)`` replaces the step's own
    random draws.  After a call, ``group`` holds the sampler's batches
    (``(IndexedGraph, seed count, global node ids)`` each) and ``batch``
    this rank's: ``ig``, ``seeds``, ``nodes``, the device ``graph`` and the
    ``draws`` handed to the step (None when it drew its own)."""

    def __init__(self, merged, cfg: PretrainConfig, step, node_table,
                 edge_table, *, weights: Sequence[float], rng,
                 csc: CSCGraph, device="cuda", world: int = 1, rank: int = 0,
                 with_layout: bool = False,
                 recorder: Optional[trace.Recorder] = None, draw_fn=None):
        self.merged, self.cfg, self.step = merged, cfg, step
        self.node_table, self.edge_table = node_table, edge_table
        self.weights, self.rng, self.csc = weights, rng, csc
        self.device, self.world, self.rank = torch.device(device), world, rank
        self.with_layout, self.recorder = with_layout, recorder
        self.draw_fn = draw_fn
        self.ptr = np.asarray(merged["ptr"])
        self._batches = None
        self.group = self.batch = None

    def new_epoch(self):
        """Draw the next epoch's seeds and start its batches."""
        seeds = get_train_node_idx(self.ptr, self.weights, self.rng)
        self._batches = iter(_batches(self.merged, self.cfg, self.csc, seeds,
                                      self.cfg.batch_size, self.rng,
                                      drop_last=True))

    def _next_group(self):
        if self._batches is None:
            return None
        with trace.span("sg:batch.sample", self.recorder):
            group = [next(self._batches, None) for _ in range(self.world)]
        return None if group[-1] is None else group

    def __call__(self, model, teacher, opt, roll_over: bool = False):
        group = self._next_group()
        if group is None and roll_over:
            self.new_epoch()
            group = self._next_group()
        if group is None:
            return None
        ig, n_seeds, nodes = group[self.rank]
        graph = batch_graph(ig, self.node_table, self.edge_table,
                            self.device, self.with_layout, self.recorder)
        self.group = group
        with trace.span("sg:pretrain.step", self.recorder):
            draws = None if self.draw_fn is None else self.draw_fn(graph)
            self.batch = dict(ig=ig, seeds=n_seeds, nodes=nodes,
                              graph=graph, draws=draws)
            return self.step(model, teacher, opt, graph, draws)


def run_pretrain(merged, cfg: PretrainConfig, *, weights: Sequence[float],
                 save_root: Optional[str] = None,
                 max_steps: Optional[int] = None, verbose: bool = True,
                 mesh=None, resume: bool = False, device="cuda",
                 model: Optional[PretrainModel] = None, teacher=None,
                 draw_fn=None):
    """Pretrain over a merged multi-dataset payload (``data.merge``).

    Epochs ``1..cfg.epochs`` (after the resumed one): seeds by
    ``get_train_node_idx(ptr, weights, rng)`` with ``rng =
    default_rng(cfg.seed)``, batches of ``cfg.batch_size`` seeds with
    ``drop_last``, one step each.  The schedule's horizon is ``cfg.epochs``
    optimizer steps, whatever the batch count (JAX builds it with
    ``steps_per_epoch=1``).  ``max_steps`` stops the run after that many
    steps; the epoch it cuts still ends and saves.  Checkpoints go to
    ``save_root`` every ``cfg.save_every`` epochs and at the last
    (:func:`save_checkpoint`); ``resume`` continues after the latest
    ``full_<epoch>.npz`` there.

    ``model``/``teacher`` replace the initial weights (else drawn from
    ``cfg.seed``); ``draw_fn(graph)`` replaces each step's random draws
    (the parity tests hand it JAX's).  ``mesh`` (a ``parallel.mesh.Ranks``
    of the data axis) trains data-parallel (JAX's ``mesh``): batch ``i`` of
    each group of ``world`` goes to rank ``i``, a partial last group is
    dropped, a step is ``parallel.data_parallel.make_dp_pretrain_step``'s
    (its metrics averaged across the ranks), no batch gets a layout, the
    k-means init runs on rank 0 and is broadcast, and rank 0 alone prints
    and saves.  Returns ``(model, teacher, history)``: per epoch the mean
    losses, each step's total loss (``step_losses``), the epoch's wall
    seconds (``epoch_s``, ending in the epoch's one readback), the
    epoch's padded edges, padded nodes and steps over ``epoch_s``
    (``throughput/*``) and the host milliseconds a batch of sampling,
    layout building and transfer (``host/*_ms``: the ``sg:batch.*``
    spans) and the share of the epoch's padded node rows that hold no
    sampled node (``batch/pad_share``, from ``data.sampler.batch_counts``).
    On CUDA also the device ms a step (``device_ms``: the
    ``sg:pretrain.step`` spans' CUDA events, read after the readback) and
    the device's idle share (``idle``: one minus the steps' summed event
    time over ``epoch_s``; the batch copies and the feature gather between
    steps count as idle, a wait inside a step as busy)."""
    if mesh is not None and not hasattr(mesh, "all_reduce"):
        raise TypeError(f"mesh must be the ranks of parallel.mesh, got "
                        f"{type(mesh).__name__}")
    world, me = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    device = torch.device(device)
    with_layout = batch_layouts_on(cfg) and mesh is None
    verbose = verbose and me == 0
    etf = merged.get("edge_text_feat")
    if with_layout and etf is not None and np.asarray(etf).shape[0] > 1:
        raise NotImplementedError(
            "fused_minibatch='on' needs one edge type: the pair-hash "
            "dropout's fused path takes no typed edge table (as JAX "
            "asserts); use fused_minibatch='auto'")
    rng_np = np.random.default_rng(cfg.seed)
    if model is None:
        model = PretrainModel(
            cfg, generator=torch.Generator().manual_seed(cfg.seed))
    if teacher is None:
        teacher = make_teacher(model)
    model.to(device)
    teacher.to(device)
    gen = torch.Generator(device=device).manual_seed(
        cfg.seed if mesh is None else cfg.seed * 65_536 + me)
    csc = CSCGraph.from_edge_index(np.asarray(merged["edge_index"]),
                                   merged["x"].shape[0])
    opt = make_pretrain_optimizer(model, cfg)

    start_epoch = 0
    if resume and save_root is not None:
        bundle, saved_epoch = load_resume_bundle(save_root)
        if bundle is not None:
            restore_bundle(bundle, model, teacher, opt, gen)
            start_epoch = saved_epoch
            if verbose:
                print(f"[pretrain] resumed from epoch {saved_epoch}",
                      flush=True)
    node_table, edge_table = _tables(merged, device, table_dtype(cfg))
    kmeans = cfg.vq.kmeans_init and not bool(model.vq.initted)
    if me == 0:
        maybe_kmeans_seed_vq(model, cfg, merged, weights, node_table,
                             edge_table, csc=csc, generator=torch.Generator(
                                 device=device).manual_seed(cfg.seed))
    if mesh is None:
        step = make_pretrain_step(cfg, bs=cfg.batch_size, generator=gen)
    else:
        from stemgnn_tpu_torch.parallel.data_parallel import \
            make_dp_pretrain_step
        from stemgnn_tpu_torch.parallel.halo import broadcast_module
        if kmeans:
            broadcast_module(model.vq, mesh)
        step = make_dp_pretrain_step(cfg, cfg.batch_size, mesh,
                                     generator=gen)

    rec = trace.Recorder(device)
    unit = MinibatchPretrain(merged, cfg, step, node_table, edge_table,
                             weights=weights, rng=rng_np, csc=csc,
                             device=device, world=world, rank=me,
                             with_layout=with_layout, recorder=rec,
                             draw_fn=draw_fn)

    preempt = PreemptionHandler()
    history = []
    total_steps = 0
    try:
        for epoch in range(start_epoch + 1, cfg.epochs + 1):
            unit.new_epoch()
            counts0 = dict(batch_counts)
            t0 = time.perf_counter()
            # losses summed ON the device and read once an epoch: a float()
            # a step would make the host wait for every step
            sums = None
            totals = []                 # each step's total loss
            steps_epoch = edges = nodes = 0
            rec.clear()
            while True:
                losses = unit(model, teacher, opt)
                if losses is None:
                    break
                sums = losses if sums is None else {
                    k: sums[k] + v for k, v in losses.items()}
                totals.append(losses["loss"])
                steps_epoch += 1
                edges += sum(g[0].num_edges_padded for g in unit.group)
                nodes += sum(g[0].num_nodes_padded for g in unit.group)
                total_steps += 1
                if (max_steps is not None and total_steps >= max_steps) \
                        or preempt.should_stop:
                    break
            if steps_epoch == 0 and world > 1 and verbose:
                print(f"[pretrain] WARNING: epoch produced 0 steps — fewer "
                      f"than {world} seed batches per epoch (leftover "
                      f"batches are dropped in data-parallel mode); reduce "
                      f"batch_size or raise dataset weights", flush=True)
            mean = {}
            if steps_epoch:
                keys = list(sums)
                vals = torch.cat([torch.stack([sums[k] for k in keys]),
                                  torch.stack(totals)]).cpu().tolist()
                mean = {k: v / steps_epoch for k, v in zip(keys, vals)}
                mean["step_losses"] = vals[len(keys):]
            mean["epoch_s"] = time.perf_counter() - t0
            spans = rec.totals()
            busy_ms = spans.get("sg:pretrain.step", {}).get("device_ms")
            if busy_ms is not None:
                mean["device_ms"] = busy_ms / steps_epoch
                mean["idle"] = 1.0 - busy_ms / (1e3 * mean["epoch_s"])
            dt = max(mean["epoch_s"], 1e-9)
            mean.update({"throughput/edges_per_s": edges / dt,
                         "throughput/nodes_per_s": nodes / dt,
                         "throughput/steps_per_s": steps_epoch / dt})
            mean.update({f"host/{k}_ms": spans.get(
                f"sg:batch.{k}", {}).get("host_ms", 0.0)
                / max(steps_epoch, 1)
                for k in ("sample", "layout", "transfer")})
            mean["batch/pad_share"] = padded_row_share(counts0)
            history.append(mean)
            if verbose:
                msg = " ".join(
                    f"{k}={v:.4f}" for k, v in mean.items()
                    if not k.startswith(("throughput", "host", "step",
                                         "epoch", "device", "idle",
                                         "batch")))
                print(f"[pretrain] epoch {epoch}/{cfg.epochs} "
                      f"({mean['epoch_s']:.1f}s, {steps_epoch} steps) "
                      f"{msg}", flush=True)
            saved = save_root is not None and me == 0 and (
                epoch % max(cfg.save_every, 1) == 0 or epoch == cfg.epochs)
            if saved:
                save_checkpoint(save_root, epoch, model, teacher, opt, gen)
            if max_steps is not None and total_steps >= max_steps:
                break
            if preempt.should_stop:
                if verbose:
                    print(f"[pretrain] preemption signal received: epoch "
                          f"{epoch} " + ("checkpointed" if saved else
                                         "NOT checkpointed (save_every "
                                         f"{cfg.save_every})")
                          + ", stopping", flush=True)
                break
    finally:
        preempt.restore()
    return model, teacher, history


def save_checkpoint(save_root: str, epoch: int, model: PretrainModel,
                    teacher, opt: Optimizer, generator):
    """``encoder_<epoch>.npz`` and ``vq_<epoch>.npz`` in the JAX package's
    trees (``{"params", "state"}`` of the encoder and of the VQ; JAX's
    ``load_pretrained_for_finetune`` reads them), and ``full_<epoch>.npz``:
    the student, teacher and state trees with the epoch, plus the port's
    own optimizer state and step generator for :func:`restore_bundle`.
    Synchronous."""
    params, teacher_params, state = pretrain_to_jax(model, teacher)
    os.makedirs(save_root, exist_ok=True)
    ckpt.save_pytree(os.path.join(save_root, f"encoder_{epoch}.npz"),
                     {"params": params["encoder"], "state": state["encoder"]})
    ckpt.save_pytree(os.path.join(save_root, f"vq_{epoch}.npz"),
                     {"params": params["vq"], "state": state["vq"]})
    bundle = {"params": params, "teacher": teacher_params, "state": state,
              "epoch": np.asarray(epoch), "opt_state": opt.state_tree(),
              "generator": generator.get_state().numpy()}
    ckpt.save_pytree(os.path.join(save_root, f"full_{epoch}.npz"), bundle)


def load_resume_bundle(save_root: str):
    """The latest ``full_<epoch>.npz`` -> (bundle, epoch), or (None, 0)."""
    path = ckpt.latest_checkpoint(save_root, "full")
    if path is None:
        return None, 0
    bundle = ckpt.load_pytree(path)
    return bundle, int(bundle.get("epoch", 0))


def restore_bundle(bundle: dict, model: PretrainModel, teacher,
                   opt: Optimizer, generator):
    """Load a :func:`save_checkpoint` bundle into the training objects, in
    place and bit for bit: the student, the teacher, their state, the
    optimizer and the step generator."""
    load_pretrain_trees(model, teacher, bundle["params"], bundle["teacher"],
                        bundle["state"])
    opt.load_state_tree(bundle["opt_state"])
    generator.set_state(torch.from_numpy(np.array(bundle["generator"])))


def load_pretrained_for_finetune(path_encoder: str, path_vq: str):
    """The separable checkpoints in the finetune bundle format
    (finetune.py:174-177)."""
    enc = ckpt.load_pytree(path_encoder)
    vq = ckpt.load_pytree(path_vq)
    return {"encoder_params": enc["params"], "encoder_state": enc["state"],
            "vq_params": vq["params"], "vq_state": vq["state"]}
