"""Node and link finetune, full batch and minibatch, and the graph task
(counterpart of ``stemgnn_tpu/train/finetune_loop.py``: ``_split_params``
:39, ``_make_model_saver`` :58, ``_make_node_steps`` :100,
``_make_minibatch_train_step`` :314, ``_minibatch_epoch`` :381,
``_run_node_like`` :486, and the graph half :783-1283).

A link task (task/link.py of the reference) classifies edges: its rows
are the midpoint edge embeddings ``(z[u] + z[v]) / 2``, with per-edge
labels and split masks; a node task's rows are the nodes.

Per split: a fresh task model from copies of the pretrained encoder and VQ
plus a new decoder (finetune.py:196-205), AdamW (lr, weight decay 0.01, eps
1e-8: ``optax.adamw``'s defaults, which decay every trainable leaf), early
stopping on the validation accuracy, best-epoch selection by the Logger.
A frozen VQ (``freeze_vq``) stays out of the optimizer
(finetune.py:179-181); ``freeze_vq=False`` trains its parameters with the
rest (the codebook as the learnable VQ of the pretrain step: the finetune
loss does not read the VQ's own loss, so it gets its weight decay only).
``use_vq=False`` decodes ``project_in(z)`` and never runs the VQ.  The loss
is the head-mean cross entropy over the train rows plus the decoder
Jacobian penalty.

``batch_size == 0`` trains full batch: one step over the whole graph an
epoch.  ``batch_size > 0`` trains on neighbour-sampled minibatches
(task/node.py:73-99, task/link.py:55-81 of the reference): node batches of
``batch_size`` train seeds with ``fanout`` neighbours a hop, the loss on
the seed rows; link batches of ``batch_size`` train edges whose endpoint
sets are sampled with ``link_fanout`` neighbours a hop from one iterator
of ``2 * batch_size`` seeds, the loss on the batch's edge midpoints.  The
batches move ids only: features are gathered on the device from resident
tables (``core.graph.materialize_graph``), and their aggregation is the
plain gather + ``index_add_`` (no kernel, as JAX's minibatch step runs no
Pallas kernel).  Every epoch ends with a full-batch evaluation over the
fused full graph, or with the layer-wise chunked evaluation
(``train/infer.py``) under ``eval_chunked``, which with minibatches never
builds the full graph and k-means-initializes the codebook from the
layer-wise encoding.

Each epoch is logged and checked for early stopping before the next.
JAX's ``epoch_chunk`` scans (K epochs a dispatch, with up to K-1 updates
past an early stop) have no counterpart: PyTorch dispatches eagerly.
``save_model_to`` writes the best-validation model of all splits (JAX's
tree layout and meta, so both packages' ``infer --mode predict`` read it).

The graph task (the reference's task/graph.py) classifies molecules with
multitask binary labels: padded disjoint batches of molecules (materialized,
or ids into the shared feature tables of an indexed bundle), the encoder's
node embeddings mean-pooled per molecule, the masked multitask BCE, and the
mean per-task AUC of each split.  JAX's scanned stacks of same-shape batches
(``_stream_scanned``, ``predict_many``) are a dispatch mechanism with no
counterpart here: each batch is one eager forward.  A molecule batch
carries no layout, so its aggregation is the gather + ``index_add_`` and no
kernel runs, as in JAX.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.core.graph import (batch_graphs, batch_indexed_graphs,
                                          graph_to_device, host_to_device,
                                          indexed_to_device,
                                          materialize_graph, round_up)
from stemgnn_tpu_torch.data.sampler import CSCGraph, NeighborBatchIterator
from stemgnn_tpu_torch.models.task import (activation_loss,
                                           decoder_jacobian_penalty, encode,
                                           maybe_kmeans_init_vq, pool_graph,
                                           task_logits, task_model_init)
from stemgnn_tpu_torch.ops.spmm import gather_rows
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph,
                                                 maybe_reorder_dataset)
from stemgnn_tpu_torch.train.infer import (layerwise_encode,
                                           layerwise_eval_predict)
from stemgnn_tpu_torch.train.pretrain_loop import _tables, batch_graph
from stemgnn_tpu_torch.utils import checkpoint as ckpt
from stemgnn_tpu_torch.utils.convert import task_model_to_jax
from stemgnn_tpu_torch.utils.early_stop import EarlyStopping
from stemgnn_tpu_torch.utils.logger import Logger
from stemgnn_tpu_torch.utils.metrics import (device_multitask_auc, evaluate,
                                             task2metric)
from stemgnn_tpu_torch.vq.quantize import vq_kmeans_init

_LOSS_KEYS = ("loss", "act_loss", "jac_loss", "env_loss")


def _split_params(model, cfg: FinetuneConfig):
    """Partition the named parameters into (trainable, frozen).  A frozen
    VQ's parameters get ``requires_grad=False`` and stay out of the
    optimizer, so they receive neither updates nor weight decay."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if cfg.freeze_vq and name.startswith("vq."):
            p.requires_grad_(False)
            frozen[name] = p
        else:
            trainable[name] = p
    return trainable, frozen


def make_optimizer(trainable: dict, cfg: FinetuneConfig):
    return torch.optim.AdamW(list(trainable.values()), lr=cfg.lr,
                             weight_decay=0.01, eps=1e-8)


def _loss_parts(model, cfg: FinetuneConfig, rows, y, row_mask, train_mask,
                aux, valid=None):
    """The head-mean cross entropy over ``train_mask`` of the decoder's
    logits on ``rows`` (the VQ's loss covering ``row_mask``), or with
    ``valid`` labels the multitask BCE, plus the Jacobian penalty and
    ``lamda_env`` times the encoder's MoE regularizer (``aux`` of the
    encoder's forward; 0 without MoE layers): (loss, {name: loss part}).
    ``env_loss`` is the scaled term, as JAX logs it (finetune_loop.py:
    123)."""
    logits, _ = task_logits(model, cfg, rows, mask=row_mask)
    act = activation_loss(logits, y, "single" if valid is None else "multi",
                          mask=train_mask, valid=valid)
    jac = decoder_jacobian_penalty(model, cfg)
    env = cfg.lamda_env * aux["env_reg"]
    loss = act + jac + env
    return loss, {"loss": loss, "act_loss": act, "jac_loss": jac,
                  "env_loss": env}


def print_moe_usage(moe_stats):
    """One line an MoE layer: the mean router probability and the top-1
    share of each expert over the counted rows (JAX finetune_loop.py:
    743-751)."""
    for st in moe_stats:
        vals = torch.cat([st["sum_prob"].float(), st["sum_top1"].float(),
                          st["count"].float().reshape(1)]).cpu().tolist()
        k = st["sum_prob"].shape[0]
        cnt = max(vals[-1], 1.0)
        avg = ", ".join(f"{v / cnt:.3f}" for v in vals[:k])
        top1 = ", ".join(f"{v / cnt:.3f}" for v in vals[k:2 * k])
        print(f"[MoE] Layer {st['layer']} avg_prob=[{avg}] "
              f"top1_frac=[{top1}]", flush=True)


def _apply(opt, loss):
    opt.zero_grad(set_to_none=True)
    loss.backward()
    # optax decays a leaf the loss does not reach (the BatchNorm parameters
    # under normalize "none", an unused VQ projection) with its zero
    # gradient; torch's AdamW would skip a parameter without one
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    opt.step()


def _make_node_steps(cfg: FinetuneConfig, task_kind: str = "node"):
    """``(loss_fn, train_step, eval_step)`` for the full-batch node or link
    task.  ``plain`` runs the aggregation kernels' plain versions."""

    def rows(model, graph, generator=None, plain=False, gumbel=None):
        """The task's rows, their mask and the encoder's aux: nodes, or
        the midpoints of the graph's edges."""
        z, aux = encode(model, graph, generator=generator, plain=plain,
                        gumbel=gumbel, return_aux=True)
        if task_kind == "link":
            return (gather_rows(z, graph.senders)
                    + gather_rows(z, graph.receivers)) / 2.0, \
                graph.edge_mask, aux
        return z, graph.node_mask, aux

    def loss_fn(model, train_mask, graph, y, generator=None, plain=False,
                gumbel=None):
        """Training-mode forward: (loss, {name: loss part}); with MoE
        layers the parts also hold the router statistics
        (``moe_stats``)."""
        model.train()
        z, row_mask, aux = rows(model, graph, generator, plain, gumbel)
        loss, parts = _loss_parts(model, cfg, z, y, row_mask, train_mask,
                                  aux)
        if aux["moe_stats"]:
            parts["moe_stats"] = aux["moe_stats"]
        return loss, parts

    def train_step(model, opt, train_mask, graph, y, generator=None,
                   plain=False, gumbel=None):
        _, parts = loss_fn(model, train_mask, graph, y, generator, plain,
                           gumbel)
        _apply(opt, parts["loss"])
        return {k: (v if k == "moe_stats" else v.detach())
                for k, v in parts.items()}

    def eval_step(model, graph, plain=False):
        """Class probabilities [rows, C] from the head-mean logits."""
        model.eval()
        with torch.no_grad():
            z, row_mask, _ = rows(model, graph, plain=plain)
            logits, _ = task_logits(model, cfg, z, mask=row_mask)
            return torch.softmax(logits.mean(1), dim=-1)

    return loss_fn, train_step, eval_step


def _make_minibatch_train_step(cfg: FinetuneConfig, task_kind: str):
    """``(loss_fn, step)`` of one minibatch (JAX
    ``_make_minibatch_train_step``) on a materialized batch graph ``g``.
    Node: the loss on the first ``len(y_batch)`` rows, the seeds, under
    ``mask``.  Link: on the midpoints ``(z[li] + z[ri]) / 2`` of the batch's
    edges, under ``mask``."""

    def loss_fn(model, g, y_batch, mask, li=None, ri=None, generator=None):
        model.train()
        z, aux = encode(model, g, generator=generator, return_aux=True)
        rows = (z[:y_batch.shape[0]] if task_kind == "node"
                else (gather_rows(z, li) + gather_rows(z, ri)) / 2.0)
        return _loss_parts(model, cfg, rows, y_batch, mask, mask, aux)

    def step(model, opt, g, y_batch, mask, li=None, ri=None, generator=None):
        _, parts = loss_fn(model, g, y_batch, mask, li, ri, generator)
        _apply(opt, parts["loss"])
        return {k: v.detach() for k, v in parts.items()}

    return loss_fn, step


class _Events:
    """Device milliseconds of named regions by CUDA events, read at the
    end; nothing is recorded on the CPU."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.pairs = {}

    def start(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.setdefault(name, []).append([ev, None])

    def stop(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs[name][-1][1] = ev

    def into(self, stats: dict):
        if self.on:
            torch.cuda.synchronize()
        for name, pairs in self.pairs.items():
            stats.setdefault(name, []).extend(
                a.elapsed_time(b) for a, b in pairs)
        self.pairs = {}


class _ModelSaver:
    """The best-validation snapshot over every split and its final save
    (JAX ``_make_model_saver``): the task model's trees in JAX's layout
    (``{"params": {"encoder", "vq", "decoder"}, "state": {"encoder",
    "vq"}}``) with the meta ``config``, ``best_val``, ``task``,
    ``dataset``.  ``pred`` keeps the snapshot epoch's evaluation."""

    def __init__(self, path: str, cfg: FinetuneConfig, verbose: bool):
        self.path, self.cfg, self.verbose = path, cfg, verbose
        self.val, self.tree, self.pred = -1.0, None, None

    def maybe_snap(self, model, val: float, pred):
        if self.path and val > self.val:
            params, state = task_model_to_jax(model)
            self.val, self.pred = val, pred
            self.tree = {"params": params, "state": state}

    def save(self):
        if not (self.path and self.tree is not None):
            return
        ckpt.save_pytree(self.path, self.tree, meta={
            "config": dataclasses.asdict(self.cfg), "best_val": self.val,
            "task": self.cfg.task, "dataset": self.cfg.dataset})
        if self.verbose:
            print(f"[save_model] best-val model (val={self.val:.2f}) -> "
                  f"{self.path}", flush=True)


def _endpoints(ds, ids):
    """The sorted unique endpoints of the edges ``ids``."""
    return np.unique(np.concatenate([np.asarray(ds.edge_index[0])[ids],
                                     np.asarray(ds.edge_index[1])[ids]]))


def _minibatch_epoch(ds, cfg: FinetuneConfig, task_kind: str, masks: dict,
                     rng_np, step, model, opt, ctx: dict, generator):
    """One minibatch training epoch (JAX ``_minibatch_epoch``; the
    reference's NeighborLoader / LinkNeighborLoader).  ``ctx`` holds the
    run's CSC graph (whose cache keeps the padding buckets across epochs),
    the resident feature tables and the device.  Returns the epoch's mean
    loss parts and its history: the batches, the host ms a batch of the
    sampler (``host/sample_ms``) and of the id copies and feature gather
    (``host/transfer_ms``); on CUDA the device ms a batch step
    (``device_ms``, CUDA events around each step) and the idle share
    (``idle``: one minus the steps' event time over the epoch's wall, which
    ends in the epoch's one readback)."""
    device = ctx["device"]
    node_table, edge_table = ctx["tables"]
    labels = np.asarray(ds.labels)
    bs = cfg.batch_size
    fanouts = ([cfg.fanout if task_kind == "node" else cfg.link_fanout]
               * cfg.encoder.num_layers)
    host = {"sample": 0.0, "transfer": 0.0}
    spans, sums, n_batches = [], None, 0
    t_epoch = time.perf_counter()

    def run(ig, y_batch, mask, li=None, ri=None):
        nonlocal sums, n_batches
        t0 = time.perf_counter()
        g = batch_graph(ig, node_table, edge_table, device, False)
        moved = [host_to_device(a, device) for a in (y_batch, mask)] + [
            None if a is None else host_to_device(a, device)
            for a in (li, ri)]
        host["transfer"] += time.perf_counter() - t0
        if ctx["timed"]:
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
        parts = step(model, opt, g, *moved, generator=generator)
        if ctx["timed"]:
            span[1].record()
            spans.append(span)
        # summed on the device and read once an epoch
        sums = parts if sums is None else {k: sums[k] + v
                                           for k, v in parts.items()}
        n_batches += 1

    if task_kind == "node":
        seeds = np.nonzero(np.asarray(masks["train"]))[0]
        it = NeighborBatchIterator(ctx["csc"], ds.x, ds.xe, seeds, bs,
                                   fanouts, rng_np, drop_last=False)
        batches = iter(it)
        while True:
            ts = time.perf_counter()
            item = next(batches, None)
            host["sample"] += time.perf_counter() - ts
            if item is None:
                break
            ig, n_seeds, nodes = item
            y_batch = np.zeros(bs, np.int64)
            y_batch[:n_seeds] = labels[nodes[:n_seeds]]
            run(ig, y_batch, np.arange(bs) < n_seeds)
    else:
        ts = time.perf_counter()
        edge_ids = np.nonzero(np.asarray(masks["train"]))[0]
        rng_np.shuffle(edge_ids)
        # one iterator of 2 * bs seeds for stable buckets; its probes are
        # the real endpoint sets, which are degree-biased
        probe = [_endpoints(ds, edge_ids[i * bs:(i + 1) * bs])
                 for i in range(min(12, max(len(edge_ids) // max(bs, 1),
                                            1)))]
        it = NeighborBatchIterator(ctx["csc"], ds.x, ds.xe,
                                   np.arange(ds.num_nodes), 2 * bs, fanouts,
                                   rng_np, shuffle=False, probe_chunks=probe)
        host["sample"] += time.perf_counter() - ts
        for i in range(0, len(edge_ids), bs):
            ts = time.perf_counter()
            chunk = edge_ids[i:i + bs]
            u = np.asarray(ds.edge_index[0])[chunk]
            v = np.asarray(ds.edge_index[1])[chunk]
            uniq, inv = np.unique(np.concatenate([u, v]),
                                  return_inverse=True)
            ig, _, _ = it.make_batch(uniq)
            li = np.zeros(bs, np.int64)
            ri = np.zeros(bs, np.int64)
            li[:len(chunk)] = inv[:len(chunk)]
            ri[:len(chunk)] = inv[len(chunk):]
            y_batch = np.zeros(bs, np.int64)
            y_batch[:len(chunk)] = labels[chunk]
            host["sample"] += time.perf_counter() - ts
            run(ig, y_batch, np.arange(bs) < len(chunk), li, ri)
    loss = {k: 0.0 for k in _LOSS_KEYS}
    if n_batches:
        vals = torch.stack([sums[k] for k in _LOSS_KEYS]).cpu().tolist()
        loss = {k: v / n_batches for k, v in zip(_LOSS_KEYS, vals)}
    hist = {"batches": n_batches, "epoch_s": time.perf_counter() - t_epoch}
    hist.update({f"host/{k}_ms": 1e3 * v / max(n_batches, 1)
                 for k, v in host.items()})
    if spans:
        busy_ms = sum(a.elapsed_time(b) for a, b in spans)
        hist["device_ms"] = busy_ms / len(spans)
        hist["idle"] = 1.0 - busy_ms / (1e3 * hist["epoch_s"])
    return loss, hist


def _kmeans_init(model, cfg: FinetuneConfig, ds, graph, device, idx: int,
                 verbose: bool):
    """k-means-initialize a codebook that is not initted (JAX
    finetune_loop.py:584-602): over the full graph's eval-mode encoding,
    or without a full graph (``eval_chunked`` with minibatches) over the
    layer-wise one."""
    if not cfg.use_vq or bool(model.vq.initted):
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(idx)
    if graph is not None:
        bins = maybe_kmeans_init_vq(model, cfg, graph, generator=gen)
        how = "the full graph's encoding"
    else:
        z0, nm0 = layerwise_encode(
            model.encoder, ds.node_features(), np.asarray(ds.edge_index[0]),
            np.asarray(ds.edge_index[1]),
            xe=None if ds.xe is None else np.asarray(ds.xe),
            edge_table=(None if ds.edge_text_feat is None
                        else np.asarray(ds.edge_text_feat)),
            num_nodes=ds.num_nodes, edge_block=cfg.eval_edge_block,
            device=device)
        bins = vq_kmeans_init(model.vq, z0, mask=nm0, generator=gen)
        how = "the layer-wise encoding"
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if verbose:
        used = (bins > 0).sum(1).tolist()
        print(f"[split {idx}] k-means init of the codebook over {how}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms, codes used per "
              f"head {used} of {bins.shape[1]}", flush=True)


# ------------------------------------------------------------ graph tasks

def _batch_graph_list(graphs, labels, idxs, batch_size: int,
                      node_bucket: int = 512, edge_bucket: int = 2048):
    """Host batching of molecule graphs into padded disjoint batches (JAX
    ``_batch_graph_list``), a generator of ``(batch, labels, n_real)``:
    nodes padded to a multiple of ``node_bucket`` past their count (one
    dead slot at least), edges to a multiple of ``edge_bucket``; labels
    padded with NaN rows to ``batch_size`` rows, of which the first
    ``n_real`` are real.  An :class:`IndexedGraphList` gives host
    :class:`IndexedGraph` batches of ids; graph dicts give host
    :class:`Graph` batches of CPU tensors."""
    indexed = getattr(graphs, "node_table", None) is not None
    num_tasks = labels.shape[1]
    for i in range(0, len(idxs), batch_size):
        chunk = idxs[i:i + batch_size]
        gs = [graphs[j] for j in chunk]
        if indexed:
            tot_n = sum(len(g["x"]) for g in gs)
            build = batch_indexed_graphs
        else:
            tot_n = sum(g["node_feat"].shape[0] for g in gs)
            build = batch_graphs
        tot_e = sum(len(g["senders"]) for g in gs)
        g = build(gs, node_pad_to=round_up(tot_n + 1, node_bucket),
                  edge_pad_to=round_up(max(tot_e, 1), edge_bucket))
        lab = np.full((batch_size, num_tasks), np.nan)
        lab[:len(chunk)] = labels[chunk]
        yield g, lab, len(chunk)


def _graph_feeder(graphs, device):
    """``(tables, to_device)`` for a graph bundle: ``to_device`` turns a
    host batch of :func:`_batch_graph_list` into a padded :class:`Graph` on
    ``device``.  An indexed bundle's feature tables (``tables``) move to the
    device once and each batch moves its ids and gathers its features there
    (``materialize_graph``); a materialized batch moves whole (``tables``
    None)."""
    if getattr(graphs, "node_table", None) is None:
        return None, lambda g: graph_to_device(g, device)
    tables = _tables({"node_text_feat": graphs.node_table,
                      "edge_text_feat": graphs.edge_table}, device)
    return tables, lambda g: materialize_graph(indexed_to_device(g, device),
                                               *tables)


def _make_graph_steps(cfg: FinetuneConfig, batch_size: int, eval_bs: int,
                      eval_bf16: bool = False):
    """``(loss_fn, train_step, predict)`` of the graph task: the encoder,
    the mean pool over each batch's ``batch_size`` graph slots, the decoder
    and the multitask BCE over the ``valid`` labels of the ``gmask`` rows
    (JAX ``_run_graph_task``'s ``_train_impl``); ``predict`` gives the
    head-mean logits [eval_bs, T] of an evaluation batch in eval mode, with
    a bf16 encoder under ``eval_bf16`` (JAX's ``eval_cfg``,
    finetune_loop.py:1017-1026: the same parameters at another compute
    dtype).  ``plain`` runs the aggregation kernels' plain versions (a
    molecule batch carries no layout, so both routes are the gather +
    ``index_add_``)."""
    eval_dtype = "bfloat16" if eval_bf16 else None

    def loss_fn(model, g, y, valid, gmask, generator=None, plain=False):
        model.train()
        z, aux = encode(model, g, generator=generator, plain=plain,
                        return_aux=True)
        pooled = pool_graph(z, g, "mean", num_segments=batch_size)
        return _loss_parts(model, cfg, pooled, y, gmask, gmask, aux,
                           valid=valid)

    def train_step(model, opt, g, y, valid, gmask, generator=None,
                   plain=False):
        _, parts = loss_fn(model, g, y, valid, gmask, generator, plain)
        _apply(opt, parts["loss"])
        return {k: v.detach() for k, v in parts.items()}

    def predict(model, g, plain=False):
        model.eval()
        with torch.no_grad():
            z = encode(model, g, plain=plain, compute_dtype=eval_dtype)
            pooled = pool_graph(z, g, "mean", num_segments=eval_bs)
            logits, _ = task_logits(model, cfg, pooled)
            return logits.mean(1).float()

    return loss_fn, train_step, predict


def _device_eval_split(batches, y_split, device, budget: float = 2e9):
    """A split's evaluation resident on the device (JAX
    ``build_device_eval``): its id batches and its labels and validity, so
    an evaluation copies nothing and reads back one AUC.  None when the
    batches' host bytes pass ``budget``; the caller then streams."""
    host, total = [], 0
    for g, _, n in batches:
        total += sum(a.nbytes for a in (g.node_ids, g.senders, g.receivers,
                                        g.node_mask, g.edge_mask, g.xe_ids,
                                        g.node_graph_id) if a is not None)
        if total > budget:
            return None
        host.append((g, n))
    return ([(indexed_to_device(g, device), n) for g, n in host],
            torch.from_numpy(np.nan_to_num(y_split).astype(np.float32)).to(
                device),
            torch.from_numpy(~np.isnan(y_split)).to(device))


def graph_task_predict(graphs, num_tasks: int, cfg: FinetuneConfig, model,
                       batch_size: int = 0):
    """Per-molecule head-mean logits [G, num_tasks] of a trained task model,
    in dataset order, on the model's device (JAX ``graph_task_predict``;
    ``infer --mode predict`` serves their sigmoid)."""
    bs = batch_size or cfg.batch_size or 64
    _, to_device = _graph_feeder(graphs, next(model.parameters()).device)
    predict = _make_graph_steps(cfg, bs, bs)[2]
    dummy = np.zeros((len(graphs), num_tasks))
    outs = [predict(model, to_device(g))[:n] for g, _, n in
            _batch_graph_list(graphs, dummy, np.arange(len(graphs)), bs)]
    return torch.cat(outs).cpu().numpy()


def graph_task_encode(graphs, cfg: FinetuneConfig, encoder, quantizer,
                      batch_size: int = 0):
    """Per-molecule artifacts of a pretrained encoder and VQ in eval mode
    (JAX ``graph_task_encode``; ``infer --mode encode``): the mean-pooled
    embeddings [G, D], their quantized form [G, D] and VQ codes [G, H]."""
    bs = batch_size or cfg.batch_size or 64
    _, to_device = _graph_feeder(graphs, next(encoder.parameters()).device)
    dummy = np.zeros((len(graphs), 1))
    outs = {"pooled": [], "quant": [], "codes": []}
    encoder.eval()
    quantizer.eval()
    with torch.no_grad():
        for g, _, n in _batch_graph_list(graphs, dummy,
                                         np.arange(len(graphs)), bs):
            g = to_device(g)
            z = encoder(g.node_feat, g.senders, g.receivers,
                        edge_feat=g.edge_feat, edge_mask=g.edge_mask,
                        node_mask=g.node_mask)
            pooled = pool_graph(z, g, "mean", num_segments=bs)
            res = quantizer(pooled)
            outs["pooled"].append(pooled[:n])
            outs["quant"].append(res["quantize"][:n])
            outs["codes"].append(res["indices"][:n])
    return tuple(torch.cat(outs[k]).cpu().numpy()
                 for k in ("pooled", "quant", "codes"))


def _run_graph_task(graphs, labels, split, cfg: FinetuneConfig,
                    pretrained=None, device="cuda", verbose: bool = False,
                    seed_base: int = 0, save_model_to: str = ""):
    """The graph task (JAX ``_run_graph_task``; the reference's
    task/graph.py): per repeat a fresh task model, its codebook
    k-means-initialized from the first train-sized batch's node encodings,
    AdamW over batches of ``batch_size`` molecules shuffled by
    ``default_rng(seed_base + idx)``, and every ``eval_every`` epochs (and
    the last) the mean per-task AUC of the train (``eval_train_auc``),
    valid and test splits over batches of ``eval_batch_size``; early stop
    and the saved snapshot on the validation AUC.  An indexed bundle keeps
    its evaluation batches and labels on the device and computes the AUC
    there (``device_multitask_auc``) unless their ids pass 2e9 bytes;
    otherwise the batches are cached on the host (50,000 graphs or fewer)
    or rebuilt each evaluation, and the AUC is computed on the host.  The
    logged loss of an epoch is its last batch's, as in JAX."""
    device = resolve_device(device)
    labels = np.asarray(labels, np.float64)
    batch_size = cfg.batch_size or 64
    eval_bs = cfg.eval_batch_size or batch_size
    tables, to_device = _graph_feeder(graphs, device)
    steps = _make_graph_steps(cfg, batch_size, eval_bs, cfg.eval_bf16)
    _, train_step, predict = steps
    masks = {k: np.asarray(split[k]).astype(bool)
             for k in ("train", "valid", "test")}

    def make_batches(k, bs, shuffle_rng=None):
        idxs = np.where(masks[k])[0]
        if shuffle_rng is not None:
            shuffle_rng.shuffle(idxs)
        return _batch_graph_list(graphs, labels, idxs, bs)

    ev_splits = (("train", "valid", "test") if cfg.eval_train_auc
                 else ("valid", "test"))
    dev_eval = None
    if tables is not None:
        dev_eval = {k: _device_eval_split(
            make_batches(k, eval_bs), labels[masks[k]], device)
            for k in ev_splits}
        if any(v is None for v in dev_eval.values()):
            dev_eval = None
    cached = None
    if dev_eval is not None:
        route = "device AUC, resident id batches"
    elif len(graphs) <= 50_000:
        route = "host AUC, cached batches"
        cached = {k: list(make_batches(k, eval_bs)) for k in ev_splits}
    else:
        route = "host AUC, streamed batches"
    if verbose:
        print(f"graph task: {len(graphs)} graphs, {labels.shape[1]} tasks, "
              f"batches of {batch_size}, evaluation batches of {eval_bs}; "
              f"evaluation: {route}", flush=True)

    def evaluate_split(model, k):
        """(AUC x 100, the split's head-mean logits on the device)."""
        if dev_eval is not None:
            batches, y_dev, valid_dev = dev_eval[k]
            preds = torch.cat([predict(model, materialize_graph(g, *tables))
                               [:n] for g, n in batches])
            return float(device_multitask_auc(preds, y_dev, valid_dev)) \
                * 100, preds
        source = cached[k] if cached is not None else make_batches(k,
                                                                   eval_bs)
        preds, ys = [], []
        for g, lab, n in source:
            preds.append(predict(model, to_device(g))[:n])
            ys.append(lab[:n])
        preds = torch.cat(preds)
        return evaluate(preds.cpu().numpy(), np.concatenate(ys), None,
                        "graph"), preds

    logger = Logger()
    saver = _ModelSaver(save_model_to, cfg, verbose)
    events = _Events(device)
    timed = device.type == "cuda"
    out = {}
    for idx in range(cfg.repeat):
        model = task_model_init(
            cfg, None if pretrained is None
            else copy.deepcopy(pretrained["encoder"]),
            None if pretrained is None else copy.deepcopy(pretrained["vq"]),
            generator=torch.Generator().manual_seed(seed_base + idx))
        model.to(device)
        # k-means from the first TRAIN-sized batch, so the trajectory does
        # not depend on the evaluation batches
        first = next(iter(make_batches("train", batch_size)), None)
        if first is not None:
            bins = maybe_kmeans_init_vq(
                model, cfg, to_device(first[0]),
                generator=torch.Generator(device=device).manual_seed(
                    seed_base + idx))
            if verbose and bins is not None:
                print(f"[split {idx}] k-means init of the codebook over the "
                      f"first train batch: codes used per head "
                      f"{(bins > 0).sum(1).tolist()} of {bins.shape[1]}",
                      flush=True)
        trainable, _ = _split_params(model, cfg)
        init_params = {k: p.detach().cpu().clone()
                       for k, p in model.named_parameters()}
        opt = make_optimizer(trainable, cfg)
        stopper = EarlyStopping(patience=cfg.early_stop)
        rng_np = np.random.default_rng(seed_base + idx)
        gen = torch.Generator(device=device).manual_seed(seed_base + idx)
        gmask_all = torch.arange(batch_size, device=device)
        epoch_losses, history = [], []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            host = {"sample": 0.0, "transfer": 0.0}
            spans, parts, n_b = [], None, 0
            batches = make_batches("train", batch_size, rng_np)
            while True:
                ts = time.perf_counter()
                item = next(batches, None)
                host["sample"] += time.perf_counter() - ts
                if item is None:
                    break
                g, lab, n_real = item
                ts = time.perf_counter()
                g = to_device(g)
                y = host_to_device(np.nan_to_num(lab * 2.0 - 1.0).astype(
                    np.float32), device)
                valid = host_to_device(~np.isnan(lab), device)
                host["transfer"] += time.perf_counter() - ts
                if timed:
                    span = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                    span[0].record()
                parts = train_step(model, opt, g, y, valid,
                                   gmask_all < n_real, gen)
                if timed:
                    span[1].record()
                    spans.append(span)
                n_b += 1
            loss = {k: 0.0 for k in _LOSS_KEYS}
            if parts is not None:
                vals = torch.stack([parts[k] for k in _LOSS_KEYS]).tolist()
                loss = dict(zip(_LOSS_KEYS, vals))
            hist = {"batches": n_b, "epoch_s": time.perf_counter() - t0}
            hist.update({f"host/{k}_ms": 1e3 * v / max(n_b, 1)
                         for k, v in host.items()})
            if spans:
                busy_ms = sum(a.elapsed_time(b) for a, b in spans)
                hist["device_ms"] = busy_ms / len(spans)
                hist["idle"] = 1.0 - busy_ms / (1e3 * hist["epoch_s"])
            epoch_losses.append(loss)
            history.append(hist)
            k_ev = max(1, cfg.eval_every)
            if (epoch + 1) % k_ev and epoch != cfg.epochs - 1:
                if verbose:
                    print(f"[split {idx}] epoch {epoch}: loss "
                          f"{loss['loss']:.4f} | {hist['epoch_s']:.3f} s "
                          f"(evaluation every {k_ev})", flush=True)
                continue
            t_ev = time.perf_counter()
            result, preds = {"metric": "auc"}, {}
            for k, key in (("train", "train"), ("valid", "val"),
                           ("test", "test")):
                if k not in ev_splits:
                    result[key] = float("nan")
                    continue
                events.start(f"eval_ms/{k}")
                result[key], preds[k] = evaluate_split(model, k)
                events.stop(f"eval_ms/{k}")
            events.into(hist)
            hist.update({k: v[0] for k, v in hist.items()
                         if isinstance(v, list)})
            if timed:
                hist["eval_ms"] = sum(hist[f"eval_ms/{k}"]
                                      for k in ev_splits)
            hist.update(eval_s=time.perf_counter() - t_ev, eval_route=route)
            logger.log(idx, epoch, loss, result)
            saver.maybe_snap(model, float(result["val"]), preds)
            if verbose:
                extra = ""
                if "device_ms" in hist:
                    extra = (f", step {hist['device_ms']:.3f} ms device, "
                             f"idle {hist['idle']:.3f}")
                print(f"[split {idx}] epoch {epoch}: loss {loss['loss']:.4f}"
                      f" | train {result['train']:.2f} val "
                      f"{result['val']:.2f} test {result['test']:.2f} | "
                      f"{n_b} batches in {hist['epoch_s']:.3f} s, build "
                      f"{hist['host/sample_ms']:.2f} + copy "
                      f"{hist['host/transfer_ms']:.2f} ms a batch{extra}; "
                      f"evaluation {hist['eval_s']:.3f} s", flush=True)
            if stopper(result):
                if verbose:
                    print(f"[split {idx}] early stop at epoch {epoch}")
                break
        if verbose:
            b = logger.get_single_best(idx)
            print(f"[split {idx}] best val={b['val']:.2f} "
                  f"test={b['test']:.2f}", flush=True)
        out = dict(model=model, steps=steps, to_device=to_device,
                   epoch_losses=epoch_losses, history=history,
                   init_params=init_params, cfg=cfg, eval_route=route)
    saver.save()
    if save_model_to:
        out["best_pred"] = (None if saver.pred is None else
                            {k: v.cpu().numpy() for k, v in
                             saver.pred.items()})
    return dict(logger=logger, **out)


def run_finetune(ds, cfg: FinetuneConfig, pretrained=None, device="cuda",
                 verbose: bool = False, save_model_to: str = ""):
    """Finetune ``cfg.repeat`` splits of the node or link dataset ``ds``
    (``cfg.task``), full batch or minibatch (module docstring), or the
    graph task on ``ds = (graphs, labels, split)`` (``_run_graph_task``,
    whose history also holds each evaluation's device ms a split,
    ``eval_ms/<split>``, and its ``eval_route``; ``best_pred`` is a dict of
    each evaluated split's head-mean logits).
    ``pretrained`` is None or ``{"encoder": Encoder, "vq": VectorQuantize}``
    (copied per split); ``save_model_to`` names the npz of the best model.

    Returns the Logger and what the last split used: ``cfg``, ``model``,
    ``graph`` (None when the chunked evaluation trains minibatches), ``y``,
    ``train_mask``, ``steps`` (the full-batch step functions), the
    parameters right before its first step (``init_params``, on the CPU),
    and per epoch its loss parts (``epoch_losses``), host seconds
    (``epoch_s``, each ending in a device sync) and ``history``: the
    evaluation's device ms (``eval_ms``, CUDA events), full batch the
    training step's (``step_ms``) and, under
    minibatches, the batches and their host and device times (see
    ``_minibatch_epoch``); with ``save_model_to``, the predictions of the
    saved snapshot's evaluation (``best_pred``)."""
    task = cfg.task
    if task == "graph":
        graphs, labels, split = ds
        return _run_graph_task(graphs, labels, split, cfg, pretrained,
                               device, verbose, save_model_to=save_model_to)
    if task not in ("node", "link"):
        raise ValueError(f"Invalid task {task}")
    device = torch.device(device)
    minibatch = cfg.batch_size != 0
    if not minibatch:
        ds = maybe_reorder_dataset(ds, cfg, task, device)
    n = ds.num_nodes if task == "node" else ds.num_edges
    if cfg.eval_chunked and minibatch:
        # never build the full padded graph (the point of the streamed
        # evaluation); the item padding follows make_graph's
        graph = None
        n_pad = round_up(max(n, 1), 8 if task == "node" else 128)
    else:
        graph = fused_full_graph(ds, cfg, device=device)
        n_pad = (graph.num_nodes_padded if task == "node"
                 else graph.num_edges_padded)
        if verbose and graph.layout is not None:
            t_rows = (1 if graph.edge_table is None
                      else int(graph.edge_table.shape[0]))
            print(describe_layout(graph.layout, t_rows), flush=True)
    y_np = np.zeros(n_pad, np.int64)
    y_np[:n] = np.asarray(ds.labels)[:n]
    y = torch.from_numpy(y_np).to(device)

    splits = ds.splits
    if len(splits) == 1 and cfg.repeat > 1:
        splits = splits * cfg.repeat
    splits = splits[:cfg.repeat]

    logger = Logger()
    saver = _ModelSaver(save_model_to, cfg, verbose)
    steps = _make_node_steps(cfg, task)
    _, train_step, eval_step = steps
    ctx = None
    if minibatch:
        mb_step = _make_minibatch_train_step(cfg, task)[1]
        ctx = {"csc": CSCGraph.from_edge_index(np.asarray(ds.edge_index),
                                               ds.num_nodes),
               "tables": _tables({"node_text_feat": ds.node_text_feat,
                                  "edge_text_feat": ds.edge_text_feat},
                                 device),
               "device": device, "timed": device.type == "cuda"}
    # JAX draws every split's batches from one generator: default_rng(0)
    # (its FinetuneConfig has no seed field)
    rng_np = np.random.default_rng(0)
    # the MoE usage lines of the full-batch epochs (finetune.py:239-254)
    moe_print_interval = max(1, cfg.epochs // 20)
    events = _Events(device)
    out = {}
    for idx, split in enumerate(splits):
        model = task_model_init(
            cfg, None if pretrained is None
            else copy.deepcopy(pretrained["encoder"]),
            None if pretrained is None else copy.deepcopy(pretrained["vq"]),
            generator=torch.Generator().manual_seed(idx))
        model.to(device)
        _kmeans_init(model, cfg, ds, graph, device, idx, verbose)
        trainable, _ = _split_params(model, cfg)
        init_params = {k: p.detach().cpu().clone()
                       for k, p in model.named_parameters()}
        opt = make_optimizer(trainable, cfg)
        stopper = EarlyStopping(patience=cfg.early_stop)
        gen = torch.Generator(device=device).manual_seed(idx)
        masks = {}
        for k in ("train", "valid", "test"):
            m = np.zeros(n_pad, bool)
            m[:n] = np.asarray(split[k])[:n]
            masks[k] = m
        train_mask = torch.from_numpy(masks["train"]).to(device)
        epoch_s, epoch_losses, history = [], [], []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            hist = {}
            if minibatch:
                loss, hist = _minibatch_epoch(ds, cfg, task, masks, rng_np,
                                              mb_step, model, opt, ctx, gen)
            else:
                events.start("step_ms")
                losses = train_step(model, opt, train_mask, graph, y, gen)
                events.stop("step_ms")
                moe_stats = losses.pop("moe_stats", None)
                if moe_stats and epoch % moe_print_interval == 0:
                    print_moe_usage(moe_stats)
            events.start("eval_ms")
            if cfg.eval_chunked:
                pred = layerwise_eval_predict(
                    model, cfg, ds, task, n_pad,
                    edge_block=cfg.eval_edge_block, device=device)
            else:
                pred = eval_step(model, graph)
            events.stop("eval_ms")
            pred = np.asarray(pred.cpu()) if torch.is_tensor(pred) else pred
            if not minibatch:
                loss = {k: float(v) for k, v in losses.items()}
            epoch_s.append(time.perf_counter() - t0)
            epoch_losses.append(loss)
            events.into(hist)
            hist = {k: v[0] if isinstance(v, list) else v
                    for k, v in hist.items()}
            history.append(hist)
            result = {"train": evaluate(pred, y_np, masks["train"], cfg.task),
                      "val": evaluate(pred, y_np, masks["valid"], cfg.task),
                      "test": evaluate(pred, y_np, masks["test"], cfg.task),
                      "metric": task2metric[cfg.task]}
            logger.log(idx, epoch, loss, result)
            saver.maybe_snap(model, float(result["val"]), pred)
            if verbose:
                extra = ""
                if minibatch:
                    extra = (f" | {hist['batches']} batches, sampler "
                             f"{hist['host/sample_ms']:.2f} ms a batch")
                print(f"[split {idx}] epoch {epoch}: loss {loss['loss']:.4f}"
                      f" | train {result['train']:.2f} val "
                      f"{result['val']:.2f} test {result['test']:.2f} | "
                      f"{epoch_s[-1]:.3f} s{extra}", flush=True)
            if stopper(result):
                if verbose:
                    print(f"[split {idx}] early stop at epoch {epoch}")
                break
        if verbose:
            b = logger.get_single_best(idx)
            print(f"[split {idx}] best val={b['val']:.2f} "
                  f"test={b['test']:.2f}", flush=True)
        out = dict(model=model, graph=graph, y=y, train_mask=train_mask,
                   steps=steps, epoch_s=epoch_s, epoch_losses=epoch_losses,
                   history=history, init_params=init_params, cfg=cfg)
    saver.save()
    if save_model_to:
        out["best_pred"] = saver.pred
    return dict(logger=logger, **out)
