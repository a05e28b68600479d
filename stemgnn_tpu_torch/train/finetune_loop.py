"""Node and link finetune, full batch and minibatch (counterpart of the
node/link branch of ``stemgnn_tpu/train/finetune_loop.py``:
``_split_params`` :39, ``_make_model_saver`` :58, ``_make_node_steps``
:100, ``_make_minibatch_train_step`` :314, ``_minibatch_epoch`` :381,
``_run_node_like`` :486).

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
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import host_to_device, round_up
from stemgnn_tpu_torch.data.sampler import CSCGraph, NeighborBatchIterator
from stemgnn_tpu_torch.models.task import (activation_loss,
                                           decoder_jacobian_penalty, encode,
                                           maybe_kmeans_init_vq, task_logits,
                                           task_model_init)
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
from stemgnn_tpu_torch.utils.metrics import evaluate, task2metric
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


def _loss_parts(model, cfg: FinetuneConfig, rows, y, row_mask, train_mask):
    """The head-mean cross entropy over ``train_mask`` of the decoder's
    logits on ``rows`` (the VQ's loss covering ``row_mask``), plus the
    Jacobian penalty: (loss, {name: loss part})."""
    logits, _ = task_logits(model, cfg, rows, mask=row_mask)
    act = activation_loss(logits, y, mask=train_mask)
    jac = decoder_jacobian_penalty(model, cfg)
    # the MoE environment regularizer is 0 without MoE layers
    env = torch.zeros((), device=act.device)
    loss = act + jac + cfg.lamda_env * env
    return loss, {"loss": loss, "act_loss": act, "jac_loss": jac,
                  "env_loss": env}


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

    def rows(model, graph, generator=None, plain=False):
        """The task's rows and their mask: nodes, or the midpoints of the
        graph's edges."""
        z = encode(model, graph, generator=generator, plain=plain)
        if task_kind == "link":
            return (z[graph.senders] + z[graph.receivers]) / 2.0, \
                graph.edge_mask
        return z, graph.node_mask

    def loss_fn(model, train_mask, graph, y, generator=None, plain=False):
        """Training-mode forward: (loss, {name: loss part})."""
        model.train()
        z, row_mask = rows(model, graph, generator, plain)
        return _loss_parts(model, cfg, z, y, row_mask, train_mask)

    def train_step(model, opt, train_mask, graph, y, generator=None,
                   plain=False):
        _, parts = loss_fn(model, train_mask, graph, y, generator, plain)
        _apply(opt, parts["loss"])
        return {k: v.detach() for k, v in parts.items()}

    def eval_step(model, graph, plain=False):
        """Class probabilities [rows, C] from the head-mean logits."""
        model.eval()
        with torch.no_grad():
            z, row_mask = rows(model, graph, plain=plain)
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
        z = encode(model, g, generator=generator)
        rows = (z[:y_batch.shape[0]] if task_kind == "node"
                else (z[li] + z[ri]) / 2.0)
        return _loss_parts(model, cfg, rows, y_batch, mask, mask)

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


def run_finetune(ds, cfg: FinetuneConfig, pretrained=None, device="cuda",
                 verbose: bool = False, save_model_to: str = ""):
    """Finetune ``cfg.repeat`` splits of the node or link dataset ``ds``
    (``cfg.task``), full batch or minibatch (module docstring).
    ``pretrained`` is None or ``{"encoder": Encoder, "vq": VectorQuantize}``
    (copied per split); ``save_model_to`` names the npz of the best model.

    Returns the Logger and what the last split used: ``cfg``, ``model``,
    ``graph`` (None when the chunked evaluation trains minibatches), ``y``,
    ``train_mask``, ``steps`` (the full-batch step functions), the
    parameters right before its first step (``init_params``, on the CPU),
    and per epoch its loss parts (``epoch_losses``), host seconds
    (``epoch_s``, each ending in a device sync) and ``history``: the
    evaluation's device ms (``eval_ms``, CUDA events) and, under
    minibatches, the batches and their host and device times (see
    ``_minibatch_epoch``); with ``save_model_to``, the predictions of the
    saved snapshot's evaluation (``best_pred``)."""
    task = cfg.task
    if task not in ("node", "link"):
        raise NotImplementedError(
            f"the {task} task is not ported; the port finetunes node and "
            f"link tasks (graph tasks: ROADMAP Queue 1 item 7)")
    if any(cfg.encoder.moe_layer_flags()):
        raise NotImplementedError("MoE-SAGE layers are not ported (ROADMAP "
                                  "Queue 1 item 5)")
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
                losses = train_step(model, opt, train_mask, graph, y, gen)
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
