"""The training scaffold the five robustness evaluations share (counterpart
of ``stemgnn_tpu/eval/runner.py``).

Every evaluation script has one shape: a split -> a full-batch node
finetune -> per-epoch accuracy on each split and bucket -> a snapshot of
the best validation epoch -> (optionally) the snapshot re-evaluated on a
perturbed graph -> nan-aware mean and std over runs.  This module is that
scaffold; the ``scripts`` modules supply the buckets and perturbations and
loop over runs.

Built on the finetune loop's steps (``train/finetune_loop``): on CUDA the
full graph carries the fused layout, so kernel 2
(``gathered_scatter_rows_sorted``) runs three times a training step, twice
an evaluation, twice in the k-means init of a codebook that is not initted,
and twice in each re-evaluation: over the training graph's layout with the
perturbed features swapped in when the edges are unchanged (missing
features), else over the perturbed graph's own layout (edge drops).

The loop trains exactly ``cfg.epochs`` epochs, one step and one evaluation
at a time.  JAX's default epoch-chunk scan trains in chunks of
``epoch_chunk`` epochs and can run (and pick its best epoch from) up to
``epoch_chunk - 1`` epochs past ``cfg.epochs``; the port does not copy that.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import host_to_device
from stemgnn_tpu_torch.data.dataset import TAGDataset
from stemgnn_tpu_torch.models.task import (maybe_kmeans_init_vq,
                                           task_model_init)
from stemgnn_tpu_torch.train.finetune_loop import (_make_node_steps,
                                                   _split_params,
                                                   make_optimizer)
from stemgnn_tpu_torch.train.graph_setup import fused_full_graph
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.utils.convert import from_jax_pytree
from stemgnn_tpu_torch.utils.metrics import eval_acc


def _pad_mask(idx_or_mask, n: int, pad: int) -> np.ndarray:
    """A boolean mask of ``pad`` rows from a mask of ``n`` rows or from
    indices."""
    m = np.zeros(pad, bool)
    a = np.asarray(idx_or_mask)
    if a.dtype == bool:
        m[:n] = a[:n]
    else:
        m[a] = True
    return m


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _graph(ds, cfg, device, use_layout, gwin, stats):
    """The full graph of ``ds``; its host seconds (up to the device's
    copies' end) appended to ``stats["layout_s"]``."""
    t0 = time.perf_counter()
    graph = fused_full_graph(ds, cfg, device=device, use_layout=use_layout,
                             gwin=gwin)
    _sync(device)
    stats.setdefault("layout_s", []).append(time.perf_counter() - t0)
    return graph


def _init_model(cfg: FinetuneConfig, pretrained, seed: int):
    """A task model around the pretrained encoder and VQ (the JAX-format
    trees of ``train.pretrain_loop.load_pretrained_for_finetune``, copied)
    or fresh ones, with a new decoder drawn from ``seed``."""
    enc = vq = None
    if pretrained is not None:
        enc, vq = from_jax_pytree(
            {"encoder": pretrained["encoder_params"],
             "vq": pretrained["vq_params"]},
            {"encoder": pretrained["encoder_state"],
             "vq": pretrained["vq_state"]}, cfg)
    return task_model_init(cfg, enc, vq,
                           generator=torch.Generator().manual_seed(seed))


def train_node_with_buckets(ds: TAGDataset, cfg: FinetuneConfig,
                            split_masks: Dict[str, np.ndarray],
                            bucket_indices: Dict[str, np.ndarray],
                            pretrained=None, seed: int = 0,
                            eval_every: int = 1, verbose: bool = False, *,
                            device="cuda", plain: bool = False,
                            use_layout: Optional[bool] = None,
                            gwin: str = "auto", model=None):
    """Full-batch node training with per-bucket tracking.

    ``model`` is an initial task model to train in place of a new one (its
    VQ is k-means-initialized first when not initted); ``plain`` runs the
    aggregation kernels' plain versions; ``use_layout``/``gwin`` go to
    ``fused_full_graph``.  Returns a dict: the best validation epoch
    (``epoch``, ``val``), its split and bucket accuracies (``split_acc``,
    ``bucket_acc``; x100), its snapshot (``state``: a device-side clone of
    the model's state dict, and the trained ``model`` it loads into), the
    padded ``masks``, ``bucket_masks`` and labels ``y``, the training
    ``graph`` with what it was built from (``graph_of``), and ``stats``:
    host seconds of the layout build (``layout_s``) and of the k-means init
    (``kmeans_s``), and on CUDA each step's and evaluation's device ms
    (``step_ms``, ``eval_ms``; CUDA events)."""
    device = torch.device(device)
    stats = {}
    graph = _graph(ds, cfg, device, use_layout, gwin, stats)
    n, pad = ds.num_nodes, graph.num_nodes_padded
    y_np = np.zeros(pad, np.int64)
    y_np[:n] = np.asarray(ds.labels)[:n]
    y = torch.from_numpy(y_np).to(device)

    masks = {k: _pad_mask(v, n, pad) for k, v in split_masks.items()}
    bucket_masks = {k: _pad_mask(v, n, pad) for k, v in bucket_indices.items()}

    _, train_step, eval_step = _make_node_steps(cfg, "node")
    if model is None:
        model = _init_model(cfg, pretrained, seed)
    model.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    if maybe_kmeans_init_vq(model, cfg, graph, generator=gen,
                            plain=plain) is not None:
        _sync(device)
        stats["kmeans_s"] = time.perf_counter() - t0
    trainable, _ = _split_params(model, cfg)
    opt = make_optimizer(trainable, cfg)
    train_mask = torch.from_numpy(masks["train"]).to(device)

    best = {"val": -np.inf, "epoch": -1, "state": None, "bucket_acc": None,
            "split_acc": None}
    rec = trace.Recorder(device)
    bad = 0
    for epoch in range(cfg.epochs):
        with trace.span("sg:finetune.train_step", rec):
            losses = train_step(model, opt, train_mask, graph, y, gen,
                                plain=plain)
        if epoch % eval_every:
            continue
        with trace.span("sg:finetune.eval", rec):
            pred = eval_step(model, graph, plain=plain)
        pred = pred.cpu().numpy()
        split_acc = {k: eval_acc(pred, y_np, m) * 100
                     for k, m in masks.items()}
        if split_acc["valid"] > best["val"]:
            bucket_acc = {k: eval_acc(pred, y_np, m) * 100
                          for k, m in bucket_masks.items()}
            best.update(val=split_acc["valid"], epoch=epoch,
                        state={k: v.detach().clone()
                               for k, v in model.state_dict().items()},
                        bucket_acc=bucket_acc, split_acc=split_acc)
            bad = 0
        else:
            bad += eval_every
            if bad >= cfg.early_stop:
                break
        if verbose and epoch % 50 == 0:
            print(f"  epoch {epoch}: loss={float(losses['loss']):.4f} "
                  f"val={split_acc['valid']:.2f}")
    _device_ms_into(stats, rec, step_ms="sg:finetune.train_step",
                    eval_ms="sg:finetune.eval")

    best.update(model=model, masks=masks, bucket_masks=bucket_masks, y=y_np,
                stats=stats, graph=graph, graph_of=(ds, use_layout, gwin))
    return best


def _device_ms_into(stats: dict, rec: trace.Recorder, **keys):
    """Each call's device ms of span ``keys[key]`` appended to the list
    ``stats[key]`` (nothing off CUDA)."""
    for key, name in keys.items():
        ms = rec.ms(name)
        if ms:
            stats.setdefault(key, []).extend(ms)


def snapshot_model(best: dict):
    """A copy of the trained model holding the best epoch's snapshot."""
    model = copy.deepcopy(best["model"])
    model.load_state_dict(best["state"])
    return model


def _same_edges(a: TAGDataset, b: TAGDataset) -> bool:
    """Whether ``a`` and ``b`` have the same nodes, edges and edge types, so
    the graph of one carries the other with its node features swapped."""
    def same(x, y):
        return x is y or (x is not None and y is not None
                          and np.array_equal(x, y))
    return (a.num_nodes == b.num_nodes and same(a.edge_index, b.edge_index)
            and same(a.xe, b.xe) and same(a.edge_text_feat, b.edge_text_feat))


def _graph_for(ds, cfg, best, device, use_layout, gwin):
    """The full graph of ``ds`` for a re-evaluation.  A graph whose edges
    are the training graph's (a missing-feature perturbation) reuses the
    training graph's layout and row plans with the new feature table
    swapped in, its host seconds appended to ``stats["feat_swap_s"]``; any
    other (an edge-dropped graph) builds its own (``stats["layout_s"]``)."""
    stats = best["stats"]
    graph = best.get("graph")
    if graph is None or best["graph_of"][1:] != (use_layout, gwin) \
            or not _same_edges(ds, best["graph_of"][0]):
        return _graph(ds, cfg, device, use_layout, gwin, stats)
    t0 = time.perf_counter()
    feat = np.zeros((graph.num_nodes_padded, ds.node_text_feat.shape[1]),
                    np.float32)
    feat[:ds.num_nodes] = ds.node_features()
    graph = dataclasses.replace(graph, node_feat=host_to_device(
        feat, device).to(graph.node_feat.dtype))
    _sync(device)
    stats.setdefault("feat_swap_s", []).append(time.perf_counter() - t0)
    return graph


def predict_snapshot_on(ds: TAGDataset, cfg: FinetuneConfig, best: dict, *,
                        plain: bool = False, use_layout: Optional[bool] = None,
                        gwin: str = "auto"):
    """Class probabilities [N_pad, C] (numpy) of the best snapshot on the
    full graph of ``ds`` (:func:`_graph_for`: the training graph's layout
    when the edges are the same, else built anew on the snapshot's device);
    on CUDA the evaluation's device ms is appended to
    ``best["stats"]["reeval_ms"]``."""
    model = snapshot_model(best)
    device = next(model.parameters()).device
    graph = _graph_for(ds, cfg, best, device, use_layout, gwin)
    _, _, eval_step = _make_node_steps(cfg, "node")
    rec = trace.Recorder(device)
    with trace.span("sg:finetune.eval", rec):
        pred = eval_step(model, graph, plain=plain)
    pred = pred.cpu().numpy()
    _device_ms_into(best["stats"], rec, reeval_ms="sg:finetune.eval")
    return pred


def evaluate_snapshot_on(ds: TAGDataset, cfg: FinetuneConfig, best: dict,
                         bucket_indices: Optional[Dict[str, np.ndarray]] = None,
                         *, plain: bool = False,
                         use_layout: Optional[bool] = None,
                         gwin: str = "auto"):
    """Re-evaluate a best-validation snapshot on a (possibly perturbed)
    graph: accuracy x100 on each split and on each bucket (the training
    run's buckets unless ``bucket_indices`` are given)."""
    pred = predict_snapshot_on(ds, cfg, best, plain=plain,
                               use_layout=use_layout, gwin=gwin)
    n, pad = ds.num_nodes, pred.shape[0]
    y = best["y"]
    out = {k: eval_acc(pred, y, m) * 100 for k, m in best["masks"].items()}
    buckets = best["bucket_masks"] if bucket_indices is None else {
        k: _pad_mask(v, n, pad) for k, v in bucket_indices.items()}
    out.update({k: eval_acc(pred, y, m) * 100 for k, m in buckets.items()})
    return out


def nanmean_std(values):
    """nan-aware (mean, std); (nan, nan) when every value is nan."""
    arr = np.asarray(values, dtype=np.float64)
    if np.all(np.isnan(arr)):
        return float("nan"), float("nan")
    return float(np.nanmean(arr)), float(np.nanstd(arr))
