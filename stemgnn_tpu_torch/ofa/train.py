"""OFA in-context training: classify by scoring the class nodes of prompted
graphs (counterpart of ``stemgnn_tpu/ofa/train.py``).

The reference's OFA-heritage prediction head (``BinGraphModel``,
STEM-GNN/dataset/models/model.py:72-115 over gp lightning): a GNN over the
prompted graph, every *class node* scored by a binary MLP, BCE against
``bin_labels`` on ``bin_valid``; a sample's prediction is the argmax over
its own class nodes.

The batches are JAX's: prompted samples collated into padded disjoint
batches (nodes to a multiple of 1,024 with one dead slot, edges to a
multiple of 4,096), all built before the first step and copied to the
device as they are built; the same ``default_rng(seed)`` orders them.  No
hand-written kernel runs here, as no Pallas kernel runs in JAX's loop: the
sums are ``index_add_`` (``ops.segment``), the products cuBLAS.
"""

from __future__ import annotations

import copy
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.core.graph import (Graph, graph_to_device,
                                           host_to_device, round_up)
from stemgnn_tpu_torch.ofa.prompt import collate_prompted
from stemgnn_tpu_torch.train.optim import Optimizer
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.utils.metrics import _binary_auc
from stemgnn_tpu_torch.zoo.mlp import MLP
from stemgnn_tpu_torch.zoo.stack import GNNStack


class OFAModel(nn.Module):
    """``{"enc", "head"}`` as ``ofa_train_eval``'s JAX trees: the stack at
    one relation (JAX passes no edge types, ROADMAP known behaviours) and
    an MLP head without BatchNorm."""

    def __init__(self, kind: str, num_layers: int, dim: int, generator=None):
        super().__init__()
        self.enc = GNNStack(kind, num_layers, dim, generator=generator)
        self.head = MLP([dim, 2 * dim, 1], batch_norm=False,
                        generator=generator)

    def forward(self, g: Graph):
        z = self.enc(g.node_feat, g.edge_feat, g.senders, g.receivers,
                     edge_mask=g.edge_mask, node_mask=g.node_mask)
        return self.head(z)[:, 0]


def bce_loss(scores, valid, labels):
    """Mean BCE-with-logits over the ``valid`` rows (JAX's stable form)."""
    per = F.relu(scores) - scores * labels + torch.log1p(
        torch.exp(-scores.abs()))
    per = torch.where(valid, per, torch.zeros((), dtype=per.dtype,
                                              device=per.device))
    return per.sum() / torch.clamp(valid.sum(), min=1).to(per.dtype)


class Batch(NamedTuple):
    g: Graph                # on the device
    aux: dict               # collate_prompted's numpy arrays
    ys: np.ndarray
    n_real: int
    valid: torch.Tensor     # bin_valid, on the device
    labels: torch.Tensor    # bin_labels, on the device
    true_mask: torch.Tensor


def make_batches(dataset, idxs, batch_size: int, node_bucket: int = 1024,
                 edge_bucket: int = 4096, device="cpu", host_ms=None):
    """JAX ``_make_batches`` with each batch copied to ``device`` as it is
    built; ``host_ms`` (a list) gets each batch's host milliseconds
    (sampling, prompting, collating, queueing the copies)."""
    batches = []
    for i in range(0, len(idxs), batch_size):
        t0 = time.perf_counter()
        chunk = [dataset[int(j)] for j in idxs[i: i + batch_size]]
        tot_n = sum(len(s["node_feat"]) for s in chunk)
        tot_e = sum(len(s["senders"]) for s in chunk)
        g, aux = collate_prompted(
            chunk, node_pad_to=round_up(tot_n + 1, node_bucket),
            edge_pad_to=round_up(max(tot_e, 1), edge_bucket), device="cpu")
        g = graph_to_device(g, device)
        ys = np.asarray([s["y"] for s in chunk])
        batches.append(Batch(
            g, aux, ys, len(chunk),
            host_to_device(aux["bin_valid"], device),
            host_to_device(aux["bin_labels"], device),
            host_to_device(aux["true_nodes_mask"], device)))
        if host_ms is not None:
            host_ms.append((time.perf_counter() - t0) * 1e3)
    return batches


def ofa_train_eval(dataset, train_idx: Sequence[int],
                   eval_idx: Sequence[int], *, dim: int, kind: str = "gine",
                   num_layers: int = 2, epochs: int = 10, lr: float = 1e-3,
                   weight_decay: float = 0.0, batch_size: int = 16,
                   seed: int = 0, task: str = "single",
                   verbose: bool = False, device=None, model=None,
                   stats=None):
    """Train the class-node scoring model on prompted graphs; returns
    (final train loss, eval metric).

    ``task="single"``: prediction = per-sample argmax over class nodes,
    eval metric = accuracy.  ``task="multi"`` (chem multitask): every class
    node is an independent binary task, BCE restricted to ``bin_valid``
    (NaN labels excluded) and eval = the nan-tolerant mean per-task AUC.

    ``device`` None is the card (``core.device.resolve_device``).
    ``model``, an :class:`OFAModel`, replaces the seeded initial one and
    is trained in place (tests hand JAX's initial weights over).
    ``stats``, a dict, gets every step's loss, the host ms of each batch,
    the device ms of each step and evaluation batch and the walls."""
    dev = resolve_device(device)
    t_call = time.perf_counter()
    rng_np = np.random.default_rng(seed)
    if model is None:
        model = OFAModel(kind, num_layers, dim,
                         generator=torch.Generator().manual_seed(seed))
    model = model.to(dev)
    opt = Optimizer(model.parameters(), lr, weight_decay=weight_decay)
    host_ms, eval_host_ms = [], []
    rec = trace.Recorder(dev)
    losses = []

    train_batches = make_batches(dataset, np.asarray(train_idx), batch_size,
                                 device=dev, host_ms=host_ms)
    model.train()
    for epoch in range(epochs):
        order = rng_np.permutation(len(train_batches))
        for bi in order:
            b = train_batches[bi]
            with trace.span("sg:ofa.train_step", rec):
                opt.zero_grad()
                loss = bce_loss(model(b.g), b.valid, b.labels)
                loss.backward()
                opt.step()
            losses.append(loss.detach())
        if verbose:
            print(f"  ofa epoch {epoch}: loss={float(losses[-1]):.4f}")
    loss = float(losses[-1]) if losses else float("nan")

    model.eval()
    eval_batches = make_batches(dataset, np.asarray(eval_idx), batch_size,
                                device=dev, host_ms=eval_host_ms)
    outs = []
    with torch.no_grad():
        for b in eval_batches:
            with trace.span("sg:ofa.eval", rec):
                s = torch.where(b.true_mask, model(b.g),
                                torch.full((), -torch.inf, device=dev))
            outs.append(s.cpu().numpy())
    if task == "multi":
        metric = _multi_auc(eval_batches, outs)
    else:
        metric = _accuracy(eval_batches, outs)
    if stats is not None:
        stats.update(
            losses=[float(x) for x in losses], host_ms=host_ms,
            eval_host_ms=eval_host_ms,
            # device ms on the card, the host's clock on the CPU
            step_ms=rec.ms("sg:ofa.train_step", device=rec.cuda),
            eval_ms=rec.ms("sg:ofa.eval", device=rec.cuda),
            wall_s=time.perf_counter() - t_call,
            samples=len(train_idx) * epochs + len(eval_idx))
    return loss, metric


def _multi_auc(batches, outs):
    """The nan-tolerant mean per-task AUC: a sample's k-th class node is
    task k; invalid labels are skipped, one-class tasks left out."""
    per_task_scores, per_task_labels = {}, {}
    for b, s in zip(batches, outs):
        tm = b.aux["true_nodes_mask"]
        valid = b.aux.get("bin_valid", tm)
        gid_np = b.g.node_graph_id.cpu().numpy()
        for i in range(b.n_real):
            rows = np.nonzero((gid_np == i) & tm)[0]
            for k2, row in enumerate(rows):
                if not valid[row]:
                    continue
                per_task_scores.setdefault(k2, []).append(float(s[row]))
                per_task_labels.setdefault(k2, []).append(
                    float(b.aux["bin_labels"][row]))
    aucs = []
    for k2 in sorted(per_task_scores):
        y = np.asarray(per_task_labels[k2])
        if len(np.unique(y)) < 2:
            continue
        aucs.append(_binary_auc(y, np.asarray(per_task_scores[k2])))
    return float(np.mean(aucs)) if aucs else float("nan")


def _accuracy(batches, outs):
    """Per-sample argmax over its own class nodes against ``ys``."""
    correct = total = 0
    for b, s in zip(batches, outs):
        tm = b.aux["true_nodes_mask"]
        gid_np = b.g.node_graph_id.cpu().numpy()
        for i in range(b.n_real):
            rows = np.nonzero((gid_np == i) & tm)[0]
            if rows.size == 0:
                continue
            correct += int(int(np.argmax(s[rows])) == int(b.ys[i]))
            total += 1
    return correct / max(total, 1)


class _Concat:
    """Two datasets end to end."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __len__(self):
        return len(self.a) + len(self.b)

    def __getitem__(self, j):
        return self.a[j] if j < len(self.a) else self.b[j - len(self.a)]


def fewshot_train_eval(base_dataset, labels, class_split, *, dim: int,
                       fs_edge_feats=None, n_way: int = 3, k_shot: int = 2,
                       train_episodes: int = 64, eval_episodes: int = 32,
                       kind: str = "gine", num_layers: int = 2,
                       epochs: int = 5, lr: float = 1e-3,
                       batch_size: int = 8, seed: int = 0,
                       verbose: bool = False, device=None, model=None,
                       stats=None):
    """Few-shot episode training + evaluation (``FewShotDataset`` +
    ``ConstructFSTask``, ofa_datasets.py:457-549, task_constructor.py:
    231-271): episodes from the train-class pool, episode accuracy on
    episodes from each held-out class pool.  As in JAX, every held-out
    split trains a model of its own from the same seed over fresh train
    episodes (ROADMAP, known behaviours).

    ``base_dataset`` is any prompted NOI dataset; ``class_split`` maps
    {"train": [...], "valid"/"test": [...]} class ids.  ``model`` (an
    :class:`OFAModel`) is copied as each split's initial model; ``stats``
    gets each split's :func:`ofa_train_eval` stats under its name.
    Returns {"train_loss", "<split>_acc" per eval split}."""
    from stemgnn_tpu_torch.ofa.fewshot import FewShotDataset, SimpleFSManager
    from stemgnn_tpu_torch.ofa.tasks import fewshot_class_pools

    if fs_edge_feats is None:
        fs_edge_feats = np.stack([np.zeros(dim, np.float32),
                                  np.ones(dim, np.float32)])
    pools = fewshot_class_pools(labels, class_split)

    def make_episodes(split, size, seed_off):
        cls, data_ind = pools[split]
        fs = SimpleFSManager(cls, data_ind, k_shot=k_shot, q_query=1,
                             n_way=min(n_way, len(cls)),
                             seed=seed + seed_off)
        return FewShotDataset(fs, base_dataset, base_dataset,
                              fs_edge_feats=fs_edge_feats, sample_size=size,
                              seed=seed + seed_off)

    train_ds = make_episodes("train", train_episodes, 0)
    out = {}
    for i, split in enumerate(s for s in class_split if s != "train"):
        eval_ds = make_episodes(split, eval_episodes, 100 + i)
        cat = _Concat(train_ds, eval_ds)
        st = None if stats is None else stats.setdefault(split, {})
        loss, acc = ofa_train_eval(
            cat, np.arange(len(train_ds)),
            np.arange(len(train_ds), len(cat)), dim=dim, kind=kind,
            num_layers=num_layers, epochs=epochs, lr=lr,
            batch_size=batch_size, seed=seed, verbose=verbose,
            device=device, stats=st,
            model=None if model is None else copy.deepcopy(model))
        out["train_loss"] = loss
        out[f"{split}_acc"] = acc
    return out
