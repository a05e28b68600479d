"""Full-batch node and link finetune (counterpart of the node/link branch
of ``stemgnn_tpu/train/finetune_loop.py`` with ``batch_size=0``:
``_split_params`` :39, ``_make_node_steps`` :100, ``_run_node_like`` :486).

A link task (task/link.py:19-48 of the reference) classifies edges: its
rows are the midpoint edge embeddings ``(z[senders] + z[receivers]) / 2``
of the graph's edges, with ``graph.edge_mask`` as the row mask, per-edge
labels and per-edge split masks; a node task's rows are the nodes.

Per split: a fresh task model from copies of the pretrained encoder and VQ
plus a new decoder (finetune.py:196-205), AdamW (lr, weight decay 0.01, eps
1e-8: ``optax.adamw``'s defaults, which decay every trainable leaf), early
stopping on the validation accuracy, best-epoch selection by the Logger.
The frozen VQ stays out of the optimizer (finetune.py:179-181).  The loss is
the head-mean cross entropy over the train rows (the decoder runs over all
padded rows and the loss is mask-weighted, as in JAX), plus the decoder
Jacobian penalty.

Each epoch is one train step and one evaluation, logged and checked for
early stopping before the next.  JAX's ``epoch_chunk`` scan (K epochs per
dispatch, with up to K-1 updates past an early stop) has no counterpart:
PyTorch dispatches eagerly.  A codebook that is not initted (a finetune
without a pretrain checkpoint) is k-means-initialized first, over the full
graph's eval-mode encoding.  Minibatch training, graph tasks, MoE and the
layer-wise chunked eval (with JAX's graph-free k-means route) are not
ported yet.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.models.task import (activation_loss,
                                           decoder_jacobian_penalty, encode,
                                           maybe_kmeans_init_vq, task_logits,
                                           task_model_init)
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph,
                                                 maybe_reorder_dataset)
from stemgnn_tpu_torch.utils.early_stop import EarlyStopping
from stemgnn_tpu_torch.utils.logger import Logger
from stemgnn_tpu_torch.utils.metrics import evaluate, task2metric

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
        logits, _ = task_logits(model, cfg, z, mask=row_mask)
        act = activation_loss(logits, y, mask=train_mask)
        jac = decoder_jacobian_penalty(model, cfg)
        # the MoE environment regularizer is 0 without MoE layers
        env = torch.zeros((), device=act.device)
        loss = act + jac + cfg.lamda_env * env
        return loss, {"loss": loss, "act_loss": act, "jac_loss": jac,
                      "env_loss": env}

    def train_step(model, opt, train_mask, graph, y, generator=None,
                   plain=False):
        _, parts = loss_fn(model, train_mask, graph, y, generator, plain)
        opt.zero_grad(set_to_none=True)
        parts["loss"].backward()
        # optax decays a leaf the loss does not reach (the BatchNorm
        # parameters under normalize "none") with its zero gradient;
        # torch's AdamW would skip a parameter without one
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        return {k: v.detach() for k, v in parts.items()}

    def eval_step(model, graph, plain=False):
        """Class probabilities [rows, C] from the head-mean logits."""
        model.eval()
        with torch.no_grad():
            z, row_mask = rows(model, graph, plain=plain)
            logits, _ = task_logits(model, cfg, z, mask=row_mask)
            return torch.softmax(logits.mean(1), dim=-1)

    return loss_fn, train_step, eval_step


def run_finetune(ds, cfg: FinetuneConfig, pretrained=None, device="cuda",
                 verbose: bool = False):
    """Finetune ``cfg.repeat`` splits of the node or link dataset ``ds``
    (``cfg.task``).  ``pretrained`` is None or ``{"encoder": Encoder, "vq":
    VectorQuantize}`` (copied per split).  Returns the Logger and what the
    last split used: ``model``, ``graph``, ``y``, ``train_mask``, ``steps``,
    and per epoch its loss parts (``epoch_losses``) and host seconds
    (``epoch_s``, each ending in a device sync)."""
    task = cfg.task
    if task not in ("node", "link") or cfg.batch_size != 0:
        raise NotImplementedError("the port finetunes node and link tasks "
                                  "full batch (batch_size 0) so far")
    if cfg.eval_chunked or any(cfg.encoder.moe_layer_flags()):
        raise NotImplementedError("chunked eval and MoE layers are not "
                                  "ported yet")
    device = torch.device(device)
    ds = maybe_reorder_dataset(ds, cfg, task, device)
    graph = fused_full_graph(ds, cfg, device=device)
    if verbose and graph.layout is not None:
        t_rows = (1 if graph.edge_table is None
                  else int(graph.edge_table.shape[0]))
        print(describe_layout(graph.layout, t_rows), flush=True)
    # a link task's rows are the edges: labels and split masks per edge
    n, n_pad = ((ds.num_nodes, graph.num_nodes_padded) if task == "node"
                else (ds.num_edges, graph.num_edges_padded))
    y_np = np.zeros(n_pad, np.int64)
    y_np[:n] = np.asarray(ds.labels)[:n]
    y = torch.from_numpy(y_np).to(device)

    splits = ds.splits
    if len(splits) == 1 and cfg.repeat > 1:
        splits = splits * cfg.repeat
    splits = splits[:cfg.repeat]

    logger = Logger()
    steps = _make_node_steps(cfg, task)
    _, train_step, eval_step = steps
    out = {}
    for idx, split in enumerate(splits):
        model = task_model_init(
            cfg, None if pretrained is None
            else copy.deepcopy(pretrained["encoder"]),
            None if pretrained is None else copy.deepcopy(pretrained["vq"]),
            generator=torch.Generator().manual_seed(idx))
        model.to(device)
        if cfg.use_vq and not bool(model.vq.initted):
            # JAX finetune_loop.py:584-586: k-means over the full graph's
            # eval-mode encoding
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            bins = maybe_kmeans_init_vq(
                model, cfg, graph,
                generator=torch.Generator(device=device).manual_seed(idx))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if verbose:
                used = (bins > 0).sum(1).tolist()
                print(f"[split {idx}] k-means init of the codebook: "
                      f"{(time.perf_counter() - t0) * 1e3:.1f} ms, codes "
                      f"used per head {used} of {bins.shape[1]}",
                      flush=True)
        trainable, _ = _split_params(model, cfg)
        opt = make_optimizer(trainable, cfg)
        stopper = EarlyStopping(patience=cfg.early_stop)
        gen = torch.Generator(device=device).manual_seed(idx)
        masks = {}
        for k in ("train", "valid", "test"):
            m = np.zeros(n_pad, bool)
            m[:n] = np.asarray(split[k])[:n]
            masks[k] = m
        train_mask = torch.from_numpy(masks["train"]).to(device)
        epoch_s, epoch_losses = [], []
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            losses = train_step(model, opt, train_mask, graph, y, gen)
            pred = eval_step(model, graph).cpu().numpy()
            loss = {k: float(v) for k, v in losses.items()}
            epoch_s.append(time.perf_counter() - t0)
            epoch_losses.append(loss)
            result = {"train": evaluate(pred, y_np, masks["train"], cfg.task),
                      "val": evaluate(pred, y_np, masks["valid"], cfg.task),
                      "test": evaluate(pred, y_np, masks["test"], cfg.task),
                      "metric": task2metric[cfg.task]}
            logger.log(idx, epoch, loss, result)
            if verbose:
                print(f"[split {idx}] epoch {epoch}: loss {loss['loss']:.4f}"
                      f" | train {result['train']:.2f} val "
                      f"{result['val']:.2f} test {result['test']:.2f} | "
                      f"{epoch_s[-1]:.3f} s", flush=True)
            if stopper(result):
                if verbose:
                    print(f"[split {idx}] early stop at epoch {epoch}")
                break
        if verbose:
            b = logger.get_single_best(idx)
            print(f"[split {idx}] best val={b['val']:.2f} "
                  f"test={b['test']:.2f}", flush=True)
        out = dict(model=model, graph=graph, y=y, train_mask=train_mask,
                   steps=steps, epoch_s=epoch_s, epoch_losses=epoch_losses)
    return dict(logger=logger, **out)
