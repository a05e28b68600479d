"""Full-batch node finetune (counterpart of the node branch of
``stemgnn_tpu/train/finetune_loop.py`` with ``batch_size=0``: ``_split_params``
:39, ``_make_node_steps`` :100, ``_run_node_like`` :486).

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
PyTorch dispatches eagerly.  Minibatch training, link and graph tasks, MoE
and the layer-wise chunked eval are not ported yet.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.models.task import (activation_loss,
                                           decoder_jacobian_penalty, encode,
                                           task_logits, task_model_init)
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


def _make_node_steps(cfg: FinetuneConfig):
    """``(loss_fn, train_step, eval_step)`` for the full-batch node task.
    ``plain`` runs the aggregation kernels' plain versions."""

    def loss_fn(model, train_mask, graph, y, generator=None, plain=False):
        """Training-mode forward: (loss, {name: loss part})."""
        model.train()
        z = encode(model, graph, generator=generator, plain=plain)
        logits, _ = task_logits(model, cfg, z, mask=graph.node_mask)
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
        opt.step()
        return {k: v.detach() for k, v in parts.items()}

    def eval_step(model, graph, plain=False):
        """Class probabilities [N_pad, C] from the head-mean logits."""
        model.eval()
        with torch.no_grad():
            z = encode(model, graph, plain=plain)
            logits, _ = task_logits(model, cfg, z, mask=graph.node_mask)
            return torch.softmax(logits.mean(1), dim=-1)

    return loss_fn, train_step, eval_step


def run_finetune(ds, cfg: FinetuneConfig, pretrained=None, device="cuda",
                 verbose: bool = False):
    """Finetune ``cfg.repeat`` splits of the node dataset ``ds``.
    ``pretrained`` is None or ``{"encoder": Encoder, "vq": VectorQuantize}``
    (copied per split).  Returns the Logger and what the last split used:
    ``model``, ``graph``, ``y``, ``train_mask``, ``steps``, and per epoch
    its loss parts (``epoch_losses``) and host seconds (``epoch_s``, each
    ending in a device sync)."""
    if cfg.task != "node" or cfg.batch_size != 0:
        raise NotImplementedError("the port finetunes the node task full "
                                  "batch (batch_size 0) so far")
    if cfg.eval_chunked or any(cfg.encoder.moe_layer_flags()):
        raise NotImplementedError("chunked eval and MoE layers are not "
                                  "ported yet")
    device = torch.device(device)
    ds = maybe_reorder_dataset(ds, cfg, "node", device)
    graph = fused_full_graph(ds, cfg, device=device)
    if verbose and graph.layout is not None:
        print(describe_layout(graph.layout), flush=True)
    n, n_pad = ds.num_nodes, graph.num_nodes_padded
    y_np = np.zeros(n_pad, np.int64)
    y_np[:n] = np.asarray(ds.labels)[:n]
    y = torch.from_numpy(y_np).to(device)

    splits = ds.splits
    if len(splits) == 1 and cfg.repeat > 1:
        splits = splits * cfg.repeat
    splits = splits[:cfg.repeat]

    logger = Logger()
    steps = _make_node_steps(cfg)
    _, train_step, eval_step = steps
    out = {}
    for idx, split in enumerate(splits):
        model = task_model_init(
            cfg, None if pretrained is None
            else copy.deepcopy(pretrained["encoder"]),
            None if pretrained is None else copy.deepcopy(pretrained["vq"]),
            generator=torch.Generator().manual_seed(idx))
        if cfg.use_vq and not bool(model.vq.initted):
            raise NotImplementedError(
                "the VQ codebook is not initialized (initted is False): its "
                "k-means init is not ported yet; finetune from a pretrain "
                "checkpoint whose VQ state is initted")
        model.to(device)
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
