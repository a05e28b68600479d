"""Plain reference of ``stemgnn-finetune-arxiv-node``: STEM-GNN's
full-batch node finetune (model/ft_model.py, finetune.py) in plain PyTorch
from ``benchmark.plain``.

One epoch: the 2-layer SAGE encoder (no normalization, relu and inverted
dropout between the layers) in training mode, the frozen 4-head cosine VQ
(its codes passed straight through to the encoder), the per-head linear
decoder, the head-mean cross entropy over the train rows, and AdamW (lr,
weight decay 0.01) over the encoder and the decoder; then the evaluation:
the same forward without dropout, the class probabilities of the
head-mean logits.  The dropout's uniforms are drawn again from the
generator state the program's step started from.

``fault="half_batch"`` leaves every other train row out of the loss and
takes the mean over the rest.  ``fault="flip<k>"`` gives the first step's
``k`` train (row, head) pairs nearest to a code tie their second-best
code: what a rounding difference does to a near-tie; ``hubflip<k>`` does
so among the 64 nodes of the largest in-degree.
"""

from __future__ import annotations

import torch

from benchmark import plain


def _forward(p, conf, data, u, fault=None):
    enc, vq = conf["encoder"], conf["vq"]
    x = data["x"]
    n = x.shape[0]
    g = dict(senders=data["senders"], receivers=data["receivers"],
             t0=data["t0"], node_mask=data["node_mask"],
             edge_order=data.get("edge_order"))
    z = plain.encoder(p, "encoder.", x, g, data["edge_valid"],
                      data["inv_deg"], num_layers=enc["num_layers"],
                      batch_norm_on=enc["normalize"] != "none",
                      keep_u=None if u is None else [u],
                      dropout=enc["dropout"])
    flip, flip_rows = plain.flip_rows(fault, data, data["train_mask"])
    xh, q, scores = plain.quantize(p, z, heads=vq["heads"],
                                   code_dim=vq["codebook_dim"], flip=flip,
                                   rows=flip_rows)
    if u is not None:
        q = xh + (q - xh).detach()
    logits = plain.linear(p, "decoder", plain.from_heads(q)).reshape(
        n, vq["heads"], conf["num_classes"]).mean(1)
    return logits, scores


def _loss(logits, data, fault):
    rows = data["train_mask"]
    if fault == "half_batch":
        rows = rows & (torch.arange(rows.shape[0], device=rows.device) % 2
                       == 0)
    nll = -torch.log_softmax(logits, -1).gather(1, data["y"][:, None])[:, 0]
    rf = rows.float()
    return (nll * rf).sum() / rf.sum().clamp(min=1.0)


def run(conf: dict, data: dict, init: dict, steps: list, *, tf32=False,
        fault=None) -> dict:
    """The reference's ``len(steps)`` epochs from ``init`` (every leaf by
    the program's name; ``vq.*`` frozen): ``losses``, ``grads1`` (the first
    step's gradients of the trained leaves), ``params`` (the trained leaves
    after the last step), and the last epoch's evaluation: ``probs`` [N, C]
    and ``margin`` [N], each row's smallest gap between its best and second
    code score over the heads."""
    frozen = {k: v.detach() for k, v in init.items() if k.startswith("vq.")}
    trained = {k: v.detach().clone() for k, v in init.items()
               if not k.startswith("vq.")}
    opt = plain.AdamW(trained, conf["lr"], 0.01)
    data = dict(data, inv_deg=plain.inv_in_degree(
        data["receivers"], data["edge_valid"], data["x"].shape[0]))
    losses, grads1 = [], None
    shape = tuple(data["x"].shape)
    with plain.matmul_precision(tf32):
        for t, st in enumerate(steps):
            u, = plain.dropout_draws(st["rng_state"], shape, 1,
                                     data["x"].device)
            leaves = {k: v.requires_grad_(True) for k, v in trained.items()}
            logits, _ = _forward({**leaves, **frozen}, conf, data, u,
                                 fault if t == 0 else None)
            loss = _loss(logits, data, fault)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            grads = {k: (torch.zeros_like(v) if gr is None else gr)
                     for (k, v), gr in zip(leaves.items(), got)}
            if t == 0:
                grads1 = grads
            losses.append(float(loss.detach()))
            trained = opt.step({k: v.detach() for k, v in trained.items()},
                               grads)
            del leaves, logits, loss, got
        with torch.no_grad():
            logits, scores = _forward({**trained, **frozen}, conf, data,
                                      None)
            probs = torch.softmax(logits, -1)
            margin = plain.code_margin(scores)
    return dict(losses=losses, grads1=grads1, params=trained, probs=probs,
                margin=margin)
