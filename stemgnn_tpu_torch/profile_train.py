"""Where the time of one full-batch finetune training step goes on the card.

    python -m stemgnn_tpu_torch.profile_train [--dataset arxiv_synthetic_pl]
    python -m stemgnn_tpu_torch.profile_train --task link
    python -m stemgnn_tpu_torch.profile_train --backbone gat
    python -m stemgnn_tpu_torch.profile_train --moe_layers last

Builds the dataset and its layout, a task model with random weights from
``--seed`` (the frozen VQ, a per-head decoder over the dataset's classes),
and runs the training step of ``python -m stemgnn_tpu_torch.finetune``
(``train.finetune_loop``).  ``--task link`` profiles the typed-edge link
finetune instead: ``kg_synthetic`` (11 relation types) at WN18RR's size,
40,943 entities and 93,003 triples, whose rows are the edges.
``--backbone gcn|gin|gat`` and ``--moe_layers last|all`` (3 experts,
``lamda_env`` 0.1) profile the other encoders, whose aggregations are
gathers and ``index_add_`` (no layout for gcn, gin and gat).  Prints the
step's device time and its stages (forward with the loss, backward,
update), from the spans the step itself records (``utils.trace``), the
evaluation's,
the kernel launches of one step, the step's device time by kernel from
``torch.profiler``, the device's busy share of the profiled window, and the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stemgnn_tpu_torch.core.config import (EncoderConfig, FinetuneConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.models.task import task_model_init
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.profile_encode import card_line, kernel_table
from stemgnn_tpu_torch.train.finetune_loop import (_make_node_steps,
                                                   _split_params,
                                                   make_optimizer)
from stemgnn_tpu_torch.train.graph_setup import (describe_layout,
                                                 fused_full_graph)
from stemgnn_tpu_torch.utils import trace

# the spans that partition the step (train.finetune_loop._make_node_steps)
STAGES = ("sg:finetune.forward", "sg:train.backward", "sg:train.update")
# WN18RR's entity and triple counts (the generator keeps its 11 relations)
WN18RR_ENTITIES, WN18RR_TRIPLES = 40_943, 93_003


def main(argv=None):
    p = argparse.ArgumentParser("profile_train")
    p.add_argument("--dataset", default="arxiv_synthetic_pl",
                   help="the node task's dataset")
    p.add_argument("--task", choices=("node", "link"), default="node")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--backbone", default="sage",
                   choices=("sage", "gcn", "gin", "gat"))
    p.add_argument("--moe_layers", default="none",
                   choices=("none", "last", "all"))
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=20)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    if args.task == "link":
        ds = load_dataset("kg_synthetic", feat_dim=args.feat_dim,
                          seed=args.seed, num_entities=WN18RR_ENTITIES,
                          num_edges=WN18RR_TRIPLES)
    else:
        ds = load_dataset(args.dataset, feat_dim=args.feat_dim,
                          seed=args.seed)
    t_data = time.perf_counter() - t0
    d = args.feat_dim
    moe = args.moe_layers != "none"
    cfg = FinetuneConfig(
        encoder=EncoderConfig(input_dim=d, hidden_dim=d,
                              backbone=args.backbone, moe=moe,
                              moe_layers=args.moe_layers),
        vq=VQConfig(dim=d, codebook_dim=d, commitment_weight=0.25),
        dataset=ds.name, task=args.task, num_classes=ds.num_classes,
        lr=1e-3, lamda_env=0.1 if moe else 0.0)
    t0 = time.perf_counter()
    g = fused_full_graph(ds, cfg, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    t_rows = 1 if g.edge_table is None else int(g.edge_table.shape[0])
    lay = ("no layout" if g.layout is None
           else describe_layout(g.layout, t_rows))
    print(f"host: dataset {t_data:.2f} s, graph + layout {t_graph:.2f} s; "
          f"{lay}; encoder {args.backbone}, MoE layers {args.moe_layers}",
          flush=True)

    model = task_model_init(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(dev)
    trainable, _ = _split_params(model, cfg)
    opt = make_optimizer(trainable, cfg)
    _, train_step, eval_step = _make_node_steps(cfg, args.task)
    # the task's rows: the nodes, or the edges of a link task
    n, n_pad = ((ds.num_nodes, g.num_nodes_padded) if args.task == "node"
                else (ds.num_edges, g.num_edges_padded))
    y = torch.zeros(n_pad, dtype=torch.long)
    y[:n] = torch.from_numpy(np.asarray(ds.labels)[:n])
    mask = torch.zeros(n_pad, dtype=torch.bool)
    mask[:n] = torch.from_numpy(np.asarray(ds.splits[0]["train"])[:n])
    y, mask = y.to(dev), mask.to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def step():
        train_step(model, opt, mask, g, y, gen)

    for _ in range(2):
        step()
    for k in sc.launch_counts:
        sc.launch_counts[k] = 0
    step()
    print(f"kernel launches of one training step: {sc.launch_counts}")

    # the step's own spans
    trace.take()
    with trace.enabled():
        for _ in range(args.reps):
            step()
        for _ in range(args.reps):
            eval_step(model, g)
    spans = trace.take()

    def ms(name):
        return (spans.get(name, {}).get("device_ms") or 0.0) / args.reps
    print(f"training step: {ms('sg:finetune.train_step'):.3f} ms (its "
          f"spans, mean of {args.reps}): " + ", ".join(
              f"{s} {ms(s):.3f} ms" for s in STAGES)
          + f"; evaluation {ms('sg:finetune.eval'):.3f} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, args.reps, wall_ms, args.top, "step", ranges=())
    torch.cuda.reset_peak_memory_stats()
    step()
    print(f"peak device memory of a step "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
