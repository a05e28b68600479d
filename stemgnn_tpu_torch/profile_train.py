"""Where the time of one full-batch finetune training step goes on the card.

    python -m stemgnn_tpu_torch.profile_train [--dataset arxiv_synthetic_pl]
    python -m stemgnn_tpu_torch.profile_train --task link

Builds the dataset and its layout, a task model with random weights from
``--seed`` (the frozen VQ, a per-head decoder over the dataset's classes),
and runs the training step of ``python -m stemgnn_tpu_torch.finetune``
(``train.finetune_loop``).  ``--task link`` profiles the typed-edge link
finetune instead: ``kg_synthetic`` (11 relation types) at WN18RR's size,
40,943 entities and 93,003 triples, whose rows are the edges.  Prints the step's time and its stages (forward
with the loss, backward, optimizer) by CUDA events, the evaluation's time,
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

STAGES = ("forward+loss", "backward", "optimizer")
# WN18RR's entity and triple counts (the generator keeps its 11 relations)
WN18RR_ENTITIES, WN18RR_TRIPLES = 40_943, 93_003


def main(argv=None):
    p = argparse.ArgumentParser("profile_train")
    p.add_argument("--dataset", default="arxiv_synthetic_pl",
                   help="the node task's dataset")
    p.add_argument("--task", choices=("node", "link"), default="node")
    p.add_argument("--feat_dim", type=int, default=768)
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
    cfg = FinetuneConfig(
        encoder=EncoderConfig(input_dim=d, hidden_dim=d),
        vq=VQConfig(dim=d, codebook_dim=d, commitment_weight=0.25),
        dataset=ds.name, task=args.task, num_classes=ds.num_classes,
        lr=1e-3)
    t0 = time.perf_counter()
    g = fused_full_graph(ds, cfg, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    t_rows = 1 if g.edge_table is None else int(g.edge_table.shape[0])
    print(f"host: dataset {t_data:.2f} s, graph + layout {t_graph:.2f} s; "
          f"{describe_layout(g.layout, t_rows)}", flush=True)

    model = task_model_init(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(dev)
    trainable, _ = _split_params(model, cfg)
    opt = make_optimizer(trainable, cfg)
    loss_fn, train_step, eval_step = _make_node_steps(cfg, args.task)
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

    # stage times: CUDA events between the stages of each step
    stage_ms = np.zeros(len(STAGES))
    for _ in range(args.reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _ = loss_fn(model, mask, g, y, gen)
        ev[1].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        stage_ms += [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    stage_ms /= args.reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.reps):
        eval_step(model, g)
    stop.record()
    torch.cuda.synchronize()
    eval_ms = start.elapsed_time(stop) / args.reps
    print(f"training step: {stage_ms.sum():.3f} ms (CUDA events, mean of "
          f"{args.reps}): " + ", ".join(
              f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stage_ms))
          + f"; evaluation {eval_ms:.3f} ms", flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernel_table(prof, args.reps, wall_ms, args.top, "step", ranges=())
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB")
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
