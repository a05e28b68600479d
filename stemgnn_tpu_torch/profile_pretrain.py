"""Where the time of one full-graph pretrain step goes on the card.

    python -m stemgnn_tpu_torch.profile_pretrain [--dataset arxiv_synthetic_pl]

The counterpart of ``scripts/pretrain_step_probe.py``'s ``full_step`` with
the pair-hash dropout: builds the dataset and its layout, a
:class:`~stemgnn_tpu_torch.models.pretrain.PretrainModel` with random
weights from ``--seed`` (2-layer SAGE at D = 768 with batch norm and
dropout 0.15, the 4-head cosine VQ with 128 learnable codes, the four
decoders) and its EMA teacher, and runs ``train.pretrain_loop``'s step at
``bs`` = the padded node count.  Prints:

  * host stage times and the layout;
  * the kernel launches of one step;
  * the step's device ms (mean of ``--reps``) in each span the step
    itself records (``utils.trace``): the student (the draws, the
    augmented view and the student encoder), the VQ, the losses, the
    teacher, the backward, and the update (AdamW with the clip, the EMA
    codebook and the teacher's EMA update);
  * the step's device time by kernel (``torch.profiler``), the device's
    busy share, and the shares of kernel 1, kernel 2 (and their second
    pass), the GEMMs, the other (elementwise, reduction, copy) kernels, and
    the dropout's masks (the ``sg:agg.masks.*`` spans, whose kernels the
    other rows also count);
  * the masked hub blocks of both directions by CUDA events as the step
    forms them (the blocks' nonzero pairs hashed) and in the dense form
    the JAX package uses (the whole (node, hub) grid hashed);
  * peak device memory of a step and the card's name and power limit.

    python -m stemgnn_tpu_torch.profile_pretrain --mixed_precision

does the same for the step under ``pretrain.py --mixed_precision`` (bf16
encoder and VQ pipeline, bf16 teacher pass and loss decoders: kernels 1
and 2 with bf16 outputs).

    python -m stemgnn_tpu_torch.profile_pretrain --minibatch

runs ``run_pretrain`` itself instead (batches of 1,024 seeds, fanout 10,
as ``configs/pretrain.yaml``), on both routes (``auto``: gather +
``index_add_``; ``on``: the batch's own layout through kernels 1 and 2):
after a warm-up run, one epoch cut at ``--steps`` steps gives, from the
loop's own history, the host ms a batch of the sampler, of the layout build
and of the transfer, the wall ms a step, the device ms a step (CUDA events
recorded in the loop) and the device's idle share, plus the kernel launches
a step and peak device memory; one batch gives the step's split by stage
(its spans); and two runs under ``torch.profiler`` that differ by
``--reps`` steps give the device ms a step by kernel group.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from stemgnn_tpu_torch.core.config import (EncoderConfig, PretrainConfig,
                                           VQConfig)
from stemgnn_tpu_torch.core.device import resolve_device
from stemgnn_tpu_torch.data.merge import merge_datasets
from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.data.sampler import (CSCGraph, NeighborBatchIterator,
                                            get_train_node_idx)
from stemgnn_tpu_torch.models.pretrain import PretrainModel, make_teacher
from stemgnn_tpu_torch.ops import scatter as sc
from stemgnn_tpu_torch.ops.fused_sage import (hub_partials,
                                              masked_hub_blocks,
                                              masked_hub_blocks_dense,
                                              tail_messages)
from stemgnn_tpu_torch.profile_encode import (_device_us, _on_device,
                                              card_line, kernel_table)
from stemgnn_tpu_torch.train.graph_setup import describe_layout
from stemgnn_tpu_torch.utils import trace
from stemgnn_tpu_torch.train.pretrain_loop import (batch_graph,
                                                   make_pretrain_optimizer,
                                                   make_pretrain_step,
                                                   pretrain_graph,
                                                   run_pretrain, table_dtype)

# the spans that partition the step (train.pretrain_loop.make_pretrain_step)
STAGES = ("sg:pretrain.student", "sg:vq", "sg:pretrain.losses",
          "sg:pretrain.teacher", "sg:train.backward", "sg:train.update")
# the minibatch mode: the reference's batches (configs/pretrain.yaml)
MB_BATCH, MB_FANOUT = 1024, 10
# the spans of ops.fused_sage.DropView's masks
DROP_RANGES = ("sg:agg.masks.hub", "sg:agg.masks.keep",
               "sg:agg.masks.kept_deg")
# device kernels by name, in the order they are matched
GROUPS = (("kernel 1", ("scatter_rows_kernel",)),
          ("kernel 2", ("gathered_rows_kernel",)),
          ("second pass (kernels 1-2)", ("split_rows_kernel",)),
          ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "Gemm")),
          ("other (elementwise, reductions, copies)", ("",)))


def pretrain_config(d: int, mixed_precision: bool = False) -> PretrainConfig:
    """The step probe's configuration at width ``d``; with
    ``mixed_precision`` what ``pretrain.py --mixed_precision`` sets (the
    encoder and the VQ's per-head pipeline in bf16, ``teacher_bf16``,
    ``loss_bf16``), as the probe's mp variants do
    (scripts/pretrain_step_probe.py:183-229)."""
    dt = "bfloat16" if mixed_precision else "float32"
    return PretrainConfig(
        encoder=EncoderConfig(input_dim=d, hidden_dim=d, num_layers=2,
                              normalize="batch", dropout=0.15,
                              compute_dtype=dt),
        vq=VQConfig(dim=d, codebook_size=128, codebook_dim=d, heads=4,
                    compute_dtype=dt),
        batch_size=0, teacher_bf16=mixed_precision,
        loss_bf16=mixed_precision)


def dropout_tail_cases(graph, view, src, t0):
    """Kernel 1's launches on the pretrain step's dropout tails, as
    ``ops.fused_sage`` makes them under ``drop_hash``: layer 1's forward
    hub tail (the masked features in bf16 gathered with t0, times the tail
    keep; the masked hub blocks' sums as init, 1/kept degree as scale) and
    the backward hub tail (gp = g / kept degree in bf16 gathered by
    receiver, times the keep; the masked blocks' sums of gp as init, the
    relu gate), on seeded random upstream gradients.  Returns
    ``{direction: (arguments of the kernel and its plain version, keywords
    of both, the kernel's row plan keyword)}``."""
    lay = graph.layout
    dev = src.device
    ft, bt = lay.hub_r.tail, lay.hub_s.tail
    n_pad = lay.num_nodes_padded
    gen = torch.Generator(device=dev).manual_seed(3)
    gp = (torch.randn(src.shape, device=dev, generator=gen)
          * view.inv_deg()).to(torch.bfloat16)
    fwd_epi = dict(num_nodes_padded=n_pad, relu=True,
                   init=hub_partials(src, lay.hub_r, t0,
                                     blocks=view.hub(lay.hub_r)[:2]),
                   scale=view.inv_deg(), out_dtype=torch.float32)
    bwd_epi = dict(num_nodes_padded=n_pad, relu=False,
                   init=hub_partials(gp, lay.hub_s, None, relu=False,
                                     blocks=view.hub(lay.hub_s)[:2]),
                   gate=src + t0, out_dtype=torch.float32)
    keep_r = view.keep(ft, "r").to(torch.bfloat16)[:, None]
    keep_s = view.keep(bt, "s").to(torch.bfloat16)[:, None]
    return {"drop_fwd": (dict(m=tail_messages(src, ft, t0) * keep_r,
                              local_row=ft.lrow_r, block_ptr=ft.block_ptr_r),
                         fwd_epi, dict(plan=ft.plan_r)),
            "drop_bwd": (dict(m=tail_messages(gp, bt, None, "s") * keep_s,
                              local_row=bt.lrow_s, block_ptr=bt.block_ptr_s),
                         bwd_epi, dict(plan=bt.plan_s))}


def cuda_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def group_shares(prof, reps: int):
    """Device ms per step of each kernel group and of the dropout's mask
    ranges, and the busy ms they share."""
    per = {name: 0.0 for name, _ in GROUPS}
    ranges = {}
    for e in prof.key_averages():
        if not _on_device(e):
            continue
        us = _device_us(e) / reps
        if e.key in DROP_RANGES:
            ranges[e.key] = ranges.get(e.key, 0.0) + us / 1e3
        if e.key.startswith("sg:"):         # the program's spans
            continue
        for name, needles in GROUPS:
            if any(n in e.key for n in needles):
                per[name] += us / 1e3
                break
    return per, ranges


def stage_ms(cfg, model, teacher, opt, g, gen, bs: int, reps: int):
    """The device ms of each of :data:`STAGES`, mean of ``reps`` steps of
    ``train.pretrain_loop.make_pretrain_step`` (the spans it records under
    ``utils.trace.enabled``)."""
    step = make_pretrain_step(cfg, bs, generator=gen)
    trace.take()
    with trace.enabled():
        for _ in range(reps):
            step(model, teacher, opt, g)
    spans = trace.take()
    return np.array([spans.get(s, {}).get("device_ms") or 0.0
                     for s in STAGES]) / reps


def print_groups(per: dict, ranges: dict, busy: float):
    if busy <= 0:
        print("the profiler saw no device time: the shares are not "
              "measured")
        return
    print("device time per step by group:")
    for name, ms in per.items():
        print(f"  {name}: {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)")
    for name, ms in sorted(ranges.items()):
        print(f"  range {name}: {ms:.3f} ms ({100 * ms / busy:.1f}% of "
              f"busy; its kernels are counted above too)")


def minibatch_main(args, dev):
    """``run_pretrain``'s minibatch loop on both routes (module
    docstring)."""
    t0 = time.perf_counter()
    ds = load_dataset(args.dataset, feat_dim=args.feat_dim, seed=args.seed)
    merged = merge_datasets([ds])
    print(f"host: dataset {time.perf_counter() - t0:.2f} s; "
          f"{ds.num_nodes} nodes, {ds.num_edges} edges", flush=True)
    for route in ("auto", "on"):
        cfg = dataclasses.replace(pretrain_config(args.feat_dim,
                                                  args.mixed_precision),
                                  batch_size=MB_BATCH, fanout=MB_FANOUT,
                                  fused_minibatch=route, seed=args.seed)

        def run(steps):
            return run_pretrain(merged, cfg, weights=[1.0], device=dev,
                                max_steps=steps, verbose=False)

        run(3)          # the kernels built, cuBLAS and the allocator warm
        for k in sc.launch_counts:
            sc.launch_counts[k] = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, teacher, hist = run(args.steps)
        run_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v / args.steps for k, v in sc.launch_counts.items()}
        h = hist[0]
        print(f"[{route}] run_pretrain, one epoch cut at {args.steps} steps "
              f"({run_s:.2f} s with its set-up): host ms a batch: sampler "
              f"{h['host/sample_ms']:.3f}, layout build "
              f"{h.get('host/layout_ms', 0.0):.3f}, transfer + gather "
              f"{h['host/transfer_ms']:.3f}; wall "
              f"{1e3 * h['epoch_s'] / args.steps:.3f} ms a step; device "
              f"{h['device_ms']:.3f} ms a step (CUDA events in the loop); "
              f"idle share {h['idle']:.4f}", flush=True)
        print(f"[{route}] kernel launches a step: {per_step}; peak device "
              f"memory {peak_gb:.2f} GB (the k-means seed's batch "
              f"included)", flush=True)

        # the stage split, on one batch of the loop's kind
        rng = np.random.default_rng(args.seed + 1)
        it = NeighborBatchIterator(
            CSCGraph.from_edge_index(merged["edge_index"], ds.num_nodes),
            merged["x"], merged["xe"],
            get_train_node_idx(merged["ptr"], [1.0], rng), cfg.batch_size,
            [cfg.fanout] * cfg.encoder.num_layers, rng, drop_last=True)
        ig = next(iter(it))[0]
        node_table = torch.from_numpy(
            merged["node_text_feat"]).float().to(dev).to(table_dtype(cfg))
        edge_table = torch.from_numpy(
            merged["edge_text_feat"]).float().to(dev).to(table_dtype(cfg))
        g = batch_graph(ig, node_table, edge_table, dev, route == "on")
        opt = make_pretrain_optimizer(model, cfg)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        stages = stage_ms(cfg, model, teacher, opt, g, gen, cfg.batch_size,
                          args.reps)
        print(f"[{route}] one batch of {ig.n_node} nodes / {ig.n_edge} "
              f"edges (padded {ig.num_nodes_padded} / "
              f"{ig.num_edges_padded}): step {stages.sum():.3f} ms (its "
              f"spans, mean of {args.reps}): " + ", ".join(
                  f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stages)),
              flush=True)
        del model, teacher, opt, g, node_table, edge_table
        torch.cuda.empty_cache()

        # the kernel groups a step: two runs under the profiler that differ
        # by --reps steps, so the set-up before the loop cancels out
        per = []
        for steps in (2, 2 + args.reps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                h = run(steps)[2][0]
            per.append(group_shares(prof, args.reps))
        groups = {k: per[1][0][k] - per[0][0][k] for k in per[0][0]}
        ranges = {k: per[1][1].get(k, 0.0) - per[0][1].get(k, 0.0)
                  for k in per[1][1]}
        busy = sum(groups.values())
        print(f"[{route}] under the profiler ({2 + args.reps} steps): wall "
              f"{1e3 * h['epoch_s'] / (2 + args.reps):.3f} ms a step, "
              f"device {h['device_ms']:.3f} ms a step (CUDA events), idle "
              f"share {h['idle']:.4f}; kernels {busy:.3f} ms a step",
              flush=True)
        print_groups(groups, ranges, busy)
    print(card_line(), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser("profile_pretrain")
    p.add_argument("--dataset", default="arxiv_synthetic_pl")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--minibatch", action="store_true",
                   help="profile run_pretrain's minibatch loop instead")
    p.add_argument("--mixed_precision", "--mp", action="store_true",
                   help="the step under pretrain.py --mixed_precision")
    p.add_argument("--steps", type=int, default=20,
                   help="--minibatch: the steps of the timed epoch")
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.minibatch:
        minibatch_main(args, dev)
        return

    t0 = time.perf_counter()
    ds = load_dataset(args.dataset, feat_dim=args.feat_dim, seed=args.seed)
    t_data = time.perf_counter() - t0
    cfg = pretrain_config(args.feat_dim, args.mixed_precision)
    print(f"step: {'mixed precision (bf16 encoder, VQ pipeline, teacher '
                   'and loss decoders)' if args.mixed_precision else 'f32'}",
          flush=True)
    t0 = time.perf_counter()
    g = pretrain_graph(ds, cfg, device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    print(f"host: dataset {t_data:.2f} s, graph + layout {t_graph:.2f} s; "
          f"{g.num_nodes_padded} padded nodes, {ds.num_edges} edges; "
          f"{describe_layout(g.layout)}", flush=True)

    model = PretrainModel(
        cfg, generator=torch.Generator().manual_seed(args.seed)).to(dev)
    teacher = make_teacher(model)
    opt = make_pretrain_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bs = g.num_nodes_padded
    step = make_pretrain_step(cfg, bs, generator=gen)

    for _ in range(2):
        step(model, teacher, opt, g)
    for k in sc.launch_counts:
        sc.launch_counts[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    losses = step(model, teacher, opt, g)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"kernel launches of one step: {sc.launch_counts}")
    print("losses: " + ", ".join(f"{k} {float(v):.5f}"
                                 for k, v in losses.items()))

    stages = stage_ms(cfg, model, teacher, opt, g, gen, bs, args.reps)
    print(f"pretrain step: {stages.sum():.3f} ms (its spans, mean of "
          f"{args.reps}): " + ", ".join(
              f"{s} {ms:.3f} ms" for s, ms in zip(STAGES, stages)),
          flush=True)

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step(model, teacher, opt, g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = kernel_table(prof, args.reps, wall_ms, args.top, "step",
                          ranges=DROP_RANGES)
    busy = sum(_device_us(e) for e in events if _on_device(e)
               and not e.key.startswith("sg:")) / 1e3 / args.reps
    print_groups(*group_shares(prof, args.reps), busy)

    seed = torch.tensor(12345, device=dev)
    for tag, hub in (("hub_r", g.layout.hub_r), ("hub_s", g.layout.hub_s)):
        if hub is None:
            continue
        nz = hub.cnt_nz[0].numel() + (0 if hub.sc_nz is None
                                      else hub.sc_nz[0].numel())
        sparse = cuda_ms(lambda: masked_hub_blocks(hub, seed, cfg.edge_p),
                         args.reps)
        dense = cuda_ms(
            lambda: masked_hub_blocks_dense(hub, seed, cfg.edge_p), 2)
        grid = hub.cnt.numel() + (0 if hub.sc_cnt is None
                                  else hub.sc_cnt.numel())
        print(f"masked {tag} blocks: {sparse:.3f} ms hashing the {nz} "
              f"nonzero pairs (the step's form); {dense:.3f} ms hashing "
              f"the whole {grid} grid (the JAX package's form)", flush=True)
    print(f"peak device memory of a step {peak_gb:.2f} GB ({held_gb:.2f} GB "
          f"held before it: graph, layout, model, teacher, AdamW state)")
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
