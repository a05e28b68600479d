"""What the ranks of the edge-parallel tests' gloo worlds run (spawned
processes: this module imports torch and the port, never JAX).  Each
function takes the rank's ``Ranks`` and numpy inputs from the test and
returns numpy outputs, which the test holds against the JAX package."""

import numpy as np
import torch

from stemgnn_tpu_torch.parallel import edge_partition as pep
from stemgnn_tpu_torch.parallel import full_graph as pfg
from stemgnn_tpu_torch.parallel.halo import mean_across
from stemgnn_tpu_torch.utils.convert import task_model_from_jax


def aggregate_checks(ranks, inp):
    """``sharded_sage_aggregate`` over this rank's shard of ``h = x @ w``
    for each ``(reduce, with edge_feat)`` case: the value, and the
    gradients of ``sum(out * cot)`` in ``x`` and ``w`` averaged across the
    ranks (the step's mean)."""
    shards = pep.partition_edges_by_destination(
        inp["s"], inp["r"], ranks.world, edge_feat=inp["ef"])
    me = ranks.rank
    s, r, m, ef = (torch.from_numpy(shards[k][me]) for k in (
        "senders", "receivers", "edge_mask", "edge_feat"))
    out = {}
    for reduce, with_ef in inp["cases"]:
        x = torch.tensor(inp["x"], requires_grad=True)
        w = torch.tensor(inp["w"], requires_grad=True)
        agg = pep.sharded_sage_aggregate(
            x @ w, s.long(), r.long(), m, ef if with_ef else None,
            ranks=ranks, reduce=reduce)
        (agg * torch.from_numpy(inp["cot"])).sum().backward()
        own = (x.grad.clone(), w.grad.clone())
        mean_across([x.grad, w.grad], ranks)
        out[(reduce, with_ef)] = dict(
            value=agg.detach().numpy(), gx=x.grad.numpy(),
            gw=w.grad.numpy(), own_gx=own[0].numpy(), own_gw=own[1].numpy())
    return out


def run_checks(ranks, inp):
    """``run_finetune_edge_parallel`` on this rank from JAX's initial task
    model (``inp["init"]``), with JAX's k-means initial means handed to
    rank 0's init where ``inp`` has them: the history, the k-means record
    and the parameters' digest."""
    cfg = inp["cfg"]
    kw = {}
    if "init" in inp:
        kw["model"] = task_model_from_jax(*inp["init"], cfg)
    if "means" in inp:
        real = pfg.maybe_kmeans_init_vq
        pfg.maybe_kmeans_init_vq = lambda m, c, g, **k: real(
            m, c, g, means=torch.from_numpy(inp["means"].copy()))
    rec = pfg.run_finetune_edge_parallel(inp["ds"], cfg, ranks, **kw)
    return {"history": rec["history"], "kmeans": rec["kmeans"],
            "digest": rec["digest"], "best": rec["logger"].get_best(),
            "world": rec["world"], "backend": rec["backend"]}
