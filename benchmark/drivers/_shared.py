"""What the two full-graph drivers share: the traffic's graph handed to the
program as its dataset and padded device graph, the reference's copy of
the same inputs, the seeded weights written into the program's modules,
and the snapshots the comparison reads."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import common, graphgen


def program_graph(traffic: dict, seed: int, feat_dim: int, device,
                  build_graph):
    """``(ds, graph, host)``: the traffic's graph as the program's
    ``TAGDataset`` and padded device graph (``build_graph(ds)``, with its
    layout), the node features and the edge-text row made on the card and
    put in the graph; ``host`` keeps the structure for the reference and
    the host seconds of the two stages (``stages``)."""
    from stemgnn_tpu_torch.data.dataset import TAGDataset

    params = traffic["graph"]
    t0 = time.perf_counter()
    s = graphgen.structure(params, seed)
    t_structure = time.perf_counter() - t0
    n, e = int(params["num_nodes"]), s["senders"].shape[0]
    feats, edge_row = graphgen.device_features(params, s["labels"], feat_dim,
                                               seed, device)
    # the program's make_graph copies host features; a zero-stride view
    # stands in for them, and the card's features replace the copy
    ds = TAGDataset(
        name="arxiv_like",
        node_text_feat=np.broadcast_to(np.zeros((1, feat_dim), np.float32),
                                       (n, feat_dim)),
        edge_text_feat=np.zeros((1, feat_dim), np.float32),
        x=np.arange(n), xe=np.zeros(e, np.int64),
        edge_index=np.stack([s["senders"], s["receivers"]]),
        labels=s["labels"],
        splits=[{"train": s["train"], "valid": s["valid"],
                 "test": s["test"]}],
        num_classes=int(params["num_classes"]))
    t0 = time.perf_counter()
    ds, graph = build_graph(ds)
    t_graph = time.perf_counter() - t0
    node_feat = torch.zeros(graph.num_nodes_padded, feat_dim,
                            device=device)
    node_feat[:n] = feats[torch.as_tensor(ds.x, device=device)]
    graph = dataclasses.replace(graph, node_feat=node_feat,
                                edge_table=edge_row)
    host = dict(senders=np.asarray(ds.edge_index[0]),
                receivers=np.asarray(ds.edge_index[1]),
                labels=np.asarray(ds.labels), n=n,
                splits=ds.splits[0], x=node_feat, t0=edge_row,
                stages={"structure_s": t_structure, "program_graph_s": t_graph})
    return ds, graph, host


def reference_data(host: dict, graph, device) -> dict:
    """The reference's inputs: the padded edge list, its validity, the node
    mask, the features and the edge-text row, as the benchmark made them."""
    e, e_pad = host["senders"].shape[0], graph.num_edges_padded
    n, n_pad = host["n"], graph.num_nodes_padded

    def pad(a, width):
        out = np.zeros(width, np.int64)
        out[:a.shape[0]] = a
        return torch.from_numpy(out).to(device)
    y = pad(host["labels"], n_pad)
    train = torch.zeros(n_pad, dtype=torch.bool, device=device)
    train[:n] = torch.from_numpy(np.asarray(host["splits"]["train"])).to(
        device)
    return dict(senders=pad(host["senders"], e_pad),
                receivers=pad(host["receivers"], e_pad),
                edge_valid=torch.arange(e_pad, device=device) < e,
                node_mask=torch.arange(n_pad, device=device) < n,
                x=host["x"], t0=host["t0"],
                y=y, train_mask=train)


@torch.no_grad()
def write_weights(named_params: dict, seed: int, device):
    """Seeded values (``common.seeded_weights``) copied into the program's
    parameters."""
    vals = common.seeded_weights(named_params, seed, device)
    for k, p in named_params.items():
        p.copy_(vals[k])


def snapshot(named: dict) -> dict:
    return {k: v.detach().clone() for k, v in named.items()}


def adam_first_grads(opt, named: dict) -> dict:
    """The gradient each leaf gave AdamW at its first step, read back from
    its first moment (``(1 - b1) * g`` after one step)."""
    out = {}
    for k, p in named.items():
        st = opt.state.get(p)
        b1 = opt.param_groups[0]["betas"][0]
        out[k] = (torch.zeros_like(p) if not st
                  else st["exp_avg"].detach().clone() / (1.0 - b1))
    return out


def training_readings(init: dict, prog: dict, ref_out: dict,
                      moved: list) -> dict:
    """The training numbers (``compare``'s module docstring) of ``prog``
    against ``ref_out``: ``loss_gap``, and ``grad_gap`` and ``change_gap``
    over the worst leaf, which ``_leaves`` names."""
    from benchmark import compare
    grads = {k: prog["grads1"][k] for k in ref_out["grads1"]}
    grad, grad_leaf = compare.norm_gap(grads, ref_out["grads1"])
    dp = {k: prog["params"][k] - init[k] for k in moved}
    dr = {k: ref_out["params"][k] - init[k] for k in moved}
    change, change_leaf = compare.norm_gap(dp, dr)
    return dict(loss_gap=compare.loss_gap(prog["losses"], ref_out["losses"]),
                grad_gap=grad, change_gap=change,
                _leaves=dict(grad=grad_leaf, change=change_leaf,
                             moved=len(moved), total=len(ref_out["params"])))


def aggregation_call(graph, cfg_encoder, seed: int, drop_p=None):
    """Layer 1's aggregation through the public front end the SAGE layers
    call (``ops.spmm.sage_aggregate``), forward and backward, on the cell's
    layout, with the pair-hash dropout at ``drop_p`` where given: the call
    the aggregation's roofline times."""
    from stemgnn_tpu_torch.ops.spmm import sage_aggregate
    x = graph.node_feat.detach().clone().requires_grad_(True)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    up = torch.randn(x.shape, device=x.device, generator=gen)
    drop = None if drop_p is None else (
        torch.tensor(seed % (2 ** 31 - 1), device=x.device), drop_p)

    def run():
        out = sage_aggregate(x, graph.senders, graph.receivers,
                             edge_mask=graph.edge_mask, num_nodes=x.shape[0],
                             layout=graph.layout, edge_table=graph.edge_table,
                             bf16_messages=cfg_encoder.fused_bf16_messages,
                             drop_hash=drop)
        out.backward(up)
    return run
