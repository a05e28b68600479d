"""Full-batch graph construction with the fused-aggregation layout
(counterpart of ``stemgnn_tpu/train/graph_setup.py``).

With the sage backbone, a full-batch graph on CUDA carries an
``EdgeLayout`` plus the small per-edge-type feature table, so the encoder
runs the hub-dense matmuls and the tail kernels and never materializes
per-edge [E_pad, D] features.  On the CPU the plain padded graph with
materialized edge features is returned unless the caller asks for the
layout (``use_layout=True``; the kernel wrappers then run their plain
versions).  Only the sage layers read edge features: for the gcn, gin and
gat backbones the plain graph carries none (JAX materializes them, [E, D],
7.3 GB at arxiv scale, and never reads them), unless the caller asks for
them (``edge_feat=True``: the pretrain step's topo-sem targets).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import round_up
from stemgnn_tpu_torch.ops.chip_profile import ChipProfile
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout, gwin_gate
from stemgnn_tpu_torch.ops.reorder import (community_order, degree_order,
                                           rcm_order, relabel)


def _layout_applies(cfg: FinetuneConfig, device) -> bool:
    return (torch.device(device).type == "cuda" and cfg.use_fused_layout
            and cfg.encoder.backbone == "sage")


def reorder_dataset(ds, method: str = "rcm", task: str = "node"):
    """Relabel the dataset's nodes for gather locality (JAX
    ``reorder_dataset``; ``ops/reorder.py``'s RCM, community or degree
    order).  A pure permutation: ``x`` (text-row ids), edge endpoints, node
    labels and node split masks permute together, so every metric is
    unchanged.  Link-task labels and splits are per edge and keep their
    slots.  ``extras["node_perm"]`` records the permutation (new -> old);
    cached host structures (underscore extras) are dropped."""
    ei = np.asarray(ds.edge_index)
    orders = dict(rcm=rcm_order, community=community_order,
                  degree=degree_order)
    if method not in orders:
        raise ValueError(f"unknown reorder method {method!r}")
    perm = orders[method](ei[0], ei[1], ds.num_nodes)
    s2, r2, (x2,) = relabel(perm, ei[0], ei[1], node_arrays=(ds.x,))
    kw = dict(x=x2, edge_index=np.stack([s2, r2]),
              extras={k: v for k, v in ds.extras.items()
                      if not k.startswith("_")})
    kw["extras"]["node_perm"] = perm
    if task == "node":
        if ds.labels is not None and len(ds.labels) == ds.num_nodes:
            kw["labels"] = np.asarray(ds.labels)[perm]
        if ds.splits is not None:
            kw["splits"] = [{k: np.asarray(v)[perm] for k, v in sp.items()}
                            for sp in ds.splits]
    return dataclasses.replace(ds, **kw)


def maybe_reorder_dataset(ds, cfg: FinetuneConfig, task: str, device="cuda",
                          profile: Optional[ChipProfile] = None):
    """The locality relabel of JAX ``maybe_reorder_dataset``: a forced
    method (``rcm``, ``community``, ``degree``) relabels; ``auto`` relabels
    only where that changes the executed path.

    One difference is kept on purpose: ``auto`` checks the in-kernel gather
    gate on the ORIGINAL graph first.  Under a profile that gathers rows in
    the kernel (the H100) it is open on every graph, so ``auto`` leaves the
    graph as it is.  Where it is closed (the ``V5E`` profile) the
    candidates are probed as JAX probes them: ``community``, then ``rcm``,
    each kept when its layout (``loc_split="auto"``) opens a direction's
    windows or builds a local/stray split."""
    mode = cfg.reorder
    if mode == "off" or not _layout_applies(cfg, device) \
            or task not in ("node", "link"):
        return ds
    if mode in ("rcm", "community", "degree"):
        return reorder_dataset(ds, mode, task)
    if mode != "auto":
        raise ValueError(f"unknown reorder mode {mode!r}")
    d = int(ds.node_text_feat.shape[1])
    n_pad = round_up(ds.num_nodes, 128)
    use_r, use_s = gwin_gate(
        np.asarray(ds.edge_index[0], np.int32),
        np.asarray(ds.edge_index[1], np.int32), n_pad, feat_dim_hint=d,
        profile=profile)
    if use_r or use_s:
        print(f"[reorder] auto: the in-kernel gather is open on {ds.name} "
              f"as it is; no relabel", flush=True)
        return ds
    for method in ("community", "rcm"):
        cand = reorder_dataset(ds, method, task)
        probe = build_edge_layout(
            np.asarray(cand.edge_index[0], np.int32),
            np.asarray(cand.edge_index[1], np.int32), n_pad,
            feat_dim_hint=d, loc_split="auto", profile=profile)
        if (probe.use_gwin_r or probe.use_gwin_s
                or probe.split_r is not None or probe.split_s is not None):
            why = ("whole-direction windows"
                   if probe.use_gwin_r or probe.use_gwin_s
                   else "local/stray split")
            print(f"[reorder] {method} relabel enables {why} on {ds.name}",
                  flush=True)
            return cand
    return ds


def fused_full_graph(ds, cfg: FinetuneConfig, device="cuda",
                     use_layout: Optional[bool] = None,
                     profile: Optional[ChipProfile] = None,
                     gwin: str = "auto", edge_feat: Optional[bool] = None):
    """Padded full graph for ``ds`` on ``device``.  ``use_layout`` None
    means: on CUDA, when ``cfg.use_fused_layout`` and the backbone is
    sage.  ``profile`` fixes the gates' device profile; ``gwin`` the
    in-kernel gather gate (``build_edge_layout``).  ``edge_feat``: whether
    a graph without a layout materializes the edge features (None: for
    the sage backbone, the only one that reads them)."""
    device = torch.device(device)
    if use_layout is None:
        use_layout = _layout_applies(cfg, device)
    if not use_layout:
        if edge_feat is None:
            edge_feat = cfg.encoder.backbone == "sage"
        return ds.to_graph(device=device, with_edge_feat=edge_feat)
    graph = ds.to_graph(node_pad_to=round_up(ds.num_nodes, 128),
                        with_edge_feat=False, device=device)
    # build from the HOST arrays, padded as make_graph pads them
    e, e_pad = ds.num_edges, graph.num_edges_padded
    s = np.zeros(e_pad, np.int32)
    r = np.zeros(e_pad, np.int32)
    s[:e] = np.asarray(ds.edge_index[0], np.int32)
    r[:e] = np.asarray(ds.edge_index[1], np.int32)
    xe = None
    if ds.xe is not None:
        xe = np.zeros(e_pad, np.int32)
        xe[:e] = np.asarray(ds.xe, np.int32)[:e]
    table = ds.edge_text_feat
    t_rows = 1 if table is None else int(table.shape[0])
    # typed virtual hubs cover T <= 32 (ops.edge_layout HubDense.hub_xe);
    # the scatter-side block needs per-source messages (T <= 1)
    hub_size = cfg.hub_size if t_rows <= 32 else 0
    lay = build_edge_layout(s, r, graph.num_nodes_padded, xe_ids=xe,
                            edge_mask=np.arange(e_pad) < e, hub_size=hub_size,
                            sc_hub_size=(cfg.sc_hub_size
                                         if hub_size and t_rows <= 1 else 0),
                            num_edge_types=t_rows,
                            feat_dim_hint=int(ds.node_text_feat.shape[1]),
                            loc_split="off" if cfg.reorder == "off"
                            else "auto",
                            gwin=gwin, profile=profile, device=device)
    return dataclasses.replace(
        graph, layout=lay,
        edge_table=None if table is None
        else torch.from_numpy(np.asarray(table)).to(device))


def _route(lay, order: str) -> str:
    use = lay.use_gwin_r if order == "r" else lay.use_gwin_s
    return "gathered_scatter_rows_sorted" if use else "scatter_rows_sorted"


def _split_note(lay) -> str:
    """The local/stray splits the aggregation runs: a direction's own, or
    its hub tail's."""
    parts = []
    for order in ("r", "s"):
        hub = getattr(lay, "hub_" + order)
        sub = lay if hub is None else hub.tail
        where = "" if hub is None else "hub tail "
        sp = getattr(sub, "split_" + order)
        if sp is not None:
            parts.append(f"{where}{order} local {sp.loc_frac:.4f}"
                         + (" (merged)" if sp.m_keys is not None else ""))
    return "" if not parts else "; local/stray split: " + ", ".join(parts)


def describe_layout(lay, num_edge_types: int = 1) -> str:
    """One line on the layout's hub decomposition, tail size and the kernel
    each direction's tail runs through; on a typed graph
    (``num_edge_types > 1``) also whether typed hubs were chosen and the
    backward's kernel."""
    hub = lay.hub_r
    if num_edge_types > 1:
        fwd = ("no typed hubs" if hub is None else
               f"typed hubs {hub.hub_size} (node, type) pairs (coverage "
               f"{hub.coverage:.4f}), tail {hub.tail.num_edges_padded} "
               f"padded edges")
        tail = lay if hub is None else hub.tail
        return (f"layout: T={num_edge_types} edge types, {fwd}; forward "
                f"through {_route(tail, 'r')}, backward over "
                f"{lay.num_edges_padded} padded edges through "
                f"masked_scatter_rows_sorted")
    if hub is None:
        return (f"layout: no hub block, {lay.num_edges_padded} padded edges "
                f"through {_route(lay, 'r')} (forward) and "
                f"{_route(lay, 's')} (backward){_split_note(lay)}")
    back = ("" if lay.hub_s is None else
            f"; backward tail {lay.hub_s.tail.num_edges_padded} padded edges "
            f"through {_route(lay.hub_s.tail, 's')}")
    return (f"layout: hub_r size {hub.hub_size} (coverage "
            f"{hub.coverage:.4f}), sc size {hub.sc_size} (coverage "
            f"{hub.sc_coverage:.4f}), tail {hub.tail.num_edges_padded} "
            f"padded edges through {_route(hub.tail, 'r')}{back}"
            f"{_split_note(lay)}")
