"""Full-batch graph construction with the fused-aggregation layout
(counterpart of ``stemgnn_tpu/train/graph_setup.py``).

With the sage backbone, a full-batch graph on CUDA carries an
``EdgeLayout`` plus the small per-edge-type feature table, so the encoder
runs the hub-dense matmuls and the tail kernels and never materializes
per-edge [E_pad, D] features.  On the CPU the plain padded graph with
materialized edge features is returned unless the caller asks for the
layout (``use_layout=True``; the kernel wrappers then run their plain
versions).
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


def _layout_applies(cfg: FinetuneConfig, device) -> bool:
    return (torch.device(device).type == "cuda" and cfg.use_fused_layout
            and cfg.encoder.backbone == "sage")


def maybe_reorder_dataset(ds, cfg: FinetuneConfig, task: str, device="cuda",
                          profile: Optional[ChipProfile] = None):
    """The locality relabel of JAX ``maybe_reorder_dataset``, which relabels
    only "when it will actually change the executed path".

    The port checks the in-kernel gather gate on the ORIGINAL graph first.
    On the H100 it is open already (the GPU kernel gathers rows at any
    address), so ``auto`` leaves the graph as it is; JAX instead probes the
    relabelled candidates.  Relabelling itself (``ops/reorder.py``) is not
    ported: a forced method (``rcm``, ``community``, ``degree``) raises, and
    ``auto`` with a closed gate leaves the graph as it is and says so."""
    mode = cfg.reorder
    if mode == "off" or not _layout_applies(cfg, device) \
            or task not in ("node", "link"):
        return ds
    if mode in ("rcm", "community", "degree"):
        raise NotImplementedError(f"--reorder {mode}: node relabelling "
                                  f"(ops/reorder.py) is not ported yet")
    if mode != "auto":
        raise ValueError(f"unknown reorder mode {mode!r}")
    use_r, use_s = gwin_gate(
        np.asarray(ds.edge_index[0], np.int32),
        np.asarray(ds.edge_index[1], np.int32), round_up(ds.num_nodes, 128),
        feat_dim_hint=int(ds.node_text_feat.shape[1]), profile=profile)
    if use_r or use_s:
        print(f"[reorder] auto: the in-kernel gather is open on {ds.name} "
              f"as it is; no relabel", flush=True)
    else:
        print(f"[reorder] auto: the in-kernel gather is closed on {ds.name}; "
              f"relabelling is not ported, graph left as it is", flush=True)
    return ds


def fused_full_graph(ds, cfg: FinetuneConfig, device="cuda",
                     use_layout: Optional[bool] = None,
                     profile: Optional[ChipProfile] = None,
                     gwin: str = "auto"):
    """Padded full graph for ``ds`` on ``device``.  ``use_layout`` None
    means: on CUDA, when ``cfg.use_fused_layout`` and the backbone is
    sage.  ``profile`` fixes the gates' device profile; ``gwin`` the
    in-kernel gather gate (``build_edge_layout``)."""
    device = torch.device(device)
    if use_layout is None:
        use_layout = _layout_applies(cfg, device)
    if not use_layout:
        return ds.to_graph(device=device)
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
                            gwin=gwin, profile=profile, device=device)
    return dataclasses.replace(
        graph, layout=lay,
        edge_table=None if table is None
        else torch.from_numpy(np.asarray(table)).to(device))


def _route(lay, order: str) -> str:
    use = lay.use_gwin_r if order == "r" else lay.use_gwin_s
    return "gathered_scatter_rows_sorted" if use else "scatter_rows_sorted"


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
                f"{_route(lay, 's')} (backward)")
    back = ("" if lay.hub_s is None else
            f"; backward tail {lay.hub_s.tail.num_edges_padded} padded edges "
            f"through {_route(lay.hub_s.tail, 's')}")
    return (f"layout: hub_r size {hub.hub_size} (coverage "
            f"{hub.coverage:.4f}), sc size {hub.sc_size} (coverage "
            f"{hub.sc_coverage:.4f}), tail {hub.tail.num_edges_padded} "
            f"padded edges through {_route(hub.tail, 'r')}{back}")
