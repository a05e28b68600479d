"""Full-batch graph construction with the fused-aggregation layout
(counterpart of ``fused_full_graph`` in ``stemgnn_tpu/train/graph_setup.py``).

With the sage backbone, a full-batch graph on CUDA carries an
``EdgeLayout`` plus the small per-edge-type feature table, so the encoder
runs the hub-dense matmuls and the ``scatter_rows_sorted`` kernel and never
materializes per-edge [E_pad, D] features.  On the CPU the plain padded
graph with materialized edge features is returned unless the caller asks
for the layout (``use_layout=True``; the kernel wrapper then runs its plain
version).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from stemgnn_tpu_torch.core.config import FinetuneConfig
from stemgnn_tpu_torch.core.graph import round_up
from stemgnn_tpu_torch.ops.chip_profile import ChipProfile
from stemgnn_tpu_torch.ops.edge_layout import build_edge_layout


def fused_full_graph(ds, cfg: FinetuneConfig, device="cuda",
                     use_layout: Optional[bool] = None,
                     profile: Optional[ChipProfile] = None):
    """Padded full graph for ``ds`` on ``device``.  ``use_layout`` None
    means: on CUDA, when ``cfg.use_fused_layout`` and the backbone is
    sage.  ``profile`` fixes the hub gate's device profile."""
    device = torch.device(device)
    if use_layout is None:
        use_layout = (device.type == "cuda" and cfg.use_fused_layout
                      and cfg.encoder.backbone == "sage")
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
    hub_size = cfg.hub_size if t_rows <= 1 else 0
    lay = build_edge_layout(s, r, graph.num_nodes_padded, xe_ids=xe,
                            edge_mask=np.arange(e_pad) < e, hub_size=hub_size,
                            sc_hub_size=cfg.sc_hub_size if hub_size else 0,
                            num_edge_types=t_rows,
                            feat_dim_hint=int(ds.node_text_feat.shape[1]),
                            profile=profile, device=device)
    return dataclasses.replace(
        graph, layout=lay,
        edge_table=None if table is None
        else torch.from_numpy(np.asarray(table)).to(device))


def describe_layout(lay) -> str:
    """One line on the layout's hub decomposition and tail size."""
    hub = lay.hub_r
    if hub is None:
        return (f"layout: no hub block, {lay.num_edges_padded} padded edges "
                f"through scatter_rows_sorted")
    return (f"layout: hub_r size {hub.hub_size} (coverage "
            f"{hub.coverage:.4f}), sc size {hub.sc_size} (coverage "
            f"{hub.sc_coverage:.4f}), tail {hub.tail.num_edges_padded} "
            f"padded edges through scatter_rows_sorted")
