"""Multi-dataset merging for pretraining (counterpart of
``stemgnn_tpu/data/merge.py``; the reference's ``get_pt_data``,
STEM-GNN/dataset/process_datasets.py:147-183): offsets the node-text and
edge-type id spaces of each dataset, concatenates the edge lists with node
offsets, and records ``ptr`` (the per-dataset node offsets) for the
weighted seed resampling."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def merge_datasets(datasets: Sequence) -> dict:
    """``TAGDataset``s -> the merged pretrain payload: ``node_text_feat``,
    ``edge_text_feat``, ``x``, ``xe``, ``edge_index`` [2, E], ``ptr`` and
    ``names``."""
    x_start, xe_start, n_start = 0, 0, 0
    xs, xes, eis, ptr = [], [], [], [0]
    nfs, efs = [], []
    for ds in datasets:
        xs.append(np.asarray(ds.x) + x_start)
        xes.append(np.asarray(ds.xe) + xe_start)
        eis.append(np.asarray(ds.edge_index) + n_start)
        nfs.append(np.asarray(ds.node_text_feat))
        efs.append(np.asarray(ds.edge_text_feat))
        x_start += ds.node_text_feat.shape[0]
        xe_start += ds.edge_text_feat.shape[0]
        n_start += ds.num_nodes
        ptr.append(n_start)
    return {
        "node_text_feat": np.concatenate(nfs, axis=0),
        "edge_text_feat": np.concatenate(efs, axis=0),
        "x": np.concatenate(xs),
        "xe": np.concatenate(xes),
        "edge_index": np.concatenate(eis, axis=1),
        "ptr": np.asarray(ptr),
        "names": [ds.name for ds in datasets],
    }
