"""Evaluation metrics (counterpart of ``stemgnn_tpu/utils/metrics.py``,
STEM-GNN/utils/eval.py): node/link accuracy x100.  The graph tasks' AUC
comes with the graph-task slice."""

from __future__ import annotations

import numpy as np

task2metric = {"node": "acc", "link": "acc", "graph": "auc"}


def eval_acc(pred, y, mask=None):
    """pred [N, C] probabilities/logits, y [N] int labels."""
    pred = np.asarray(pred)
    y = np.asarray(y)
    if mask is not None:
        mask = np.asarray(mask).astype(bool)
        pred, y = pred[mask], y[mask]
    if len(y) == 0:
        return float("nan")
    return float((pred.argmax(-1) == y).mean())


def evaluate(pred, y, mask=None, task: str = "node"):
    metric = task2metric[task]
    if metric == "acc":
        return eval_acc(pred, y, mask) * 100
    raise NotImplementedError(f"metric {metric} is not ported yet")
