"""Per-run curve logger with best-val snapshot selection (counterpart of
``stemgnn_tpu/utils/logger.py``, STEM-GNN/utils/logger.py:8-82): tracks
train/val/test per epoch per run, selects the best epoch by the validation
metric, and reports mean and std across runs."""

from __future__ import annotations

import numpy as np

metric2order = {"loss": "min", "acc": "max", "f1": "max", "precision": "max",
                "recall": "max", "auc": "max", "ap": "max", "mcc": "max",
                "hit": "max", "ndcg": "max", "map": "max", "mrr": "max"}


class Logger:
    def __init__(self):
        self.data = {}
        self.best = {}

    def check_result(self, result):
        if "metric" not in result:
            raise ValueError("Result must contain metric key")
        if result["metric"] not in metric2order:
            raise ValueError("Metric not supported")
        if result.get("train") is None:
            result["train"] = 0
        if result.get("val") is None:
            result["val"] = 0
        return result

    def log(self, run, epoch, loss, result):
        result = self.check_result(result)
        tr, va, te = result["train"], result["val"], result["test"]
        rec = self.data.setdefault(run, {"train": [], "val": [], "test": []})
        rec["loss_train"] = loss
        rec["train"].append(tr)
        rec["val"].append(va)
        rec["test"].append(te)
        rec["epoch"] = epoch

        best = self.best.setdefault(run, {"train": None, "val": None,
                                          "test": None})
        better = (best["val"] is None or
                  (va >= best["val"] if metric2order[result["metric"]] == "max"
                   else va <= best["val"]))
        if better:
            best.update(train=tr, val=va, test=te, epoch=epoch)

    def get_single_best(self, run_idx):
        return self.best[run_idx]

    def get_best(self):
        def agg(k):
            vals = [self.best[r][k] for r in self.best]
            return {"mean": float(np.mean(vals)), "std": float(np.std(vals))}
        return {"train": agg("train"), "val": agg("val"), "test": agg("test")}
