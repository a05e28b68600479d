"""Generic fit / test loop template (counterpart of
``stemgnn_tpu/train/trainer.py``; the reference's lightning scaffolding,
STEM-GNN/dataset/gp/lightning/training.py:11-159, module_template.py,
metric.py ``EvalKit``).

The loop owns the epochs, the evaluation cadence, the best-epoch record,
early stopping and logging; the caller supplies the step functions.  Pure
Python over the port's ``utils.early_stop.EarlyStopping`` and
``utils.logger.Logger``: what a step runs on is the caller's affair.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from stemgnn_tpu_torch.utils.early_stop import EarlyStopping
from stemgnn_tpu_torch.utils.logger import Logger


@dataclasses.dataclass
class EvalKit:
    """Named metric functions and the one that selects the best epoch
    (gp/lightning/metric.py:90): ``metrics`` maps a name to ``fn(preds,
    targets) -> float``; ``select`` names the selecting metric; ``mode``
    is ``"max"`` or ``"min"``."""
    metrics: Dict[str, Callable]
    select: str
    mode: str = "max"

    def evaluate(self, preds, targets) -> Dict[str, float]:
        return {k: float(fn(preds, targets))
                for k, fn in self.metrics.items()}


def fit(train_epoch_fn: Callable[[Any, int], Any],
        eval_fn: Callable[[Any], Dict[str, float]],
        state: Any, *, epochs: int, evalkit: EvalKit,
        patience: Optional[int] = None, eval_every: int = 1,
        on_best: Optional[Callable[[Any, int], None]] = None,
        logger: Optional[Logger] = None, run_idx: int = 0,
        verbose: bool = False):
    """Train ``epochs`` epochs: ``train_epoch_fn(state, epoch) -> (state,
    loss_dict)``, and every ``eval_every``-th epoch (0, k, 2k, ...)
    ``eval_fn(state) -> {"train", "val", "test"}``, logged (the result's
    ``metric`` defaults to ``evalkit.select``); the best validation under
    ``evalkit.mode`` is recorded (``on_best(state, epoch)`` called at each
    new best) and, with ``patience``, early stopping ends the loop.
    Returns ``(state, best, logger)``, ``best`` = ``{"val", "epoch",
    "result"}``."""
    logger = logger or Logger()
    stopper = EarlyStopping(patience=patience) if patience else None
    best = {"val": -np.inf if evalkit.mode == "max" else np.inf,
            "epoch": -1, "result": None}
    sign = 1.0 if evalkit.mode == "max" else -1.0
    for epoch in range(epochs):
        state, loss = train_epoch_fn(state, epoch)
        if epoch % eval_every:
            continue
        result = eval_fn(state)
        result.setdefault("metric", evalkit.select)
        logger.log(run_idx, epoch, loss, dict(result))
        if sign * result["val"] > sign * best["val"]:
            best.update(val=result["val"], epoch=epoch, result=result)
            if on_best is not None:
                on_best(state, epoch)
        if stopper is not None and stopper(result):
            if verbose:
                print(f"early stop at epoch {epoch}")
            break
    return state, best, logger


def test(eval_fn: Callable[[Any], Dict[str, float]], state: Any,
         evalkit: EvalKit) -> Dict[str, float]:
    """One evaluation pass (``lightning_test``)."""
    return eval_fn(state)
