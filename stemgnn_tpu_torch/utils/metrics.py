"""Evaluation metrics (counterpart of ``stemgnn_tpu/utils/metrics.py``,
STEM-GNN/utils/eval.py): node/link accuracy x100, graph mean per-task AUC
x100 (nan-task tolerant) on the host, and its twin on the device.

Accuracy is scored in one native pass over the rows a mask keeps
(``csrc/metrics.cpp``, built at first use by ``utils.native_build``): no
copy of the masked rows, no per-row call.  Its argmax has numpy's exact
semantics (the first maximum wins on ties, a row holding a NaN takes its
first NaN), so :func:`eval_acc` returns the same float either way.  The
native path engages on what the inputs show, nothing else: a 2-D
C-contiguous float32 ``pred`` with at least one column, 1-D integer
labels of its length (cast to int64 once), and a 1-D bool mask of that
length or None.  Any other input (float64, a strided view, an int mask)
takes the numpy code; so does every input, after one line on standard
error, when the library cannot be built or loaded.
``score_counts`` counts :func:`eval_acc` calls by path."""

from __future__ import annotations

import collections
import ctypes
import os
import sys
import threading

import numpy as np
import torch

from stemgnn_tpu_torch.utils import native_build, trace

task2metric = {"node": "acc", "link": "acc", "graph": "auc"}

SOURCE = os.path.join(native_build.CSRC, "metrics.cpp")

# eval_acc calls by path; each call adds one to its path's count (a
# Counter, so ``score_counts.update(numpy=1)`` adds one), so a caller can
# show which path a run took.  Reset by setting every count to 0.
score_counts = collections.Counter(native=0, numpy=0)

_lib = None              # the loaded scorer, or False once its build failed
_lib_lock = threading.Lock()


def _scorer():
    """The loaded scorer library (built first when needed), or None when
    it cannot be built or loaded (reported once on standard error)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(native_build.build(
                    SOURCE, "the accuracy scorer"))
            except (RuntimeError, OSError) as ex:
                print(f"utils.metrics: accuracies scored with numpy, the "
                      f"native scorer is unavailable: {ex}", file=sys.stderr,
                      flush=True)
                _lib = False
            else:
                lib.stemgnn_masked_hits.restype = ctypes.c_int64
                lib.stemgnn_masked_hits.argtypes = [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64)]
                _lib = lib
    return _lib or None


def _native_hits(pred: np.ndarray, y: np.ndarray, mask):
    """``(hits, rows)`` of the native pass, or None where the inputs are
    not of its kind (module docstring) or the scorer is unavailable."""
    n = pred.shape[0] if pred.ndim == 2 else -1
    if not (pred.dtype == np.float32 and pred.flags.c_contiguous
            and n >= 0 and pred.shape[1] > 0 and y.shape == (n,)
            and y.dtype.kind in "iu" and np.can_cast(y.dtype, np.int64)):
        return None
    if mask is not None:
        mask = np.asarray(mask)
        if mask.dtype != np.bool_ or mask.shape != (n,):
            return None
        mask = np.ascontiguousarray(mask)
    lib = _scorer()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, np.int64)
    rows = ctypes.c_int64(0)
    hits = lib.stemgnn_masked_hits(
        pred.ctypes.data, y.ctypes.data,
        None if mask is None else mask.ctypes.data, n, pred.shape[1],
        ctypes.byref(rows))
    return hits, rows.value


def eval_acc(pred, y, mask=None):
    """Accuracy of the argmax of ``pred`` [N, C] (probabilities or logits)
    against ``y`` [N] int labels over the rows ``mask`` keeps (all rows
    when None): ``(pred[mask].argmax(-1) == y[mask]).mean()`` as a float,
    NaN for an empty selection.  The native pass (module docstring) gives
    the same float64 as ``hits / rows``, ties and NaNs included."""
    pred = np.asarray(pred)
    y = np.asarray(y)
    native = _native_hits(pred, y, mask)
    if native is not None:
        score_counts.update(native=1)
        hits, rows = native
        return hits / rows if rows else float("nan")
    score_counts.update(numpy=1)
    if mask is not None:
        mask = np.asarray(mask).astype(bool)
        pred, y = pred[mask], y[mask]
    if len(y) == 0:
        return float("nan")
    return float((pred.argmax(-1) == y).mean())


def _binary_auc(y_true, y_score):
    """Rank-based ROC-AUC (Mann-Whitney U); ties take average ranks."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = len(y_true) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return float((ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def eval_auc(pred, y):
    """Mean per-task ROC-AUC over tasks with both classes present
    (STEM-GNN/utils/eval.py:33-48); NaN labels excluded per task."""
    pred = np.asarray(pred)
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
        pred = pred[:, None] if pred.ndim == 1 else pred
    rocs = []
    for i in range(y.shape[1]):
        yi = y[:, i]
        valid = ~np.isnan(yi)
        yi = yi[valid]
        if (yi == 1).sum() > 0 and (yi == 0).sum() > 0:
            rocs.append(_binary_auc(yi, pred[valid, i]))
    if not rocs:
        return float("nan")
    return float(np.mean(rocs))


def evaluate(pred, y, mask=None, task: str = "node"):
    """The task's metric x100 of host predictions, in an
    ``sg:metrics.score`` span (``utils.trace``)."""
    metric = task2metric[task]
    with trace.span("sg:metrics.score"):
        if metric == "acc":
            return eval_acc(pred, y, mask) * 100
        if metric == "auc":
            return eval_auc(pred, y) * 100
    raise ValueError(f"Metric {metric} is not supported.")


def device_multitask_auc(pred, y, valid):
    """Mean per-task ROC-AUC on the device, the twin of :func:`eval_auc`
    (JAX ``device_multitask_auc``): the Mann-Whitney rank statistic with
    average ranks for ties, f32 products (an int32 ``n_pos * (n_pos + 1)``
    would wrap past ~46K positives), tasks missing a class dropped by a
    NaN-mean.  ``pred`` [G, T] scores, ``y`` [G, T] 0/1 labels (any value
    where not ``valid``), ``valid`` [G, T] bool.  Returns a 0-d tensor in
    [0, 1], NaN when no task has both classes; the caller reads one scalar
    back instead of [G, T] predictions."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=pred.device)
    p = torch.where(valid, pred.float(), big).T.contiguous()      # [T, G]
    sp = torch.sort(p, dim=1).values
    lo = torch.searchsorted(sp, p, side="left").float()
    hi = torch.searchsorted(sp, p, side="right").float()
    avg_rank = ((lo + hi + 1.0) / 2.0).T                           # 1-based
    pos = valid & (y == 1)
    neg = valid & (y == 0)
    n_pos = pos.sum(0).float()
    n_neg = neg.sum(0).float()
    sum_pos = torch.where(pos, avg_rank, torch.zeros((), device=p.device))
    sum_pos = sum_pos.sum(0)
    auc = (sum_pos - n_pos * (n_pos + 1.0) / 2.0) / torch.clamp(
        n_pos * n_neg, min=1.0)
    auc = torch.where((n_pos > 0) & (n_neg > 0), auc,
                      torch.full_like(auc, float("nan")))
    return torch.nanmean(auc)
