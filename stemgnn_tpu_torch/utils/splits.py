"""Split utilities (counterpart of ``stemgnn_tpu/utils/splits.py``):
stratified k-fold without sklearn, the rotating train/test/val fold
assignment (reference STEM-GNN/dataset/gp/utils/utils.py:145-189) and the
random mask split (utils/others.py:88-99).  Host numpy, bit-equal to the
JAX package's for the same seed."""

from __future__ import annotations

from typing import List

import numpy as np


def k_fold_ind(labels, fold: int, seed: int = 10) -> List[np.ndarray]:
    """Stratified k folds: per class, shuffle then deal round-robin."""
    labels = np.asarray(labels, int)
    rng = np.random.default_rng(seed)
    folds = [[] for _ in range(fold)]
    for cls in np.unique(labels):
        idx = np.nonzero(labels == cls)[0]
        rng.shuffle(idx)
        for i, v in enumerate(idx):
            folds[i % fold].append(v)
    return [np.sort(np.asarray(f)) for f in folds]


def k_fold2_split(folds, data_len: int):
    """Per fold i: test = fold i, valid = fold i+1, train = rest.
    Returns [[train_ind, test_ind, val_ind], ...]."""
    splits = []
    for i in range(len(folds)):
        test = np.zeros(data_len, bool)
        test[folds[i]] = True
        val = np.zeros(data_len, bool)
        val[folds[(i + 1) % len(folds)]] = True
        train = ~(test | val)
        splits.append([np.nonzero(train)[0], np.nonzero(test)[0],
                       np.nonzero(val)[0]])
    return splits


def random_split_masks(num_samples: int, train_ratio: float = 0.1,
                       test_ratio: float = 0.1, seed: int = 0):
    """utils/others.py:88-99 ``get_mask`` analog (returns index arrays)."""
    assert train_ratio + test_ratio < 1
    rng = np.random.default_rng(seed)
    idx = rng.permutation(num_samples)
    n_tr = int(num_samples * train_ratio)
    n_te = int(num_samples * test_ratio)
    return {"train": idx[:n_tr], "valid": idx[n_tr:n_tr + n_te],
            "test": idx[n_tr + n_te:]}
