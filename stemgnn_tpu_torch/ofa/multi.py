"""Weighted multi-dataset mixing with adaptive per-dataset halving
(counterpart of ``stemgnn_tpu/ofa/multi.py``; host numpy, bit-equal to the
JAX package's draws).

Re-design of ``MultiDataset`` (reference
STEM-GNN/dataset/ofa_datasets.py:552-631): each epoch samples
``size_i * multiple_i`` examples per dataset uniformly with replacement; on
validation plateau (windowed relative improvement <= 0 for ``patience``
epochs) a dataset's multiple halves, floored at ``min_ratio``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class MultiDataset:
    def __init__(self, datas: Sequence, data_val_index=None,
                 dataset_multiple=1.0, window_size=3, patience=3,
                 min_ratio=0.1, mode: Optional[Sequence[str]] = None,
                 seed: int = 0):
        self.datas = list(datas)
        self.sizes = np.asarray([len(d) for d in self.datas])
        n = len(self.datas)
        self.data_val_index = ([[i] for i in range(n)]
                               if data_val_index is None else data_val_index)
        self.patience = np.zeros(n) + patience
        self.inpatience = np.zeros(n)
        self.window_size = np.zeros(n) + window_size
        self.dataset_multiple = (np.zeros(n) + dataset_multiple
                                 if not isinstance(dataset_multiple, (list,
                                                                      tuple))
                                 else np.asarray(dataset_multiple, float))
        self.min_ratio = np.zeros(n) + min_ratio
        self.mode = None if mode is None else np.asarray(
            [1 if m == "max" else -1 for m in mode])
        self.performance_record = []
        self.rng = np.random.default_rng(seed)
        self.compute_sizes()

    def compute_sizes(self):
        self.aug_sizes = (self.sizes * self.dataset_multiple).astype(int)
        self.ind2dataset = np.arange(len(self.datas)).repeat(self.aug_sizes)
        self.sample_ind = (self.rng.random(len(self.ind2dataset))
                           * self.sizes.repeat(self.aug_sizes)).astype(int)

    def __len__(self):
        return int(np.sum(self.aug_sizes))

    def __getitem__(self, index):
        d = self.ind2dataset[index]
        return self.datas[d][int(self.sample_ind[index])]

    def update(self, metric):
        """Per-epoch validation metrics -> adapt multiples
        (ofa_datasets.py:607-631)."""
        metric = np.asarray(metric, float)
        p = np.asarray(self.performance_record, float)
        for i in range(len(self.datas)):
            if len(p) < self.window_size[i] or not len(self.data_val_index[i]):
                continue
            vals = p[-int(self.window_size[i]):][:, self.data_val_index[i]]
            mode = (np.ones(vals.shape[1]) if self.mode is None
                    else self.mode[self.data_val_index[i]])
            mean = vals.mean()
            improvement = (((metric[self.data_val_index[i]] - mean) / mean)
                           * mode).sum()
            if improvement > 0:
                self.inpatience[i] = 0
            else:
                self.inpatience[i] += 1
            if self.inpatience[i] > self.patience[i]:
                self.dataset_multiple[i] = max(self.min_ratio[i],
                                               self.dataset_multiple[i] / 2)
        self.compute_sizes()
        self.performance_record.append(metric)
