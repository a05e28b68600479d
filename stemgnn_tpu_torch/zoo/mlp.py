"""MLP (counterpart of ``stemgnn_tpu/zoo/mlp.py``; reference
STEM-GNN/dataset/gp/nn/models/util_model.py:9).

``{"layers": [Linear...], "norms": [BatchNorm...]}`` as JAX's pytree: a
BatchNorm after every hidden layer when ``batch_norm``.  The BatchNorm
takes no mask, so the padded rows of a padded batch enter its statistics,
as in JAX (ROADMAP, known behaviours).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from stemgnn_tpu_torch.nn.layers import BatchNorm, Linear, dropout


class MLP(nn.Module):
    def __init__(self, dims, batch_norm: bool = True, generator=None):
        """``dims`` = [in, hidden..., out]."""
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(a, b, generator=generator)
            for a, b in zip(dims[:-1], dims[1:]))
        self.norms = nn.ModuleList(
            BatchNorm(b) for b in dims[1:-1]) if batch_norm \
            else nn.ModuleList()

    def forward(self, x, *, drop: float = 0.0, act=F.relu, generator=None,
                update: bool = True):
        """``update=False``: the BatchNorms leave their running statistics
        as they were (a JAX caller that drops the MLP's new state)."""
        n_layers = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n_layers - 1:
                if i < len(self.norms):
                    x = self.norms[i](x, update=update)
                x = act(x)
                if drop > 0:
                    x = dropout(x, drop, training=self.training,
                                generator=generator)
        return x
