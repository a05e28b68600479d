"""Activation resolver (counterpart of ``stemgnn_tpu/zoo/resolver.py``;
reference STEM-GNN/dataset/gp/nn/resolver.py)."""

from __future__ import annotations

import torch.nn.functional as F

_ACTS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": F.sigmoid,
    "tanh": F.tanh,
    "silu": F.silu,
    "swish": F.silu,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def resolve_activation(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in _ACTS:
        raise ValueError(f"unknown activation {name!r}; "
                         f"one of {sorted(_ACTS)}")
    return _ACTS[key]
