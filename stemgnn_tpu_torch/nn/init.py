"""Initializers matching the reference's torch defaults (counterpart of
``stemgnn_tpu/nn/init.py``), drawn from an explicit ``torch.Generator``.

Weights are stored ``[in, out]`` as in the JAX package, so fan-in is
``shape[0]`` of a 2-D weight.  The two frameworks draw different numbers
from the same seed; parity tests carry weights across instead
(``utils/convert.py``).
"""

from __future__ import annotations

import math

import torch


def _uniform(shape, bound: float, generator):
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def kaiming_uniform(shape, fan_in=None, a: float = math.sqrt(5),
                    generator=None):
    """torch.nn.init.kaiming_uniform_ (fan_in mode, leaky_relu gain)."""
    fan_in = shape[0] if fan_in is None else fan_in
    gain = math.sqrt(2.0 / (1 + a ** 2))
    return _uniform(shape, gain * math.sqrt(3.0 / fan_in), generator)


def uniform_bias(shape, fan_in, generator=None):
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0,
                    generator)


def glorot_uniform(shape, generator=None):
    """xavier/glorot uniform for [in, out] (PyG Linear 'glorot' default)."""
    return _uniform(shape, math.sqrt(6.0 / (shape[0] + shape[-1])), generator)
