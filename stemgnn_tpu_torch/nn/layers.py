"""Building-block layers: Linear, BatchNorm and dropout (counterpart of
``stemgnn_tpu/nn/layers.py``).

Parameter names and layouts follow the JAX package's pytrees so weights
carry across by name (``utils/convert.py``): ``Linear.w`` is ``[in, out]``
and applies as ``x @ w``; BatchNorm has parameters ``scale``/``bias`` and
buffers ``mean``/``var``/``count``.
"""

from __future__ import annotations

import torch
from torch import nn

from stemgnn_tpu_torch.nn import init as inits
from stemgnn_tpu_torch.ops import split_gemm


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 weight_init: str = "torch", generator=None):
        super().__init__()
        if weight_init == "torch":
            w = inits.kaiming_uniform((in_dim, out_dim), fan_in=in_dim,
                                      generator=generator)
        elif weight_init == "glorot":
            w = inits.glorot_uniform((in_dim, out_dim), generator=generator)
        else:
            raise ValueError(weight_init)
        self.w = nn.Parameter(w)
        self.b = (nn.Parameter(inits.uniform_bias((out_dim,), in_dim,
                                                  generator=generator))
                  if bias else None)

    def forward(self, x):
        # compute in the activation dtype, as the JAX package does; f32
        # products on the card take the split-TF32 kernel where its rule
        # accepts them (ops/split_gemm.py)
        return split_gemm.linear(
            x, self.w.to(x.dtype),
            None if self.b is None else self.b.to(x.dtype))


class BatchNorm(nn.Module):
    """BatchNorm1d over the node axis (JAX ``batchnorm_apply``).

    Training normalizes with the batch statistics of the ``mask`` rows
    (padding excluded) and updates the buffers in place with torch's
    momentum convention: ``running <- (1 - m) * running + m * batch``, the
    unbiased variance in the running buffer, ``count`` + 1.  Eval uses the
    running statistics.  ``reduce`` (a sum across ranks whose backward sums
    again) makes the batch moments global: the raw sums ``mean * n`` and
    ``(var + mean^2) * n`` of every rank's rows combine (JAX
    ``batchnorm_apply(axis_name=...)``, nn/layers.py:56-87); a rank without
    valid rows adds nothing.  ``update=False`` normalizes with the batch
    statistics and leaves the buffers as they were (JAX callers that drop
    the new state: the zoo's virtual-node MLP)."""

    momentum = 0.1               # torch BatchNorm1d's default

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.register_buffer("count", torch.zeros((), dtype=torch.int32))

    def forward(self, x, mask=None, reduce=None, update: bool = True):
        xf = x.float()               # statistics and normalization in f32
        if not self.training:
            y = (xf - self.mean) * torch.rsqrt(self.var + self.eps)
            return (y * self.scale + self.bias).to(x.dtype)
        if mask is None:
            n = n_raw = torch.tensor(float(x.shape[0]), device=x.device)
            mean = xf.mean(0)
            var = ((xf - mean) ** 2).mean(0)
        else:
            m = mask.to(xf.dtype)[:, None]
            n_raw = m.sum()
            n = torch.clamp(n_raw, min=1.0)
            mean = (xf * m).sum(0) / n
            var = (((xf - mean) ** 2) * m).sum(0) / n
        if reduce is not None:
            # the count and both raw sums in one collective
            d = mean.shape[0]
            sums = reduce(torch.cat([n_raw.detach().reshape(1), mean * n_raw,
                                     (var + mean ** 2) * n_raw]))
            n = torch.clamp(sums[0], min=1.0)
            mean = sums[1:d + 1] / n
            var = torch.clamp(sums[d + 1:] / n - mean ** 2, min=0.0)
        if update:
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                mo = self.momentum
                self.mean.mul_(1 - mo).add_(mo * mean)
                self.var.mul_(1 - mo).add_(mo * unbiased)
                self.count.add_(1)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


def dropout(x, rate: float, *, training: bool, generator=None):
    """Inverted dropout; the keep mask is drawn from ``generator`` (a
    ``torch.Generator`` on ``x``'s device), so a run is repeatable."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))
