"""Masked segment reductions (counterpart of ``stemgnn_tpu/ops/segment.py``).

Padding entries are masked to the additive (or max) identity before the
reduction, so results match the unpadded math exactly.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def _mask_like(data, mask, identity):
    if mask is None:
        return data
    m = mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))
    return torch.where(m, data, torch.as_tensor(identity, dtype=data.dtype,
                                                device=data.device))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    data = _mask_like(data, mask, 0)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Mean over segments; empty segments yield zeros."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = torch.ones(data.shape[:1], dtype=total.dtype, device=data.device)
    count = segment_sum(ones, segment_ids, num_segments, mask=mask)
    count = count.reshape(count.shape + (1,) * (total.dim() - count.dim()))
    return total / torch.clamp(count, min=1)


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Max over segments; empty segments yield zeros."""
    data = _mask_like(data, mask, _NEG_INF)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.reshape(segment_ids.shape
                              + (1,) * (data.dim() - 1)).expand_as(data)
    out = out.scatter_reduce(0, idx, data, reduce="amax", include_self=True)
    return torch.where(out <= _NEG_INF / 2, torch.zeros((), dtype=out.dtype,
                                                        device=out.device),
                       out)
