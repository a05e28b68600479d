"""Masked segment reductions (counterpart of ``stemgnn_tpu/ops/segment.py``).

Padding entries are masked to the additive (or max) identity before the
reduction, so results match the unpadded math exactly.

Reduced-precision data (bf16) is summed in f32 and rounded once: a bf16
``index_add_`` adds in bf16, on CUDA through atomics in no fixed order.
XLA's bf16 scatter-add, which the JAX package runs, adds one update at a
time in bf16, so the sums differ in their rounding (ROADMAP, differences
kept on purpose).  The mean's count follows JAX's (:func:`segment_mean`).
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
    """Sums over segments in ``data``'s dtype; bf16 sums in f32, rounded
    once."""
    data = _mask_like(data, mask, 0)
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    return out.index_add_(0, segment_ids, data.to(acc)).to(data.dtype)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Mean over segments; empty segments yield zeros.

    The count is JAX's: a scatter-add of ones in the data's dtype, which
    XLA adds one at a time, so in bf16 it stops at 256 (256 + 1 rounds back
    to 256): a receiver with more in-edges divides by 256 (ROADMAP, known
    behaviours)."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    ones = torch.ones(data.shape[:1], dtype=torch.float32,
                      device=data.device)
    count = segment_sum(ones, segment_ids, num_segments, mask=mask)
    if total.dtype == torch.bfloat16:
        count = torch.clamp(count, max=256.0)
    count = count.to(total.dtype)
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
