"""Masked segment reductions (counterpart of ``stemgnn_tpu/ops/segment.py``).

Padding entries are masked to the additive (or max) identity before the
reduction, so results match the unpadded math exactly.

Reduced-precision data (bf16) is summed in f32 and rounded once: a bf16
``index_add_`` adds in bf16, on CUDA through atomics in no fixed order.
XLA's bf16 scatter-add, which the JAX package runs, adds one update at a
time in bf16, so the sums differ in their rounding (ROADMAP, differences
kept on purpose).  The mean's count follows JAX's (:func:`segment_mean`).

``drop_oob=True`` gives JAX's handling of segment ids outside ``[0,
num_segments)``: ``jax.ops.segment_*`` drop them, and a gather clamps them
into range in its forward while its backward (a scatter-add) drops them
(:func:`take_clamped`), where ``index_add_`` and indexing raise (a device
assert on CUDA).  A padded disjoint batch points its padded nodes at such
an id, the dead graph slot ``n_graph`` (``core/graph.py``).
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


def take_clamped(table, ids):
    """``table[ids]`` as JAX gathers it: an id outside ``[0, len(table))``
    reads the nearest row, and no gradient flows back through that read
    (the transposed scatter-add drops it)."""
    n = table.shape[0]
    ids = ids.long()
    rows = table.index_select(0, ids.clamp(0, n - 1))
    inside = ((ids >= 0) & (ids < n)).reshape(
        ids.shape + (1,) * (rows.dim() - 1))
    return torch.where(inside, rows, rows.detach())


def _spill(segment_ids, num_segments: int, drop_oob: bool):
    """(ids, segments to reduce into): with ``drop_oob`` an id outside
    ``[0, num_segments)`` goes to one extra segment, cut off afterwards."""
    if not drop_oob:
        return segment_ids, num_segments
    ids = segment_ids.long()
    inside = (ids >= 0) & (ids < num_segments)
    return torch.where(inside, ids, num_segments), num_segments + 1


def segment_sum(data, segment_ids, num_segments: int, mask=None,
                drop_oob: bool = False):
    """Sums over segments in ``data``'s dtype; bf16 sums in f32, rounded
    once."""
    data = _mask_like(data, mask, 0)
    ids, n = _spill(segment_ids, num_segments, drop_oob)
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    out = out.index_add_(0, ids, data.to(acc)).to(data.dtype)
    return out[:num_segments] if drop_oob else out


def segment_mean(data, segment_ids, num_segments: int, mask=None,
                 drop_oob: bool = False):
    """Mean over segments; empty segments yield zeros.

    The count is JAX's: a scatter-add of ones in the data's dtype, which
    XLA adds one at a time, so in bf16 it stops at 256 (256 + 1 rounds back
    to 256): a receiver with more in-edges divides by 256 (ROADMAP, known
    behaviours)."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask,
                        drop_oob=drop_oob)
    count = segment_count(segment_ids, num_segments, mask, total.dtype,
                          drop_oob=drop_oob)
    count = count.reshape(count.shape + (1,) * (total.dim() - count.dim()))
    return total / count


def segment_count(segment_ids, num_segments: int, mask=None,
                  dtype=torch.float32, drop_oob: bool = False):
    """The mean's divisor: each segment's count of valid entries, at least
    1, in ``dtype``; in bf16 JAX's stalled count (at most 256)."""
    ones = torch.ones(segment_ids.shape[:1], dtype=torch.float32,
                      device=segment_ids.device)
    count = segment_sum(ones, segment_ids, num_segments, mask=mask,
                        drop_oob=drop_oob)
    if dtype == torch.bfloat16:
        count = torch.clamp(count, max=256.0)
    return torch.clamp(count.to(dtype), min=1)


def _segment_amax(data, ids, num_segments: int):
    """Per-segment max over the leading axis of ``data`` (any trailing
    dims); -inf where a segment is empty."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = ids.reshape(ids.shape + (1,) * (data.dim() - 1)).expand_as(data)
    return out.scatter_reduce(0, idx, data, reduce="amax", include_self=True)


def segment_max(data, segment_ids, num_segments: int, mask=None,
                drop_oob: bool = False):
    """Max over segments; empty segments yield zeros."""
    data = _mask_like(data, mask, _NEG_INF)
    ids, n = _spill(segment_ids.long(), num_segments, drop_oob)
    out = _segment_amax(data, ids, n)[:num_segments]
    return torch.where(out <= _NEG_INF / 2, torch.zeros((), dtype=out.dtype,
                                                        device=out.device),
                       out)


def segment_softmax(logits, segment_ids, num_segments: int, mask=None,
                    drop_oob: bool = False):
    """Per-segment softmax over the leading axis of ``logits`` [E, ...]
    (the GAT backbone's [E]; RGAT's [E, H], one softmax a head): masked
    logits count as -inf, an empty segment's max as 0, and the denominator
    is floored at 1e-16.  The max only shifts the logits, which the softmax
    does not see, so no gradient flows through it.  With ``drop_oob`` an
    out-of-range id reads the max and denominator of its clamped segment,
    as JAX's gathers do (:func:`take_clamped`)."""
    logits = _mask_like(logits, mask, _NEG_INF)
    ids = segment_ids.long()
    sids, n = _spill(ids, num_segments, drop_oob)
    take = take_clamped if drop_oob else (
        lambda t, i: t.index_select(0, i))
    with torch.no_grad():
        seg_max = _segment_amax(logits, sids, n)[:num_segments]
        seg_max = torch.where(seg_max <= _NEG_INF / 2,
                              torch.zeros((), dtype=seg_max.dtype,
                                          device=seg_max.device), seg_max)
    exp = torch.exp(logits - take(seg_max, ids))
    exp = _mask_like(exp, mask, 0)
    denom = segment_sum(exp, sids, n)[:num_segments]
    return exp / torch.clamp(take(denom, ids), min=1e-16)
