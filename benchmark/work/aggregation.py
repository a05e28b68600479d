"""The least work of one SAGE mean aggregation, forward and backward, from
its shapes alone: whatever implements it, the inputs are read once and the
outputs written once.

Forward ``out[i] = mean_j relu(x[j] + t0)`` over the in-edges; backward
``dx[j] = 1[x[j] + t0 > 0] * sum_i g[i] / deg[i]`` over the out-edges.

  * bytes: the distinct sender rows of ``x`` (f32), the edge list (two
    int32 a pair), the type row, the upstream gradient's distinct receiver
    rows, then ``out`` and ``dx`` over the valid rows, each f32;
  * operations: an add of ``t0`` and an add into the sum a message, and one
    add a message in the backward's sum; a scale by ``1/deg`` a row and
    direction, and the gate a row.

A dropout changes which edges count, not what is read: the pair hash needs
no input bytes, so ``dropout`` keeps the same bytes and counts the same
operations (an upper count of the kept edges' work).
"""

from __future__ import annotations

import numpy as np

F32, INDEX = 4, 4


def sage_mean(senders, n: int, d: int, dropout: bool = False,
              receivers=None) -> dict:
    """``{"bytes", "flops"}`` of one forward + backward at width ``d`` over
    the edge list ``senders`` (and ``receivers``: the same node set when
    None, as in an undirected graph) of ``n`` valid nodes."""
    senders = np.asarray(senders)
    e = int(senders.shape[0])
    n_s = int(np.unique(senders).shape[0])
    n_r = n_s if receivers is None else int(
        np.unique(np.asarray(receivers)).shape[0])
    nbytes = ((n_s + n_r) * d * F32 + e * 2 * INDEX + d * F32
              + 2 * n * d * F32)
    flops = 3 * e * d + 3 * n * d
    return {"bytes": float(nbytes), "flops": float(flops),
            "edges": e, "distinct_senders": n_s, "dropout": bool(dropout)}
