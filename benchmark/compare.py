"""The comparison that decides ``correct``: the numbers a run reads from
the program's first steps against the plain reference's, each held to the
limit of the cell's file ``benchmark/limits/<workload>.json``.

Training numbers (the builder's measure):

  * ``loss_gap``: the widest relative gap of a step's total loss;
  * ``<term>_gap`` (``commit_gap``, ``feat_gap``, ...): the relative gap of
    one loss term at the first step, where both sides start from the same
    state;
  * ``grad_gap``: the first step's gradient as the optimizer got it, the
    worst leaf's ``| ||g_prog|| - ||g_ref|| |`` over the larger of the
    reference leaf's norm and the median leaf's;
  * ``change_gap``: the same measure of each leaf's change over the
    checked steps, over the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a leaf with no gradient, such as a
    bias before BatchNorm, moves under Adam by round-off alone);
  * ``prob_gap`` (evaluations): the widest gap of a class probability over
    the rows whose every VQ head has a clear nearest code (an argmax at a
    near-tie flips on rounding, which no precision fixes).

Which of them a cell compares, and each limit, is the cell's limits file;
``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import math

import torch

# a leaf counts in change_gap when its reference gradient norm is at least
# this share of the median leaf's
MOVED_SHARE = 1e-3


def loss_gap(prog, ref) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _median(values) -> float:
    vals = sorted(values)
    mid = len(vals) // 2
    return vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])


def leaf_gaps(prog: dict, ref: dict, names=None) -> dict:
    """Each leaf's ``| ||prog|| - ||ref|| |`` over the larger of its
    reference norm and the median leaf's, for the leaves ``names`` (all of
    ``ref``)."""
    names = list(ref) if names is None else list(names)
    rn, pn = _norms({k: ref[k] for k in names}), _norms(
        {k: prog[k] for k in names})
    med = _median(rn.values())
    out = {}
    for k in names:
        den = max(rn[k], med)
        out[k] = abs(pn[k] - rn[k]) / den if den > 0 else (
            0.0 if pn[k] == 0 else math.inf)
    return out


def norm_gap(prog: dict, ref: dict, names=None):
    """``(worst gap, its leaf)`` of :func:`leaf_gaps`."""
    gaps = leaf_gaps(prog, ref, names)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def part_gaps(prog: dict, ref: dict) -> dict:
    """``<term>_gap``: the relative gap of each loss term both sides report
    at one step (``{term: value}``)."""
    out = {}
    for name, r in ref.items():
        if name in prog:
            short = name.replace("_recon_loss", "").replace("_loss", "")
            out[short + "_gap"] = loss_gap([prog[name]], [r])
    return out


def moved_leaves(ref_grads: dict) -> list:
    """The leaves whose reference gradient norm reaches
    :data:`MOVED_SHARE` of the median leaf's."""
    n = _norms(ref_grads)
    med = _median(n.values())
    return [k for k, v in n.items() if v >= MOVED_SHARE * med]


def prob_gap(prog, ref, rows) -> float:
    """The widest absolute gap of a probability over ``rows`` (bool)."""
    if not bool(rows.any()):
        return math.inf
    p = torch.as_tensor(prog, device=ref.device)[rows]
    return float((p.float() - ref[rows].float()).abs().max())


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: each reading beside its limit, in the order of
    the limits file; a reading that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        if name.startswith("_"):
            continue
        value = readings.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        if not (isinstance(value, float) and math.isfinite(value)
                and value <= limit):
            ok = False
    return ok, checks
