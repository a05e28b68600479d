"""Host seconds of the locality relabels (``--reorder``) on one graph.

    python -m stemgnn_tpu_torch.profile_reorder [--dataset arxiv_synthetic]

Times ``degree_order``, ``rcm_order`` and ``community_order`` on the
dataset's edges, and ``community_order``'s label propagation two ways: as
this package runs it (:func:`~stemgnn_tpu_torch.ops.reorder.
propagate_labels`: the keys sorted by value, each node's first run of its
largest count) and as the reference package writes it (a stable argsort of
the keys, then a lexsort of the runs by node, count and label; copied
below).  Checks that both give the same labels and prints the mean host
seconds of each over ``--reps`` runs, and the host's processor.  Host work
only: needs no card.
"""

from __future__ import annotations

import argparse
import os
import platform
import time

import numpy as np

from stemgnn_tpu_torch.data.registry import load_dataset
from stemgnn_tpu_torch.ops.reorder import (community_order, degree_order,
                                           propagate_labels, rcm_order)


def reference_propagate_labels(senders, receivers, num_nodes: int,
                               iters: int = 15) -> np.ndarray:
    """The reference's label propagation (``community_order``'s loop in the
    JAX package's ``ops/reorder.py``), as written there."""
    s = np.asarray(senders, np.int64)
    r = np.asarray(receivers, np.int64)
    u = np.concatenate([s, r])
    v = np.concatenate([r, s])
    lab = np.arange(num_nodes, dtype=np.int64)
    for _ in range(iters):
        key = u * np.int64(num_nodes + 1) + lab[v]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        boundary = np.ones(len(ks), bool)
        boundary[1:] = ks[1:] != ks[:-1]
        starts = np.nonzero(boundary)[0]
        counts = np.diff(np.append(starts, len(ks)))
        run_node = u[order][starts]
        run_label = lab[v][order][starts]
        o2 = np.lexsort((run_label, -counts, run_node))
        rn = run_node[o2]
        first = np.ones(len(o2), bool)
        first[1:] = rn[1:] != rn[:-1]
        new_lab = lab.copy()
        new_lab[rn[first]] = run_label[o2][first]
        if np.array_equal(new_lab, lab):
            break
        lab = new_lab
    return lab


def _mean_s(fn, reps):
    out, times = None, []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.mean(times))


def main(argv=None):
    p = argparse.ArgumentParser("profile_reorder")
    p.add_argument("--dataset", default="arxiv_synthetic")
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    ds = load_dataset(args.dataset, feat_dim=args.feat_dim, seed=args.seed)
    s = np.asarray(ds.edge_index[0])
    r = np.asarray(ds.edge_index[1])
    n = ds.num_nodes
    print(f"{args.dataset}: {n} nodes, {len(s)} edges; host "
          f"{platform.processor() or platform.machine()}, "
          f"{os.cpu_count()} logical CPUs; mean of {args.reps}", flush=True)
    res = {}
    for name, fn in (("degree_order", lambda: degree_order(s, r, n)),
                     ("rcm_order", lambda: rcm_order(s, r, n)),
                     ("community_order", lambda: community_order(s, r, n)),
                     ("propagate_labels", lambda: propagate_labels(s, r, n)),
                     ("reference_propagate_labels",
                      lambda: reference_propagate_labels(s, r, n))):
        res[name], sec = _mean_s(fn, args.reps)
        print(f"  {name}: {sec:.3f} s", flush=True)
    if not np.array_equal(res["propagate_labels"],
                          res["reference_propagate_labels"]):
        raise AssertionError("the two label propagations disagree")
    print("  the two label propagations give the same labels", flush=True)


if __name__ == "__main__":
    main()
