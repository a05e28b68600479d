"""Degree-shift OOD evaluation (counterpart of the repo's
``scripts/degree_shift_ood.py``).

Buckets nodes by undirected degree (bottom/top 15% = OOD-low/high, the
middle = ID), splits each class 50/25/25 inside ID, finetunes full batch
with best-validation snapshots, and reports ID vs OOD accuracy over runs
with nan-aware mean and std.

  python -m stemgnn_tpu_torch.scripts.degree_shift_ood \\
      --finetune_dataset arxiv_synthetic_fragile --runs 3
"""

import sys
import time

import numpy as np

from stemgnn_tpu_torch.eval.buckets import (compute_degree_buckets,
                                            stratified_split)
from stemgnn_tpu_torch.eval.runner import (nanmean_std,
                                           train_node_with_buckets)
from stemgnn_tpu_torch.scripts._common import (base_parser, build_cfg, emit,
                                               load_node_dataset,
                                               load_pretrained,
                                               parse_with_sweep)


def main(argv=None):
    """Run the evaluation; returns the printed payload with the dataset,
    config, the last run's best snapshot and the host seconds of the
    buckets (for callers such as ``chip_smoke.py``)."""
    args = parse_with_sweep(base_parser("degree_shift_ood"), argv=argv)
    ds = load_node_dataset(args)
    cfg = build_cfg(args, ds.num_classes)
    pretrained = load_pretrained(args)

    t0 = time.perf_counter()
    deg, bounds, buckets = compute_degree_buckets(ds.edge_index, ds.num_nodes)
    host_s = {"buckets_s": time.perf_counter() - t0}
    print(f"degree buckets: low<= {bounds[0]:.0f}, high>= {bounds[1]:.0f} "
          f"sizes={{ {', '.join(f'{k}:{len(v)}' for k, v in buckets.items())} }}")

    per_run, best = [], None
    for r in range(args.runs):
        tr, va, te = stratified_split(buckets["ID"], np.asarray(ds.labels),
                                      seed=args.seed + r)
        split = {"train": tr, "valid": va, "test": te}
        best = train_node_with_buckets(ds, cfg, split, buckets,
                                       pretrained=pretrained,
                                       seed=args.seed + r,
                                       verbose=args.debug, device=args.device)
        row = dict(best["bucket_acc"], **{f"split/{k}": v
                                          for k, v in best["split_acc"].items()},
                   best_epoch=best["epoch"])
        per_run.append(row)
        print(f"[run {r}] " + " ".join(
            f"{k}={v:.2f}" for k, v in best["bucket_acc"].items()))

    summary = {}
    for k in ["ID", "OOD-low", "OOD-high"]:
        m, s = nanmean_std([row[k] for row in per_run])
        summary[f"final/{k}_mean"] = m
        summary[f"final/{k}_std"] = s
    m, s = nanmean_std([min(row["OOD-low"], row["OOD-high"])
                        for row in per_run])
    summary["final/OOD_worst_mean"] = m
    summary["final/OOD_worst_std"] = s
    payload = {"buckets": {k: len(v) for k, v in buckets.items()},
               "boundaries": bounds, "runs": per_run, "summary": summary}
    emit(payload, args)
    return dict(payload=payload, ds=ds, cfg=cfg, best=best, host_s=host_s)


if __name__ == "__main__":
    main(sys.argv[1:])
