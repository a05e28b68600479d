"""Homophily-shift OOD evaluation (counterpart of the repo's
``scripts/homophily_shift_ood.py``).

Buckets nodes by the mean cosine similarity of their features to their
neighbours' (15/85 cut; nodes without neighbours or with invalid features
stay out), then runs the degree script's scaffold.

  python -m stemgnn_tpu_torch.scripts.homophily_shift_ood \\
      --finetune_dataset arxiv_synthetic_fragile --runs 3
"""

import sys
import time

import numpy as np

from stemgnn_tpu_torch.eval.buckets import (compute_homophily_buckets,
                                            stratified_split)
from stemgnn_tpu_torch.eval.runner import (nanmean_std,
                                           train_node_with_buckets)
from stemgnn_tpu_torch.scripts._common import (base_parser, build_cfg, emit,
                                               load_node_dataset,
                                               load_pretrained,
                                               parse_with_sweep)


def main(argv=None):
    """Run the evaluation; returns as ``degree_shift_ood.main`` does."""
    args = parse_with_sweep(base_parser("homophily_shift_ood"), argv=argv)
    ds = load_node_dataset(args)
    cfg = build_cfg(args, ds.num_classes)
    pretrained = load_pretrained(args)

    t0 = time.perf_counter()
    hom, bounds, buckets, no_nbrs, invalid = compute_homophily_buckets(
        ds.node_features(), ds.edge_index, ds.num_nodes)
    host_s = {"buckets_s": time.perf_counter() - t0}
    print(f"homophily buckets: low<= {bounds[0]:.3f}, high>= {bounds[1]:.3f} "
          f"(no-neighbor nodes={no_nbrs}, invalid-feature nodes={invalid})")

    per_run, best = [], None
    for r in range(args.runs):
        tr, va, te = stratified_split(buckets["ID"], np.asarray(ds.labels),
                                      seed=args.seed + r)
        best = train_node_with_buckets(
            ds, cfg, {"train": tr, "valid": va, "test": te}, buckets,
            pretrained=pretrained, seed=args.seed + r, verbose=args.debug,
            device=args.device)
        per_run.append(dict(best["bucket_acc"], best_epoch=best["epoch"]))
        print(f"[run {r}] " + " ".join(
            f"{k}={v:.2f}" for k, v in best["bucket_acc"].items()))

    summary = {}
    for k in ["ID", "OOD-low", "OOD-high"]:
        m, s = nanmean_std([row[k] for row in per_run])
        summary[f"final/{k}_mean"], summary[f"final/{k}_std"] = m, s
    payload = {"buckets": {k: len(v) for k, v in buckets.items()},
               "boundaries": bounds, "diagnostics": {
                   "no_feature_neighbors": no_nbrs,
                   "invalid_features": invalid},
               "runs": per_run, "summary": summary}
    emit(payload, args)
    return dict(payload=payload, ds=ds, cfg=cfg, best=best, host_s=host_s)


if __name__ == "__main__":
    main(sys.argv[1:])
