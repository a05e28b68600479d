"""Tri-objective (Fit / OOD / Perturb) evaluation (counterpart of the
repo's ``scripts/tri_objective.py``).

Buckets nodes by feature-structure alignment into ID and OOD1/2/3, trains
inside ID and reports

  * Fit     — the ID test accuracy,
  * OOD     — the lowest accuracy over the OOD buckets,
  * Perturb — the mean ID test accuracy of the best snapshot under a
              missing-feature sweep p in {0.2, 0.4, 0.6, 0.8}.

  python -m stemgnn_tpu_torch.scripts.tri_objective \\
      --finetune_dataset arxiv_synthetic_fragile --runs 3
"""

import sys
import time

import numpy as np

from stemgnn_tpu_torch.eval.buckets import (compute_alignment_buckets,
                                            stratified_split)
from stemgnn_tpu_torch.eval.perturb import apply_missing_features
from stemgnn_tpu_torch.eval.runner import (evaluate_snapshot_on, nanmean_std,
                                           train_node_with_buckets)
from stemgnn_tpu_torch.scripts._common import (base_parser, build_cfg, emit,
                                               load_node_dataset,
                                               load_pretrained,
                                               parse_with_sweep)

PERTURB_PROBS = (0.2, 0.4, 0.6, 0.8)


def main(argv=None):
    """Run the evaluation; returns the printed payload with the dataset,
    config, the last run's best snapshot and last perturbed dataset, and
    the host seconds of the buckets and of each perturbation."""
    p = base_parser("tri_objective")
    p.add_argument("--perturb_scope", default="all",
                   choices=["test", "valtest", "all"])
    args = parse_with_sweep(p, argv=argv)
    ds = load_node_dataset(args)
    cfg = build_cfg(args, ds.num_classes)
    pretrained = load_pretrained(args)

    t0 = time.perf_counter()
    stat, bounds, buckets, no_nbrs, invalid = compute_alignment_buckets(
        ds.node_features(), ds.edge_index, ds.num_nodes)
    host_s = {"buckets_s": time.perf_counter() - t0, "perturb_s": []}
    print(f"alignment buckets sizes: "
          f"{{ {', '.join(f'{k}:{len(v)}' for k, v in buckets.items())} }}")

    per_run, best, ds_p = [], None, None
    for r in range(args.runs):
        tr, va, te = stratified_split(buckets["ID"], np.asarray(ds.labels),
                                      seed=args.seed + r)
        split = {"train": tr, "valid": va, "test": te}
        best = train_node_with_buckets(ds, cfg, split, buckets,
                                       pretrained=pretrained,
                                       seed=args.seed + r, verbose=args.debug,
                                       device=args.device)
        fit = best["split_acc"]["test"]
        ood = min(best["bucket_acc"][k] for k in ("OOD1", "OOD2", "OOD3"))
        perturb_accs = []
        for prob in PERTURB_PROBS:
            t0 = time.perf_counter()
            ds_p = apply_missing_features(ds, split, missing_prob=prob,
                                          seed=args.seed + r,
                                          perturb=args.perturb_scope)
            host_s["perturb_s"].append(time.perf_counter() - t0)
            res = evaluate_snapshot_on(ds_p, cfg, best)
            perturb_accs.append(res["test"])
        assert len(perturb_accs) == len(PERTURB_PROBS)
        row = {"fit": fit, "ood": ood,
               "perturb": float(np.mean(perturb_accs)),
               **{f"perturb_p{p_}": a for p_, a in zip(PERTURB_PROBS,
                                                       perturb_accs)},
               **best["bucket_acc"], "best_epoch": best["epoch"]}
        per_run.append(row)
        print(f"[run {r}] fit={fit:.2f} ood={ood:.2f} "
              f"perturb={row['perturb']:.2f}")

    summary = {}
    for k in ["fit", "ood", "perturb"]:
        m, s = nanmean_std([row[k] for row in per_run])
        summary[f"final/{k}_mean"], summary[f"final/{k}_std"] = m, s
    payload = {"buckets": {k: len(v) for k, v in buckets.items()},
               "boundaries": bounds, "runs": per_run, "summary": summary}
    emit(payload, args)
    return dict(payload=payload, ds=ds, cfg=cfg, best=best, perturbed=ds_p,
                host_s=host_s)


if __name__ == "__main__":
    main(sys.argv[1:])
