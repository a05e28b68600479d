"""Random-edge-drop robustness evaluation (counterpart of the repo's
``scripts/random_edge_drop.py``).

Trains on the clean graph, then re-evaluates the best-validation snapshot
on a graph whose candidate edges (those touching a scoped node) were
dropped per undirected pair or per directed edge with prob
``--drop_prob``, never all of them.

  python -m stemgnn_tpu_torch.scripts.random_edge_drop \\
      --finetune_dataset arxiv_synthetic_fragile --drop_prob 0.2
"""

import sys
import time

from stemgnn_tpu_torch.eval.perturb import apply_random_edge_drops
from stemgnn_tpu_torch.eval.runner import (evaluate_snapshot_on, nanmean_std,
                                           train_node_with_buckets)
from stemgnn_tpu_torch.scripts._common import (base_parser, build_cfg, emit,
                                               load_node_dataset,
                                               load_pretrained,
                                               parse_with_sweep)


def main(argv=None):
    """Run the evaluation; returns as ``missing_feature.main`` does."""
    p = base_parser("random_edge_drop")
    p.add_argument("--drop_prob", type=float, default=0.2)
    p.add_argument("--perturb", default="test",
                   choices=["test", "valtest", "all"])
    p.add_argument("--drop_mode", default="per_undirected",
                   choices=["per_undirected", "per_edge"])
    args = parse_with_sweep(p, argv=argv)
    ds = load_node_dataset(args)
    cfg = build_cfg(args, ds.num_classes)
    pretrained = load_pretrained(args)

    per_run, best, ds_pert, host_s = [], None, None, {"perturb_s": []}
    for r in range(min(args.runs, len(ds.splits))):
        split = ds.splits[r % len(ds.splits)]
        best = train_node_with_buckets(ds, cfg, split, {},
                                       pretrained=pretrained,
                                       seed=args.seed + r, verbose=args.debug,
                                       device=args.device)
        t0 = time.perf_counter()
        ds_pert = apply_random_edge_drops(
            ds, split, drop_prob=args.drop_prob, seed=args.seed + r,
            perturb=args.perturb, drop_mode=args.drop_mode)
        host_s["perturb_s"].append(time.perf_counter() - t0)
        pert = evaluate_snapshot_on(ds_pert, cfg, best)
        per_run.append({**{f"clean/{k}": v
                           for k, v in best["split_acc"].items()},
                        **{f"perturbed/{k}": v for k, v in pert.items()
                           if k in ("train", "valid", "test")},
                        "best_epoch": best["epoch"]})
        print(f"[run {r}] clean_test={best['split_acc']['test']:.2f} "
              f"perturbed_test={pert['test']:.2f}")

    summary = {}
    for k in ["clean/test", "perturbed/test"]:
        m, s = nanmean_std([row[k] for row in per_run])
        summary[f"final/{k}_mean"], summary[f"final/{k}_std"] = m, s
    payload = {"drop_prob": args.drop_prob, "drop_mode": args.drop_mode,
               "perturb": args.perturb, "runs": per_run, "summary": summary}
    emit(payload, args)
    return dict(payload=payload, ds=ds, cfg=cfg, best=best,
                perturbed=ds_pert, host_s=host_s)


if __name__ == "__main__":
    main(sys.argv[1:])
