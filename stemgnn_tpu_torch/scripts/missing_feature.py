"""Missing-feature robustness evaluation (counterpart of the repo's
``scripts/missing_feature.py``).

Trains on the clean graph (the dataset's own splits), then re-evaluates
the best-validation snapshot on a graph whose scoped nodes had each
feature dim zeroed with prob ``--missing_prob`` (optionally with relative
L2 noise on the kept dims).  ``--save_tsv 1`` writes the per-split TSV.

  python -m stemgnn_tpu_torch.scripts.missing_feature \\
      --finetune_dataset arxiv_synthetic_fragile --missing_prob 0.4
"""

import sys
import time

from stemgnn_tpu_torch.eval.perturb import apply_missing_features
from stemgnn_tpu_torch.eval.runner import (evaluate_snapshot_on, nanmean_std,
                                           train_node_with_buckets)
from stemgnn_tpu_torch.scripts._common import (base_parser, build_cfg, emit,
                                               load_node_dataset,
                                               load_pretrained,
                                               parse_with_sweep)


def main(argv=None):
    """Run the evaluation; returns the printed payload with the dataset,
    config, the last run's best snapshot and perturbed dataset, and the
    host seconds of each perturbation."""
    p = base_parser("missing_feature")
    p.add_argument("--missing_prob", type=float, default=0.4)
    p.add_argument("--perturb", default="valtest",
                   choices=["test", "valtest", "all"])
    p.add_argument("--relative_noise_alpha", type=float, default=0.0)
    p.add_argument("--save_tsv", type=int, default=0, choices=[0, 1],
                   help="write the per-split TSV next to the pretrain "
                        "checkpoint (or in the working directory)")
    p.add_argument("--tsv_name", default="")
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
        clean = best["split_acc"]
        t0 = time.perf_counter()
        ds_pert = apply_missing_features(
            ds, split, missing_prob=args.missing_prob, seed=args.seed + r,
            perturb=args.perturb,
            relative_noise_alpha=args.relative_noise_alpha)
        host_s["perturb_s"].append(time.perf_counter() - t0)
        pert = evaluate_snapshot_on(ds_pert, cfg, best)
        row = {**{f"clean/{k}": v for k, v in clean.items()},
               **{f"perturbed/{k}": v for k, v in pert.items()
                  if k in ("train", "valid", "test")},
               "best_epoch": best["epoch"]}
        per_run.append(row)
        print(f"[run {r}] clean_test={clean['test']:.2f} "
              f"perturbed_test={pert['test']:.2f}")

    summary = {}
    for k in ["clean/test", "perturbed/test"]:
        m, s = nanmean_std([row[k] for row in per_run])
        summary[f"final/{k}_mean"], summary[f"final/{k}_std"] = m, s
    if args.save_tsv:
        _write_tsv(args, per_run)
    payload = {"missing_prob": args.missing_prob, "perturb": args.perturb,
               "runs": per_run, "summary": summary}
    emit(payload, args)
    return dict(payload=payload, ds=ds, cfg=cfg, best=best,
                perturbed=ds_pert, host_s=host_s)


def _write_tsv(args, per_run):
    """One row per split, ``split<TAB>[missing_val<TAB>]missing_test``
    (the val column when val is perturbed too), written next to the
    pretrain checkpoint under a name made from the flags unless
    ``--tsv_name`` is given."""
    import csv
    import os
    import os.path as osp
    log_val = args.perturb in ("valtest", "all")
    tsv_name = args.tsv_name or (
        f"finetune_{args.finetune_dataset}_missing_p{args.missing_prob}_"
        f"alpha{args.relative_noise_alpha}_{args.perturb}_"
        f"seed{args.seed}.tsv")
    tsv_path = osp.join(args.pretrain_path or ".", tsv_name)
    if osp.dirname(tsv_path):
        os.makedirs(osp.dirname(tsv_path), exist_ok=True)
    with open(tsv_path, "w", newline="") as f:
        header = ["split", "missing_test"]
        if log_val:
            header.insert(1, "missing_val")
        writer = csv.writer(f, delimiter="\t")
        writer.writerow(header)
        for idx, row in enumerate(per_run):
            data_row = [idx]
            if log_val:
                data_row.append(row["perturbed/valid"])
            data_row.append(row["perturbed/test"])
            writer.writerow(data_row)
    print(f"[saved] {tsv_path}")


if __name__ == "__main__":
    main(sys.argv[1:])
