"""Readings that the limits of ``benchmark/limits/<workload>.json`` are set
from, at the cell's own size, in one process:

    python3 -m benchmark.calibrate --workload <name> --seeds 1 2 3 ...

For each seed: the program's checked units as a run's set-up drives them,
then the plain reference (float32, TF32 off), and against it

  * ``program``: the program's readings (the lower reading of each number
    is the largest over a dozen seeds or more);
  * ``control``: the reference computed with TF32, one precision below the
    configuration's float32, put in the program's place;
  * ``half_batch``: the reference with every other row left out of the
    losses, the mean taken over the rest, put in the program's place;
  * ``flip<k>``: the reference whose first step gives the ``k`` (row,
    head) pairs nearest to a code tie their second-best code, and
    ``reorder``: the reference summing every aggregation's edges in the
    reverse order; both are sound, and what they read is rounding;
  * ``unchanged``: a step that returns its state unchanged (the change
    reads 1 by construction and needs no run).

The benchmark's own runs never run this.  One JSON line a seed and kind on
standard output; ``near_ties`` counts the valid rows whose reference code
scores, at the first checked unit, are within 1e-6 or 1e-5 of a tie.
"""

import argparse
import json
import sys
import time

import torch

from benchmark import common


def readings(w: dict, seeds, kinds=("program", "control", "half_batch"),
             device="cuda"):
    """Yield one dict of readings a seed and kind (module docstring)."""
    driver = __import__(f"benchmark.drivers.{w['traffic_mix']['driver']}",
                        fromlist=["Cell"])
    ref = common.reference_module(w["config_entry"]["file"])
    opts = {k[1:]: v for k, v in w["limits"].items() if k.startswith("_")}
    for seed in seeds:
        t0 = time.perf_counter()
        cell = driver.Cell(w, seed, device)
        cell.setup()
        common.free_cuda()
        t_setup = time.perf_counter() - t0
        cell.release()
        base = cell.reference(ref)
        margins = base.get("margins", [base.get("margin")])[0]
        ties = {f"{t:g}": int((margins < t).sum()) for t in (1e-6, 1e-5)}
        for kind in kinds:
            if kind == "program":
                r = cell.readings(base, **opts)
            elif kind == "control":
                r = cell.readings(base, prog=cell.reference(ref, tf32=True),
                                  **opts)
            elif kind == "reorder":
                data = cell.data
                e = data["senders"].shape[0]
                cell.data = dict(data, edge_order=torch.arange(
                    e - 1, -1, -1, device=data["senders"].device))
                r = cell.readings(base, prog=cell.reference(ref), **opts)
                cell.data = data
            else:
                r = cell.readings(base, prog=cell.reference(ref, fault=kind),
                                  **opts)
            leaves = r.pop("_leaves")
            yield dict(workload=w["name"], seed=seed, kind=kind, **r,
                       leaves=leaves, near_ties=ties, setup_s=t_setup,
                       stages=cell.host.get("stages"))
        del cell, base
        common.free_cuda()


def main(argv=None) -> int:
    p = argparse.ArgumentParser("benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kinds", nargs="+",
                   default=["program", "control", "half_batch"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    for r in readings(common.cell(args.workload), args.seeds, args.kinds):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
