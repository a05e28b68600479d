"""Where the time of a step goes on the multi-rank pretrain paths.

    python -m stemgnn_tpu_torch.profile_parallel [--out DIR]

Runs, on ranks that share the card over gloo (as ``chip_smoke.py``'s phase
halo_pretrain runs them):

  * **grid**: the halo pretrain on a 2 x 2 (data x edge) grid of ranks over
    ``arxiv_synthetic_pl`` cut to ``--grid_nodes`` nodes, at the pretrain
    CLI's configuration with dropout 0 and hub blocks of 2,048,
    ``--epochs`` epochs of one step;
  * **dp**: ``--data_parallel``'s ``run_pretrain`` on 2 ranks over the
    whole graph, batches of 1,024 seeds at fanout 10 (the step probe's
    configuration, as ``chip_smoke.py`` runs it), ``--dp_steps`` steps.

Each rank runs its steps after the first under ``torch.profiler`` (host and
CUDA) and prints one summary line a profiled step: the step's wall (the
device synchronized at both ends), the device's busy time (every kernel and
copy's self time), the host time the step spends in the collectives (each
``torch.distributed`` call the ranks make, timed whole by a profiler range
``collective:<name>``, with their count) and the device-to-host and
host-to-device copies' device time.  Rank 0 prints its two tables (by self
host time and by self device time); with ``--out`` every rank writes its
tables there.

Needs a CUDA device; ``--device cpu`` runs the same on the CPU (with
``--feat_dim``, ``--grid_nodes`` and ``--dp_nodes`` to make it small).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import time

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

# the collectives the ranks call (parallel.mesh.Ranks), each timed whole
COLLECTIVES = ("all_reduce", "all_to_all_single", "broadcast")
COPY = re.compile(r"memcpy (dtoh|htod)", re.I)
DATASET, SEED = "arxiv_synthetic_pl", 42


def _device_us(e) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, name):
            return float(getattr(e, name))
    return 0.0


class StepProfiler:
    """Wraps a step function: from call ``skip + 1`` on, ``torch.profiler``
    records (to the end of the run) and each call's wall is summed with
    the device synchronized at both ends."""

    def __init__(self, device: torch.device, skip: int = 1):
        self.device, self.skip = device, skip
        self.calls, self.wall_s, self.prof = 0, 0.0, None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def wrap(self, fn):
        def step(*a, **kw):
            self.calls += 1
            if self.calls == self.skip + 1:
                self._sync()
                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
            if self.prof is None:
                return fn(*a, **kw)
            self._sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self._sync()
            self.wall_s += time.perf_counter() - t0
            return out
        return step

    def summary(self) -> dict:
        """Per profiled step: wall, device busy, collectives' host time and
        the copies' device time (ms); the tables by self host and device
        time."""
        if self.prof is None:
            raise RuntimeError("no step ran after the skipped ones")
        self.prof.stop()
        rows = self.prof.key_averages()
        steps = self.calls - self.skip
        busy = sum(_device_us(e) for e in rows)
        # the host events of the ranges (their device-side annotations
        # carry no host time)
        comm = sorted(((e.cpu_time_total, e.count, e.key) for e in rows
                       if e.key.startswith("collective:")
                       and e.cpu_time_total > 0), reverse=True)
        copies = sum(_device_us(e) for e in rows if COPY.search(e.key))

        def table(key):
            try:
                return rows.table(sort_by=key, row_limit=30)
            except (AttributeError, KeyError, ValueError):
                return rows.table(sort_by=key.replace("device", "cuda"),
                                  row_limit=30)
        return dict(
            steps=steps, step_ms=self.wall_s * 1e3 / steps,
            device_busy_ms=busy / 1e3 / steps,
            collective_host_ms=sum(t for t, _, _ in comm) / 1e3 / steps,
            collectives=[(k.split(":", 1)[1], n / steps,
                          round(t / 1e3 / steps, 3)) for t, n, k in comm],
            copy_device_ms=copies / 1e3 / steps,
            host_table=table("self_cpu_time_total"),
            device_table=(table("self_device_time_total")
                          if self.device.type == "cuda" else ""))


def _ranged(name, fn):
    def call(*a, **kw):
        with record_function(f"collective:{name}"):
            return fn(*a, **kw)
    return call


def profiled_rank(ranks, kind: str, merged, cfg, skip: int, kw: dict):
    """One rank: the grid's ``run_pretrain_halo`` (two edge shards) or the
    data-parallel ``run_pretrain``, its steps after ``skip`` profiled and
    each collective in a range of its name.  Returns
    :meth:`StepProfiler.summary` with the rank."""
    from stemgnn_tpu_torch.parallel import data_parallel, halo_pretrain
    from stemgnn_tpu_torch.train.pretrain_loop import run_pretrain
    for name in COLLECTIVES:
        setattr(dist, name, _ranged(name, getattr(dist, name)))
    prof = StepProfiler(ranks.device, skip)
    if kind == "grid":
        real = halo_pretrain.halo_pretrain_step
        halo_pretrain.halo_pretrain_step = prof.wrap(real)
        try:
            halo_pretrain.run_pretrain_halo(merged, cfg, ranks, 2, **kw)
        finally:
            halo_pretrain.halo_pretrain_step = real
    else:
        real = data_parallel.make_dp_pretrain_step
        data_parallel.make_dp_pretrain_step = \
            lambda *a, **k: prof.wrap(real(*a, **k))
        try:
            run_pretrain(merged, cfg, mesh=ranks, device=ranks.device, **kw)
        finally:
            data_parallel.make_dp_pretrain_step = real
    return dict(prof.summary(), rank=ranks.rank, world=ranks.world,
                backend=ranks.backend)


def main(argv=None):
    from stemgnn_tpu_torch import pretrain as pretrain_cli
    from stemgnn_tpu_torch.data.merge import merge_datasets
    from stemgnn_tpu_torch.data.registry import load_dataset
    from stemgnn_tpu_torch.parallel import mesh
    from stemgnn_tpu_torch.profile_pretrain import pretrain_config
    # by its module's name: the ranks unpickle it from there
    from stemgnn_tpu_torch.profile_parallel import profiled_rank as rank_fn
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--feat_dim", type=int, default=768)
    p.add_argument("--grid_nodes", type=int, default=169_343 // 8)
    p.add_argument("--dp_nodes", type=int, default=None,
                   help="the data-parallel graph's nodes (default: the "
                        "dataset's own)")
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--dp_steps", type=int, default=5)
    p.add_argument("--only", choices=("grid", "dp"), default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_parallel: no CUDA device (--device cpu "
                         "runs it on the CPU)")
    d = args.feat_dim
    runs = {}
    if args.only in (None, "grid"):
        small = merge_datasets([load_dataset(
            DATASET, feat_dim=d, seed=SEED,
            num_nodes=args.grid_nodes)])
        cfg = pretrain_cli.make_config(pretrain_cli.parse(
            ["--feat_dim", str(d), "--hidden_dim", str(d), "--code_dim",
             str(d), "--seed", str(SEED), "--epochs",
             str(args.epochs), "--dropout", "0"]))
        runs["grid"] = (4, small, cfg, dict(weights=[1.0], hub_size=2048,
                                            verbose=False))
    if args.only in (None, "dp"):
        ds = load_dataset(DATASET, feat_dim=d, seed=SEED,
                          **({} if args.dp_nodes is None
                             else {"num_nodes": args.dp_nodes}))
        cfg = dataclasses.replace(pretrain_config(d), batch_size=1024,
                                  fanout=10)
        runs["dp"] = (2, merge_datasets([ds]), cfg, dict(
            weights=[1.0], max_steps=args.dp_steps, verbose=False))
    for kind, (world, merged, cfg, kw) in runs.items():
        print(f"{kind}: {mesh.describe_world(world, args.device)}",
              flush=True)
        recs = mesh.spawn(rank_fn, world, args.device, kind, merged, cfg, 1,
                          kw)
        for rec in recs:
            print(f"{kind} rank {rec['rank']}: {rec['steps']} profiled "
                  f"steps; a step: wall {rec['step_ms']:.3f} ms, device "
                  f"busy {rec['device_busy_ms']:.3f} ms, in collectives "
                  f"{rec['collective_host_ms']:.3f} ms of host (name, "
                  f"calls, ms: {rec['collectives']}), device-host copies "
                  f"{rec['copy_device_ms']:.3f} ms of device", flush=True)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                with open(os.path.join(
                        args.out, f"{kind}_rank{rec['rank']}.txt"), "w") as f:
                    f.write(rec["host_table"] + "\n" + rec["device_table"])
        print(f"{kind} rank 0 by self host time:\n{recs[0]['host_table']}",
              flush=True)
        if recs[0]["device_table"]:
            print(f"{kind} rank 0 by self device time:\n"
                  f"{recs[0]['device_table']}", flush=True)
    if args.device == "cuda":
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
