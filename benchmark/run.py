"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<name>.json``, its plain reference beside it as
``<name>.py``) and a traffic mix (``benchmark/traffic/<name>.json``), whose
``driver`` names the module under ``benchmark/drivers/`` that sets the
program up and runs one unit of its work.  A run:

  1. set-up (``setup_s``, from this process's start): the graph and the
     program's model from the seed, and the first checked units through
     the window's own call, which also warms up every shape;
  2. the window: units until ``--seconds`` have passed, ending in a
     device sync; ``--trace 1`` runs it under ``torch.profiler`` and
     reports the per-layer metrics instead of the end-to-end ones;
  3. the comparison: the program's state is freed, the plain reference
     runs the checked units from the same weights, inputs and draws, and
     each number compared is printed beside its limit
     (``benchmark/limits/<workload>.json``), on standard error and last in
     the result line.

The result is the last line of standard output, one JSON object.  The run
exits non-zero and prints no result without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# the program's compile caches stay inside the checkout, at fixed paths
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(HERE, "_cache", _sub)
os.environ["USE_FLAX"] = "0"

import torch  # noqa: E402

from benchmark import common, compare, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "stemgnn_tpu")
AGG_REPS = 20


def parse(argv=None):
    p = argparse.ArgumentParser("benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def loaded_forbidden() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name (``stemgnn_tpu_torch`` is not ``stemgnn_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def peaks_for(kind: str) -> dict:
    table = common.load_json(os.path.join(HERE, "peaks.json"))
    for key, row in table.items():
        if key in kind:
            return row
    return None


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as ex:
        return f"nvidia-smi unavailable: {ex}"


def time_aggregation(run) -> float:
    """Seconds a call of ``run`` by CUDA events, after a warm-up."""
    for _ in range(3):
        run()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(AGG_REPS):
        run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / AGG_REPS


def run_cell(w: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", log=sys.stderr) -> dict:
    """One run of the cell ``w`` (``common.cell``); returns the result
    object.  ``device="cpu"`` drives the same steps through the kernels'
    plain versions (the tests' route; no device metric is read there)."""
    driver = __import__(f"benchmark.drivers.{w['traffic_mix']['driver']}",
                        fromlist=["Cell"])
    on_card = torch.device(device).type == "cuda"
    cell = driver.Cell(w, seed, device)
    t_before = time.perf_counter() - T_START
    cell.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    if trace and hasattr(cell, "time_evaluations"):
        cell.time_evaluations()
    launches0 = tracing.kernel_launches()
    units = 0
    with tracing.profiled(trace and on_card) as prof:
        t0 = time.perf_counter()
        while True:
            with tracing.span(driver.UNIT):
                cell.step()
            units += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    launches = tracing.launches_per_unit(launches0, units)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = cell.failed()

    metrics, extra = {}, {}
    if not trace:
        per_unit_ms = 1e3 * window_s / units
        values = {"step_ms": per_unit_ms, "epoch_ms": per_unit_ms,
                  "peak_mem_gb": peak / 1e9, "setup_s": setup_s}
        for m in w["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif on_card:
        peaks = peaks_for(torch.cuda.get_device_name(0))
        summary = tracing.summarize(prof)
        agg = dict(cell.aggregation_work())
        agg["seconds"] = time_aggregation(cell.aggregation_call())
        ctx = dict(trace=summary, units=units, window_s=window_s,
                   peaks=peaks, model_flops=cell.model_flops(),
                   aggregation=agg,
                   eval_ms=cell.eval_ms() if hasattr(cell, "eval_ms")
                   else None)
        for m in w["per_layer"]:
            value = common.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = dict(busy_s=summary["busy_s"], window_s=window_s)
        breakdown = {"device_ops": tracing.device_ops(summary),
                     "idle_gaps": tracing.idle_gaps(summary)}
        if peaks:
            f32 = (100.0 * ctx["model_flops"] * units / window_s
                   / peaks["f32_flops"])
            print(f"model FLOPs a {driver.UNIT} {ctx['model_flops']:.6e}; "
                  f"share of the 67 TFLOP/s f32 peak {f32:.4f}% (for "
                  f"reading only)", file=log)
        print(f"aggregation: {agg}", file=log)
        print(f"kernel launches a {driver.UNIT}: {launches}", file=log)

    # the comparison, once the program's state is freed
    t_ref = time.perf_counter()
    cell.release()
    ref = common.reference_module(w["config_entry"]["file"])
    ref_out = cell.reference(ref)
    opts = {k[1:]: v for k, v in w["limits"].items() if k.startswith("_")}
    readings = cell.readings(ref_out, **opts)
    correct, checks = compare.judge(readings, w["limits"])
    print(f"set-up stages (s): before the cell {t_before:.3f}, "
          f"{cell.host.get('stages')}", file=log)
    print(f"reference: {time.perf_counter() - t_ref:.1f} s; leaves "
          f"{readings.get('_leaves')}", file=log)

    result = {"correct": bool(correct and failed == 0), "attempted": units,
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_card
                                  else "cpu"),
                         "count": 1, "memory_peak_bytes": int(peak),
                         **extra}}
    if trace and on_card:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=log)
    return result


def main(argv=None) -> int:
    args = parse(argv)
    w = common.cell(args.workload)
    need = int(w["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: {need} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", file=sys.stderr)
    result = run_cell(w, args.seed, args.seconds, bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
