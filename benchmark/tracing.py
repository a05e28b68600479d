"""The traced run: ``torch.profiler`` over the measured window, reduced to
the device's busy time, the kernels by name and the idle gaps by what the
host was doing, plus the spans the benchmark itself records around the
calls into each layer (``bench:*``).

Device activity is every event the profiler puts on the device (kernels,
copies, sets) other than the annotation ranges that mirror the host's
``record_function`` spans there, which span kernels and idle time alike.
Busy time is the union of those events' intervals."""

from __future__ import annotations

import contextlib

import torch

# device kernels of dense products, by name (profile_pretrain.GROUPS)
GEMM_PATTERNS = ("gemm", "nvjet", "xmma", "cutlass", "Gemm")
SPAN = "bench:"


def span(name: str):
    """A host span of the benchmark's own, visible in the trace."""
    return torch.profiler.record_function(SPAN + name)


@contextlib.contextmanager
def profiled(on: bool):
    """``torch.profiler`` over the body when ``on``; yields the profiler or
    None."""
    if not on:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield prof


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def summarize(prof, window_start_us: float = None) -> dict:
    """``{"kernels": [(name, start_us, dur_us)], "busy_s", "host": [(name,
    start_us, end_us, depth)]}`` of a finished profile."""
    events = list(prof.events())
    host = [e for e in events if not _on_device(e)]
    host_names = {e.name for e in host}
    kernels = [(e.name, float(e.time_range.start),
                float(e.time_range.end - e.time_range.start))
               for e in events if _on_device(e) and e.name not in host_names
               and e.time_range.end > e.time_range.start]
    kernels.sort(key=lambda k: k[1])
    merged = []
    for _, s, d in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    busy_us = sum(b - a for a, b in merged)
    spans = [(e.name, float(e.time_range.start), float(e.time_range.end))
             for e in host]
    return dict(kernels=kernels, busy_s=busy_us / 1e6, merged=merged,
                host=spans)


def dense_ms(trace: dict, units: int) -> float:
    """Device ms a unit in dense-product kernels."""
    us = sum(d for name, _, d in trace["kernels"]
             if any(p in name for p in GEMM_PATTERNS))
    return us / 1e3 / units


def device_ops(trace: dict, top: int = 10) -> list:
    """The ``top`` device operations by total seconds."""
    tot = {}
    for name, _, d in trace["kernels"]:
        tot[name] = tot.get(name, 0.0) + d / 1e6
    return sorted(([k[:200], v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:top]


def idle_gaps(trace: dict, top: int = 10) -> list:
    """The ``top`` longest gaps between device activity, each named by the
    benchmark span and the innermost host operation that were running when
    it began."""
    merged = trace["merged"]
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    host = trace["host"]
    out = []
    for dur, at in gaps:
        live = [h for h in host if h[1] <= at < h[2]]
        ours = [h for h in live if h[0].startswith(SPAN)]
        inner = min(live, key=lambda h: h[2] - h[1])[0] if live else "idle"
        outer = min(ours, key=lambda h: h[2] - h[1])[0] if ours else "-"
        out.append([f"{outer} > {inner}"[:200], dur / 1e6])
    return out


def kernel_launches() -> dict:
    """The program's own count of its CUDA kernels' launches, by name
    (``ops.scatter.launch_counts``), as it stands now."""
    from stemgnn_tpu_torch.ops import scatter
    return dict(scatter.launch_counts)


def launches_per_unit(before: dict, units: int) -> dict:
    """Launches a unit since ``before``: the route the window took."""
    now = kernel_launches()
    return {k: (now[k] - before.get(k, 0)) / units for k in now}
