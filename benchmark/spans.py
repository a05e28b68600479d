"""The program's own spans (``stemgnn_tpu_torch.utils.trace``), read for the
per-layer metrics whose source is ``program_span``.

The program records its spans while a ``torch.profiler`` session records,
and the traced run's session covers the measured window alone, so the
program's recorder holds the window's spans.  Every reader returns None
where the program has no such recorder or the span never ran."""

from __future__ import annotations


def totals():
    """The program's span totals by name, or None where it records none."""
    try:
        from stemgnn_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.totals()


def device_ms(ctx: dict, name: str = None, prefix: str = None):
    """Device ms a unit in the spans named ``name``, or in every span whose
    name starts with ``prefix``."""
    if not ctx.get("units"):
        return None
    spans = totals() or {}
    ms = [t["device_ms"] for k, t in spans.items()
          if (k == name or (prefix and k.startswith(prefix)))
          and t["device_ms"] is not None]
    if not ms:
        return None
    return sum(ms) / ctx["units"]


# the profiler's host event while a launch waits for room in the card's
# full launch queue: the host is ahead of the card, not busy
QUEUE_FULL = "Command Buffer Full"


def _merged(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _overlap(start, end, merged):
    return sum(max(0.0, min(end, b) - max(start, a)) for a, b in merged)


def host_ms(ctx: dict, name: str, less: str = None):
    """Host ms a unit inside the profiler's ranges named ``name``, less
    the time inside them covered by the host events named ``less``."""
    trace, units = ctx.get("trace"), ctx.get("units")
    if not trace or not units:
        return None
    ranges = [(start, end) for n, start, end in trace["host"] if n == name]
    if not ranges:
        return None
    waits = _merged((start, end) for n, start, end in trace["host"]
                    if n == less)
    us = sum(end - start - _overlap(start, end, waits)
             for start, end in ranges)
    return us / 1e3 / units


def idle_within(ctx: dict, name: str):
    """Device-idle ms a unit inside the host intervals of the ranges named
    ``name``: the gaps between the trace's merged device intervals,
    intersected with those intervals."""
    trace, units = ctx.get("trace"), ctx.get("units")
    if not trace or not units:
        return None
    ranges = sorted((start, end) for n, start, end in trace["host"]
                    if n == name)
    if not ranges:
        return None
    merged = trace["merged"]
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    return sum(_overlap(start, end, gaps) for start, end in ranges) \
        / 1e3 / units
