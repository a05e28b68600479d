"""Device-idle ms a step while the host builds the next batch: the gaps
between the trace's device activity inside the host ranges of the
program's ``sg:batch.sample``, ``sg:batch.layout`` and
``sg:batch.transfer`` spans (``spans.idle_within`` over the three names,
in one sweep: a window holds ~400 such ranges and ~10^5 gaps)."""

NAMES = ("sg:batch.sample", "sg:batch.layout", "sg:batch.transfer")


def read(ctx):
    trace, units = ctx.get("trace"), ctx.get("units")
    if not trace or not units:
        return None
    # one thread opens these spans one after another: they do not overlap
    ranges = sorted((start, end) for n, start, end in trace["host"]
                    if n in NAMES)
    if not ranges:
        return None
    merged = trace["merged"]
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    us, first = 0.0, 0
    for start, end in ranges:
        while first < len(gaps) and gaps[first][1] <= start:
            first += 1
        k = first
        while k < len(gaps) and gaps[k][0] < end:
            us += max(0.0, min(end, gaps[k][1]) - max(start, gaps[k][0]))
            k += 1
    return us / 1e3 / units
