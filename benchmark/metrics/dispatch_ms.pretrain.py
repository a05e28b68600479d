"""Host ms a step inside the step's span (``sg:pretrain.step``), less the
time the host waits there for room in the card's full launch queue: the
host's own work to enqueue a step, from the profiler's host ranges."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "sg:pretrain.step", less=spans.QUEUE_FULL)
