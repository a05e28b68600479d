"""Device ms an epoch in the aggregation (``sg:agg``: every layer's
forward, training and evaluation, and the backward), from the program's
spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:agg")
