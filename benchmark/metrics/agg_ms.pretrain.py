"""Device ms a step in the aggregation (``sg:agg``: every layer's
forward, student and teacher, and the student's backward), from the
program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:agg")
