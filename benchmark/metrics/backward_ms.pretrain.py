"""Device ms a step in the backward (``sg:train.backward``), from the
program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:train.backward")
