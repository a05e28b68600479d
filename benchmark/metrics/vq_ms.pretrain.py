"""Device ms a step in the VQ's span (``sg:vq``), from the program's
spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:vq")
