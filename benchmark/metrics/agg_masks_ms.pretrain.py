"""Device ms a step building the dropout's masks (``sg:agg.masks.*``: the
masked hub blocks, the tail keeps and the kept degrees), from the
program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, prefix="sg:agg.masks.")
