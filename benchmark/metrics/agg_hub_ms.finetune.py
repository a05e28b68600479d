"""Device ms an epoch in the aggregation's dense hub products
(``sg:agg.hub``), from the program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:agg.hub")
