"""Device-idle ms an epoch while the host scores the predictions: the gaps
between the trace's device activity that fall inside the host intervals of
``sg:metrics.score``."""

from benchmark import spans


def read(ctx):
    return spans.idle_within(ctx, "sg:metrics.score")
