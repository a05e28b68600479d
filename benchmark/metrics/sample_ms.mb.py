"""Host ms a step inside the program's ``sg:batch.sample`` ranges: the
host sampler drawing the next batch's neighbours and padding its ids."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "sg:batch.sample")
