"""Host ms a step inside the program's ``sg:batch.transfer`` ranges: the
batch's ids copied to the card through pinned buffers and its features
gathered from the resident table."""

from benchmark import spans


def read(ctx):
    return spans.host_ms(ctx, "sg:batch.transfer")
