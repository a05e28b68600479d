"""Device ms a step in the EMA teacher's forward (``sg:pretrain.teacher``),
from the program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:pretrain.teacher")
