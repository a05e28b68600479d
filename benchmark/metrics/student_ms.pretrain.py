"""Device ms a step in the student's span (``sg:pretrain.student``: the
draws, the augmented view and the student encoder), from the program's
spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:pretrain.student")
