"""Device ms an epoch in the evaluation forward's span (``sg:finetune.eval``),
from the program's spans: the in-program counterpart of ``eval_ms``."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:finetune.eval")
