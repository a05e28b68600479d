"""Device ms an epoch in the training step's span
(``sg:finetune.train_step``), from the program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:finetune.train_step")
