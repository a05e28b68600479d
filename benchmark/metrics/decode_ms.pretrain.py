"""Device ms a step in the losses' spans (``sg:pretrain.losses``: the
decoders, the projector and the loss terms), from the program's spans."""

from benchmark import spans


def read(ctx):
    return spans.device_ms(ctx, "sg:pretrain.losses")
