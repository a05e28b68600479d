"""The whole unit's share of the chip's dense bf16 peak: the model FLOPs of
the window's units (``work.model_flops``) over the window, in %."""


def read(ctx):
    flops, window = ctx.get("model_flops"), ctx.get("window_s")
    if not flops or not window or not ctx.get("peaks"):
        return None
    return 100.0 * flops * ctx["units"] / window / ctx["peaks"][
        "bf16_dense_flops"]
