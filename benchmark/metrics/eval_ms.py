"""Device ms of an epoch's evaluation forward (CUDA events around
``eval_step``), the mean over the traced window's epochs."""


def read(ctx):
    ms = ctx.get("eval_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
