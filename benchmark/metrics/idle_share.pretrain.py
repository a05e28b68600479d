"""The share of the traced window in which no operation ran on the device:
one minus the union of device-activity intervals over the window, in %."""


def read(ctx):
    trace, window = ctx.get("trace"), ctx.get("window_s")
    if not trace or not window:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / window)
