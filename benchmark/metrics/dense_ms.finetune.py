"""Device ms a unit in dense-product kernels (GEMM kernel names), from the
profiler's trace of the window."""

from benchmark import tracing


def read(ctx):
    if not ctx.get("trace") or not ctx.get("units"):
        return None
    return tracing.dense_ms(ctx["trace"], ctx["units"])
