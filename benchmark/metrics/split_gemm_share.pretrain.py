"""The share of ``Linear``'s product FLOPs that took the split-TF32 tensor
core kernel, in %: the program's counter (``ops.split_gemm.flop_counts``:
FLOPs by route, the kernel's or the reason they went to ``torch.matmul``)
over every product of the run, set-up's units and the window's alike."""


def read(ctx):
    if not ctx.get("units"):
        return None
    try:
        from stemgnn_tpu_torch.ops import split_gemm
        counts = split_gemm.flop_counts
    except (ImportError, AttributeError):
        return None
    total = sum(counts.values())
    return 100.0 * counts["kernel"] / total if total else None
