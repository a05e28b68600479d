"""Layer 1's aggregation of one sampled batch through
``ops.spmm.sage_aggregate`` (forward and backward on the route without a
layout: gathers and ``index_add_``, the pair-hash dropout in the edge mask)
against its least time on the chip: the larger of its bytes over the HBM
rate and its operations over the dense peak (``work.aggregation``), over
the time CUDA events give it, in %."""


def read(ctx):
    agg, peaks = ctx.get("aggregation"), ctx.get("peaks")
    if not agg or not peaks or not agg.get("seconds"):
        return None
    bound = max(agg["bytes"] / peaks["hbm_bytes_per_s"],
                agg["flops"] / peaks["bf16_dense_flops"])
    return 100.0 * bound / agg["seconds"]
