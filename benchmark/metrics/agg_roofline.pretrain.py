"""Layer 1's aggregation through ``ops.spmm.sage_aggregate`` (forward and
backward, the cell's layout) against its least time on the chip: the larger
of its bytes over the HBM rate and its operations over the dense peak
(``work.aggregation``), over the time CUDA events give it, in %."""


def read(ctx):
    agg, peaks = ctx.get("aggregation"), ctx.get("peaks")
    if not agg or not peaks or not agg.get("seconds"):
        return None
    bound = max(agg["bytes"] / peaks["hbm_bytes_per_s"],
                agg["flops"] / peaks["bf16_dense_flops"])
    return 100.0 * bound / agg["seconds"]
