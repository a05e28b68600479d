"""The share of the batches' padded node rows that hold no sampled node,
in %: the program's sampler counter (``data.sampler.batch_counts``) over
every batch the run built."""


def read(ctx):
    if not ctx.get("units"):
        return None
    try:
        from stemgnn_tpu_torch.data import sampler
        built = sampler.batch_counts["node_rows"]
    except (ImportError, AttributeError):
        return None
    return 100.0 * sampler.padded_row_share() if built else None
