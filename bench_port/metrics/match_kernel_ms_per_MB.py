"""Device time of the match's hand kernels (record sort and merge, probe,
compaction, chain) per MB of input, from the traced window's kernel
records, in ms per 10^6 bytes."""

KERNELS = ("sort_tiles_kernel", "merge_pass_kernel", "probe_kernel",
           "compact_cluster_kernel", "chain_cluster_kernel",
           "chain_step_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    s, n = ctx.trace.kernel_s(KERNELS)
    if n == 0:
        return None
    return s * 1e3 / (sum(r["data_bytes"] for r in ctx.traced) / 1e6)
