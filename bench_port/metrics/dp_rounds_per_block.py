"""Policy-iteration rounds of the device DP per block of the
device-resident encode: the ``n_dp_rounds`` counts of the window's
``resident.sync`` spans (one a block, read with the block's output size),
over the number of those spans."""
from bench_port.lib import spans


def read(ctx):
    recs = spans.window(ctx)
    if not recs:
        return None
    syncs = spans.named(recs, "resident.sync")
    if not syncs:
        return None
    return sum(r.counts.get("n_dp_rounds", 0) for r in syncs) / len(syncs)
