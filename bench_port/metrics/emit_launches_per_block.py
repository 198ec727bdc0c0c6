"""Kernel launches of the device-resident encode's emit per block: the
trace's host launch records (runtime calls whose name starts with ``cu``
and holds ``Launch``) that start inside a ``resident.emit`` span (the host
enqueue of the block's sequence emit), over the number of those spans."""
import bisect

from bench_port.lib import spans


def read(ctx):
    recs = spans.window(ctx)
    if not recs:
        return None
    emits = spans.named(recs, "resident.emit")
    if not emits:
        return None
    starts = sorted(s for n, s, _ in ctx.trace.host
                    if n.startswith("cu") and "Launch" in n)
    launches = sum(bisect.bisect_right(starts, r.end_ns)
                   - bisect.bisect_left(starts, r.start_ns) for r in emits)
    return launches / len(emits)
