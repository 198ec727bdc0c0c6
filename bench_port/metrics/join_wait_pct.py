"""Share of the traced window that the caller of the parity encode spent
in the stream driver's ordered join (``stream.join``: waiting for the
CPU assist's blocks and for each block's host tail, in frame order), in
%."""
from bench_port.lib import spans


def read(ctx):
    recs = spans.window(ctx)
    if not recs:
        return None
    a, b = ctx.trace.start_ns, ctx.trace.end_ns
    joins = spans.named(recs, "stream.join")
    if not joins:
        return None
    ns = sum(max(0, min(r.end_ns, b) - max(r.start_ns, a)) for r in joins)
    return 100.0 * ns / (b - a)
