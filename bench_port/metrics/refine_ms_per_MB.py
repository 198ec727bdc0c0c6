"""Host time of the refine on the parity path's device-path blocks: the
self time of the ``host.refine`` and ``host.dist_fix`` spans under a
``host.block`` span with ``assist`` 0, per MB (10^6 bytes) of those
blocks (their ``n_positions``), in ms per MB."""
from bench_port.lib import spans


def read(ctx):
    recs = spans.window(ctx)
    if not recs:
        return None
    blocks = {r.span_id: r for r in spans.named(recs, "host.block")
              if r.counts.get("assist") == 0}
    mb = sum(b.counts.get("n_positions", 0) for b in blocks.values()) / 1e6
    if not mb:
        return None
    own = spans.self_ns(recs)
    ns = sum(own[r.span_id]
             for r in spans.named(recs, "host.refine", "host.dist_fix")
             if r.parent_id in blocks)
    return ns / 1e6 / mb
