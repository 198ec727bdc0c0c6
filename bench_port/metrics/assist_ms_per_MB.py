"""Host time of the CPU assist's blocks on the parity path: the duration
of the ``host.block`` spans with ``assist`` 1 (a whole host search, DP and
emit each), per MB (10^6 bytes) of those blocks (their ``n_positions``),
in ms per MB."""
from bench_port.lib import spans


def read(ctx):
    recs = spans.window(ctx)
    if not recs:
        return None
    blocks = [r for r in spans.named(recs, "host.block")
              if r.counts.get("assist") == 1]
    mb = sum(b.counts.get("n_positions", 0) for b in blocks) / 1e6
    if not mb:
        return None
    return sum(b.end_ns - b.start_ns for b in blocks) / 1e6 / mb
