"""The program's own spans in a traced window, for the per-layer metrics
whose source is ``program_span``.

The program buffers a record of each span it opens while a profiler
session runs, or inside a call given a sink
(``smallz4_tpu_torch.utils.profiling.spans``): name, span id, parent span
id, request id, thread, ``start_ns`` and ``end_ns`` on the clock of the
profiler's host events, and counts.  A program without that function
gives nothing to read, and neither does a run without a trace.
"""
from __future__ import annotations

import importlib


def window(ctx):
    """The program's span records that overlap the traced window, or None
    where there is no trace or the program keeps no spans."""
    if ctx.trace is None:
        return None
    profiling = importlib.import_module("smallz4_tpu_torch.utils.profiling")
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    return spans(ctx.trace.start_ns, ctx.trace.end_ns) or None


def named(records, *names) -> list:
    return [r for r in records if r.name in names]


def self_ns(records) -> dict:
    """span id -> self time in ns: the span's duration less the part of it
    that its children (of any thread) cover."""
    kids: dict = {}
    for r in records:
        kids.setdefault(r.parent_id, []).append((r.start_ns, r.end_ns))
    out = {}
    for r in records:
        covered, edge = 0, r.start_ns
        for a, b in sorted(kids.get(r.span_id, ())):
            a, b = max(a, edge), min(b, r.end_ns)
            if b > a:
                covered += b - a
                edge = b
        out[r.span_id] = r.end_ns - r.start_ns - covered
    return out


def input_mb(records) -> float:
    """Input of the window's requests (the root spans' ``n_bytes``), in
    10^6 bytes."""
    return sum(r.counts.get("n_bytes", 0)
               for r in named(records, "encode")) / 1e6


def staging_ms_per_mb(ctx):
    """Self ms of the resident path's host staging and uploads per input
    MB."""
    recs = window(ctx)
    if not recs or not input_mb(recs):
        return None
    own = self_ns(recs)
    ns = sum(own[r.span_id]
             for r in named(recs, "resident.stage", "resident.upload"))
    return ns / 1e6 / input_mb(recs)
