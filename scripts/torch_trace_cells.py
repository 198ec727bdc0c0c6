"""The program's spans in the benchmark's cells, and what tracing costs.

    python3 scripts/torch_trace_cells.py [--seed N] [--cells a,b,c]
        [--reps R] [--mb MB] [--skip-cost] [--out FILE]

From the root of a checkout, on a CUDA card.  For each cell of
``BENCHMARK.json`` named (default: all) it makes one traced run as
``bench_port/run.py --trace 1`` does (the harness's own code, window
``--seconds 0``), then reads the program's spans of the traced window
(``smallz4_tpu_torch.utils.profiling.spans``):

- each span name's self time, summed over the window's requests, and
  the root ``encode`` span's self time as a share of the requests' time;
- the share of the device's idle time in the window that spans other
  than the root cover (of any thread), and the same for every span;
- on the parity path, which block ends last in each request: the
  device-path block's host tail or a block of the CPU assist;
- the per-layer metrics and the ``breakdown`` of the run's result line.

Then it times the cell's requests (the seed's cycle up to ``--mb`` MB of
input, after a warm pass): tracing off (no profiler, no sink) and spans
on (a sink passed: the spans record, no profiler) in turns request by
request, then passes under a profiler session of the CPU and CUDA
(spans, ``record_function`` on the caller's thread, and the profiler's
own cost); it prints each mode's median request time over the off mode's,
request by request.  Last, the cost of a span with tracing off and of a
recording span, on this host.  Everything goes to ``--out`` as JSON
(default ``smallz4_tpu_torch/build/trace_cells.json``, git-ignored) and
the summary to standard output.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time
import timeit

ROOT = pathlib.Path.cwd()
sys.path.insert(0, str(ROOT))


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def overlap(xs, ys) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def traced_cell(harness, devtrace, profiling, bench, name, seed, log):
    """One traced run of ``name``; returns (result line, span summary)."""
    views = []

    class Keep(devtrace.Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            views.append(self)

    real = devtrace.Trace
    devtrace.Trace = Keep
    try:
        cell = harness.Cell(bench, name)
        result = harness.run(cell, seed, 0.0, True, time.perf_counter(),
                             log=lambda *a, **k: None)
    finally:
        devtrace.Trace = real
    tr = views[-1]
    a, b = tr.start_ns, tr.end_ns
    recs = profiling.spans(a, b)
    own = profiling.self_ns(recs)
    by_name: dict = {}
    for r in recs:
        by_name[r.name] = by_name.get(r.name, 0) + own[r.span_id]
    roots = [r for r in recs if r.name == "encode"]
    req_ns = sum(r.end_ns - r.start_ns for r in roots)
    idle, edge = [], a
    for x, y in tr.busy_intervals():  # sorted, disjoint; clipped here
        x, y = max(x, a), min(y, b)
        if x > edge:
            idle.append([edge, x])
        edge = max(edge, y)
    if b > edge:
        idle.append([edge, b])
    idle_ns = sum(y - x for x, y in idle)

    def clipped(rs):
        return union([max(r.start_ns, a), min(r.end_ns, b)] for r in rs)

    inner = clipped(r for r in recs if r.name != "encode")
    every = clipped(recs)
    last = []
    for root in roots:
        blocks = [r for r in recs if r.name == "host.block"
                  and r.request_id == root.request_id]
        ends = {k: max((r.end_ns for r in blocks
                        if r.counts.get("assist") == k), default=None)
                for k in (0, 1)}
        if ends[0] is not None:
            last.append({
                "last": "assist" if ends[1] and ends[1] > ends[0]
                else "device-path tail",
                "device_tail_end_ms": (ends[0] - root.start_ns) / 1e6,
                "assist_end_ms": (ends[1] - root.start_ns) / 1e6
                if ends[1] else None,
                "request_ms": (root.end_ns - root.start_ns) / 1e6,
                "device_blocks": sum(r.counts.get("assist") == 0
                                     for r in blocks),
                "assist_blocks": sum(r.counts.get("assist") == 1
                                     for r in blocks)})
    summary = {
        "window_s": (b - a) / 1e9, "requests": len(roots),
        "request_s": [(r.end_ns - r.start_ns) / 1e9 for r in roots],
        "self_s": {k: v / 1e9 for k, v in sorted(by_name.items(),
                                                 key=lambda x: -x[1])},
        "root_self_pct_of_requests": 100.0 * by_name.get("encode", 0)
        / max(req_ns, 1),
        "device_idle_s": idle_ns / 1e9,
        "device_idle_pct_of_window": 100.0 * idle_ns / (b - a),
        "idle_covered_by_inner_spans_pct": 100.0 * overlap(idle, inner)
        / max(idle_ns, 1),
        "idle_covered_by_any_span_pct": 100.0 * overlap(idle, every)
        / max(idle_ns, 1),
        "last_block": last,
        "threads": len({r.thread_id for r in recs}),
        "records": len(recs)}
    log(f"{name}: metrics " + json.dumps(result["metrics"]))
    log(f"{name}: breakdown " + json.dumps(result.get("breakdown")))
    log(f"{name}: spans " + json.dumps(summary))
    return result, summary


def cost_of_tracing(harness, profiling, bench, name, seed, reps, mb, log):
    """Median request time of each mode over the off mode's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bench_port.lib import traffic as traffic_mod

    cell = harness.Cell(bench, name)
    threads = torch.get_num_threads()
    torch.set_num_threads(cell.config.get("torch_cpu_threads", threads))
    try:
        entry = harness.bind(cell.op["entry"])
        reqs, total = [], 0
        for req in traffic_mod.Traffic(cell.mix, seed).cycle:
            if total >= mb * 1e6:
                break
            reqs.append(req)
            total += len(req["data"])
        stats_kw = cell.op["entry"].get("stats_kwarg")

        def one(req, mode):
            kw = {}
            if mode == "spans":  # a sink: the spans record
                if stats_kw:
                    kw[stats_kw] = {}
                else:
                    kw["report"] = profiling.RunReport("encode", "")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry(req["data"], **kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        for req in reqs:
            one(req, "off")
        times = {m: [[] for _ in reqs] for m in ("off", "spans", "profiler")}
        # off and spans in turns, request by request (ABBA over reps)
        for k in range(reps):
            for i, req in enumerate(reqs):
                for mode in (("off", "spans"), ("spans", "off"))[k % 2]:
                    times[mode][i].append(one(req, mode))
        # then passes under a profiler session
        for k in range(reps):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                for i, req in enumerate(reqs):
                    times["profiler"][i].append(one(req, "profiler"))
    finally:
        torch.set_num_threads(threads)
    med = {m: [statistics.median(t) for t in ts] for m, ts in times.items()}
    out = {"requests": len(reqs), "reps": reps,
           "off_median_ms": statistics.median(med["off"]) * 1e3,
           "spans_median_ms": statistics.median(med["spans"]) * 1e3}
    for m in ("spans", "profiler"):
        ratios = [x / y for x, y in zip(med[m], med["off"])]
        out[f"{m}_over_off"] = statistics.median(ratios)
        out[f"{m}_over_off_range"] = [min(ratios), max(ratios)]
    log(f"{name}: cost " + json.dumps(out))
    return out


def span_cost(profiling, log):
    """µs a span costs: off (no profiler, no sink), recording inside a
    sink's request (no profiler), and under a profiler session; and the
    calls a recording span makes."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    n = 200_000

    def loop():
        for _ in range(n):
            with profiling.span("x"):
                pass

    def empty():
        for _ in range(n):
            pass

    base = min(timeit.repeat(empty, number=1, repeat=5))
    off = min(timeit.repeat(loop, number=1, repeat=5))
    m = 20_000

    def rec_loop():
        with profiling.request("r", {}):
            for _ in range(m):
                with profiling.span("x"):
                    pass

    on = min(timeit.repeat(rec_loop, number=1, repeat=3))
    with profile(activities=[ProfilerActivity.CPU]):
        prof = min(timeit.repeat(rec_loop, number=1, repeat=3))
    out = {"off_us": (off - base) / n * 1e6, "recording_us": on / m * 1e6,
           "under_profiler_us": prof / m * 1e6}
    for name, fn in (("time_ns", time.time_ns),
                     ("get_native_id", threading.get_native_id),
                     ("profiler_enabled",
                      torch._C._autograd._profiler_enabled)):
        out[f"{name}_us"] = min(timeit.repeat(fn, number=n, repeat=3)) / n \
            * 1e6
    log("span cost " + json.dumps(out))
    return out


def clock_check(profiling, log):
    """The buffered span against its profiler event (CPU and CUDA
    session): ns apart at each end."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import torch.autograd.profiler as ap

    flags = {"has_is_profiler_enabled": hasattr(ap, "_is_profiler_enabled")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        flags["flag_in_session"] = bool(
            getattr(ap, "_is_profiler_enabled", False))
        for _ in range(5):
            with profiling.request("clock check"):
                torch.ones(1 << 20, device="cuda").sum()
    recs = [r for r in profiling.spans() if r.name == "clock check"][-5:]
    evs = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name() == "clock check"), key=lambda e: e.start_ns())
    evs = [e for e in evs if e.device_type() != torch.autograd.DeviceType.CUDA]
    flags["ends_ns"] = [[e.start_ns() - r.start_ns, r.end_ns - e.end_ns()]
                        for e, r in zip(evs, recs)]
    log("clock " + json.dumps(flags))
    return flags


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--cells", default="")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--mb", type=float, default=64.0)
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--out",
                    default="smallz4_tpu_torch/build/trace_cells.json")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from bench_port.lib import devtrace, harness
    from smallz4_tpu_torch.utils import profiling

    def log(*a, **k):
        print(*a, **k, flush=True)

    log(f"card: {devtrace.card_line()}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = ([c for c in args.cells.split(",") if c] if args.cells
             else [w["name"] for w in bench["workloads"]])
    out = {"card": devtrace.card_line(), "torch": torch.__version__,
           "clock": clock_check(profiling, log),
           "span_cost": span_cost(profiling, log), "cells": {}}
    for name in names:
        result, summary = traced_cell(harness, devtrace, profiling, bench,
                                      name, args.seed, log)
        entry = {"result": result, "spans": summary}
        if not args.skip_cost:
            entry["cost"] = cost_of_tracing(
                harness, profiling, bench, name, args.seed + 1, args.reps,
                args.mb, log)
        out["cells"][name] = entry
    path = ROOT / args.out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
