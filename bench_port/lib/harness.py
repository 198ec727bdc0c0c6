"""One run of one cell: set-up, a closed-loop window, the check, the metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(ctx)`` that returns the number, or None
where it finds nothing to read) and ``reference/<name>.py`` (a
``check(kept, ctx)`` that returns the numbers compared, each with its
limit).  The program is reached only through the calls a configuration
names (``"call": "module.function"`` with its ``kwargs``; an optional
``stats_kwarg`` names the keyword that takes a dict of the program's
``n_*`` counters, passed in traced runs only).  A configuration's
``torch_cpu_threads``, where it has one, is the size of torch's CPU
thread pool in the caller's process.  ``faults/<name>.py``
break the timed path for the proof of the check (``install(setattr)``);
the benchmark's own runs never load them.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
import traceback
import types

import numpy as np

from . import devtrace, traffic as traffic_mod

BENCH = pathlib.Path(__file__).resolve().parent.parent


def load_py(kind: str, name: str):
    """``bench_port/<kind>/<name>.py`` as a module."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_port_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bind(spec: dict, extra: dict | None = None):
    """The callable a configuration names, with its keyword arguments."""
    module, fn = spec["call"].rsplit(".", 1)
    f = getattr(importlib.import_module(module), fn)
    kwargs = dict(spec.get("kwargs", {}))
    kwargs.update(extra or {})
    return lambda x, **more: f(x, **kwargs, **more)


class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.cell = cells[name]
        self.name = name
        cfg = {c["name"]: c for c in bench["configs"]}[self.cell["config"]]
        self.config = json.loads((BENCH.parent / cfg["file"]).read_text())
        self.mix = traffic_mod.load(self.cell["traffic"])
        self.op = self.config["ops"][self.mix["op"]]

        def applies(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, t_start: float,
        control: bool = False, device: str = "cuda",
        extra_kwargs: dict | None = None, log=print) -> dict:
    """One run; returns the result line's object."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(cell.config.get("torch_cpu_threads", threads))
    log(f"torch CPU threads {torch.get_num_threads()}")
    try:
        return _run(cell, seed, seconds, trace, t_start, control, device,
                    extra_kwargs, log)
    finally:
        torch.set_num_threads(threads)


def _run(cell, seed, seconds, trace, t_start, control, device, extra_kwargs,
         log):
    import torch
    from torch.profiler import record_function

    op, mix = cell.op, cell.mix
    extra = dict(extra_kwargs or {})
    entry = bind(op["entry"], extra)
    stats_kw = op["entry"].get("stats_kwarg") if trace else None
    prepare = bind(op["prepare"], extra) if "prepare" in op else None
    if control:
        ctl = op["control"]
        if "call" in ctl:
            entry = bind(ctl, extra)
            stats_kw = None
        if ctl.get("alter_output"):
            entry = _altered(entry, np.random.default_rng([seed, 2]))
            stats_kw = None

    tr = traffic_mod.Traffic(mix, seed, prepare)
    decode = mix["op"] == "decode"
    block = cell.config["block_size"]
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    stats: dict = {}
    prof = trace_view = None

    def one(req):
        """Send one request; returns (output, seconds)."""
        x = req["frame"] if decode else req["data"]
        kw = {}
        if stats_kw:
            st = {}
            kw[stats_kw] = st
        t0 = time.perf_counter()
        if prof is not None:  # names the host's part in a trace
            with record_function(devtrace.request_span(mix["op"])):
                out = entry(x, **kw)
        else:
            out = entry(x, **kw)
        t1 = time.perf_counter()
        if kw:
            for k, v in st.items():
                if k.startswith("n_"):
                    stats[k] = stats.get(k, 0) + v
        return out, t1 - t0

    for req in tr.warm():
        one(req)
    sync()
    stats.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    kept = traffic_mod.EachRequest(tr.check_rng)
    records, traced = [], []
    attempted = failed = 0
    first_error = None
    n_trace = mix["trace_requests"] + 2 if trace else 0

    def send(i, req, in_window_span=False):
        nonlocal attempted, failed, first_error
        attempted += 1
        try:
            out, s = one(req)
        except Exception:  # an answer that never comes counts as failed
            failed += 1
            if first_error is None:
                first_error = traceback.format_exc()
            return
        data = req["data"]
        rec = {"data_bytes": len(data),
               "frame_bytes": len(req["frame"] if decode else out),
               "seconds": s, "blocks": max(1, math.ceil(len(data) / block))}
        records.append(rec)
        if in_window_span:
            traced.append(dict(rec, frame=req["frame"] if decode else out))
        kept.offer(i, {"data": data,
                       "frame": req["frame"] if decode else out,
                       "out": out})

    setup_s = time.perf_counter() - t_start
    cpu0 = time.process_time()
    t_window = time.perf_counter()
    sent = 0
    cycle_ends = []
    while True:
        for i, req in enumerate(tr.cycle):
            if sent < n_trace:
                if sent == 0:
                    from torch.profiler import ProfilerActivity, profile
                    acts = [ProfilerActivity.CPU] + (
                        [ProfilerActivity.CUDA] if on_card else [])
                    prof = profile(activities=acts)
                    prof.__enter__()
                    send(i, req)
                elif sent < n_trace - 1:
                    if sent == 1:
                        span = devtrace.window_span(torch) if on_card else \
                            contextlib.nullcontext()
                        span.__enter__()
                    send(i, req, in_window_span=True)
                    if sent == n_trace - 2:
                        span.__exit__(None, None, None)
                else:
                    send(i, req)
                    sync()
                    prof.__exit__(None, None, None)
                    trace_view = devtrace.Trace(prof, torch) if on_card \
                        else None
                    prof = None
            else:
                send(i, req)
            sent += 1
        sync()
        cycle_ends.append(time.perf_counter() - t_window)
        if time.perf_counter() - t_window >= seconds and sent >= n_trace:
            break
    window_s = time.perf_counter() - t_window
    cpu_s = time.process_time() - cpu0
    n_cycle = len(tr.cycle)

    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = None  # the traffic's bytes, but for the kept answers
    if on_card:
        torch.cuda.empty_cache()

    ctx = types.SimpleNamespace(
        records=records, traced=traced, window_s=window_s, setup_s=setup_s,
        stats=stats if stats_kw else None, trace=trace_view,
        block_size=block, config=cell.config, mix=mix, device=device,
        rng=np.random.default_rng([seed, 3]), log=log)

    t0 = time.perf_counter()
    checks = load_py("reference", op["reference"]).check(kept.kept, ctx)
    log(f"check of {len(kept.kept)} answers: {time.perf_counter() - t0} s")
    correct = (failed == 0 and attempted > 0
               and all(v <= lim for _, v, lim in checks))
    if first_error:
        log(first_error, file=sys.stderr)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_py("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    log(f"cores {os.cpu_count()}; requests {len(records)} in "
        f"{window_s} s, {n_cycle} a cycle; set-up {setup_s} s")
    log("cycles end at s: " + " ".join(f"{c:.3f}" for c in cycle_ends))
    if ctx.stats:
        log("counters " + json.dumps(stats, sort_keys=True))
    log(f"window: process CPU {cpu_s} s over {window_s} s")
    if len(records) <= 64:
        log("request s (MiB): " + " ".join(
            f"{r['seconds']:.4f}({r['data_bytes'] / 2**20:.1f})"
            for r in records))
    lat = sorted(r["seconds"] * 1e3 for r in records)
    if lat:
        log(f"latency ms: median {float(np.median(lat))} p95 "
            f"{float(np.percentile(lat, 95))} max {lat[-1]} samples "
            f"{len(lat)}")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(cell.cell["chips"]),
            "memory_peak_bytes": int(memory_peak)}
    else:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 1,
                            "memory_peak_bytes": 0}
    if trace_view is not None:
        result["device"]["busy_s"] = trace_view.busy_s
        result["device"]["window_s"] = trace_view.window_s
        result["breakdown"] = trace_view.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    return result


def _altered(fn, rng):
    """``fn`` with one byte of each answer changed (the control of a
    configuration whose guarantee is exact bytes)."""
    def wrapped(x, **kw):
        out = bytearray(fn(x, **kw))
        # past a frame's 7-byte header and before its end mark
        k = int(rng.integers(min(7, len(out) - 1),
                             max(len(out) - 4, min(8, len(out)))))
        out[k] ^= 0x20
        return bytes(out)
    return wrapped
