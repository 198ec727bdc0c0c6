"""The port's tracing: spans and counters at the encode paths' layer
boundaries, a run report, and a ``torch.profiler`` trace of one call.

``span(name, **counts)`` is a context manager around one step of a call;
its handle takes ``.count(**kv)`` for counts known only at the end.  A
call's entry opens ``request(name, sink, **counts)``, the root span, which
starts a new request id.  A span's parent is the thread's current span;
work handed to a thread pool gets its parent passed as ``parent=``, since
the pool carries no context.  A record holds the name, span id, parent
span id, request id, the thread's native id, ``start_ns``, ``end_ns`` and
the counts.

Spans record while a ``torch.profiler`` session runs in the process, or
inside a request given a sink; otherwise a span is one flag check and no
allocation, clock read or ``record_function``.  The clock is
``time.time_ns()``, the clock of the profiler's host events.  On the
thread that runs the profiler session a recording span also opens
``torch.profiler.record_function(name)``, so the session's own trace names
host time by the program's spans; spans of other threads (which
``record_function`` does not reach in such a session) are in the buffer
only.  Records go to a bounded ring (``CAPACITY``); ``spans(start_ns,
end_ns)`` returns those that overlap a window.  When a request ends, its
sink (a dict) receives the summed self seconds of each span name under
that name; a span's self time is its duration less the part of it that
its children, of any thread, cover.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import pathlib
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 32768  # records kept; the oldest go first


class _Local(threading.local):
    """A thread's current span and native id (read once: the system call
    costs microseconds in a virtual machine)."""
    top = None

    def __init__(self):
        self.tid = threading.get_native_id()


_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_local = _Local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


class _Off:
    """The span of a call that is not traced: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def count(self, **kv):
        return None


OFF = _Off()


class _Request:
    """One request: its id, its sink and, with a sink, its records."""

    def __init__(self, sink):
        self.id = next(_request_ids)
        self.sink = sink
        self.records = []


class Span:
    """One recording span; closed spans are the buffer's records."""

    __slots__ = ("name", "span_id", "parent_id", "request_id", "thread_id",
                 "start_ns", "end_ns", "counts", "_req", "_root", "_prev",
                 "_rf")

    def __init__(self, name, parent, counts, req=None):
        self.name = name
        self.span_id = next(_span_ids)
        self.parent_id = parent.span_id if parent is not None else 0
        self._root = req is not None
        if req is None and parent is not None:
            req = parent._req
        self._req = req
        self.request_id = req.id if req is not None else 0
        self.counts = counts
        self.start_ns = self.end_ns = 0

    def count(self, **kv):
        """Adds ``kv`` to the span's counts."""
        for k, v in kv.items():
            self.counts[k] = self.counts.get(k, 0) + v

    def __enter__(self):
        self.thread_id = _local.tid
        self._prev = _local.top
        _local.top = self
        self._rf = None
        if torch._C._autograd._profiler_enabled():  # the session's thread
            self._rf = torch.profiler.record_function(self.name)
            self.start_ns = time.time_ns()
            self._rf.__enter__()
        else:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        self.end_ns = time.time_ns()
        _local.top = self._prev
        self._prev = None
        req = self._req
        with _lock:
            _ring.append(self)
            if req is not None and req.sink is not None:
                req.records.append(self)
        if self._root and req.sink is not None:
            for name, s in self_seconds(req.records).items():
                req.sink[name] = req.sink.get(name, 0.0) + s
            req.sink, req.records = None, []  # the ring holds no sink
        return None


def span(name: str, parent=None, **counts):
    """A span under ``parent`` (a span handle, for work handed to another
    thread) or the thread's current span; records while its parent does or
    a profiler session runs, and is ``OFF`` otherwise."""
    if parent is None:
        parent = _local.top
    elif parent is OFF:
        parent = None
    if parent is None and not _autograd_profiler._is_profiler_enabled:
        return OFF
    return Span(name, parent, counts)


def request(name: str, sink: dict | None = None, **counts):
    """The root span of one call, under a new request id; records while a
    profiler session runs, inside a recording span, or when ``sink`` is
    given, which then receives the request's self seconds by span name."""
    parent = _local.top
    if (parent is None and sink is None
            and not _autograd_profiler._is_profiler_enabled):
        return OFF
    return Span(name, parent, counts, _Request(sink))


def current():
    """The thread's current span (``OFF`` when none records), to pass as
    ``parent=`` to work handed to another thread."""
    return _local.top or OFF


def spans(start_ns: int = 0, end_ns: int | None = None) -> list:
    """The buffered records that overlap [start_ns, end_ns)."""
    end_ns = time.time_ns() if end_ns is None else end_ns
    with _lock:
        return [r for r in _ring
                if r.end_ns > start_ns and r.start_ns < end_ns]


def self_ns(records) -> dict:
    """span id -> self time in ns: the span's duration less the union of
    its children's intervals (of any thread) inside it."""
    kids = collections.defaultdict(list)
    for r in records:
        kids[r.parent_id].append((r.start_ns, r.end_ns))
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


def self_seconds(records) -> dict:
    """Summed self seconds of each span name of ``records``."""
    own = self_ns(records)
    out: dict = {}
    for r in records:
        out[r.name] = out.get(r.name, 0.0) + own[r.span_id] / 1e9
    return out


@dataclasses.dataclass
class RunReport:
    """Structured codec run report."""
    operation: str                 # "encode" | "decode"
    engine: str
    bytes_in: int = 0
    bytes_out: int = 0
    blocks: int = 0
    chips: int = 1
    wall_s: float = 0.0
    # self seconds by span name (the sink of the call's request)
    stages: dict = dataclasses.field(default_factory=dict)
    # engine counters (n_*: byte and position counts)
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.bytes_out / self.bytes_in if self.bytes_in else 0.0

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ratio"] = round(self.ratio, 4)
        return json.dumps(d)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """Trace what runs inside the block with ``torch.profiler`` (the CPU
    and, where there is one, the CUDA device) into ``log_dir/trace.json``
    (Chrome trace format), with the buffered spans of every thread added
    as host events (category ``program_span``, counts and ids in ``args``)
    on their own threads; no trace when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    t1 = time.time_ns()
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)  # ts: µs past this
    pid = os.getpid()
    trace["traceEvents"] += [
        {"ph": "X", "cat": "program_span", "name": r.name, "pid": pid,
         "tid": r.thread_id, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": dict(r.counts, span_id=r.span_id, parent_id=r.parent_id,
                      request_id=r.request_id)}
        for r in spans(t0, t1)]
    path.write_text(json.dumps(trace))
