"""The port's tracing (smallz4_tpu_torch/utils/profiling.py) inside its two
encode paths, on the CPU.

Off (no profiler session, no sink) a span is a flag check: nothing is
buffered and ``record_function`` is never entered.  Under a CPU
``torch.profiler`` session every span of the parity path
(``pipeline.compress``, chunk engine at C = 1024, CPU assist on) and of
the resident path (``compress_device_resident``) is buffered: the pool
threads' spans carry the request id of the call's root and a parent,
every child lies inside its parent, no self time is negative, and the
root's buffered record agrees with its profiler event.  The spans' counts
equal the stream driver's counters and the DP's round counts.
"""
import json
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from smallz4_tpu_torch import native
from smallz4_tpu_torch.ops import chunkmatch as tcm
from smallz4_tpu_torch.ops import parse, pipeline
from smallz4_tpu_torch.utils import profiling

C = 1024
PARITY_SPANS = {"encode", "stream.dispatch", "stream.group", "stream.collect",
                "stream.join", "host.block", "host.unpack", "host.refine",
                "host.dp", "host.dist_fix", "host.emit"}
RESIDENT_SPANS = {"encode", "resident.stage", "resident.upload",
                  "resident.match", "resident.dp", "resident.emit",
                  "resident.sync", "resident.fetch", "resident.fallback",
                  "host.refine", "host.dp", "host.emit"}
POOL_SPANS = {"host.block", "host.unpack", "host.refine", "host.dp",
              "host.dist_fix", "host.emit"}


def _mixed(n, seed=5):
    """tests/test_torch_pipeline.py's generator: random bytes, text-like
    runs, repeats of earlier parts and byte runs."""
    rng = np.random.default_rng(seed)
    parts = []
    while sum(map(len, parts)) < n:
        r = rng.random()
        if r < 0.3:
            parts.append(bytes(rng.integers(0, 256, 200, dtype=np.uint8)))
        elif r < 0.6:
            parts.append(bytes(rng.integers(97, 103, 300, dtype=np.uint8)))
        elif r < 0.8 and parts:
            parts.append(parts[rng.integers(0, len(parts))])
        else:
            parts.append(bytes([rng.integers(0, 256)])
                         * int(rng.integers(5, 200)))
    return b"".join(parts)[:n]


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """The chunk engine at C = 1024, one chunk a group; torch on one
    thread (the plain versions run many small operations)."""
    monkeypatch.setattr(tcm, "CHUNK", C)
    monkeypatch.setattr(tcm, "GROUP", 1)
    monkeypatch.setattr(tcm, "HEAD_CAP", C)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _parity(data, **kw):
    return pipeline.compress(data, 9, device="cpu", block_size=2 * C, **kw)


def _resident(data, **kw):
    return pipeline.compress_device_resident(data, block_size=2 * C,
                                             device="cpu", **kw)


def _request(records, root):
    return [r for r in records if r.request_id == root.request_id]


def _roots(records):
    return [r for r in records if r.name == "encode"]


def _check_tree(records):
    """Parents exist in the request, children lie inside their parents,
    self times are not negative."""
    by_id = {r.span_id: r for r in records}
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.name == "encode":
            continue
        p = by_id[r.parent_id]
        assert p.request_id == r.request_id
        assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (
            r.name, p.name)
    assert min(profiling.self_ns(records).values()) >= 0


def test_off_buffers_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "1")
    before = profiling.spans()
    data = _mixed(6 * C + 100, seed=17)
    assert native.decompress(_parity(data, parity=False)) == data
    assert native.decompress(_resident(data)) == data
    assert profiling.span("x") is profiling.OFF
    assert profiling.request("x") is profiling.OFF
    assert profiling.spans() == before


@pytest.fixture(scope="module")
def traced():
    """Both paths under one CPU profiler session: a parity block on the
    device path, blocks the CPU assist takes, and a resident encode (one
    call with a block forced through the host fallback)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(tcm, "CHUNK", C)
    mp.setattr(tcm, "GROUP", 1)
    mp.setattr(tcm, "HEAD_CAP", C)
    mp.setenv("SMALLZ4_TPU_CPU_ASSIST", "1")
    rounds = []
    real_dp = parse.policy_iteration

    def dp(*a, **k):
        out = real_dp(*a, **k)
        rounds.append(int(out[3]))
        return out

    mp.setattr(parse, "policy_iteration", dp)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one = _mixed(2 * C)
    many = _mixed(6 * C + 100, seed=17)
    stats_one, stats_many = {}, {}
    _parity(one)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # a session's first costs more
            pass
        frames = [_parity(one, stats=stats_one),
                  _parity(many, parity=False, stats=stats_many),
                  _resident(many)]
        real_step = pipeline._device_resident_block_step

        def capped(*a):  # the DP's round cap on the first block
            halo, payload, n_out, ok, r = real_step(*a)
            return halo, payload, n_out, torch.tensor(False), r

        mp.setattr(pipeline, "_device_resident_block_step", capped)
        frames.append(_resident(one))
    mp.undo()
    torch.set_num_threads(threads)
    records = profiling.spans()
    roots = _roots(records)[-4:]
    yield types.SimpleNamespace(
        frames=frames, data=[one, many, many, one], prof=prof,
        records=records, roots=roots,
        reqs=[_request(records, r) for r in roots],
        stats=[stats_one, stats_many], rounds=rounds)


def test_traced_streams_decode(traced):
    for frame, data in zip(traced.frames, traced.data):
        assert native.decompress(frame) == data
    assert traced.frames[0] == native.compress(traced.data[0], 9,
                                               block_size=2 * C)


def test_every_span_of_both_paths_is_buffered(traced):
    parity = {r.name for q in traced.reqs[:2] for r in q}
    resident = {r.name for q in traced.reqs[2:] for r in q}
    assert parity == PARITY_SPANS
    assert resident == RESIDENT_SPANS
    assert len({r.request_id for r in traced.roots}) == 4


@pytest.mark.parametrize("k", range(4))
def test_spans_nest_within_their_request(traced, k):
    req = traced.reqs[k]
    root = traced.roots[k]
    _check_tree(req)
    assert sum(r.name == "encode" for r in req) == 1
    assert root.counts["n_bytes"] == len(traced.data[k])
    assert root.counts["n_blocks"] == -(-len(traced.data[k]) // (2 * C))


def test_pool_spans_carry_the_request_and_a_parent(traced):
    main = threading.get_native_id()
    for req, root in zip(traced.reqs[:2], traced.roots[:2]):
        pool = [r for r in req if r.name in POOL_SPANS]
        assert pool and all(r.thread_id != main for r in pool)
        assert all(r.request_id == root.request_id and r.parent_id
                   for r in pool)
        blocks = [r for r in pool if r.name == "host.block"]
        assert all(r.parent_id == root.span_id for r in blocks)
    assists = [r.counts["assist"] for r in traced.reqs[1]
               if r.name == "host.block"]
    assert 1 in assists and 0 in assists
    on_main = {r.name for q in traced.reqs[:2] for r in q
               if r.thread_id == main}
    assert not on_main & POOL_SPANS
    # the resident fallback runs the host tail on the calling thread
    by_id = {r.span_id: r for r in traced.reqs[3]}
    tail = [r for r in traced.reqs[3] if r.name.startswith("host.")]
    assert {r.name for r in tail} == {"host.refine", "host.dp", "host.emit"}
    assert all(r.thread_id == main
               and by_id[r.parent_id].name == "resident.fallback"
               for r in tail)


def test_root_record_agrees_with_its_profiler_event(traced):
    """The buffered root and the profiler's event of the same span (opened
    on the session's thread) agree within 100 µs at both ends."""
    events = [e for e in traced.prof.profiler.kineto_results.events()
              if e.name() == "encode"]
    assert len(events) == 4
    for e, r in zip(sorted(events, key=lambda e: e.start_ns()),
                    traced.roots):
        assert abs(e.start_ns() - r.start_ns) < 100_000
        assert abs(e.end_ns() - r.end_ns) < 100_000


def test_refine_counts_equal_the_counters(traced):
    for req, stats in zip(traced.reqs[:2], traced.stats):
        by_id = {r.span_id: r for r in req}
        device = [r.counts["n_refine_positions"] for r in req
                  if r.name == "host.refine"
                  and by_id[r.parent_id].counts["assist"] == 0]
        assert device and sum(device) == stats["n_refine_positions"]
        fix = sum(r.counts["n_dist_fix_positions"] for r in req
                  if r.name == "host.dist_fix")
        assert fix == stats.get("n_dist_fix_positions", 0)


def test_dp_rounds_equal_the_dp(traced):
    sync = [r.counts["n_dp_rounds"] for q in traced.reqs[2:] for r in q
            if r.name == "resident.sync"]
    assert sync == traced.rounds and len(sync) == 4 + 1


def test_byte_counts_equal_the_counters():
    rep = profiling.RunReport(operation="encode", engine="")
    data = _mixed(6 * C + 100, seed=3)
    with profile(activities=[ProfilerActivity.CPU]):
        frame = _resident(data, report=rep)
    assert native.decompress(frame) == data
    req = _request(profiling.spans(), _roots(profiling.spans())[-1])
    for name, key in (("resident.upload", "n_h2d_bytes"),
                      ("resident.fetch", "n_d2h_bytes")):
        assert sum(r.counts[key] for r in req if r.name == name) == \
            rep.counters[key]


def test_sink_receives_self_seconds_by_name(traced):
    for req, stats in zip(traced.reqs[:2], traced.stats):
        own = profiling.self_seconds(req)
        assert set(own) == {r.name for r in req}
        for name, s in own.items():
            assert stats[name] == pytest.approx(s)
        assert not {k for k in stats if not k.startswith("n_")} - set(own)


def test_a_sink_records_without_a_profiler():
    stats = {}
    before = profiling.spans()
    _parity(_mixed(2 * C), stats=stats)
    names = {k for k in stats if not k.startswith("n_")}
    assert names == PARITY_SPANS  # one block: no assist, no wholesale
    req = [r for r in profiling.spans() if r not in before]
    assert {r.name for r in req} == names
    assert len({r.request_id for r in req}) == 1
    assert min(stats[k] for k in names) >= 0


def test_self_time_subtracts_the_union_of_children():
    S = profiling.Span
    recs = []
    for sid, pid, a, b in ((1, 0, 0, 100), (2, 1, 10, 40), (3, 1, 30, 60),
                           (4, 1, 90, 120), (5, 2, 15, 20)):
        r = S.__new__(S)
        r.name, r.span_id, r.parent_id = f"s{sid}", sid, pid
        r.start_ns, r.end_ns = a, b
        recs.append(r)
    own = profiling.self_ns(recs)
    # children of 1 cover [10, 60) and [90, 100): 60 of 100 ns
    assert own == {1: 40, 2: 25, 3: 30, 4: 30, 5: 5}
    assert profiling.self_seconds(recs)["s1"] == pytest.approx(40e-9)


def test_counts_add_and_the_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "_ring",
                        profiling.collections.deque(maxlen=8))
    sink = {}
    with profiling.request("root", sink, a=1) as root:
        root.count(a=2, b=3)
        for _ in range(20):
            with profiling.span("leaf") as leaf:
                leaf.count(n=1)
    got = profiling.spans()
    assert len(got) == 8 and got[-1] is root
    assert root.counts == {"a": 3, "b": 3}
    assert sum(1 for r in got if r.name == "leaf") == 7
    assert set(sink) == {"root", "leaf"}
    assert profiling.current() is profiling.OFF
    assert profiling.span("x", parent=profiling.OFF) is profiling.OFF


def test_device_trace_adds_the_pool_threads_spans(tmp_path, monkeypatch):
    monkeypatch.setenv("SMALLZ4_TPU_CPU_ASSIST", "1")
    data = _mixed(6 * C + 100, seed=17)
    _parity(data, parity=False)
    with profiling.device_trace(str(tmp_path)):
        frame = _parity(data, parity=False)
    assert native.decompress(frame) == data
    trace = json.loads((tmp_path / "trace.json").read_text())
    events = trace["traceEvents"]
    ours = [e for e in events if e.get("cat") == "program_span"]
    main = threading.get_native_id()
    assert {e["name"] for e in ours} >= {"encode", "host.block", "host.emit"}
    assert any(e["tid"] != main and e["name"] == "host.block" for e in ours)
    root = [e for e in ours if e["name"] == "encode"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"] == "encode"]
    assert len(root) == len(marks) == 1
    assert abs(root[0]["ts"] - marks[0]["ts"]) < 100
    assert abs(root[0]["ts"] + root[0]["dur"]
               - marks[0]["ts"] - marks[0]["dur"]) < 100
    assert root[0]["args"]["n_bytes"] == len(data)
