"""The per-layer metrics that read the program's spans (``program_span``),
on a synthetic traced window: fake span records in place of the
program's buffer, fake host launch records in the trace, and each value
worked out by hand.  Without a trace, or with a program that keeps no
spans (the tracing module without ``spans``), each returns None.  Run
from the repository root:

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import pathlib
import sys
import types

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port.lib import harness  # noqa: E402
from smallz4_tpu_torch.utils import profiling  # noqa: E402

B = 10 ** 18  # the window's start, ns
MS = 10 ** 6


def rec(span_id, name, parent_id, a_ms, b_ms, **counts):
    return types.SimpleNamespace(
        name=name, span_id=span_id, parent_id=parent_id, request_id=1,
        thread_id=span_id, start_ns=B + a_ms * MS, end_ns=B + b_ms * MS,
        counts=counts)


# a parity request of 6 MB: a device-path block of 4 MB and an assist
# block of 2 MB, in pool threads, the caller's join over 400 of the
# window's 1,000 ms
PARITY = [
    rec(1, "encode", 0, 0, 1000, n_bytes=6_000_000, n_blocks=2),
    rec(2, "stream.dispatch", 1, 0, 50, n_groups=1),
    rec(3, "stream.collect", 1, 50, 100),
    rec(4, "stream.join", 1, 500, 900),
    rec(5, "host.block", 1, 100, 500, assist=0, n_positions=4_000_000),
    rec(6, "host.unpack", 5, 100, 110),
    rec(7, "host.refine", 5, 110, 310, n_refine_positions=1, wholesale=0),
    rec(8, "host.dp", 5, 310, 350),
    rec(9, "host.dist_fix", 5, 350, 400, n_dist_fix_positions=1),
    rec(10, "host.emit", 5, 400, 450),
    rec(11, "host.block", 1, 100, 700, assist=1, n_positions=2_000_000),
    rec(12, "host.refine", 11, 100, 400, n_refine_positions=2, wholesale=1),
]
# a resident request of 2 MB in two blocks; stage 20 ms, upload 10 ms
# with a 4 ms child that is not staging
RESIDENT = [
    rec(21, "encode", 0, 0, 500, n_bytes=2_000_000, n_blocks=2),
    rec(22, "resident.stage", 21, 10, 30),
    rec(23, "resident.upload", 21, 30, 44),
    rec(24, "aten::to", 23, 35, 39),
    rec(25, "resident.emit", 21, 100, 200),
    rec(26, "resident.sync", 21, 200, 210, n_dp_rounds=11),
    rec(27, "resident.emit", 21, 300, 400),
    rec(28, "resident.sync", 21, 400, 410, n_dp_rounds=4),
]
# host events of the trace: four launches inside the emits, one outside,
# a copy and an operator inside
HOST = [(name, B + t * MS, B + t * MS + 10)
        for name, t in (("cudaLaunchKernel", 150), ("cudaLaunchKernel", 151),
                        ("cudaLaunchKernel", 199), ("cuLaunchKernelEx", 350),
                        ("cudaLaunchKernel", 250), ("cudaMemcpyAsync", 160),
                        ("aten::add", 170))]

CASES = [
    ("refine_ms_per_MB", PARITY, (200 + 50) / 4.0),
    ("assist_ms_per_MB", PARITY, 600 / 2.0),
    ("join_wait_pct", PARITY, 40.0),
    ("staging_ms_per_MB.encode", RESIDENT, (20 + 14 - 4) / 2.0),
    ("staging_ms_per_MB.objects", RESIDENT, (20 + 14 - 4) / 2.0),
    ("emit_launches_per_block", RESIDENT, 4 / 2),
    ("dp_rounds_per_block", RESIDENT, (11 + 4) / 2),
]


def ctx(trace=True):
    tr = types.SimpleNamespace(start_ns=B, end_ns=B + 1000 * MS, host=HOST)
    return types.SimpleNamespace(trace=tr if trace else None, log=print)


@pytest.mark.parametrize("name,records,want", CASES,
                         ids=[c[0] for c in CASES])
def test_span_metric_on_a_synthetic_window(monkeypatch, name, records,
                                           want):
    def spans(a, b):
        assert (a, b) == (B, B + 1000 * MS)
        return [r for r in records if r.end_ns > a and r.start_ns < b]

    monkeypatch.setattr(profiling, "spans", spans)
    metric = harness.load_py("metrics", name)
    assert metric.read(ctx()) == pytest.approx(want)
    assert metric.read(ctx(trace=False)) is None
    monkeypatch.setattr(profiling, "spans", lambda a, b: [])
    assert metric.read(ctx()) is None
    monkeypatch.delattr(profiling, "spans")
    assert metric.read(ctx()) is None


def test_every_span_metric_is_declared():
    import json

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    declared = {m["name"] for m in bench["per_layer"]
                if m["source"] == "program_span"}
    assert declared == {c[0] for c in CASES}
