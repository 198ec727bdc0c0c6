"""The benchmark's harness on the CPU, at a size a test run can hold.

Every cell runs end to end with the chip's look skipped: the program on
its plain PyTorch versions at its own chunk size (the level-9 parity of
the chunk engine holds only there), requests of a few KiB.  A sound run
is correct; the configuration's control run in the program's place is
not; and neither is a run whose timed path is broken by one of the
configuration's ``faults`` (``bench_port/faults/``).  The cells are those
of ``BENCHMARK.json`` and of ``bench_port/pending/``.  Run from the
repository root:

    python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench_port.lib import harness  # noqa: E402

SEED = 2 ** 40 + 12345


def bench() -> dict:
    """BENCHMARK.json with the entries of the cells that wait in
    ``bench_port/pending/``."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "bench_port" / "pending").glob("*.json")):
        more = json.loads(f.read_text())
        for key in ("workloads", "end_to_end", "per_layer"):
            have = {e["name"] for e in b[key]}
            b[key] += [e for e in more.get(key, []) if e["name"] not in have]
    return b


CELLS = [w["name"] for w in bench()["workloads"]]


def cell(name: str) -> harness.Cell:
    c = harness.Cell(bench(), name)
    c.mix = dict(c.mix, sizes={"min": 6000, "max": 24000, "count": 3},
                 pieces={"min": 512, "max": 8192}, trace_requests=1)
    return c


FAULTS = [(name, fault) for name in CELLS
          for fault in cell(name).op.get("faults", [])]


def drive(name: str, control: bool = False) -> dict:
    return harness.run(cell(name), SEED, 0.0, False, time.perf_counter(),
                       control=control, device="cpu",
                       extra_kwargs={"device": "cpu"},
                       log=lambda *a, **k: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = drive(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 3 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    want = {m["name"] for m in harness.Cell(bench(), name).end_to_end}
    assert set(res["metrics"]) == want


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    res = drive(name, control=True)
    assert not res["correct"], res["checks"]


def test_every_cell_has_a_fault():
    assert {name for name, _ in FAULTS} == set(CELLS)


@pytest.mark.parametrize("name,fault", FAULTS)
def test_timed_path_broken_is_not_correct(monkeypatch, name, fault):
    """The timed path broken inside the program, as the fault's file says:
    an answer altered where it is produced (the parity encode's block
    emit, the resident encode's device emit, the decode's expansion), or
    the parity encode's device path trusting the device's claims."""
    harness.load_py("faults", fault).install(monkeypatch.setattr)
    res = drive(name)
    assert not res["correct"], res["checks"]


def test_opt9_reference_matches_the_native_encoder():
    """The plain smallz4 -9 block encoder against the C++ runtime (which is
    golden-tested against smallz4 itself), on a block with no history and
    on one that starts past 65,547 bytes (history and the chain cut)."""
    from bench_port.lib import corpus, lz4ref, opt9ref
    from smallz4_tpu_torch import native

    import numpy as np

    rng = np.random.default_rng(SEED)
    data = corpus.recombine(corpus.fixture("realcorpus"), 2 * 65536 + 9000,
                            rng, 512, 8192)
    frame = native.compress(data, 9, block_size=65536)
    walk = lz4ref.frame_blocks(frame)
    assert lz4ref.decode_frame(frame) == data
    for k in (2,):
        off, _, pay = walk[k]
        start = k * 65536
        want = frame[off: off + 4 + len(pay)]
        assert opt9ref.encode_block(data, start, min(len(data),
                                                     start + 65536)) == want
    small = data[:12000]
    frame = native.compress(small, 9)
    off, _, pay = lz4ref.frame_blocks(frame)[0]
    assert opt9ref.encode_block(small, 0, len(small)) == \
        frame[off: off + 4 + len(pay)]


def test_traffic_is_seeded():
    from bench_port.lib import traffic

    mix = dict(cell("resident-obj").mix)
    a = traffic.Traffic(mix, SEED).cycle
    b = traffic.Traffic(mix, SEED).cycle
    c = traffic.Traffic(mix, SEED + 1).cycle
    assert [r["data"] for r in a] == [r["data"] for r in b]
    assert [r["data"] for r in a] != [r["data"] for r in c]
    assert sorted(len(r["data"]) for r in a) == \
        sorted(len(r["data"]) for r in c)


def test_fixed_traffic_orders_the_same_requests():
    from bench_port.lib import traffic

    mix = dict(cell("parity-src").mix)
    assert mix["content"] == "fixed"
    a = [r["data"] for r in traffic.Traffic(mix, SEED).cycle]
    others = [[r["data"] for r in traffic.Traffic(mix, SEED + k).cycle]
              for k in range(1, 6)]
    assert any(c != a for c in others)
    assert all(sorted(c) == sorted(a) for c in others)


def test_run_refuses_without_a_card(tmp_path):
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, str(ROOT / "bench_port" / "run.py"), "--workload",
         "parity-src", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
