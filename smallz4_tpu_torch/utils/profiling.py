"""Run reports and traces (port of ``smallz4_tpu/utils/profiling.py``).

A structured report of one codec run (bytes, ratio, wall time and
per-stage times, engine counters, MB/s) and a ``torch.profiler`` trace
context for device-level inspection, in place of the reference's
``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import pathlib
import time


@dataclasses.dataclass
class StageTimer:
    """Accumulates wall time per pipeline stage."""
    stages: dict = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = (self.stages.get(name, 0.0)
                                 + time.perf_counter() - t0)


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
    stages: dict = dataclasses.field(default_factory=dict)
    # engine counters (n_*: byte and position counts)
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def ratio(self) -> float:
        return self.bytes_out / self.bytes_in if self.bytes_in else 0.0

    @property
    def mbps(self) -> float:
        return self.bytes_in / self.wall_s / 1e6 if self.wall_s else 0.0

    @property
    def mbps_per_chip(self) -> float:
        return self.mbps / max(self.chips, 1)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["ratio"] = round(self.ratio, 4)
        d["mbps"] = round(self.mbps, 3)
        d["mbps_per_chip"] = round(self.mbps_per_chip, 3)
        return json.dumps(d)


@contextlib.contextmanager
def device_trace(log_dir: str | None):
    """torch.profiler trace of the CPU and, where there is one, the CUDA
    device, written as ``trace.json`` (Chrome trace format) into
    ``log_dir``; no trace when ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))

