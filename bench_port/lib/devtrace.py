"""Reading the device from a torch.profiler trace, and the roofline arithmetic.

A traced run profiles a few requests of its window: one request before
the traced window and one after it, so that no kernel of the window is
the session's first or last (a session can lose those records), and the
window itself, marked by a host span.  A device operation belongs to the
window when the host call that launched it, found by its correlation id,
lies inside the span: the card's timestamps, converted to the host's
clock, stray by hundreds of microseconds.

The peaks are the published ones of one H100 SXM at its 700 W limit; a
roofline share is stated with the card's power limit beside it.
"""
from __future__ import annotations

import contextlib
import re
import subprocess

# H100 SXM peak HBM rate (NVIDIA's data sheet, 700 W); the kernels the
# benchmark holds to a roofline (the DP, the expansion) are bound by bytes
HBM_BYTES_PER_S = 3.35e12
WINDOW_SPAN = "bench traced window"


def request_span(op: str) -> str:
    """The host span around one request of a traced run."""
    return f"{op} request"


def _annotation(e, cuda) -> bool:
    """A span of the benchmark's own, which the trace copies onto the
    device's timeline: not a device operation."""
    is_ann = getattr(e, "is_user_annotation", None)
    return ((is_ann is not None and e.device_type() == cuda and is_ann())
            or e.name() == WINDOW_SPAN or e.name().endswith(" request"))


def bound_s(moved_bytes: float) -> float:
    """The least time for a kernel that must move ``moved_bytes`` (each
    input read once, each output written once)."""
    return moved_bytes / HBM_BYTES_PER_S


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return res.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


class Trace:
    """The device operations of one traced window."""

    def __init__(self, prof, torch):
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        host = [e for e in events if e.device_type() != cuda]
        spans = [e for e in host if e.name() == WINDOW_SPAN]
        if not spans:
            raise RuntimeError("the trace lost its window span")
        w = spans[0]
        self.start_ns, self.end_ns = w.start_ns(), w.end_ns()
        # the runtime's launches and copies (cudaLaunchKernel,
        # cudaMemcpyAsync, cuLaunchKernelEx, ...), not the framework's ops
        launched = {e.correlation_id() for e in host
                    if e.name().startswith("cu") and e.correlation_id() > 0
                    and self.start_ns <= e.start_ns() <= self.end_ns}
        self.ops = [(e.name(), e.start_ns(), e.end_ns())
                    for e in events if e.device_type() == cuda
                    and not _annotation(e, cuda)
                    and e.correlation_id() in launched]
        # host events for naming the idle gaps: all but the window span
        self.host = [(e.name(), e.start_ns(), e.end_ns()) for e in host
                     if e.name() != WINDOW_SPAN
                     and e.end_ns() > self.start_ns
                     and e.start_ns() < self.end_ns]

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self) -> list:
        """(name, seconds) of each kernel of the window (copies and fills
        left out)."""
        return [(n, (b - a) / 1e9) for n, a, b in self.ops
                if not n.startswith(("Memcpy", "Memset"))]

    def kernel_s(self, names) -> tuple[float, int]:
        """(seconds, records) of the window's kernels whose name holds one
        of ``names``."""
        pat = re.compile(r"(^|[\s:])(%s)($|[<(\s])" % "|".join(names))
        hits = [s for n, s in self.kernels() if pat.search(n)]
        return sum(hits), len(hits)

    def busy_intervals(self) -> list:
        """The union of the window's device operations, sorted."""
        merged = []
        for _, a, b in sorted(self.ops, key=lambda x: x[1]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event running across them."""
        by_name: dict = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
        edges = [self.start_ns]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(self.end_ns)
        gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
                if edges[k + 1] > edges[k]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            over = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            name = min(over)[1] if over else "no host event"
            named.append([name, (b - a) / 1e9])
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[_short(n), s] for n, s in named]}


def _short(name: str) -> str:
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name if len(name) <= 96 else name[:93] + "..."


@contextlib.contextmanager
def window_span(torch):
    from torch.profiler import record_function

    with record_function(WINDOW_SPAN):
        yield
        torch.cuda.synchronize()
