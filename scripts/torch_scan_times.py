#!/usr/bin/env python3
"""Time the sort engine's neighbour scan (csrc/sortmatch.cu s4_scan).

    python3 scripts/torch_scan_times.py [REPO_DIR ...]

Runs on one CUDA card, on each checkout given (default: this one), in the
order given, so that a parent and a change can be timed in turns in one
process (copy the parent's tree into a git-ignored directory and give its
path, e.g. ``parent . . parent``).  Each tree runs in a process of its own,
so every tree loads its own package and builds its own kernel library.
The timing helpers and the cases come from this checkout's
``chip_smoke.py``; the kernel from the tree's package.  Cases, each an
[B, 5, n] tensor of sorted records:

* the real dispatch records of ``chip_smoke.sort_dispatch`` (7 segments of
  the real-data fixture from 1 MiB, a live boundary cut, one padding row:
  [8, 5, 2^17]), with the work ``chip_smoke.scan_work`` counts on them;
* ``chip_smoke.scan_rows`` at [8, 5, 2^17]: one gram across every row,
  all grams distinct, records in position order, every record invalid;
* the "mixed" rows at B = 1, n = 1,024 and n = 100,003;

and one whole ``sortmatch.match_segments`` dispatch on the real inputs.
Each case's result is compared with ``neighbor_scan_plain`` (printed, not
enforced, so that a copy cut short for a phase measurement still times).
Every case is timed five times: the mean of 20 calls after one with CUDA
events (the host's enqueue included where it is slower than the card),
and from torch.profiler traces of 5 calls a call's device time (all its
launches), its launches and each scan kernel's own device time.  Prints
the card, then per tree and case the medians and the five readings.
"""
from __future__ import annotations

import importlib.util
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
ROUNDS = 5
BIG = (8, 1 << 17)
# the scan's kernels in the trees timed (the first design's and this one's)
KERNELS = ("scan_kernel", "scan_probe_kernel", "scan_unsort_kernel")
SMALL = ((1, 1024), (1, 100_003))


def _helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _med(xs) -> str:
    return (f"{statistics.median(xs):.4f} "
            f"({', '.join(f'{x:.4f}' for x in xs)})")


def time_tree(root: pathlib.Path) -> int:
    cs = _helpers()
    sys.path[:0] = [str(root), str(HERE)]  # the package from the tree first
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from smallz4_tpu_torch.ops import sortmatch as sm

    dev = torch.device("cuda", 0)
    print(f"{cs.card_line()} | tree {root}", flush=True)
    disp = cs.sort_dispatch(torch, np, dev, cs.real_corpus())
    work = cs.scan_work(torch, disp.srec)
    print(f"real dispatch work: {work}", flush=True)
    cases = {f"real dispatch {list(disp.srec.shape)}": disp.srec}
    for i, case in enumerate(c for c in cs.SCAN_CASES if c != "mixed"):
        cases[f"{case} [{BIG[0]}, 5, {BIG[1]}]"] = torch.from_numpy(
            cs.scan_rows(np, case, *BIG, seed=i)).to(dev)
    for B, n in SMALL:
        cases[f"mixed [{B}, 5, {n}]"] = torch.from_numpy(
            cs.scan_rows(np, "mixed", B, n, seed=n)).to(dev)

    for name, rec in cases.items():
        def kern(rec=rec):
            return sm.neighbor_scan(rec)

        got = kern()
        equal = all(torch.equal(g, w) for g, w in
                    zip(got, sm.neighbor_scan_plain(rec)))
        ev, dv, per = [], [], set()
        own = {k: [] for k in KERNELS}
        for _ in range(ROUNDS):
            ev.append(cs.cuda_ms(torch, kern, 20))
            d, launches = cs.device_ms(torch, kern, 5)
            dv.append(d)
            per.add(launches)
            for k in KERNELS:
                ms, hits = cs.device_ms(torch, kern, 5, k, own=True)
                own[k].append(ms if hits else None)
        parts = "; ".join(f"{k} {_med(v)}" for k, v in own.items()
                          if None not in v)
        print(f"{name}: equal to plain {equal}; device ms {_med(dv)}; events "
              f"ms {_med(ev)}; launches a call {sorted(per)}; by kernel: "
              f"{parts}", flush=True)

    def dispatch():
        return sm.match_segments(disp.sbufs, disp.sv, disp.ev, disp.scut,
                                 disp.sfin)

    dv, per = [], set()
    for _ in range(ROUNDS):
        d, launches = cs.device_ms(torch, dispatch, 3)
        dv.append(d)
        per.add(launches)
    print(f"match_segments, one dispatch: device ms {_med(dv)}; launches a "
          f"call {sorted(per)}", flush=True)
    return 0


def main() -> int:
    roots = [pathlib.Path(a).resolve() for a in sys.argv[1:]] or [HERE]
    if len(roots) == 1:
        return time_tree(roots[0])
    rc = 0
    for root in roots:  # a process a tree: each imports its own package
        rc |= subprocess.run([sys.executable, __file__, str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
