#!/usr/bin/env python3
"""Time the CUDA compaction and head/delta pack kernels and one chunk group.

    python3 scripts/torch_compact_pack_times.py [REPO_DIR]

Runs on one CUDA card, on the checkout given as REPO_DIR (default: this
one), so that a parent and a change can be timed in turns in one call (copy
the parent's tree into a git-ignored directory and give its path).  The
timing helpers and the worst-case rows come from this checkout's
``chip_smoke.py``; the kernels from REPO_DIR's package.  Cases:

* ``chunkmatch.compact`` on one chunk group's probe outputs ([64, 131072]
  -> [64, 65536], block 1 of the real-data fixture, as chip_smoke.py phase
  2 makes them) and on the worst-case rows of ``chip_smoke.compact_rows``
  (current records ahead of the halo's, behind them, interleaved);
* ``chunkmatch.pack_results`` on the same group's claims and on the rows of
  ``chip_smoke.pack_rows`` (every position a head, slot 0 the only head,
  heads only in the last eighth);
* one whole ``match_chunks`` group.

Each kernel's result must equal its plain version's.  Every case is timed
five times; a time is the mean of 20 calls after one with CUDA events (the
host's enqueue included where it is slower than the card) and the device
time and device launches per call from a torch.profiler trace of 5 calls
(the group: 5 and 3 calls).  Prints the card and, per case, the medians
and the five readings.
"""
from __future__ import annotations

import importlib.util
import pathlib
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
ROUNDS = 5


def _helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    cs = _helpers()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from smallz4_tpu_torch.ops import chunkmatch as cm

    dev = torch.device("cuda", 0)
    print(f"{cs.card_line()} | tree {root}", flush=True)
    real = cs.real_corpus()

    CH, G = cm.CHUNK, cm.GROUP
    g = cs.chunk_group(torch, np, dev, real)
    p_pay, p_key = cm.probe(g.merged, g.cg, g.cp, g.lim, CH)
    s_key, s_pay = cm.compact(p_key, p_pay, CH)
    claims = cm._claims(s_key, s_pay, g.cp, torch.zeros_like(g.cand), g.cand,
                        g.lim, CH)

    def on_card(arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    cases = {f"compact [{G}, {2 * CH}], chunk group probe outputs": (
        lambda: cm.compact(p_key, p_pay, CH),
        lambda: cm.compact_plain(p_key, p_pay, CH))}
    for seed, order in enumerate(cs.COMPACT_ORDERS):
        k, p = on_card(cs.compact_rows(np, G, CH, order, seed))
        cases[f"compact [{G}, {2 * CH}], {order}"] = (
            lambda k=k, p=p: cm.compact(k, p, CH),
            lambda k=k, p=p: cm.compact_plain(k, p, CH))
    cases[f"pack [{G}, {CH}], chunk group claims"] = (
        lambda: cm.pack_results(*claims, chunk=CH),
        lambda: cm.pack_results_plain(*claims, chunk=CH))
    for seed, case in enumerate(cs.PACK_CASES):
        rows = on_card(cs.pack_rows(np, G, CH, case, seed))
        cases[f"pack [{G}, {CH}], {case}"] = (
            lambda rows=rows: cm.pack_results(*rows, chunk=CH),
            lambda rows=rows: cm.pack_results_plain(*rows, chunk=CH))

    def med(xs):
        return (f"{statistics.median(xs):.4f} "
                f"({', '.join(f'{x:.4f}' for x in xs)})")

    for name, (kern, plain) in cases.items():
        equal = cs.max_err(torch, kern(), plain()) == 0
        ev, dv, per = [], [], set()
        for _ in range(ROUNDS):
            ev.append(cs.cuda_ms(torch, kern, 20))
            d, n = cs.device_ms(torch, kern, 5)
            dv.append(d)
            per.add(n)
        print(f"{name}: equal to plain {equal}, device ms {med(dv)}, events"
              f" ms {med(ev)}, launches a call {sorted(per)}", flush=True)

    def group():
        return cm.match_chunks(g.halo, g.bufs, g.cand, g.cand, g.lim,
                               g.cut_gram, g.cut_pos, n_chunks=G, chunk=CH)

    ev, dv, per = [], [], set()
    for _ in range(ROUNDS):
        ev.append(cs.cuda_ms(torch, group, 5))
        d, n = cs.device_ms(torch, group, 3)
        dv.append(d)
        per.add(n)
    print(f"match_chunks, one group: device ms {med(dv)}, events ms "
          f"{med(ev)}, launches {sorted(per)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
