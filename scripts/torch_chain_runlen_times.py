#!/usr/bin/env python3
"""Time the CUDA chain and run-length kernels and one chunk group.

    python3 scripts/torch_chain_runlen_times.py [REPO_DIR]

Runs on one CUDA card, on the checkout given as REPO_DIR (default: this
one), so that a parent and a change can be timed in turns in one call (copy
the parent's tree into a git-ignored directory and give its path).  The
timing helpers come from this checkout's ``chip_smoke.py``; the kernels
from REPO_DIR's package.  On chip_smoke.py's inputs:

* ``sortmatch.chain`` on one chunk group's claims ([64, 65536], 16 steps,
  the call ``chunkmatch._claims`` makes) and on one sort-engine dispatch's
  scan results ([8, 131072], 14 steps), and on rows of distance 1 and
  length 20 at both shapes; ``chain_plain`` at the chunk shape (the tensor
  loop the kernel replaces there);
* ``pallas_kernels.run_lengths`` at [8, 131072] (the sort engine's call)
  and [8, 133119] (the walk engine's), and on rows that are one run;
* one whole ``match_chunks`` group.

Each kernel's result must equal its plain version's.  Kernel times: the
mean of 20 calls after one with CUDA events (the host's enqueue included
where it is slower than the card), and the device time and device launches
per call from a torch.profiler trace of 5 calls.  Prints the card and one
line per case.
"""
from __future__ import annotations

import importlib.util
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent


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
    from smallz4_tpu_torch.ops import pallas_kernels as pk
    from smallz4_tpu_torch.ops import pipeline, sortnet
    from smallz4_tpu_torch.ops import sortmatch as sm

    dev = torch.device("cuda", 0)
    print(f"{cs.card_line()} | tree {root}", flush=True)
    real = cs.real_corpus()

    CH, G = cm.CHUNK, cm.GROUP
    g = cs.chunk_group(torch, np, dev, real)
    p_pay, p_key = cm.probe(g.merged, g.cg, g.cp, g.lim, CH)
    _, s_pay = cm.compact(p_key, p_pay, CH)
    # the chain's input in chunkmatch._claims
    c_lens, c_dists = (s_pay >> 16) & 0xFFFF, s_pay & 0xFFFF

    s_start, s_bs = 1 << 20, 7 * pipeline.SEG
    seg_group = list(range(s_start, s_start + s_bs, pipeline.SEG))
    arrays = pipeline.segment_group(np.frombuffer(real, np.uint8), s_start,
                                    s_start + s_bs, seg_group, False, True)
    sbufs, sv, ev, scut, _ = (torch.from_numpy(a).to(dev) for a in arrays)
    rec, _ = sm.segment_records(sbufs, sv, ev, scut)
    lens0, dists0, _ = sm.neighbor_scan(sortnet.sort_records(rec, n_keys=2))
    rl_in = sbufs[:, :sm.N_ENTRIES].contiguous()

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.int32, device=dev)

    cases = {
        "chain [64, 65536] steps 16, chunk group claims": (
            lambda: sm.chain(c_lens, c_dists, 16),
            lambda: sm.chain_plain(c_lens, c_dists, 16)),
        "chain [8, 131072] steps 14, sort dispatch": (
            lambda: sm.chain(lens0, dists0, 14),
            lambda: sm.chain_plain(lens0, dists0, 14)),
        "run_lengths [8, 131072], sort dispatch": (
            lambda: pk.run_lengths(rl_in), lambda: pk.run_lengths_plain(rl_in)),
        "run_lengths [8, 133119], walk dispatch": (
            lambda: pk.run_lengths(sbufs), lambda: pk.run_lengths_plain(sbufs)),
    }
    ones64, len64 = full((G, CH), 1), full((G, CH), 20)
    ones8, len8 = full((8, sm.N_ENTRIES), 1), full((8, sm.N_ENTRIES), 20)
    eq8 = torch.full((8, sm.N_ENTRIES), 7, dtype=torch.uint8, device=dev)
    eqw = torch.full(tuple(sbufs.shape), 7, dtype=torch.uint8, device=dev)
    cases |= {
        "chain [64, 65536] steps 16, dist 1 len 20": (
            lambda: sm.chain(len64, ones64, 16),
            lambda: sm.chain_plain(len64, ones64, 16)),
        "chain [8, 131072] steps 14, dist 1 len 20": (
            lambda: sm.chain(len8, ones8, 14),
            lambda: sm.chain_plain(len8, ones8, 14)),
        "run_lengths [8, 131072], one run a row": (
            lambda: pk.run_lengths(eq8), lambda: pk.run_lengths_plain(eq8)),
        "run_lengths [8, 133119], one run a row": (
            lambda: pk.run_lengths(eqw), lambda: pk.run_lengths_plain(eqw)),
    }
    for name, (kern, plain) in cases.items():
        equal = torch.equal(kern(), plain())
        ms = cs.cuda_ms(torch, kern, 20)
        dev_ms, per_call = cs.device_ms(torch, kern, 5)
        line = (f"{name}: equal to plain {equal}, kernel {ms:.4f} ms, device "
                f"{dev_ms:.4f} ms, {per_call:g} launches a call")
        if name.startswith("chain [64"):
            line += f", plain {cs.cuda_ms(torch, plain, 5):.4f} ms"
        print(line, flush=True)

    def group():
        return cm.match_chunks(g.halo, g.bufs, g.cand, g.cand, g.lim,
                               g.cut_gram, g.cut_pos, n_chunks=G, chunk=CH)

    ms = cs.cuda_ms(torch, group, 5)
    dev_ms, per_call = cs.device_ms(torch, group, 3)
    print(f"match_chunks, one group: {ms:.3f} ms (CUDA events), device "
          f"{dev_ms:.3f} ms in {per_call:g} launches", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
