#!/usr/bin/env python3
"""Time the CUDA probe and walk kernels on chip_smoke.py's inputs.

    python3 scripts/torch_probe_walk_times.py [REPO_DIR]

Runs on one CUDA card, from the repository root or on the checkout given
as REPO_DIR (to compare kernel variants, copy the tree into git-ignored
directories, edit their constants and run the script in each).  On one
chunk-engine group of the real-data fixture (64 chunks, merged records
[64, 6, 131072]) it times ``chunkmatch.probe``; on one walk-engine dispatch
(8 rows of 133,119 bytes) ``match_finder.walk`` at max_candidates=64 with
ext_cap 512 (the pipeline's) and 4 (no extension words: the hops alone).
Each kernel's outputs must equal its plain version's; times are the mean
of 20 launches after one, with CUDA events.  Prints the card and one line
per case.
"""
from __future__ import annotations

import pathlib
import sys


def main() -> int:
    root = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else
                        pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, str(root.resolve()))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from smallz4_tpu_torch.ops import chunkmatch as cm
    from smallz4_tpu_torch.ops import match_finder as mf
    from smallz4_tpu_torch.ops import pipeline

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    real = cs.real_corpus()

    CH = cm.CHUNK
    grp = cs.chunk_group(torch, np, dev, real)
    merged, cg, cp, lim = grp.merged, grp.cg, grp.cp, grp.lim
    equal = all(torch.equal(a, b) for a, b in zip(
        cm.probe(merged, cg, cp, lim, CH),
        cm.probe_plain(merged, cg, cp, lim, CH)))
    ms = cs.cuda_ms(torch, lambda: cm.probe(merged, cg, cp, lim, CH), 20)
    print(f"probe [64, 6, 131072]: equal to plain {equal}, {ms:.4f} ms",
          flush=True)

    s_start, s_bs = 1 << 20, 7 * pipeline.SEG
    seg_group = list(range(s_start, s_start + s_bs, pipeline.SEG))
    arrays = pipeline.segment_group(np.frombuffer(real, np.uint8), s_start,
                                    s_start + s_bs, seg_group, False, True)
    sbufs, sv, ev, scut, _ = (torch.from_numpy(a).to(dev) for a in arrays)
    g, prev, runs = mf.walk_inputs(sbufs, sv, ev, scut, mf.HALO)
    for ext_cap in (512, 4):
        args = (sbufs, g, prev, runs, sv, ev, mf.HALO, mf.SEG, 64, ext_cap)
        equal = all(torch.equal(a, b)
                    for a, b in zip(mf.walk(*args), mf.walk_plain(*args)))
        ms = cs.cuda_ms(torch, lambda: mf.walk(*args), 20)
        print(f"walk [8, 133119], max_candidates 64, ext_cap {ext_cap}: "
              f"equal to plain {equal}, {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
