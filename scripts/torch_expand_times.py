#!/usr/bin/env python3
"""Time the CUDA block expansion of the decode (csrc/expand.cu).

    python3 scripts/torch_expand_times.py [REPO_DIR]

Runs on one CUDA card, on the checkout given as REPO_DIR (default: this
one), so that a parent and a change can be timed in turns in one call (copy
the parent's tree into a git-ignored directory and give its path).  The
timing helpers and the cases come from this checkout's ``chip_smoke.py``
(``expand_rows``: block 1 and block 2 of the real-data fixture at 4 MiB
blocks, the dictionary block, the worst cases of ``expand_row`` at 4 MiB --
a chain 1M deep, one run, offsets into the history, literals only, tile
edges -- and a batch of 8 rows); the kernel from REPO_DIR's package.  The
fixture's two streams are compressed once and kept in this checkout's
git-ignored ``smallz4_tpu_torch/build/``.

Each case's result is compared with ``expand_block_plain`` (printed, not
enforced, so that a copy cut short for a phase measurement still times).
Every case is timed five times: the mean of 20 calls after one with CUDA
events (the host's enqueue included where it is slower than the card), and
from a torch.profiler trace of 5 calls the device time of a call (all its
launches: the ends' add and cumsum and the kernel), the kernel's own device
time and its launches a call.  Prints the card and, per case, the medians
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


def _stream(native, real: bytes, name: str, block_size: int) -> bytes:
    """native.compress(real, 9, block_size=...), kept in this checkout's
    git-ignored build directory so that the runs of one call on several
    trees compress the fixture once."""
    cache = HERE / "smallz4_tpu_torch" / "build" / f"{name}.lz4"
    if not cache.is_file():
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_suffix(".tmp")
        tmp.write_bytes(native.compress(real, 9, block_size=block_size))
        tmp.replace(cache)
    return cache.read_bytes()


def main() -> int:
    root = pathlib.Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    cs = _helpers()
    sys.path[:0] = [str(root), str(HERE)]  # the package from REPO_DIR first
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from smallz4_tpu_torch import native
    from smallz4_tpu_torch.ops import decoder

    dev = torch.device("cuda", 0)
    print(f"{cs.card_line()} | tree {root}", flush=True)
    real = cs.real_corpus()
    streams = {name: _stream(native, real, name, bs)
               for name, bs in (("realcorpus", 4 << 20),
                                ("realcorpus_1MiB", 1 << 20))}
    rows, expect = cs.expand_rows(np, real, streams,
                                  cs.dictionary_frame(native, real))

    def med(xs):
        return (f"{statistics.median(xs):.4f} "
                f"({', '.join(f'{x:.4f}' for x in xs)})")

    for name, rs in rows.items():
        pay, hist, tabs, oc = cs.expand_batch(np, rs)
        args = tuple(torch.from_numpy(a).to(dev) for a in (pay, hist)) + \
            tuple(torch.from_numpy(tabs).to(dev))

        def kern(a=args, oc=oc):
            return decoder.expand_block(*a, out_cap=oc)

        got = kern()
        equal = torch.equal(got, decoder.expand_block_plain(*args,
                                                            out_cap=oc))
        if name in expect:
            equal = equal and (got[0, :len(expect[name])].cpu().numpy()
                               .tobytes() == expect[name])
        ev, dv, own, per = [], [], [], set()
        for _ in range(ROUNDS):
            ev.append(cs.cuda_ms(torch, kern, 20))
            d, n = cs.device_ms(torch, kern, 5, "expand_kernel")
            dv.append(d)
            own.append(cs.device_ms(torch, kern, 5, "expand_kernel",
                                    own=True)[0])
            per.add(n)
        print(f"{name}: {len(rs)} x {oc} B, equal to plain {equal}; call "
              f"device ms {med(dv)}; kernel device ms {med(own)}; events "
              f"ms {med(ev)}; kernel launches a call {sorted(per)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
