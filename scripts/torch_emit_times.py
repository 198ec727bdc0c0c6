#!/usr/bin/env python3
"""Time the CUDA sequence emit beside its plain version.

    python3 scripts/torch_emit_times.py

Runs on one CUDA card.  The timing helpers and the blocks come from
``chip_smoke.py`` (``emit_blocks``, here on the real fixture's first 4 MiB
block's native level-9 claims, parsed by the device DP; random bytes all
literals; one byte value).  For each: ``emit_block_device``
(csrc/emit.cu) must equal ``emit_block_plain`` on the card (all output
bytes, n_out) and ``native.emit_block`` (the payload); then the kernel's
time by CUDA events (mean of 20 calls after one) and by the profiler
(device time and device launches a call, 5 calls), the plain version's
(3 calls; profiler device time and launches), and the read-once bound
(block, lens, dists and the payload over 3.35 TB/s).  Prints the card and
one line per block.
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
    cs = _helpers()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from smallz4_tpu_torch import format as fmt
    from smallz4_tpu_torch import native
    from smallz4_tpu_torch.ops import emit, parse

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    real = cs.real_corpus()[:fmt.MAX_BLOCK_SIZE]
    lens, dists = (torch.from_numpy(a).to(dev)
                   for a in cs.native_claims(np, native, real))
    ok = True
    for name, (data, ln, ds) in cs.emit_blocks(
            torch, np, native, parse, dev, real, lens, dists,
            len(real)).items():
        blk = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
        args = (blk.to(dev), ln, ds)
        out, n_out = emit.emit_block_device(*args)
        want, want_n = emit.emit_block_plain(*args)
        n = int(n_out)
        same = (n == int(want_n) and torch.equal(out, want)
                and out[:n].cpu().numpy().tobytes() == native.emit_block(
                    data, ln.cpu().numpy(), ds.cpu().numpy()))
        ok &= same
        ms = cs.cuda_ms(torch, lambda: emit.emit_block_device(*args), 20)
        dev_ms, per_call = cs.device_ms(
            torch, lambda: emit.emit_block_device(*args), 5)
        plain_ms = cs.cuda_ms(torch, lambda: emit.emit_block_plain(*args), 3)
        plain_dev, plain_calls = cs.device_ms(
            torch, lambda: emit.emit_block_plain(*args), 2)
        bound_ms, by = cs.bound(cs.nbytes(*args) + n, 0)
        print(f"{name}: n_out {n}, equal to the plain version and "
              f"native.emit_block: {same}; kernel {ms:.4f} ms events, "
              f"{dev_ms:.4f} ms device in {per_call:g} launches a call; "
              f"plain {plain_ms:.4f} ms events, {plain_dev:.4f} ms device "
              f"in {plain_calls:g} launches; bound {bound_ms * 1e3:.2f} us "
              f"({by}), {bound_ms / dev_ms:.2%} of the device time",
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
