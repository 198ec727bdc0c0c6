"""The block expansion's (``s4_expand``) share of its roofline, in %.
Each call expands one compressed block; it must read the block's payload,
its sequence table (16 bytes a sequence) and the history its matches
reach before the block, and write the block's output, once: those bytes
over the HBM rate, whatever implements the expansion.  The sum over the
traced window's calls, divided by the sum of the kernel's device time."""
from bench_port.lib import devtrace, lz4ref

HISTORY = 65536


def _block_bytes(payload: bytes) -> int:
    seqs = lz4ref.sequences(payload)
    out = reach = 0
    for lit, ml, off in seqs:
        out += lit
        if ml:
            reach = max(reach, off - out)
            out += ml
    return len(payload) + 16 * len(seqs) + min(max(reach, 0), HISTORY) + out


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    moved = []
    for r in ctx.traced:
        moved += [_block_bytes(p) for _, stored, p in
                  lz4ref.frame_blocks(r["frame"]) if not stored]
    s, n = ctx.trace.kernel_s(("expand_kernel",))
    if n == 0 or not moved:
        return None
    if n != len(moved):
        ctx.log(f"expand_roofline_pct: {n} kernel records for {len(moved)} "
                f"calls; the bound is scaled to the records")
    bound = sum(devtrace.bound_s(b) for b in moved) * n / len(moved)
    return 100.0 * bound / s
