"""The device DP's (``s4_parse``) share of its roofline, in %.  Each call
of a block of N positions must read its claims (lens, dists: 8N bytes)
and write its choice and costs (8N bytes) once: 16N bytes over the HBM
rate, whatever implements the DP.  The sum of those bounds over the
traced window's calls, divided by the sum of the kernel's device time."""
from bench_port.lib import devtrace


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    bs = ctx.block_size
    calls = [min(bs, r["data_bytes"] - k * bs)
             for r in ctx.traced for k in range(r["blocks"])]
    s, n = ctx.trace.kernel_s(("parse_kernel",))
    if n == 0:
        return None
    if n != len(calls):
        ctx.log(f"parse_roofline_pct: {n} kernel records for {len(calls)} "
                f"calls; the bound is scaled to the records")
    bound = sum(devtrace.bound_s(16 * N) for N in calls) * n / len(calls)
    return 100.0 * bound / s
