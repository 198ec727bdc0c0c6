"""Input bytes encoded in the window over the window's seconds (host
clock, closed loop, one caller), in MB/s (10^6 bytes)."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["data_bytes"] for r in ctx.records) / ctx.window_s / 1e6
