"""Kernel launches on the device per object, over the traced window's
objects (kernel records of the trace; copies and fills left out)."""


def read(ctx):
    if ctx.trace is None or not ctx.traced:
        return None
    return len(ctx.trace.kernels()) / len(ctx.traced)
