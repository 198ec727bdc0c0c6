"""Share of the traced window in which no operation (kernel, copy or
fill) ran on the device: 1 - the union of their intervals over the
window, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
