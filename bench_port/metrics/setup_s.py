"""Process start to the first timed request: imports, the fixture, the
traffic, the kernel library and native runtime (built on a checkout's
first run), and the warm requests."""


def read(ctx):
    return ctx.setup_s
