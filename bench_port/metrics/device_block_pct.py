"""Share of the window's blocks that the stream driver sent down the
device path (the CPU assist took the rest), from the program's counter
``n_device_blocks``, in %."""


def read(ctx):
    if not ctx.stats or "n_device_blocks" not in ctx.stats:
        return None
    blocks = sum(r["blocks"] for r in ctx.records)
    return 100.0 * ctx.stats["n_device_blocks"] / blocks
