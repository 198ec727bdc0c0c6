"""All compressed bytes of the window over all its input bytes, in %."""


def read(ctx):
    if not ctx.records:
        return None
    return (100.0 * sum(r["frame_bytes"] for r in ctx.records)
            / sum(r["data_bytes"] for r in ctx.records))
