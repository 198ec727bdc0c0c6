"""95th percentile of the encode latency over every request of the window
(host clock, from the call to the frame's bytes on the host), in ms."""
import numpy as np


def read(ctx):
    if not ctx.records:
        return None
    return float(np.percentile([r["seconds"] for r in ctx.records], 95)) * 1e3
