"""Check of a decode: every kept answer is the input the frame was made
from, byte for byte."""
from bench_port.lib import lz4ref


def check(kept, ctx):
    unlike = sum(lz4ref.bytes_unlike(item["out"], item["data"])
                 for item in kept)
    return [("bytes_unlike", unlike, 0)]
