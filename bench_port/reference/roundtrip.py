"""Check of a -9-class encode that need not be byte-identical to smallz4:
every kept frame is a modern LZ4 frame that the benchmark's own plain
decoder reads back to its input, byte for byte."""
from bench_port.lib import lz4ref


def check(kept, ctx):
    malformed = unlike = 0
    for item in kept:
        data, frame = item["data"], item["frame"]
        try:
            back = lz4ref.decode_frame(frame)
        except (lz4ref.FrameError, IndexError):
            malformed += 1
            unlike += len(data)
            continue
        malformed += frame[:7] != lz4ref.MODERN_HEADER
        unlike += lz4ref.bytes_unlike(back, data)
    return [("frames_malformed", int(malformed), 0),
            ("roundtrip_bytes_unlike", unlike, 0)]
