"""Check of a level-9 parity encode: the frames as smallz4 -9 writes them.

Every kept frame must be a modern frame with smallz4's header, one block
per 4 MiB of input and the end mark, and must decode (with the
benchmark's own plain decoder) to its input, byte for byte.  Then two
blocks are encoded by the plain smallz4 -9 encoder (``lib/opt9ref.py``)
from the same input and compared with the program's, header and payload,
byte for byte: block 0 of a kept frame drawn from the seed, which the
stream driver always sends down the device path (it claims blocks from
the front, the CPU assist from the back), and one more block drawn from
the seed among the other blocks of the kept frames, whichever path took
it.
"""
import time

from bench_port.lib import lz4ref, opt9ref


def check(kept, ctx):
    bs = ctx.block_size
    malformed = unlike = 0
    blocks = []
    for j, item in enumerate(kept):
        data, frame = item["data"], item["frame"]
        try:
            walk = lz4ref.frame_blocks(frame)
            back = lz4ref.decode_frame(frame)
        except (lz4ref.FrameError, IndexError):
            malformed += 1
            unlike += len(data)
            continue
        if (frame[:7] != lz4ref.MODERN_HEADER
                or len(walk) != max(1, -(-len(data) // bs))):
            malformed += 1
        unlike += lz4ref.bytes_unlike(back, data)
        blocks += [(j, k, off, len(pay))
                   for k, (off, _, pay) in enumerate(walk)]
    differ = 0
    # two blocks a run: the plain encoder takes about 12 s for 4 MiB on
    # the card, after the window
    firsts = [b for b in blocks if b[1] == 0]
    picks = []
    if firsts:
        picks.append(firsts[int(ctx.rng.integers(len(firsts)))])
        others = [b for b in blocks if b != picks[0]]
        if others:
            picks.append(others[int(ctx.rng.integers(len(others)))])
    for j, k, off, size in picks:
        data, frame = kept[j]["data"], kept[j]["frame"]
        start = k * bs
        t0 = time.perf_counter()
        want = opt9ref.encode_block(data, start, min(len(data), start + bs),
                                    device=ctx.device)
        same = frame[off: off + 4 + size] == want
        differ += not same
        ctx.log(f"reference: block {k} of a {len(data)}-byte frame "
                f"{'equal' if same else 'DIFFERENT'} "
                f"({time.perf_counter() - t0} s)")
    if not picks:
        differ = 1  # nothing to compare is no proof
    return [("frames_malformed", malformed, 0),
            ("roundtrip_bytes_unlike", unlike, 0),
            ("opt9_blocks_unlike", differ, 0)]
