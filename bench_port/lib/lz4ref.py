"""Plain LZ4 frame reading: the benchmark's own, independent of the program.

Written from the LZ4 frame and block format documents
(``lz4_Frame_format.md``, ``lz4_Block_format.md``): a frame walker, a block
decoder and a sequence counter, in plain Python.  They are the yardstick
the benchmark holds the program's output against, so they import nothing
of ``smallz4_tpu_torch``.
"""
from __future__ import annotations

import struct

MAGIC_MODERN = 0x184D2204
MAGIC_LEGACY = 0x184C2102
STORED_FLAG = 0x80000000
MAX_DISTANCE = 65535
#: the header smallz4 writes: magic, FLG (version 1, dependent blocks, no
#: checksums), BD (4 MB blocks, id 7) and the descriptor's checksum byte
MODERN_HEADER = struct.pack("<I", MAGIC_MODERN) + bytes((0x40, 0x70, 0xDF))
END_MARK = bytes(4)


class FrameError(ValueError):
    """The bytes are not a frame this reader accepts."""


def frame_blocks(frame: bytes):
    """(offset of the block header, stored, payload) of each block of a
    modern frame without checksums, in order; raises FrameError on a frame
    this reader does not accept."""
    if frame[:4] != MODERN_HEADER[:4]:
        raise FrameError("not a modern LZ4 frame")
    flg, bd = frame[4], frame[5]
    if flg >> 6 != 1 or flg & 0x1F:
        raise FrameError(f"FLG {flg:#x}: checksums, sizes or ids not read")
    if (bd >> 4) & 7 < 4:
        raise FrameError(f"BD {bd:#x}")
    pos = 7
    blocks = []
    while True:
        if pos + 4 > len(frame):
            raise FrameError("frame ends inside a block header")
        word = struct.unpack_from("<I", frame, pos)[0]
        if word == 0:
            if pos + 4 != len(frame):
                raise FrameError("bytes after the end mark")
            return blocks
        size = word & ~STORED_FLAG
        if pos + 4 + size > len(frame):
            raise FrameError("frame ends inside a block")
        blocks.append((pos, bool(word & STORED_FLAG),
                       frame[pos + 4: pos + 4 + size]))
        pos += 4 + size


def sequences(payload: bytes):
    """(literal length, match length, offset) of each sequence of a
    compressed block; the last has match length 0."""
    out = []
    ip, n = 0, len(payload)
    while ip < n:
        token = payload[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                c = payload[ip]
                ip += 1
                lit += c
                if c != 255:
                    break
        ip += lit
        if ip >= n:
            if ip > n:
                raise FrameError("literals run past the block")
            out.append((lit, 0, 0))
            return out
        off = payload[ip] | (payload[ip + 1] << 8)
        ip += 2
        ml = token & 15
        if ml == 15:
            while True:
                c = payload[ip]
                ip += 1
                ml += c
                if c != 255:
                    break
        out.append((lit, ml + 4, off))
    return out


def decode_block(payload: bytes, out: bytearray) -> None:
    """Append the block's bytes to ``out``, whose tail is the history."""
    ip, n = 0, len(payload)
    while ip < n:
        token = payload[ip]
        ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                c = payload[ip]
                ip += 1
                lit += c
                if c != 255:
                    break
        if ip + lit > n:
            raise FrameError("literals run past the block")
        out += payload[ip: ip + lit]
        ip += lit
        if ip == n:
            return
        off = payload[ip] | (payload[ip + 1] << 8)
        ip += 2
        ml = token & 15
        if ml == 15:
            while True:
                c = payload[ip]
                ip += 1
                ml += c
                if c != 255:
                    break
        ml += 4
        if off == 0 or off > len(out) or off > MAX_DISTANCE:
            raise FrameError(f"offset {off} with {len(out)} bytes of output")
        start = len(out) - off
        if off >= ml:
            out += out[start: start + ml]
        else:  # overlapping copy: the last ``off`` bytes repeat
            pattern = out[start:]
            out += (pattern * (ml // off + 1))[:ml]
    raise FrameError("block ends without its last literals")


def decode_frame(frame: bytes) -> bytes:
    """The bytes a modern frame (dependent blocks, no checksums) holds."""
    out = bytearray()
    for _, stored, payload in frame_blocks(frame):
        if stored:
            out += payload
        else:
            decode_block(payload, out)
    return bytes(out)


def bytes_unlike(got: bytes, want: bytes) -> int:
    """Positions at which two byte strings differ, a length difference
    counting each missing or extra byte."""
    import numpy as np

    n = min(len(got), len(want))
    a = np.frombuffer(got, np.uint8, n)
    b = np.frombuffer(want, np.uint8, n)
    return int(np.count_nonzero(a != b)) + abs(len(got) - len(want))
