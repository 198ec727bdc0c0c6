"""LZ4 frame and block format: the constants, headers and header parsing.

The port's own copy of what it uses from ``smallz4_tpu/format.py`` (the
reference's format layer, parity notes there): block-end rules, the
match-finder hash, window and block sizes, the frame header, block size
words and the end mark on the write side; the frame and block header
parsers and the skippable-frame magic on the decode side.  Pure Python; no
kernels.
"""
from __future__ import annotations

import dataclasses
import struct

MIN_MATCH = 4                    # minimum match length
BLOCK_END_NO_MATCH = 12          # no match starts within 12 B of block end
BLOCK_END_LITERALS = 5           # last 5 bytes of a block are always literals

HASH_BITS = 20                   # match-finder hash width
HASH_MULTIPLIER = 48271          # LCG multiplier (smallz4.h:164-169)

MAX_DISTANCE = 65535             # match window (u16 offsets)
MAX_CHAIN_LENGTH = MAX_DISTANCE  # "unlimited" chain steps => optimal parsing
MAX_SAME_LETTER = 19 + 255 * 256  # run-shortcut threshold (smallz4.h:118)

MAX_BLOCK_SIZE_ID = 7
MAX_BLOCK_SIZE = 4 * 1024 * 1024
MAX_BLOCK_SIZE_LEGACY = 8 * 1024 * 1024

VERSION = "1.5"                  # behavioral parity version (smallz4.h:67-70)

MAGIC_MODERN = 0x184D2204
MAGIC_LEGACY = 0x184C2102
MAGIC_MODERN_BYTES = struct.pack("<I", MAGIC_MODERN)   # 04 22 4D 18
MAGIC_LEGACY_BYTES = struct.pack("<I", MAGIC_LEGACY)   # 02 21 4C 18
# skippable frames (LZ4 frame spec): 0x184D2A50..0x184D2A5F + u32 size; the
# decoders skip them ahead of a frame
MAGIC_SKIPPABLE_BASE = 0x184D2A50
MAGIC_SKIPPABLE_MASK = 0xFFFFFFF0
# magic + FLG (version 1, dependent blocks, no checksums) + BD (4 MB max
# block) + the header checksum byte of that descriptor (smallz4.h:486-495)
MODERN_FRAME_HEADER = MAGIC_MODERN_BYTES + bytes(
    (1 << 6, MAX_BLOCK_SIZE_ID << 4, 0xDF))

STORED_FLAG = 0x80000000         # high bit of the block size word => stored
END_MARK = struct.pack("<I", 0)


class FormatError(ValueError):
    """Corrupt or unsupported stream."""


@dataclasses.dataclass(frozen=True)
class FrameInfo:
    """Parsed frame header."""
    legacy: bool
    has_block_checksum: bool = False
    has_content_size: bool = False
    has_content_checksum: bool = False
    has_dictionary_id: bool = False
    header_size: int = 4          # bytes consumed from the stream


def parse_frame_header(buf: bytes) -> FrameInfo:
    """Parse a frame header from the start of ``buf``.  Optional fields
    (content size, dictionary id, checksums) are skipped, not verified;
    only format version 1 is accepted."""
    if len(buf) < 4:
        raise FormatError("out of data")
    magic = struct.unpack_from("<I", buf, 0)[0]
    if magic == MAGIC_LEGACY:
        return FrameInfo(legacy=True, header_size=4)
    if magic != MAGIC_MODERN:
        raise FormatError("invalid signature")
    if len(buf) < 7:
        raise FormatError("out of data")
    flags = buf[4]
    if (flags >> 6) != 1:
        raise FormatError("only LZ4 file format version 1 supported")
    has_content_size = bool(flags & 8)
    has_dictionary_id = bool(flags & 1)
    size = 4 + 1 + 1 + 1  # magic, FLG, BD, header checksum byte
    if has_content_size:
        size += 8
    if has_dictionary_id:
        size += 4
    if len(buf) < size:
        raise FormatError("out of data")
    return FrameInfo(
        legacy=False,
        has_block_checksum=bool(flags & 16),
        has_content_size=has_content_size,
        has_content_checksum=bool(flags & 4),
        has_dictionary_id=has_dictionary_id,
        header_size=size,
    )


def parse_block_header(word: bytes, legacy: bool) -> tuple[int, bool]:
    """-> (payload_size, is_compressed) of a u32 LE block size word."""
    if len(word) < 4:
        raise FormatError("out of data")
    raw = struct.unpack("<I", word[:4])[0]
    if legacy:
        return raw, True
    return raw & 0x7FFFFFFF, (raw & STORED_FLAG) == 0


def skip_skippable(data: bytes) -> bytes:
    """``data`` past its leading skippable frames."""
    while len(data) >= 8:
        magic = struct.unpack_from("<I", data, 0)[0]
        if (magic & MAGIC_SKIPPABLE_MASK) != MAGIC_SKIPPABLE_BASE:
            break
        size = struct.unpack_from("<I", data, 4)[0]
        if 8 + size > len(data):
            raise FormatError("out of data")
        data = data[8 + size:]
    return data


def level_to_max_chain(level: int) -> int:
    """CLI level -> match-chain step budget: 0..8 as given, 9 unlimited."""
    if not 0 <= level <= 9:
        raise ValueError(f"compression level must be 0..9, got {level}")
    return MAX_CHAIN_LENGTH if level == 9 else level


def build_frame_header(legacy: bool = False) -> bytes:
    """The frame header the reference writes (no checksums)."""
    return MAGIC_LEGACY_BYTES if legacy else MODERN_FRAME_HEADER


def build_block_header(payload_size: int, stored: bool,
                       legacy: bool = False) -> bytes:
    """u32 LE block size word; modern stored blocks set the high bit.
    Legacy blocks are always 'compressed'."""
    if payload_size >= STORED_FLAG:
        raise ValueError("block payload too large")
    tag = payload_size | (STORED_FLAG if (stored and not legacy) else 0)
    return struct.pack("<I", tag)


def build_end_mark(legacy: bool = False) -> bytes:
    """Modern frames end with a zero-size block; legacy frames just stop."""
    return b"" if legacy else END_MARK
