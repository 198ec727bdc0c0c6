"""ctypes binding to the repository's C++ host runtime, built for the port.

The port's own binding of the entry points it calls: the one-shot frame
encoder and decoder, the block-level stages of the device pipeline (claim
unpacking, refine, optimal-parse DP, emit) and the sequence parse of the
device decode.  At first use the runtime is compiled from
``native/src/tlz4.cpp`` with the flags of ``native/Makefile`` into
``smallz4_tpu_torch/build/libtlz4.so``.  The build
holds a file lock, compiles into a per-process temporary file and renames
it into place, so concurrent processes build it once and never load a
half-written library; a stamp file beside it holds the hash of the sources
and flags.  Nothing is written into ``native/``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from . import format as fmt

_PKG = pathlib.Path(__file__).resolve().parent
_NATIVE_DIR = _PKG.parent / "native"
SOURCE = _NATIVE_DIR / "src" / "tlz4.cpp"
INCLUDE = _NATIVE_DIR / "include"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libtlz4.so"

_lock = threading.Lock()
_lib = None

_ERRORS = {
    -1: "bad argument",
    -2: "output buffer too small",
    -3: "invalid signature",
    -4: "only LZ4 file format version 1 supported",
    -5: "invalid offset",
    -6: "out of data",
    -7: "checksum mismatch",
}


def _raise(code: int):
    msg = _ERRORS.get(code, f"native error {code}")
    if code in (-3, -4, -5, -6, -7):
        raise fmt.FormatError(msg)
    raise ValueError(msg)


def _cxx_flags(cxx: str) -> list[str]:
    """native/Makefile's CXXFLAGS: -mavx2 where the compiler accepts it."""
    flags = ["-O3", "-Wall", "-Wextra", "-std=c++17", "-fPIC"]
    probe = subprocess.run([cxx, "-mavx2", "-E", "-x", "c", os.devnull],
                           capture_output=True)
    if probe.returncode == 0:
        flags.append("-mavx2")
    return flags + ["-shared", f"-I{INCLUDE}"]


def build() -> pathlib.Path:
    """Compile the runtime unless the library matches the current sources
    and flags; returns the library path."""
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, *_cxx_flags(cxx), str(SOURCE)]
    h = hashlib.sha256(" ".join(cmd).encode())
    for src in (SOURCE, *sorted(INCLUDE.glob("*.h"))):
        h.update(src.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / (LIB_NAME + ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
        if (lib_path.is_file() and stamp.is_file()
                and stamp.read_text() == digest):
            return lib_path
        tmp = BUILD_DIR / f".{LIB_NAME}.{os.getpid()}"
        res = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                             text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed:\n{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: a loader sees old or new
        stamp.write_text(digest)
    return lib_path


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64, c_int = ctypes.c_int64, ctypes.c_int
        for name, args in {
            "tlz4_compress_bound": [i64],
            "tlz4_compress": [u8p, i64, u8p, i64, c_int, c_int, u8p, i64, i64],
            "tlz4_decompress": [u8p, i64, u8p, i64, u8p, i64],
            "tlz4_match_block_ex": [u8p, i64, i64, i64, c_int, i64, i64, i32p,
                                    i32p],
            "tlz4_match_block_ex2": [u8p, i64, i64, i64, c_int, i64, i64, i64,
                                     i32p, i32p],
            "tlz4_match_refine": [u8p, i64, i64, i64, i64, i64, u8p, i32p,
                                  i32p],
            "tlz4_match_refine2": [u8p, i64, i64, i64, i64, i64, u8p, i32p,
                                   i32p, i32p],
            "tlz4_chosen": [i32p, i64, u8p],
            "tlz4_estimate_costs": [i32p, i32p, i64],
            "tlz4_unpack_claims": [u32p, i32p, i64, i64, i32p, i32p],
            "tlz4_emit_block": [u8p, i64, i32p, i32p, u8p, i64],
            "tlz4_parse_sequences": [u8p, i64, i32p, i32p, i32p, i32p, i64],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i64
        _lib = lib
        return _lib


def _u8(buf) -> np.ndarray:
    if isinstance(buf, np.ndarray):
        return np.ascontiguousarray(buf, dtype=np.uint8)
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        buf = bytes(buf)
    return np.frombuffer(buf, dtype=np.uint8)


def _ptr(arr: np.ndarray):
    if arr.size == 0:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _ptr32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check(r: int) -> int:
    if r < 0:
        _raise(r)
    return r


def compress(data, level=9, legacy=False, dictionary=None,
             block_size=None) -> bytes:
    """One-shot frame encode (the reference's sequential encoder)."""
    lib = _load()
    if legacy and dictionary:
        raise ValueError("legacy format doesn't support dictionaries")
    if legacy and level == 0:
        raise ValueError("legacy format doesn't support uncompressed files")
    fmt.level_to_max_chain(level)  # validate
    src = _u8(data)
    d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
    cap = lib.tlz4_compress_bound(len(src))
    dst = np.empty(cap, np.uint8)
    r = _check(lib.tlz4_compress(_ptr(src), len(src), _ptr(dst), cap, level,
                                 int(legacy), _ptr(d), len(d),
                                 block_size or 0))
    return dst[:r].tobytes()


def decompress(data, dictionary=None) -> bytes:
    """One-shot frame decode; the output buffer grows fourfold until the
    frame fits (the frame header carries no content size)."""
    lib = _load()
    src = _u8(data)
    d = _u8(dictionary) if dictionary else np.zeros(0, np.uint8)
    cap = max(4 * len(src), 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        r = lib.tlz4_decompress(_ptr(src), len(src), _ptr(out), cap,
                                _ptr(d), len(d))
        if r != -2:  # -2: output buffer too small
            return out[:_check(r)].tobytes()
        cap *= 4


def match_block_ex(buf, base: int, bs: int, level: int, lookback: int,
                   cut_pos: int, lens: np.ndarray, dists: np.ndarray) -> None:
    """Match search into caller-provided arrays, with an explicit boundary
    chain-cut position."""
    b = _u8(buf)
    _check(_load().tlz4_match_block_ex(_ptr(b), len(b), base, bs, level,
                                       lookback, cut_pos, _ptr32(lens),
                                       _ptr32(dists)))


def match_chunk(buf, base: int, bs: int, level: int, lookback: int,
                cut_pos: int, block_end: int, lens: np.ndarray,
                dists: np.ndarray) -> None:
    """Match search of positions [base, base+bs) of a block that ends at
    ``block_end`` (levels 7-9): the block's end rules, the chunk's own
    lookback; bit-identical to those positions of the whole-block search
    where no giant byte run reaches the chunk's start."""
    b = _u8(buf)
    _check(_load().tlz4_match_block_ex2(_ptr(b), len(b), base, bs, level,
                                        lookback, cut_pos, block_end,
                                        _ptr32(lens), _ptr32(dists)))


def match_refine(buf, base: int, bs: int, lookback: int, mask: np.ndarray,
                 lens: np.ndarray, dists: np.ndarray,
                 cut_pos: int = -1) -> None:
    """Re-run the level-9 search at masked positions only, in place.
    ``cut_pos``: boundary chain-cut position (-1 for none)."""
    b = _u8(buf)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    _check(_load().tlz4_match_refine(_ptr(b), len(b), base, bs, lookback,
                                     cut_pos, _ptr(m), _ptr32(lens),
                                     _ptr32(dists)))


def match_refine_dist(buf, base: int, bs: int, lookback: int,
                      mask: np.ndarray, targets: np.ndarray,
                      lens: np.ndarray, dists: np.ndarray,
                      cut_pos: int = -1) -> None:
    """Distance-only refine at masked positions: ``targets`` holds each
    position's certified exact length; writes lens and dists in place."""
    b = _u8(buf)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    t = np.ascontiguousarray(targets, dtype=np.int32)
    _check(_load().tlz4_match_refine2(_ptr(b), len(b), base, bs, lookback,
                                      cut_pos, _ptr(m), _ptr32(t),
                                      _ptr32(lens), _ptr32(dists)))


def chosen_mask(lens: np.ndarray) -> np.ndarray:
    """Match starts of a DP-shortened lens array: True where a match is
    emitted."""
    assert lens.dtype == np.int32
    out = np.zeros(len(lens), np.uint8)
    _check(_load().tlz4_chosen(_ptr32(lens), len(lens), _ptr(out)))
    return out.astype(bool)


def unpack_claims(bits: np.ndarray, packed: np.ndarray, n: int):
    """Expand one chunk's head/delta packing into per-position (lens,
    dists) int32 arrays."""
    b = np.ascontiguousarray(bits, dtype=np.uint32)
    p = np.ascontiguousarray(packed, dtype=np.int32)
    lens = np.empty(n, np.int32)
    dists = np.empty(n, np.int32)
    _check(_load().tlz4_unpack_claims(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), _ptr32(p), len(p),
        n, _ptr32(lens), _ptr32(dists)))
    return lens, dists


def estimate_costs(lens: np.ndarray, dists: np.ndarray) -> None:
    """The optimal-parse DP, in place: lens become the chosen lengths."""
    assert lens.dtype == np.int32 and dists.dtype == np.int32
    _check(_load().tlz4_estimate_costs(_ptr32(lens), _ptr32(dists),
                                       len(lens)))


def emit_block(block, lens: np.ndarray, dists: np.ndarray) -> bytes:
    """Serialize one block's chosen matches into its LZ4 payload."""
    b = _u8(block)
    cap = len(b) + len(b) // 255 + 64
    out = np.empty(cap, np.uint8)
    r = _check(_load().tlz4_emit_block(_ptr(b), len(b), _ptr32(lens),
                                       _ptr32(dists), _ptr(out), cap))
    return out[:r].tobytes()


def parse_sequences(payload):
    """Split a compressed block payload into its sequence table: int32
    (lit_len, match_len, match_off, lit_src), one entry a sequence; the
    final literals-only sequence has match_len and match_off 0."""
    lib = _load()
    p = _u8(payload)
    max_seq = len(p) + 2
    lit_len = np.empty(max_seq, np.int32)
    match_len = np.empty(max_seq, np.int32)
    match_off = np.empty(max_seq, np.int32)
    lit_src = np.empty(max_seq, np.int32)
    r = _check(lib.tlz4_parse_sequences(_ptr(p), len(p), _ptr32(lit_len),
                                        _ptr32(match_len), _ptr32(match_off),
                                        _ptr32(lit_src), max_seq))
    return lit_len[:r], match_len[:r], match_off[:r], lit_src[:r]
