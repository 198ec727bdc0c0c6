"""The benchmark's source bytes: the pinned fixture and the generators over it.

``realcorpus.bin.xz`` is 10,000,000 bytes of C headers, vendored with its
sha256 so that every machine compresses the same bytes; a mismatch fails
the run.  ``recombine`` joins pieces of it with log-uniform lengths, the
same pieces for every seed, in a seeded order, the way a tarball joins
files of one source tree.  ``make_corpus`` is a seeded Silesia-like mix of
prose, records, binary and runs, for a later cell of mixed data.
"""
from __future__ import annotations

import hashlib
import lzma
import pathlib

import numpy as np

DATA = pathlib.Path(__file__).resolve().parent.parent / "data"
FIXTURES = {
    # name: (file, sha256 of the decompressed bytes)
    "realcorpus": ("realcorpus.bin.xz", "3e31bcc300eaa43295c61bac3ccf1a8cea"
                   "3720490cd5a40066d6a8f64ff582f6"),
}


def fixture(name: str) -> bytes:
    """The decompressed fixture, checked against its pin."""
    file, pin = FIXTURES[name]
    data = lzma.decompress((DATA / file).read_bytes())
    digest = hashlib.sha256(data).hexdigest()
    if digest != pin:
        raise RuntimeError(f"{file}: sha256 {digest} is not the pinned {pin}")
    return data


def log_uniform_sizes(lo: int, hi: int, count: int) -> list:
    """``count`` sizes at the mid-quantiles of a log-uniform law on
    [lo, hi]: the same sizes for every seed."""
    q = (np.arange(count) + 0.5) / count
    return [int(round(lo * (hi / lo) ** x)) for x in q]


def pieces(source: bytes, n: int, piece_min: int, piece_max: int) -> list:
    """(offset, length) of pieces of ``source`` with log-uniform lengths on
    [piece_min, piece_max], ``n`` bytes in all, drawn once for every seed
    (the same content, so a run's work does not follow its seed)."""
    rng = np.random.default_rng(0)
    out, total = [], 0
    span = np.log(piece_max / piece_min)
    while total < n:
        take = int(piece_min * np.exp(rng.random() * span))
        take = min(take, n - total, len(source))
        out.append((int(rng.integers(0, len(source) - take + 1)), take))
        total += take
    return out


def recombine(source: bytes, n: int, rng: np.random.Generator,
              piece_min: int, piece_max: int) -> bytes:
    """``n`` bytes: the pieces of ``pieces`` in an order drawn from
    ``rng``, joined the way a tarball joins a source tree's files."""
    cut = pieces(source, n, piece_min, piece_max)
    order = rng.permutation(len(cut))
    return b"".join(source[cut[k][0]: cut[k][0] + cut[k][1]] for k in order)


def make_corpus(n: int, seed: int) -> bytes:
    """Seeded Silesia-like mix: text-heavy with structured and binary
    regions (a copy of the JAX package's ``bench.make_corpus``, with the
    seed as an argument)."""
    rng = np.random.default_rng(seed)
    words = [
        b"the", b"of", b"and", b"compression", b"lz4", b"block", b"match",
        b"offset", b"literal", b"frame", b"data", b"stream", b"token",
        b"entropy", b"window", b"hash", b"parse", b"optimal", b"sequence",
        b"buffer", b"kernel", b"device", b"vector", b"tensor", b"shard",
    ]
    out = bytearray()
    while len(out) < n:
        k = len(out) % 7
        if k < 4:  # prose
            sent = b" ".join(words[i] for i in rng.integers(0, len(words), 12))
            out += sent + b". "
        elif k == 4:  # structured records
            row = b"%08d,%s,%04x;" % (
                len(out), words[int(rng.integers(0, len(words)))],
                int(rng.integers(0, 65536)))
            out += row * 40
        elif k == 5:  # binary
            out += rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
        else:  # runs
            out += bytes([int(rng.integers(32, 127))]) * int(
                rng.integers(50, 400))
    return bytes(out[:n])
