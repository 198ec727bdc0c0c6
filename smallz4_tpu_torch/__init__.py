"""smallz4_tpu_torch — the PyTorch + CUDA port of smallz4_tpu.

The level-9 encode runs its match search on a torch device (hand-written
CUDA kernels for Hopper on a GPU, their plain PyTorch versions on the CPU)
and shares the JAX-free host layer of smallz4_tpu (format, the C++ native
runtime, the host thread pool).  Streams are bit-identical to
``smallz4 -9``.

    compress(data, level=9, legacy=False, dictionary=None,
             engine="device", device="cuda") -> bytes
    decompress(data, dictionary=None) -> bytes
"""
from smallz4_tpu.format import VERSION, FormatError  # noqa: F401


def get_version() -> str:
    """Behavioral parity version (the reference's)."""
    return VERSION


def compress(data, level: int = 9, legacy: bool = False, dictionary=None,
             block_size=None, engine: str = "auto", device="cuda") -> bytes:
    """Compress to a complete LZ4 frame.  ``engine``: 'auto' | 'native' |
    'device'; ``device`` is the torch device of the 'device' engine."""
    from .codec import compress as _compress
    return _compress(data, level=level, legacy=legacy, dictionary=dictionary,
                     block_size=block_size, engine=engine, device=device)


def decompress(data, dictionary=None, engine: str = "auto") -> bytes:
    """Decompress a complete LZ4 frame (modern or legacy)."""
    from .codec import decompress as _decompress
    return _decompress(data, dictionary=dictionary, engine=engine)
