"""smallz4_tpu_torch — the PyTorch + CUDA port of smallz4_tpu.

The level-9 encode runs its match search on a torch device: hand-written
CUDA kernels for Hopper on a GPU, their plain PyTorch versions on the CPU.
The host side (format, the C++ runtime built from ``native/``, the worker
pool) is the port's own copy.  Streams are bit-identical to ``smallz4 -9``.

    compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             engine="auto", device="cuda", kernel=None) -> bytes
    decompress(data, dictionary=None) -> bytes
"""
from .format import VERSION, FormatError  # noqa: F401


def get_version() -> str:
    """Behavioral parity version (the reference's)."""
    return VERSION


def compress(data, level: int = 9, legacy: bool = False, dictionary=None,
             block_size=None, engine: str = "auto", device="cuda",
             kernel: str | None = None) -> bytes:
    """Compress to a complete LZ4 frame.  ``engine``: 'auto' (= 'device')
    | 'device' | 'native'.  The device engine runs on ``device`` (a CUDA
    device by default; without one it raises, pass device='cpu' for the
    plain versions) with search ``kernel`` 'chunk', 'sort' or 'walk' (None
    reads $SMALLZ4_TPU_KERNEL; see ops.pipeline.compress)."""
    from .codec import compress as _compress
    return _compress(data, level=level, legacy=legacy, dictionary=dictionary,
                     block_size=block_size, engine=engine, device=device,
                     kernel=kernel)


def decompress(data, dictionary=None, engine: str = "auto") -> bytes:
    """Decompress a complete LZ4 frame (modern or legacy) with the native
    decoder; the device decode is not ported yet."""
    from .codec import decompress as _decompress
    return _decompress(data, dictionary=dictionary, engine=engine)
