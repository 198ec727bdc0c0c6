"""smallz4_tpu_torch — the PyTorch + CUDA port of smallz4_tpu.

The level-9 encode runs its match search on a torch device, and the device
decode its block expansion: hand-written CUDA kernels for Hopper on a GPU,
their plain PyTorch versions on the CPU.  The host side (format, the C++
runtime built from ``native/``, the worker pool) is the port's own copy.
Streams are bit-identical to ``smallz4 -9``.

    compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             engine="auto", device="cuda", kernel=None) -> bytes
    decompress(data, dictionary=None, engine="auto", device="cuda") -> bytes
    decompress_batch(frames, dictionary=None, engine="auto",
                     device="cuda") -> list
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


def decompress(data, dictionary=None, engine: str = "auto",
               device="cuda") -> bytes:
    """Decompress a complete LZ4 frame (modern or legacy).  ``engine``:
    'auto' (= 'native') | 'native' | 'device'; the device decode runs on
    ``device`` (a CUDA device by default; without one it raises, pass
    device='cpu' for the plain version)."""
    from .codec import decompress as _decompress
    return _decompress(data, dictionary=dictionary, engine=engine,
                       device=device)


def decompress_batch(frames, dictionary=None, engine: str = "auto",
                     device="cuda") -> list:
    """Decode many independent frames; engine='device' expands block r of
    every frame in one call on ``device``."""
    from .codec import decompress_batch as _db
    return _db(frames, dictionary=dictionary, engine=engine, device=device)
