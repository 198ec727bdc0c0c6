"""Engine dispatch for the public compress/decompress API of the port.

Engines:
  'device' — the device pipeline (ops.pipeline) on a torch.device, with
             the search kernel 'chunk', 'sort' or 'walk': a CUDA device runs
             the hand-written kernels, the CPU their plain PyTorch versions.
  'native' — the C++ host runtime (smallz4_tpu_torch.native).
  'auto'   — 'device' for compress; 'native' for decompress and
             decompress_batch, as in the reference's codec.
"""
from __future__ import annotations

from . import native

ENGINES = ("auto", "native", "device")


def _check(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             engine="auto", device="cuda", kernel=None) -> bytes:
    _check(engine)
    if engine == "native":
        return native.compress(data, level=level, legacy=legacy,
                               dictionary=dictionary, block_size=block_size)
    from .ops import pipeline
    return pipeline.compress(data, level=level, legacy=legacy,
                             dictionary=dictionary, block_size=block_size,
                             device=device, kernel=kernel)


def decompress(data, dictionary=None, engine="auto", device="cuda") -> bytes:
    """'device' expands the blocks on ``device`` (ops.pipeline.decompress);
    'auto' and 'native' run the native decoder."""
    _check(engine)
    if engine == "device":
        from .ops import pipeline
        return pipeline.decompress(data, dictionary=dictionary, device=device)
    return native.decompress(data, dictionary=dictionary)


def decompress_batch(frames, dictionary=None, engine="auto",
                     device="cuda") -> list:
    """Decode many independent frames.  'device' expands block r of every
    frame in one call on ``device`` (ops.decoder.decompress_batch); 'auto'
    and 'native' loop the native decoder."""
    _check(engine)
    if engine == "device":
        from .ops import decoder
        return decoder.decompress_batch(frames, dictionary=dictionary,
                                        device=device)
    return [native.decompress(f, dictionary=dictionary) for f in frames]
