"""Engine dispatch for the public compress/decompress API of the port.

Engines:
  'device' — the device pipeline (ops.pipeline) on a torch.device, with
             the search kernel 'chunk', 'sort' or 'walk': a CUDA device runs
             the hand-written kernels, the CPU their plain PyTorch versions.
  'native' — the C++ host runtime (smallz4_tpu_torch.native).
  'auto'   — 'device' for compress; 'native' for decompress, whose device
             decode is not ported yet (ROADMAP.md, queue 1: decode).
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


def decompress(data, dictionary=None, engine="auto") -> bytes:
    """Native decode for 'auto' and 'native'; 'device' raises until the
    decode slice is ported."""
    _check(engine)
    if engine == "device":
        raise NotImplementedError(
            "device decode is not ported yet (ROADMAP.md, queue 1: decode); "
            "use engine='native'")
    return native.decompress(data, dictionary=dictionary)
