"""Engine dispatch for the public compress/decompress API of the port.

Engines:
  'device' — the chunk-engine pipeline (ops.pipeline) on an explicit
             torch.device: a CUDA device runs the hand-written kernels, the
             CPU their plain PyTorch versions.
  'native' — the shared C++ host runtime (smallz4_tpu.native).
  'auto'   — 'native', as the reference's 'auto' never picks the device.
"""
from __future__ import annotations

from smallz4_tpu import native

ENGINES = ("auto", "native", "device")


def _check(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")


def compress(data, level=9, legacy=False, dictionary=None, block_size=None,
             engine="auto", device="cuda") -> bytes:
    _check(engine)
    if engine == "device":
        from .ops import pipeline
        return pipeline.compress(data, level=level, legacy=legacy,
                                 dictionary=dictionary, block_size=block_size,
                                 device=device)
    return native.compress(data, level=level, legacy=legacy,
                           dictionary=dictionary, block_size=block_size)


def decompress(data, dictionary=None, engine="auto") -> bytes:
    _check(engine)
    if engine == "device":
        raise NotImplementedError(
            "device decode is not ported yet (ROADMAP.md, queue 1: decode); "
            "use engine='native'")
    return native.decompress(data, dictionary=dictionary)
