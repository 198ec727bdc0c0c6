"""Gram views of byte rows: the 4-byte gram, its hash and the mismatch count.

Port of ``smallz4_tpu/ops/grams.py``.  The reference holds grams as uint32.
Torch on the CPU has no uint32 multiply, shift or compare, so the port holds
them as int32 with the same bits (equality and xor are unchanged) and does
uint32 products in int64 with 16-bit halves of the constant.  Every function
takes a row ``[n]`` or rows ``[..., n]``.
"""
from __future__ import annotations

import torch

from .. import format as fmt

M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32): 16-bit halves of the
    constant keep every product below 2^63."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits -> their uint32 value in int64."""
    return x.to(torch.int64) & M32


def grams4(ctx_u8: torch.Tensor) -> torch.Tensor:
    """int32 bits of the little-endian 4-byte gram at every position (the
    shape of the input; the last 3 entries of a row are 0 and must be masked
    by the caller)."""
    c = ctx_u8.to(torch.int64)
    g = torch.zeros_like(c)
    if c.shape[-1] >= 4:
        g[..., :-3] = (c[..., :-3] | (c[..., 1:-2] << 8) | (c[..., 2:-1] << 16)
                       | (c[..., 3:] << 24))
    return to_i32(g)


def hash20(grams: torch.Tensor) -> torch.Tensor:
    """The reference's LCG hash (smallz4.h:163-169) of int32 gram bits:
    (g * HASH_MULTIPLIER mod 2^32) >> 12, int32 in [0, 2^20)."""
    prod = mul32(to_u32(grams), fmt.HASH_MULTIPLIER)
    return (prod >> (32 - fmt.HASH_BITS)).to(torch.int32)


def mismatch_bytes_in_u32(x: torch.Tensor) -> torch.Tensor:
    """Number of equal low-order bytes before the first differing byte of a
    xor'd little-endian word (0..3; the caller handles x == 0 as 4)."""
    return torch.where((x & 0xFF) != 0, 0,
           torch.where((x & 0xFF00) != 0, 1,
           torch.where((x & 0xFF0000) != 0, 2, 3))).to(torch.int32)
