"""Gram + hash and equal-byte run lengths: plain PyTorch and the CUDA kernels.

Port of ``smallz4_tpu/ops/pallas_kernels.py``; both take a uint8 row
``[n]`` or rows ``[B, n]``, each row on its own.

* ``gram_hash``: the little-endian 4-byte gram at every position and the
  reference's LCG hash of it (``grams.grams4`` + ``grams.hash20`` in one
  pass).  The last three grams of a row read past its end as the reference
  kernel lays the bytes out there: zero padding up to the next multiple of
  its 32 Ki-element tile, and past that the last tile's own first bytes
  (the last tile is its own successor).  Callers mask those grams.
* ``run_lengths``: ``R[i]`` is the length of the maximal run of equal bytes
  starting at ``i``: the distance to the nearest run boundary at or after
  ``i``, plus one.  The last byte of a row is always a boundary.

A CPU tensor takes the plain version; a CUDA tensor takes
``csrc/gramhash.cu`` (one elementwise pass) or ``csrc/runlen.cu`` (one
single-pass scan with decoupled look-back).
"""
from __future__ import annotations

import torch

from . import _cuda
from .grams import hash20, to_i32

GH_TILE = 256 * 128  # elements per tile of the reference's gram_hash kernel


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dtype != torch.uint8 or x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"{name} takes uint8 [n] or [B, n] with n >= 1, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return (x if x.dim() == 2 else x.unsqueeze(0)).contiguous()


def gram_hash_plain(x: torch.Tensor):
    """Plain PyTorch version of ``gram_hash`` (any device)."""
    xb = _rows(x, "gram_hash")
    n = xb.shape[-1]
    m = -(-n // GH_TILE) * GH_TILE  # the row padded to whole tiles
    c = torch.zeros(xb.shape[0], n + 3, dtype=torch.int64, device=xb.device)
    c[:, :n] = xb
    for i in range(m, n + 3):  # past the padding: the last tile's head
        c[:, i] = xb[:, i - GH_TILE]
    g = to_i32(c[:, :n] | (c[:, 1:n + 1] << 8) | (c[:, 2:n + 2] << 16)
               | (c[:, 3:n + 3] << 24))
    return g.reshape(x.shape), hash20(g).reshape(x.shape)


def gram_hash(x: torch.Tensor):
    """(grams, hash20), int32 of the shape of ``x``, of a uint8 row ``[n]``
    or of each row of ``[B, n]``."""
    xb = _rows(x, "gram_hash")
    if not _cuda.on_cuda(xb):
        return gram_hash_plain(x)
    B, n = xb.shape
    g = torch.empty(B, n, dtype=torch.int32, device=xb.device)
    h = torch.empty_like(g)
    _cuda.launch("gram_hash", "s4_gram_hash", xb.device, xb.data_ptr(),
                 g.data_ptr(), h.data_ptr(), B, n)
    return g.reshape(x.shape), h.reshape(x.shape)


def run_lengths_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``run_lengths`` (any device)."""
    xb = _rows(x, "run_lengths")
    n = xb.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=xb.device)
    boundary = torch.ones(xb.shape, dtype=torch.bool, device=xb.device)
    boundary[:, :-1] = xb[:, :-1] != xb[:, 1:]
    v = torch.where(boundary, idx, n)
    nearest = v.flip(-1).cummin(-1).values.flip(-1)
    return (nearest - idx + 1).to(torch.int32).reshape(x.shape)


def run_lengths(x: torch.Tensor) -> torch.Tensor:
    """Run lengths (int32, the shape of ``x``) of a uint8 row ``[n]`` or of
    each row of ``[B, n]``."""
    xb = _rows(x, "run_lengths")
    if not _cuda.on_cuda(xb):
        return run_lengths_plain(x)
    if xb.data_ptr() % 16:  # the kernel reads 16-byte words
        xb = xb.clone()
    B, n = xb.shape
    out = torch.empty(B, n, dtype=torch.int32, device=xb.device)
    tiles = -(-B * n // _cuda.lib().s4_run_lengths_tile())
    state, epoch = _cuda.tile_state("run_lengths", xb.device, tiles)
    _cuda.launch("run_lengths", "s4_run_lengths", xb.device, xb.data_ptr(),
                 out.data_ptr(), state.data_ptr(), B, n, epoch)
    return out.reshape(x.shape)
