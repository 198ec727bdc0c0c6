"""Equal-byte run lengths: plain PyTorch and the CUDA kernel.

Port of ``run_lengths`` in ``smallz4_tpu/ops/pallas_kernels.py``.  For each
byte row, ``R[i]`` is the length of the maximal run of equal bytes starting
at ``i``: the distance to the nearest run boundary at or after ``i``, plus
one.  The last byte of a row is always a boundary.

A CPU tensor takes the plain version (a reversed cumulative minimum of the
boundary indices); a CUDA tensor takes ``csrc/runlen.cu`` (a tile scan with
a carry across tiles).  The reference's other kernel there, ``gram_hash``,
belongs to the walk engine and is not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from . import _cuda

RL_TILE = 1024  # elements per block of csrc/runlen.cu


def _rows(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.uint8 or x.dim() not in (1, 2) or x.shape[-1] < 1:
        raise ValueError(f"run_lengths takes uint8 [n] or [B, n] with n >= 1,"
                         f" got {x.dtype} {tuple(x.shape)}")
    return (x if x.dim() == 2 else x.unsqueeze(0)).contiguous()


def run_lengths_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``run_lengths`` (any device)."""
    xb = _rows(x)
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
    xb = _rows(x)
    if not _cuda.on_cuda(xb):
        return run_lengths_plain(x)
    B, n = xb.shape
    out = torch.empty(B, n, dtype=torch.int32, device=xb.device)
    scratch = torch.empty(2 * B * (-(-n // RL_TILE)), dtype=torch.int32,
                          device=xb.device)
    _cuda.launch("run_lengths", "s4_run_lengths", xb.device, xb.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), B, n)
    return out.reshape(x.shape)
