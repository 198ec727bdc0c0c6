"""Record sort and merge: plain PyTorch and the CUDA kernels.

Port of ``smallz4_tpu/ops/sortnet.py`` (``sort_records``, ``merge_sorted``).
Records are int32 planes stacked as one tensor, ``[P, n]`` or, with a
leading batch dimension, ``[B, P, n]`` (one launch sorts every row).  They
sort lexicographically by the first ``n_keys`` planes compared as
*unsigned* 32-bit words, then, unless ``unique``, by plane ``n_keys`` (pos,
signed int32) as the tiebreak; the remaining planes ride along.

A CPU tensor takes the plain version (stable ``torch.sort`` passes from the
least significant key up); a CUDA tensor takes ``csrc/sortnet.cu``, a block
merge sort: 4096-record tiles sorted in registers and shared memory, then
merge passes in which each block stages both input ranges in shared memory,
merges 2048 outputs there and writes them plane by plane.  Both are stable:
records with equal keys (and tiebreak) keep their input order, and a merge
puts the first half's record first.  So the kernel equals the plain version
on any input; with distinct (keys, tiebreak), as on every main-path call,
the reference's bitonic network gives the same output too.
"""
from __future__ import annotations

import torch

from . import _cuda

SIGN = -0x80000000  # int32 sign bit: x ^ SIGN orders int32 as unsigned


def _batched(planes: torch.Tensor, n_keys: int, unique: bool, min_n: int):
    if planes.dtype != torch.int32:
        raise TypeError(f"record planes must be int32, got {planes.dtype}")
    if planes.dim() not in (2, 3):
        raise ValueError(f"planes must be [P, n] or [B, P, n], got "
                         f"{tuple(planes.shape)}")
    x = planes if planes.dim() == 3 else planes.unsqueeze(0)
    n = x.shape[-1]
    if n & (n - 1) or n < min_n:
        raise ValueError(f"record count must be a power of two >= {min_n}: {n}")
    if not 1 <= n_keys <= x.shape[1] - (0 if unique else 1):
        raise ValueError(f"{x.shape[1]} planes cannot hold {n_keys} keys"
                         f"{'' if unique else ' + tiebreak'}")
    return x.contiguous()


def sort_records_plain(planes: torch.Tensor, n_keys: int = 1,
                       unique: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``sort_records`` (any device)."""
    x = _batched(planes, n_keys, unique, 1)
    B, P, n = x.shape
    order = torch.arange(n, device=x.device).expand(B, n)
    cols = list(range(n_keys)) + ([] if unique else [n_keys])
    for c in reversed(cols):
        k = x[:, c, :].gather(1, order)
        if c < n_keys:
            k = k ^ SIGN
        order = order.gather(1, torch.sort(k, dim=1, stable=True).indices)
    return x.gather(2, order.unsqueeze(1).expand(B, P, n)).reshape(planes.shape)


def sort_records(planes: torch.Tensor, n_keys: int = 1,
                 unroll: bool | None = None,
                 unique: bool = False) -> torch.Tensor:
    """Sort records (see the module docstring).  ``unroll`` selects a TPU
    network variant in the reference and is ignored.  n must be a power of
    two >= 1024, as in the reference.  Returns a new tensor of the input's
    shape."""
    del unroll
    x = _batched(planes, n_keys, unique, 1024)
    if _cuda.on_cuda(x):
        x = _cuda.aligned(x)
        B, P, n = x.shape
        out = torch.empty_like(x)
        tmp = torch.empty_like(x)
        _cuda.launch("sort_records", "s4_sort_records", x.device,
                     x.data_ptr(), out.data_ptr(), tmp.data_ptr(), B, P, n,
                     n_keys, int(unique))
        return out.reshape(planes.shape)
    return sort_records_plain(planes, n_keys, unique)


def merge_sorted(planes: torch.Tensor, n_keys: int = 1,
                 unique: bool = False) -> torch.Tensor:
    """Merge two ascending halves: ``planes[..., :n/2]`` and
    ``planes[..., n/2:]`` must each be sorted by the record order.  n must
    be a power of two >= 2048, as in the reference."""
    x = _batched(planes, n_keys, unique, 2048)
    if _cuda.on_cuda(x):
        x = _cuda.aligned(x)
        B, P, n = x.shape
        out = torch.empty_like(x)
        _cuda.launch("merge_sorted", "s4_merge_halves", x.device,
                     x.data_ptr(), out.data_ptr(), B, P, n, n_keys,
                     int(unique))
        return out.reshape(planes.shape)
    return merge_sorted_plain(planes, n_keys, unique)


def merge_sorted_plain(planes: torch.Tensor, n_keys: int = 1,
                       unique: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``merge_sorted`` (any device): with sorted
    halves, the merge is the sort of the whole row."""
    return sort_records_plain(planes, n_keys, unique)
