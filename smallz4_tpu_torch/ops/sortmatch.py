"""Sorted-neighbourhood match search (the 'sort' engine): plain PyTorch and
the CUDA kernels.

Port of ``smallz4_tpu/ops/sortmatch.py``.  Per segment of ``n`` positions:
sort the records (gram4, prefix hash, pos) so that equal grams are
contiguous (``sortnet.sort_records``); probe sorted neighbours at static
offsets for byte-verified candidates of up to 12 bytes and store the results
back in position order (``neighbor_scan``); resolve distance-1 byte runs
from the run lengths (``pallas_kernels.run_lengths``); extend claims by
same-distance doubling (``chain``); cap them at the block end and certify
the positions whose search provably saw every candidate.  The reference
module's docstring derives the certificate; this module computes the same
arrays, bit for bit.

Segments are batched as rows ``[B, ...]`` (the reference maps one segment
over a batch with ``vmap``).  Every kernel wrapper takes its plain version
(``*_plain``) for CPU tensors and its CUDA kernel (``csrc/sortmatch.cu``)
for CUDA tensors.  The record hashes are uint32 arithmetic, computed here
in int64 and wrapped to int32 planes (torch has no uint32 multiply or shift
on the CPU).
"""
from __future__ import annotations

import torch

from .. import format as fmt
from . import _cuda, sortnet
from .grams import mul32, to_i32
from .pallas_kernels import run_lengths

INVALID_POS = 1 << 30    # pos_t offset of records that may not match
HALO = fmt.MAX_DISTANCE  # window history ahead of each segment
NEAR_PROBES = tuple(range(1, 9))
FAR_PROBES = (12, 16, 24, 32, 48, 64)
PROBES = NEAR_PROBES + FAR_PROBES
EXT_REACH = 12           # byte-verified LCP reach: gram4 + two payload words

# production segment geometry: [ 64 KB-1 halo | 64 Ki searched | 1 pad ]
N_ENTRIES = 1 << 17
SEG = N_ENTRIES - HALO - 1  # 65536 searched positions per segment

def _mix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's word-pair mix of the prefix-hash sort keys, uint32
    arithmetic on int64 values (order hints only, never trusted)."""
    return mul32(a ^ mul32(b, 0x9E3779B1), 0x85EBCA77)


def _ext_lcp(xe1: torch.Tensor, xe2: torch.Tensor) -> torch.Tensor:
    """Equal-byte prefix length (0..8) of two xor'd little-endian word
    pairs (bytes 4..12 of both suffixes)."""
    def word(x):
        return torch.where((x & 0xFF) != 0, 0,
               torch.where((x & 0xFF00) != 0, 1,
               torch.where((x & 0xFF0000) != 0, 2,
               torch.where(x != 0, 3, 4)))).to(torch.int32)

    w1 = word(xe1)
    return torch.where(w1 < 4, w1, 4 + word(xe2))


def _check_records(rec: torch.Tensor) -> None:
    if rec.dim() != 3 or rec.shape[1] != 5 or rec.dtype != torch.int32:
        raise ValueError(f"sorted records must be int32 [B, 5, n], got "
                         f"{rec.dtype} {tuple(rec.shape)}")


def neighbor_scan_plain(rec: torch.Tensor):
    """Plain PyTorch version of ``neighbor_scan`` (any device)."""
    _check_records(rec)
    n = rec.shape[-1]
    k1, pos, e1, e2 = rec[:, 0], rec[:, 2], rec[:, 3], rec[:, 4]
    slot = torch.arange(n, dtype=torch.int32, device=rec.device)
    best_len = torch.zeros_like(k1)
    best_dist = torch.zeros_like(k1)
    group_more = torch.zeros_like(k1, dtype=torch.bool)
    for sk in PROBES:
        for sgn in (1, -1):
            k = sk * sgn
            in_range = (slot + k >= 0) & (slot + k < n)
            nb_k1, nb_pos, nb_e1, nb_e2 = (torch.roll(p, -k, dims=-1)
                                           for p in (k1, pos, e1, e2))
            d = pos - nb_pos
            eq4 = in_range & (nb_k1 == k1)
            ok = eq4 & (d >= 1) & (d <= fmt.MAX_DISTANCE)
            if sk == 8:
                group_more = group_more | eq4
            lcp = torch.where(ok, 4 + _ext_lcp(e1 ^ nb_e1, e2 ^ nb_e2), 0)
            better = (lcp > best_len) | (
                (lcp == best_len) & (lcp >= 4) & (d < best_dist))
            upd = better & ok
            best_len = torch.where(upd, lcp, best_len)
            best_dist = torch.where(upd, d, best_dist)
    flags = ((best_len >= EXT_REACH).to(torch.int32)
             | (group_more.to(torch.int32) << 1))
    # unsort: the raw positions of a row are a permutation of [0, n)
    raw = (pos & (INVALID_POS - 1)).to(torch.int64)
    return tuple(torch.empty_like(v).scatter_(1, raw, v)
                 for v in (best_len, best_dist, flags))


def neighbor_scan(rec: torch.Tensor):
    """Neighbour probes over sorted records ``[B, 5, n]`` (planes k1, k2,
    pos_t, e1, e2; the raw positions ``pos_t & (2^30-1)`` of each row a
    permutation of [0, n), and equal k1 contiguous in each row, as
    ``sortnet.sort_records`` leaves them).  Returns (best_len 0 or 4..12,
    best_dist, flags: bit 0 ext-capped, bit 1 gram group beyond the
    contiguous probes), int32 ``[B, n]`` each, in position order (the
    reference's scan followed by its unsort).  On the card a batch of more
    than ``s4_scan_direct_max()`` records in rows of up to
    ``s4_scan_row_max()`` slots takes ``scan`` (the probe kernel, which
    groups each tile's results by position span, and the unsort kernel, a
    span a block); a smaller batch or a longer row takes ``scan_direct``
    (the probe kernel storing each result at its position, one launch)."""
    _check_records(rec)
    if not _cuda.on_cuda(rec):
        return neighbor_scan_plain(rec)
    rec = rec.contiguous()
    B, _, n = rec.shape
    lib = _cuda.lib()
    if B > lib.s4_scan_max_rows():
        raise ValueError(f"the scan takes at most {lib.s4_scan_max_rows()} "
                         f"rows, got {B}")

    def plane(width=n):
        return torch.empty(B, width, dtype=torch.int32, device=rec.device)

    out = [plane() for _ in range(3)]
    ptrs = [o.data_ptr() for o in out]
    if n <= lib.s4_scan_row_max() and B * n > lib.s4_scan_direct_max():
        entries, table = plane(), plane(lib.s4_scan_table_row(n))
        _cuda.launch("scan", "s4_scan", rec.device, rec.data_ptr(), *ptrs,
                     entries.data_ptr(), table.data_ptr(), B, n)
    else:
        _cuda.launch("scan_direct", "s4_scan_direct", rec.device,
                     rec.data_ptr(), *ptrs, B, n)
    return tuple(out)


MAX_CHAIN_STEPS = 30     # s = 2^29 at the last step stays an int32


def _check_chain(lens: torch.Tensor, dists: torch.Tensor, steps: int) -> None:
    if (lens.dim() != 2 or lens.shape != dists.shape
            or lens.dtype != torch.int32 or dists.dtype != torch.int32):
        raise ValueError("chain takes int32 lens and dists of one shape "
                         "[B, n]")
    if not 0 <= steps <= MAX_CHAIN_STEPS:
        raise ValueError(f"chain takes 0..{MAX_CHAIN_STEPS} steps, got "
                         f"{steps}")


def chain_plain(lens: torch.Tensor, dists: torch.Tensor,
                steps: int) -> torch.Tensor:
    """Plain PyTorch version of ``chain`` (any device)."""
    _check_chain(lens, dists, steps)
    n = lens.shape[-1]
    slot = torch.arange(n, device=lens.device)
    ln = lens
    s = 1
    for _ in range(steps):
        nb_len = torch.roll(ln, -s, dims=-1)
        nb_dist = torch.roll(dists, -s, dims=-1)
        ok = (slot + s < n) & (nb_dist == dists) & (dists >= 1) & (ln >= s)
        ln = torch.where(ok, torch.maximum(ln, s + nb_len), ln)
        s *= 2
    return ln


def chain(lens: torch.Tensor, dists: torch.Tensor, steps: int) -> torch.Tensor:
    """Same-distance doubling in position order over ``[B, n]`` rows:
    ``steps`` steps len[p] = max(len[p], s + len[p+s]) where dist[p] ==
    dist[p+s] >= 1 and len[p] >= s (claims stay byte-verified).  On the
    card a row of up to ``s4_chain_row_max()`` positions takes one launch
    (``chain``); a longer one takes a launch a step (``chain_wide``)."""
    _check_chain(lens, dists, steps)
    if not _cuda.on_cuda(lens):
        return chain_plain(lens, dists, steps)
    _cuda.check_inputs(lens, dists)
    B, n = lens.shape
    out = torch.empty_like(lens)
    ptrs = (lens.data_ptr(), dists.data_ptr(), out.data_ptr())
    if n <= _cuda.lib().s4_chain_row_max():
        _cuda.launch("chain", "s4_chain", lens.device, *ptrs, B, n, steps)
    else:
        tmp = torch.empty_like(lens)
        _cuda.launch("chain_wide", "s4_chain_wide", lens.device, *ptrs,
                     tmp.data_ptr(), B, n, steps)
    return out


def _per_row(v, B: int, dtype, device) -> torch.Tensor:
    """Scalar or [B] values -> a [B] tensor on ``device``."""
    t = torch.as_tensor(v, dtype=dtype, device=device)
    return t.expand(B).contiguous() if t.dim() == 0 else t


def _rows_in(bufs: torch.Tensor, n: int, *per_row):
    """Check the segment buffers; per-segment values (scalars or [B]) ->
    [B, 1] tensors of int32 (start/end) or bool (the rest)."""
    B, width = bufs.shape
    if bufs.dtype != torch.uint8 or width < n + 16:
        raise ValueError(f"segment buffers must be uint8 [B, >= {n + 16}] "
                         f"(a 16-byte gram/payload lookahead), got "
                         f"{bufs.dtype} {tuple(bufs.shape)}")
    return [_per_row(v, B, torch.int32 if i < 2 else torch.bool,
                     bufs.device)[:, None] for i, v in enumerate(per_row)]


def segment_records(bufs: torch.Tensor, start_valid, end_valid, cut_boundary,
                    n: int = N_ENTRIES):
    """The unsorted records of ``match_segment`` over the rows of ``bufs``
    (uint8 [B, >= n + 16]): int32 planes [B, 5, n] = (gram4, prefix hash,
    pos_t, e1, e2) and the bool [B, n] of positions that may match.
    ``pos_t`` is pos + 2^30 elsewhere: such records are sorted and probed,
    never dropped."""
    sv, ev, cut = _rows_in(bufs, n, start_valid, end_valid, cut_boundary)
    c = bufs.to(torch.int64)
    g = c[:, :-3] | (c[:, 1:-2] << 8) | (c[:, 2:-1] << 16) | (c[:, 3:] << 24)
    g4, e1, e2 = g[:, :n], g[:, 4:n + 4], g[:, 8:n + 8]
    h8 = _mix(g4, e1)
    h16 = _mix(h8, _mix(e2, g[:, 12:n + 12]))
    k2 = (h8 & 0xFFFF0000) | (h16 >> 16)

    pos = torch.arange(n, dtype=torch.int32, device=bufs.device)
    valid = (pos >= sv) & (pos + fmt.BLOCK_END_NO_MATCH <= ev)
    cut_pos = min(HALO - fmt.BLOCK_END_NO_MATCH, n - 1)
    precut = cut & (g4 == g4[:, cut_pos:cut_pos + 1]) & (pos < cut_pos)
    valid = valid & ~precut
    pos_t = torch.where(valid, pos, pos + INVALID_POS)
    rec = torch.stack([to_i32(g4), to_i32(k2), pos_t, to_i32(e1), to_i32(e2)],
                      dim=1)
    return rec, valid


def _match_rows(bufs: torch.Tensor, start_valid, end_valid, cut_boundary,
                limit_final, n: int, chain_steps: int):
    """``match_segment`` over the rows of ``bufs`` (uint8 [B, >= n + 16]);
    the four per-segment values are scalars or [B].  Returns position-order
    (lens, dists) int32 and conv bool, each [B, n]."""
    sv, ev, fin = _rows_in(bufs, n, start_valid, end_valid, limit_final)
    rec, valid = segment_records(bufs, start_valid, end_valid, cut_boundary,
                                 n)
    pos = torch.arange(n, dtype=torch.int32, device=bufs.device)
    srt = sortnet.sort_records(rec, n_keys=2)
    lens0, dists0, flags0 = neighbor_scan(srt)

    # distance-1 byte runs: the exact LCP from the run lengths
    runs = run_lengths(bufs[:, :n].contiguous())
    d1_len = torch.cat([torch.zeros_like(runs[:, :1]), runs[:, :-1]], 1) - 1
    # the run's source byte (pos-1) must be a real candidate position;
    # ties prefer d=1, the nearest possible distance
    d1_ok = valid & (d1_len >= 4) & (pos - 1 >= sv)
    take_d1 = d1_ok & (d1_len >= lens0)
    lens1 = torch.where(take_d1, d1_len, lens0)
    dists1 = torch.where(take_d1, 1, dists0).to(torch.int32)

    lens2 = chain(lens1, dists1, chain_steps)

    cap = torch.clamp_min(ev - fmt.BLOCK_END_LITERALS - pos, 0)
    lens3 = torch.minimum(lens2, cap)
    match = valid & (lens3 >= fmt.MIN_MATCH)
    lens = torch.where(match, lens3, 1).to(torch.int32)
    dists = torch.where(match, dists1, 0).to(torch.int32)

    truncated = (flags0 & 1) != 0
    group_more = (flags0 & 2) != 0
    conv = (~truncated & ~group_more) | ~valid
    capped = match & (lens3 >= cap)
    # a d=1 claim capped by the block end is complete and the nearest; a
    # claim capped by a segment read-ahead bound proves nothing
    conv = conv | (fin & capped & (dists1 == 1))
    conv = conv & ~(capped & ~fin)
    return lens, dists, conv


def match_segment(buf: torch.Tensor, start_valid, end_valid,
                  n_entries: int = N_ENTRIES, chain_steps: int = 14,
                  cut_boundary=False, limit_final=True):
    """Match search over every position of ``buf[:n_entries]`` (uint8,
    with a 16-byte lookahead).  Returns position-order (lens, dists, conv):
    lens >= 1 with the literal convention len=1, verified distances, and the
    certificate.  ``cut_boundary``: the reference's block-boundary chain cut
    at HALO-12; ``limit_final``: ``end_valid`` is the true block limit, not
    a segment read-ahead bound."""
    lens, dists, conv = _match_rows(buf.unsqueeze(0), start_valid, end_valid,
                                    cut_boundary, limit_final, n_entries,
                                    chain_steps)
    return lens[0], dists[0], conv[0]


def match_segments(bufs: torch.Tensor, start_valid, end_valid, cut_boundary,
                   limit_final, chain_steps: int = 14):
    """Batched search of segment buffers ``[B, >= N_ENTRIES + 16]`` (each
    row [halo | SEG positions | read-ahead]).  Returns the searched
    positions' (lens clamped to 65535, dists) int32 and conv bool, each
    ``[B, SEG]``; a length that reached 65536 is not certified."""
    lens, dists, conv = _match_rows(bufs, start_valid, end_valid,
                                    cut_boundary, limit_final, N_ENTRIES,
                                    chain_steps)
    s = slice(HALO, HALO + SEG)
    lens, dists, conv = lens[:, s], dists[:, s], conv[:, s]
    saturated = lens >= 65536
    return torch.clamp_max(lens, 65535), dists.contiguous(), conv & ~saturated
