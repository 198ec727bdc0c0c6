"""Sequence emit on the device: LZ4 block serialization as a prefix-sum pack.

Port of ``smallz4_tpu/ops/emit.py`` ``emit_block_device``.  It writes
exactly ``native.emit_block``'s payload from the final parse (lens after the
DP, dists), so a device-resident encode ships compressed bytes over the host
link instead of claims.  ``emit_block_device`` runs the hand-written CUDA
kernel ``csrc/emit.cu`` (``s4_emit``: the orbit, the sequence layout and the
bytes in two launches) for a CUDA tensor, and the plain PyTorch version
``emit_block_plain``, which follows the reference step for step, for a CPU
tensor:

  1. the emit walk's orbit (position 0, then +len at a chosen match, +1 at
     a literal), marked in log2(n) rounds of 2^k-hop jump tables;
  2. the sequence table: visited match starts end sequences; a rank
     cumsum compacts (literal-run start, literal count, match len, dist);
  3. each sequence's byte count (token and literal extensions, literals,
     offset and match extensions; the last token carries literals only),
     laid out by a cumsum;
  4. each output byte finds its segment by a search and computes itself.

Scatters with the reference's ``mode="drop"`` write into a buffer one slot
longer and drop that slot.  All arithmetic is int32 or int64.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from . import _cuda


def _ext_count(v: torch.Tensor) -> torch.Tensor:
    """Byte count of put_ext(v): 255-chains then the remainder byte."""
    return v // 255 + 1


def _ext_byte(v: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """k-th byte of put_ext(v): 255 while whole 255s remain, then the
    remainder (v - 255*k)."""
    return torch.where(k < v // 255, 255, v - 255 * k)


def _orbit(nxt: torch.Tensor, N: int) -> torch.Tensor:
    """Orbit of position 0 under i -> nxt[i] (nxt == N: walked off the
    end).  After round k the set holds everything reachable in <= 2^k - 1
    hops; the jump tables square each round."""
    visited = torch.zeros(N + 1, dtype=torch.bool, device=nxt.device)
    visited[0] = True
    jump = nxt
    s = 1
    while s < N:
        tgt = torch.where(visited[:N] & (jump < N), jump, N)
        visited[tgt.long()] = True  # slot N: dropped
        jump = torch.where(jump < N,
                           jump[torch.clamp(jump, 0, N - 1).long()], N)
        s *= 2
    return visited[:N]


def _scatter_drop(tgt: torch.Tensor, values: torch.Tensor, S: int):
    """zeros(S).at[tgt].set(values, mode="drop") for tgt in [0, S] (S:
    dropped)."""
    out = torch.zeros(S + 1, dtype=torch.int32, device=values.device)
    out[tgt.long()] = values.to(torch.int32)
    return out[:S]


def _check(block: torch.Tensor, lens: torch.Tensor,
           dists: torch.Tensor) -> None:
    if (block.dim() != 1 or block.dtype != torch.uint8 or block.numel() < 1
            or lens.shape != block.shape or dists.shape != block.shape):
        raise ValueError(f"block must be uint8 [N], N >= 1, and lens, dists "
                         f"[N]: got {block.dtype} {tuple(block.shape)}, "
                         f"{tuple(lens.shape)}, {tuple(dists.shape)}")


def emit_block_plain(block: torch.Tensor, lens: torch.Tensor,
                     dists: torch.Tensor):
    """Plain PyTorch version of ``emit_block_device`` (any device)."""
    _check(block, lens, dists)
    N = block.shape[0]
    dev = block.device
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    L = torch.clamp_min(lens.to(torch.int32), 1)

    # 1. the emit walk's orbit (positions covered by a chosen match are
    # skipped)
    nxt = torch.clamp_max(idx + L, N)
    visited = _orbit(nxt, N)
    m_start = visited & (L > 1)

    # 2. the sequence table, compacted by rank (row n_match = the closing
    # literals-only token)
    ms = m_start.to(torch.int32)
    rank = (torch.cumsum(ms, 0) - ms).to(torch.int32)
    n_match = ms.sum()
    S = N
    tgt = torch.where(m_start, rank, S)
    mpos = _scatter_drop(tgt, idx, S)
    mlen = _scatter_drop(tgt, L, S)
    mdist = _scatter_drop(tgt, dists, S)

    seq_i = torch.arange(S, dtype=torch.int32, device=dev)
    is_real = seq_i < n_match
    is_last = seq_i == n_match
    # literal-run start of sequence s = end of match s-1 (0 for s = 0)
    prev_end = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                          (mpos + mlen)[:-1]])
    lit_from = prev_end
    num_lit = torch.where(is_last, N - lit_from,
                          torch.where(is_real, mpos - prev_end, 0))
    ml_code = torch.where(is_real, mlen - fmt.MIN_MATCH, 0)

    # 3. per-sequence layout: A = token + literal extensions, the literals,
    # B = offset + match extensions (absent for the last token)
    a_len = 1 + torch.where(num_lit >= 15, _ext_count(num_lit - 15), 0)
    b_len = torch.where(is_real,
                        2 + torch.where(ml_code >= 15,
                                        _ext_count(ml_code - 15), 0), 0)
    live = is_real | is_last
    seq_len = torch.where(live, a_len + num_lit + b_len, 0).to(torch.int32)
    seq_off = (torch.cumsum(seq_len, 0) - seq_len).to(torch.int32)
    n_out = seq_len.sum().to(torch.int32)

    big = 1 << 30
    A0 = torch.where(live, seq_off, big)
    L0 = torch.where(live, seq_off + a_len, big)
    B0 = torch.where(live, seq_off + a_len + num_lit, big)
    starts = torch.stack([A0, L0, B0], dim=1).reshape(3 * S).to(torch.int32)

    # 4. each output byte: ties on equal starts resolve to the LATER
    # (non-empty) segment
    cap = N + N // 255 + 16
    o = torch.arange(cap, dtype=torch.int32, device=dev)
    seg = torch.clamp(torch.searchsorted(starts, o, right=True) - 1,
                      0, 3 * S - 1)
    sq = seg // 3
    kind = seg % 3
    rel = o - starts[seg]

    s_numlit = num_lit[sq]
    s_mlcode = ml_code[sq]
    s_litfrom = lit_from[sq]
    s_dist = mdist[sq]
    s_islast = is_last[sq]

    token = ((torch.clamp_max(s_numlit, 15) << 4)
             | torch.where(s_islast, 0, torch.clamp_max(s_mlcode, 15)))
    a_byte = torch.where(rel == 0, token, _ext_byte(s_numlit - 15, rel - 1))
    l_byte = block.to(torch.int32)[torch.clamp(s_litfrom + rel, 0,
                                               N - 1).long()]
    b_byte = torch.where(rel == 0, s_dist & 0xFF,
                         torch.where(rel == 1, (s_dist >> 8) & 0xFF,
                                     _ext_byte(s_mlcode - 15, rel - 2)))
    val = torch.where(kind == 0, a_byte,
                      torch.where(kind == 1, l_byte, b_byte))
    out = torch.where(o < n_out, val, 0).to(torch.uint8)
    return out, n_out


def emit_block_device(block: torch.Tensor, lens: torch.Tensor,
                      dists: torch.Tensor):
    """Serialize one block's parse: ``block`` uint8 [N] (the block, no
    padding), ``lens``/``dists`` int32 [N] as the DP writes them back (1 =
    literal, else the match length; the last BLOCK_END_LITERALS positions
    literals; ``dists`` is read at the chosen matches only).  Returns (out
    uint8 [N + N//255 + 16], n_out int32 scalar): the payload bytes, equal
    to ``native.emit_block(block, lens, dists)``, then zeros.  A CUDA
    tensor runs the kernel (two launches, no host sync), a CPU tensor the
    plain version."""
    if not _cuda.on_cuda(block):
        return emit_block_plain(block, lens, dists)
    _check(block, lens, dists)
    block = block.contiguous()
    lens = _cuda.aligned(lens.to(torch.int32).contiguous())
    dists = dists.to(torch.int32).contiguous()
    _cuda.check_inputs(block, lens, dists)
    N, dev = block.shape[0], block.device
    lib = _cuda.lib()
    if N > lib.s4_emit_max_n():
        raise ValueError(f"the CUDA emit takes at most {lib.s4_emit_max_n()} "
                         f"positions, got {N} (the plain version on the CPU "
                         f"takes it)")
    out = torch.empty(N + N // 255 + 16, dtype=torch.uint8, device=dev)
    meta = torch.empty(2, dtype=torch.int32, device=dev)  # n_out, sequences
    scratch = torch.empty(lib.s4_emit_scratch_words(N), dtype=torch.int32,
                          device=dev)
    state, epoch = _cuda.tile_state("emit", dev,
                                    lib.s4_emit_status_words(N))
    _cuda.launch("emit", "s4_emit", dev, block.data_ptr(), lens.data_ptr(),
                 dists.data_ptr(), out.data_ptr(), meta.data_ptr(),
                 scratch.data_ptr(), state.data_ptr(), N, epoch)
    return out, meta[0]
