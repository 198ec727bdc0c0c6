"""The candidate-walk match search (the 'walk' engine): plain PyTorch and
the CUDA kernel.

Port of ``smallz4_tpu/ops/match_finder.py``.  Per row of a segment batch:
the 4-byte grams (``pallas_kernels.gram_hash``, the last three zeroed as
``grams.grams4`` leaves them), the previous position with the same gram
(``build_prev``, a stable sort), the reference's block-boundary chain cut,
the equal-byte run lengths (``pallas_kernels.run_lengths``), then the walk
over each searched position's chain of earlier occurrences (``walk``).  A
lane is *converged* when its walk ended for a benign reason with no
truncation; converged lanes equal the reference's -9 search, the rest hold
a valid match that parity mode refines on the host.  The reference
module's docstring gives the design; this module computes the same arrays,
bit for bit.

The reference runs its walk as lockstep loops over all lanes in XLA.  An
inactive lane is frozen there, so the port runs one serial loop per lane:
``csrc/walk.cu`` on a CUDA tensor, ``walk_plain`` (vectorised over the lanes
still active, 16 extension words at a time) on a CPU tensor.  The kernel
stages, per block of 2048 searched positions, the 64 Ki positions before
them as 16-bit back-distances (a predecessor farther than 65535 ends a walk
just as none does), their bytes, from which it reads the grams, and the
block's run lengths; warps take 32 positions at a time from a block
counter, and long extensions are taken by the whole warp.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from . import _cuda
from .grams import mismatch_bytes_in_u32, to_u32
from .pallas_kernels import gram_hash, run_lengths

SEG = 65536                  # positions searched per segment
HALO = fmt.MAX_DISTANCE      # window history carried into each segment
TAIL = 2048                  # segment read-ahead (match headroom; > ext_cap)
SEG_BUF = HALO + SEG + TAIL  # fixed segment buffer size
MAX_CANDIDATES = 16          # match_segments' default candidate rounds
EXT_CAP = 512                # longest 4-byte-word extension of one candidate
EXT_WORDS = 16               # extension words the plain walk reads at once


def build_prev(g: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int32 previous position with the same gram along the last axis, -1
    if none; -1 also where that immediately preceding position is not
    ``valid`` (a hop never lands on padding, nor skips past it).  ``g``:
    int32 gram bits, ordered as unsigned by a stable sort."""
    n = g.shape[-1]
    sg, order = torch.sort(to_u32(g), dim=-1, stable=True)
    same = torch.zeros_like(sg, dtype=torch.bool)
    same[..., 1:] = sg[..., 1:] == sg[..., :-1]
    prev_sorted = torch.where(same, torch.roll(order, 1, dims=-1), -1)
    prev = torch.empty_like(order).scatter_(-1, order, prev_sorted)
    ok = (prev >= 0) & valid.gather(-1, prev.clamp(0, n - 1))
    return torch.where(ok, prev, -1).to(torch.int32)


def _extend(g, row, pos, q, eff_cap):
    """The reference's 4-byte-word extension of candidate ``q`` at ``pos``
    from byte 4 (the grams are equal) up to ``eff_cap``, EXT_WORDS words a
    step.  Returns (common prefix, extension words the serial loop reads)."""
    n = g.shape[-1]
    flat = g.reshape(-1)
    k = torch.clamp_max(eff_cap, 4)
    words = torch.zeros_like(k)
    open_ = torch.nonzero(k < eff_cap).squeeze(1)
    offs = 4 * torch.arange(EXT_WORDS, device=g.device)
    while open_.numel():
        ko, eo = k[open_], eff_cap[open_]
        at = (ko[:, None] + offs).to(torch.int64)
        r = row[open_, None]
        x = (flat[r + (pos[open_, None] + at).clamp(0, n - 1)]
             ^ flat[r + (q[open_, None] + at).clamp(0, n - 1)])
        nz = x != 0
        hit = nz.any(1)
        j = torch.where(hit, nz.to(torch.int8).argmax(1), EXT_WORDS)
        xj = x.gather(1, j.clamp_max(EXT_WORDS - 1)[:, None]).squeeze(1)
        mm = torch.where(hit, mismatch_bytes_in_u32(xj), 0)
        # the serial loop reads words until a mismatch or until k reaches
        # eff_cap
        words[open_] += torch.minimum(torch.where(hit, j + 1, j),
                                      (eo - ko + 3) // 4).to(words.dtype)
        knew = torch.minimum(ko + 4 * j + mm, eo).to(k.dtype)
        k[open_] = knew
        open_ = open_[~hit & (knew < eo)]
    return k, words


def walk_plain(ctx, g, prev, runs, start_valid, end_valid, base: int,
               search_len: int, max_candidates: int, ext_cap: int,
               counts: dict | None = None):
    """Plain PyTorch version of ``walk`` (any device).  ``counts``, if
    given, receives the work this input needs: ``hops``, the candidate
    rounds of active lanes, and ``ext_words``, the extension words the
    serial loop reads."""
    B, n = ctx.shape
    dev = ctx.device
    pos = base + torch.arange(search_len, dtype=torch.int32, device=dev)
    sv, ev = start_valid[:, None], end_valid[:, None]
    searchable = (pos >= sv) & (pos + fmt.BLOCK_END_NO_MATCH <= ev)
    cap = torch.clamp_min(ev - fmt.BLOCK_END_LITERALS - pos, 0).reshape(-1)
    q = prev[:, base:base + search_len].reshape(-1).clone()
    pos = pos.expand(B, -1).reshape(-1)
    best = torch.ones_like(q)
    dist = torch.zeros_like(q)
    hit_cap = torch.zeros_like(q, dtype=torch.bool)
    row = (torch.arange(B, device=dev) * n).repeat_interleave(search_len)
    c_f, p_f, r_f = (a.reshape(-1) for a in (ctx.to(torch.int32), prev, runs))
    hops = ext_words = 0

    def take(flat, lanes, idx):
        return flat[row[lanes] + idx.clamp(0, n - 1)]

    live = torch.nonzero(searchable.reshape(-1)).squeeze(1)
    for _ in range(max_candidates):
        qa, ba, pa, ca = q[live], best[live], pos[live], cap[live]
        active = (qa >= 0) & (pa - qa <= fmt.MAX_DISTANCE) & (ba + 1 <= ca)
        live = live[active]  # an inactive lane never changes again
        if not live.numel():
            break
        qa, ba, pa, ca = qa[active], ba[active], pa[active], ca[active]
        hops += live.numel()
        maybe = take(c_f, live, qa + ba) == take(c_f, live, pa + ba)
        d1 = maybe & (pa - qa == 1)
        lcp = torch.where(d1, torch.minimum(take(r_f, live, qa) - 1, ca), 0)
        mex = torch.nonzero(maybe & ~d1).squeeze(1)
        eff = torch.clamp_max(ca[mex], ext_cap)
        lcp_ext, words = _extend(g, row[live[mex]], pa[mex], qa[mex], eff)
        lcp[mex] = lcp_ext
        ext_words += int(words.sum())
        hit_cap[live[mex]] |= (lcp_ext >= eff) & (eff < ca[mex])
        improved = maybe & (lcp >= ba + 1)
        best[live] = torch.where(improved, lcp, ba)
        dist[live] = torch.where(improved, pa - qa, dist[live])
        q[live] = take(p_f, live, qa)

    exhausted = (q < 0) | (pos - q > fmt.MAX_DISTANCE) | (best + 1 > cap)
    searchable = searchable.reshape(-1)
    conv = (exhausted & ~hit_cap & (best < cap)) | ~searchable
    lens = torch.where(searchable, best, 1).to(torch.int32)
    dists = torch.where(searchable, dist, 0).to(torch.int32)
    if counts is not None:
        counts["hops"] = counts.get("hops", 0) + hops
        counts["ext_words"] = counts.get("ext_words", 0) + ext_words
    return (lens.reshape(B, search_len), dists.reshape(B, search_len),
            conv.reshape(B, search_len))


def _check_walk(ctx, g, prev, runs, start_valid, end_valid, base,
                search_len) -> None:
    B, n = ctx.shape
    if (ctx.dtype != torch.uint8 or any(
            a.dtype != torch.int32 or a.shape != ctx.shape
            for a in (g, prev, runs))):
        raise ValueError("walk takes uint8 ctx and int32 grams, prev and runs"
                         " of one shape [B, n]")
    if any(a.dtype != torch.int32 or a.shape != (B,)
           for a in (start_valid, end_valid)):
        raise ValueError("walk takes int32 [B] start_valid and end_valid")
    if base < 0 or search_len < 1 or base + search_len > n:
        raise ValueError(f"searched positions [{base}, {base + search_len}) "
                         f"outside rows of {n}")


def walk(ctx, g, prev, runs, start_valid, end_valid, base: int,
         search_len: int, max_candidates: int, ext_cap: int):
    """The candidate walk of positions [base, base + search_len) of each row
    of ``ctx`` (uint8 [B, n]) with its grams ``g`` (last three zeroed),
    predecessors ``prev`` (-1 for none, else an earlier position) and run
    lengths ``runs`` (int32 [B, n] each, as ``walk_inputs`` makes them) and
    valid ranges [start_valid, end_valid) (int32 [B]).  Returns lens, dists
    (int32) and conv (bool), each [B, search_len]."""
    _check_walk(ctx, g, prev, runs, start_valid, end_valid, base, search_len)
    if not _cuda.on_cuda(ctx):
        return walk_plain(ctx, g, prev, runs, start_valid, end_valid, base,
                          search_len, max_candidates, ext_cap)
    _cuda.check_inputs(ctx, g, prev, runs, start_valid, end_valid)
    B = ctx.shape[0]
    lens = torch.empty(B, search_len, dtype=torch.int32, device=ctx.device)
    dists = torch.empty_like(lens)
    conv = torch.empty(B, search_len, dtype=torch.bool, device=ctx.device)
    _cuda.launch("walk", "s4_walk", ctx.device,
                 *(a.data_ptr() for a in (ctx, g, prev, runs, start_valid,
                                          end_valid, lens, dists, conv)),
                 B, ctx.shape[1], base, search_len, max_candidates, ext_cap,
                 None)
    return lens, dists, conv


def walk_inputs(ctx, start_valid, end_valid, cut_boundary, base: int):
    """The walk's inputs for the rows of ``ctx`` (uint8 [B, n]) and their
    [B] valid ranges and cut flags: (grams, prev, runs), int32 [B, n]
    each."""
    n = ctx.shape[-1]
    g, _ = gram_hash(ctx)
    g[:, max(n - 3, 0):] = 0  # as grams4: the caller masks the tail
    pos = torch.arange(n, dtype=torch.int32, device=ctx.device)
    valid = ((pos >= start_valid[:, None])
             & (pos + fmt.BLOCK_END_NO_MATCH <= end_valid[:, None]))
    prev = build_prev(g, valid)
    # block-boundary chain cut (the reference's re-insertion anomaly),
    # where the segment starts a block whose history carries over
    cut_pos = base - fmt.BLOCK_END_NO_MATCH
    if 0 <= cut_pos < n:
        prev[:, cut_pos] = torch.where(cut_boundary, -1, prev[:, cut_pos])
    return g, prev, run_lengths(ctx)


def _match_rows(ctx, start_valid, end_valid, cut_boundary, base, search_len,
                max_candidates, ext_cap):
    B = ctx.shape[0]
    sv, ev = (torch.as_tensor(v, dtype=torch.int32, device=ctx.device)
              .expand(B).contiguous() for v in (start_valid, end_valid))
    cut = torch.as_tensor(cut_boundary, dtype=torch.bool,
                          device=ctx.device).expand(B)
    ctx = ctx.contiguous()
    g, prev, runs = walk_inputs(ctx, sv, ev, cut, base)
    return walk(ctx, g, prev, runs, sv, ev, base, search_len, max_candidates,
                ext_cap)


def match_block(ctx: torch.Tensor, base: int, start_valid=None,
                end_valid=None, search_len: int | None = None,
                max_candidates: int = 64, cut_boundary=True,
                ext_cap: int = EXT_CAP):
    """Whole-buffer search of positions [base, base + search_len) of the
    uint8 row ``ctx`` (valid bytes [start_valid, end_valid), by default the
    whole row).  Returns lens, dists (int32) and conv (bool), each
    [search_len]."""
    n = ctx.shape[0]
    if search_len is None:
        search_len = n - base
    res = _match_rows(ctx[None], 0 if start_valid is None else start_valid,
                      n if end_valid is None else end_valid, cut_boundary,
                      base, search_len, max_candidates, ext_cap)
    return tuple(r[0] for r in res)


def match_segments(bufs: torch.Tensor, start_valid, end_valid, cut_boundary,
                   max_candidates: int = MAX_CANDIDATES,
                   ext_cap: int = EXT_CAP):
    """Batched search of segment buffers (uint8 [B, SEG_BUF], each row
    [halo | SEG positions | read-ahead]) with [B] valid ranges and cut
    flags.  Returns the searched positions' (lens clamped to 65535, dists)
    int32 and conv bool, each [B, SEG]; a length that reached 65536 is not
    certified."""
    if bufs.dim() != 2 or bufs.dtype != torch.uint8 \
            or bufs.shape[1] < HALO + SEG:
        raise ValueError(f"segment buffers must be uint8 [B, >= {HALO + SEG}]"
                         f", got {bufs.dtype} {tuple(bufs.shape)}")
    lens, dists, conv = _match_rows(bufs, start_valid, end_valid,
                                    cut_boundary, HALO, SEG, max_candidates,
                                    ext_cap)
    saturated = lens >= 65536
    return torch.clamp_max(lens, 65535), dists, conv & ~saturated
