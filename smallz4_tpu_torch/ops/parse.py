"""Optimal parse on the device: the backward cost DP as policy iteration.

Port of ``smallz4_tpu/ops/parse.py`` ``estimate_costs_device``.  The
reference DP (``native.estimate_costs``) is a backward scan whose serial
chain is the token count of the parse.  Policy iteration replaces it with a
few global rounds, each of which

  1. evaluates the current decisions (``choice[i]`` = 1 for a literal, else
     the match length) exactly: the cost to the block end of following them
     from every position, the literal extension bytes resolved by a suffix
     run length (the num_lit thresholds 15, 270, 525, ...), the jump graph
     summed by pointer doubling (``_policy_eval``);
  2. re-decides every position with the reference's rule against those
     costs: the literal, tier-1 lengths 4..18 in an ascending ``<=`` scan,
     tiers >= 2 through a range-min table of (min cost, largest argmin), and
     the MAX_SAME_LETTER distance-1 shortcut, which overrides the scan.

It stops when no decision changes (then ``choice`` equals the native DP's
lens element-wise) or after ``max_iters`` rounds (``converged`` False).

``estimate_costs_device`` runs the hand-written CUDA kernel
``csrc/parse.cu`` (``s4_parse``: every round in one cooperative launch) for
a CUDA tensor and the plain PyTorch version, which follows the reference
step for step, for a CPU tensor.
"""
from __future__ import annotations

import torch

from .. import format as fmt
from . import _cuda

TIER0_HI = 18          # lengths 4..18 cost 3 extra bytes
TIER_W = 255           # each further tier adds one extra byte
TABLE_LEVELS = 8       # doubling range-min table covers widths <= 255
BIG = 1 << 30          # cost past the array (never a minimum)


def _shift_up(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """out[i] = x[i + s], ``fill`` past the end."""
    n = x.shape[0]
    if s >= n:
        return torch.full_like(x, fill)
    return torch.cat([x[s:], torch.full((s,), fill, dtype=x.dtype,
                                        device=x.device)])


def _extra_match(length: torch.Tensor) -> torch.Tensor:
    """Token + offset + length-extension bytes of a match of ``length``:
    3 for lengths 4..18, then +1 per 255."""
    return torch.where(length <= TIER0_HI, 3,
                       4 + (length - (TIER0_HI + 1)) // TIER_W).to(torch.int32)


def _lit_runs(lit: torch.Tensor) -> torch.Tensor:
    """r[i] = length of the run of True starting at i (log-step doubling)."""
    n = lit.shape[0]
    r = lit.to(torch.int32)
    s = 1
    while s < n:
        r = torch.where(r == s, s + _shift_up(r, s, 0), r)
        s *= 2
    return r


def _floor_log2_255(w: torch.Tensor) -> torch.Tensor:
    """floor(log2(w)) for w in [1, 255] by compares."""
    k = torch.zeros_like(w)
    for p in (2, 4, 8, 16, 32, 64, 128):
        k = k + (w >= p).to(torch.int32)
    return k


def _lit_extra(num_lit: torch.Tensor) -> torch.Tensor:
    """1 where this literal starts another length-extension byte (num_lit
    15, 270, 525, ...)."""
    return ((num_lit == 15)
            | ((num_lit >= 15 + TIER_W)
               & ((num_lit - 15) % TIER_W == 0))).to(torch.int32)


def _policy_eval(choice: torch.Tensor, limit: int, n_end: int) -> torch.Tensor:
    """Exact cost to the block end of following ``choice`` from every
    position; positions >= ``limit`` are the zero-cost absorbing tail, and
    the literal run stops at ``n_end`` (the real block end)."""
    N = choice.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=choice.device)
    term = idx >= limit
    lit = ((choice <= 1) | term) & (idx < n_end)
    num_lit = 1 + _shift_up(_lit_runs(lit), 1, 0)
    step = torch.where(lit, 1 + _lit_extra(num_lit), _extra_match(choice))
    span = torch.where(lit, 1, choice)
    nxt = torch.clamp_max(idx + span, N - 1)
    step = torch.where(term, 0, step).to(torch.int32)
    nxt = torch.where(term, idx, nxt).long()
    acc = step
    s = 1
    while s < N:
        acc = acc + acc[nxt]
        nxt = nxt[nxt]
        s *= 2
    return acc


def _range_min_table(cost: torch.Tensor):
    """Doubling sparse table over (cost[j], j), last-argmin on ties: level k
    holds (min cost, largest argmin) over [j, j + 2^k), levels
    concatenated for single-gather lookups."""
    N = cost.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=cost.device)
    cs, js = [cost], [idx]
    c, j = cost, idx
    for k in range(TABLE_LEVELS - 1):
        c2 = _shift_up(c, 1 << k, BIG)
        j2 = _shift_up(j, 1 << k, 0)
        take2 = (c2 < c) | ((c2 == c) & (j2 > j))
        c = torch.where(take2, c2, c)
        j = torch.where(take2, j2, j)
        cs.append(c)
        js.append(j)
    return torch.cat(cs), torch.cat(js)


def _claims(lens: torch.Tensor, dists: torch.Tensor, n: int):
    """(L, run_sc, n_tiers): the claims clamped to the DP's legal range,
    the MAX_SAME_LETTER shortcut positions, and the tiers the scan needs
    (read on the host)."""
    N = lens.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=lens.device)
    limit = n - fmt.BLOCK_END_LITERALS
    term = idx >= limit
    L = torch.minimum(lens.to(torch.int32), torch.clamp_min(limit - idx, 0))
    L = torch.where((L >= fmt.MIN_MATCH) & ~term, L, 1)
    run_sc = (L >= fmt.MAX_SAME_LETTER) & (dists.to(torch.int32) == 1)
    max_l = int(torch.where(run_sc, 0, L).max())
    n_tiers = (2 + (max_l - (TIER0_HI + 1)) // TIER_W
               if max_l > TIER0_HI else 1)
    return L, run_sc, n_tiers


def policy_iteration_plain(lens: torch.Tensor, dists: torch.Tensor, n: int,
                           max_iters: int = 48):
    """Plain PyTorch version of ``policy_iteration`` (any device)."""
    _check(lens, dists, n, max_iters)
    N = lens.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=lens.device)
    limit = n - fmt.BLOCK_END_LITERALS
    term = idx >= limit
    L, run_sc, n_tiers = _claims(lens, dists, n)

    def improve(choice):
        cost = _policy_eval(choice, limit, n)

        # the literal, with the current policy's run accounting
        lit_now = ((choice <= 1) | term) & (idx < n)
        num_lit = 1 + _shift_up(_lit_runs(lit_now), 1, 0)
        best_c = _shift_up(cost, 1, 0) + 1 + _lit_extra(num_lit)
        best_l = torch.ones_like(choice)

        # tier 1: lengths 4..18, ascending `<=` scan
        for ln in range(fmt.MIN_MATCH, TIER0_HI + 1):
            tot = _shift_up(cost, ln, BIG) + 3
            ok = (L >= ln) & (tot <= best_c)
            best_c = torch.where(ok, tot, best_c)
            best_l = torch.where(ok, ln, best_l)

        # tiers >= 2: (min, last argmin) from the sparse table
        if n_tiers >= 2:
            tc, tj = _range_min_table(cost)
            for t in range(2, n_tiers + 1):
                lo = TIER0_HI + 1 + TIER_W * (t - 2)
                e = torch.clamp_max(L, lo + TIER_W - 1)
                w = e - lo + 1
                active = w >= 1
                k = _floor_log2_255(torch.clamp_min(w, 1))
                a = torch.clamp(idx + lo, 0, N - 1)
                b = torch.clamp(idx + e - (1 << k) + 1, 0, N - 1)
                ia, ib = (k * N + a).long(), (k * N + b).long()
                c1, j1 = tc[ia], tj[ia]
                c2, j2 = tc[ib], tj[ib]
                take2 = (c2 < c1) | ((c2 == c1) & (j2 > j1))
                mc = torch.where(take2, c2, c1)
                mj = torch.where(take2, j2, j1)
                tot = mc + 2 + t  # tier t costs 3 + (t - 1) extra bytes
                ok = active & (tot <= best_c)
                best_c = torch.where(ok, tot, best_c)
                best_l = torch.where(ok, mj - idx, best_l)

        # the MAX_SAME_LETTER distance-1 shortcut overrides the scan
        return torch.where(run_sc & ~term, L,
                           torch.where(term, 1, best_l)).to(torch.int32)

    choice = torch.where(run_sc & ~term, L,
                         torch.where(term | (L < fmt.MIN_MATCH), 1, L))
    it, changed = 0, True
    while changed and it < max_iters:
        new_choice = improve(choice)
        it += 1
        changed = bool((new_choice != choice).any())
        choice = new_choice
    cost = _policy_eval(choice, limit, n)
    return (choice, cost,
            torch.tensor(not changed, device=lens.device),
            torch.tensor(it, dtype=torch.int32, device=lens.device))


def _check(lens: torch.Tensor, dists: torch.Tensor, n: int,
           max_iters: int) -> None:
    if (lens.dim() != 1 or lens.shape != dists.shape or lens.numel() < 1
            or lens.dtype != torch.int32 or dists.dtype != torch.int32):
        raise ValueError(f"lens and dists must be int32 [N], N >= 1, got "
                         f"{lens.dtype} {tuple(lens.shape)}, {dists.dtype} "
                         f"{tuple(dists.shape)}")
    if not 0 <= n <= lens.shape[0] or max_iters < 0:
        raise ValueError(f"need 0 <= n <= N and max_iters >= 0, got n={n}, "
                         f"N={lens.shape[0]}, max_iters={max_iters}")


def policy_iteration(lens: torch.Tensor, dists: torch.Tensor, n: int,
                     max_iters: int = 48):
    """``estimate_costs_device`` and its round count: (choice, cost,
    converged, rounds), rounds an int32 scalar tensor (the improvements
    made, at most ``max_iters``)."""
    n = int(n)
    if not _cuda.on_cuda(lens):
        return policy_iteration_plain(lens, dists, n, max_iters)
    _check(lens, dists, n, max_iters)
    _cuda.check_inputs(lens, dists)
    N, dev = lens.shape[0], lens.device
    lib = _cuda.lib()
    if N > lib.s4_parse_max_n():
        raise ValueError(f"the CUDA parse takes at most "
                         f"{lib.s4_parse_max_n()} positions, got {N} (the "
                         f"plain version on the CPU takes it)")
    choice = torch.empty(N, dtype=torch.int32, device=dev)
    cost = torch.empty_like(choice)
    flags = torch.empty(2, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.s4_parse_scratch_bytes(N), dtype=torch.uint8,
                          device=dev)
    state, epoch = _cuda.tile_state("parse", dev, 5)
    _cuda.launch("parse", "s4_parse", dev, lens.data_ptr(), dists.data_ptr(),
                 choice.data_ptr(), cost.data_ptr(), flags.data_ptr(),
                 scratch.data_ptr(), state.data_ptr(), N, n, max_iters, epoch)
    return choice, cost, flags[0] != 0, flags[1]


def estimate_costs_device(lens: torch.Tensor, dists: torch.Tensor, n,
                          max_iters: int = 48):
    """Device optimal parse of int32 claims ``lens``, ``dists`` [N] whose
    first ``n`` positions are the block: (choice int32 [N], cost int32 [N],
    converged bool scalar).  ``choice`` equals the lens that
    ``native.estimate_costs`` writes back on the first ``n`` positions once
    converged; ``cost`` is the final policy's cost over the whole array
    (padding included); ``converged`` False means the round cap was hit."""
    return policy_iteration(lens, dists, n, max_iters)[:3]
