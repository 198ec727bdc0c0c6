"""A plain ``smallz4 -9`` block encoder: the benchmark's byte-exact yardstick.

Written from smallz4 v1.5's documented behaviour (its optimal parse,
``smallz4.h`` ``findLongestMatch``, ``estimateCosts`` and ``selectBlock``)
in plain PyTorch and Python, without the program's code.  It encodes one
block of a modern frame with dependent 4 MB blocks, given the bytes before
it, so a sample of blocks from the program's frames can be checked byte
for byte.

1. Match search, exhaustive over every distance: for each position p of
   the block and each d = 1 .. 65,535, the run of equal bytes from p and
   p - d, capped at the block's match limit (its last 5 bytes are
   literals), on the torch device of the context.  Only pairs whose first
   4 bytes match are candidates; a candidate's run is found from where its
   run of matches starts.  The nearest of the longest matches wins, as the
   reference's nearest-first chain walk keeps the first strictly longer
   match.  The last 11 positions are not searched.  At a block that starts
   65,547 or more bytes into the stream the reference re-inserts the
   position 12 bytes before the block into its hash chain, which ends that
   chain there: positions whose 4-byte hash equals that position's see no
   candidate before it.  The reference also skips positions inside runs of
   one byte longer than 65,299; the benchmark's traffic has none, and the
   encoder refuses a block that has one.
2. The optimal parse, backwards over the block: a literal, or every length
   from 4 to the longest match, at the costs smallz4 counts, with ties to
   the later (longer) choice.
3. The LZ4 sequences, the block stored when they are not shorter.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

MIN_MATCH = 4
BLOCK_END_NO_MATCH = 12
BLOCK_END_LITERALS = 5
MAX_DISTANCE = 65535
MAX_SAME_LETTER = 19 + 255 * 256
HASH_MUL = 48271
HASH_BITS = 20
STORED_FLAG = 0x80000000


def _gram_hash(four: int) -> int:
    return ((four * HASH_MUL) & 0xFFFFFFFF) >> (32 - HASH_BITS)


def longest_run(block: bytes) -> int:
    a = np.frombuffer(block, np.uint8)
    if len(a) == 0:
        return 0
    new = np.empty(len(a), bool)
    new[0] = True
    np.not_equal(a[1:], a[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    return int(np.diff(np.append(starts, len(a))).max())


def longest_matches(data: bytes, start: int, end: int, device="cpu",
                    batch: int = 128):
    """(lens, dists) int64 numpy arrays [end - start]: the reference's
    longest match at each position of the block [start, end) of ``data``,
    0 where it has none."""
    bs = end - start
    lens = np.zeros(bs, np.int64)
    dists = np.zeros(bs, np.int64)
    n_search = bs - BLOCK_END_NO_MATCH + 1  # positions 0 .. bs - 12
    if n_search <= 0:
        return lens, dists
    lo = max(0, start - MAX_DISTANCE)
    base = start - lo
    limit = bs - BLOCK_END_LITERALS         # no match reaches past it
    n = base + limit                        # context bytes read
    m = limit
    ctx = torch.frombuffer(bytearray(data[lo: lo + n]), dtype=torch.uint8)
    # reversed coordinates: t = n - 1 - (position in the context), so the
    # run of equal bytes of a match at t reaches down from t; -1 (never a
    # byte) pads past the context's start
    rev = torch.full((n + MAX_DISTANCE + batch,), -1, dtype=torch.int16)
    rev[:n] = ctx.flip(0).to(torch.int16)
    rev = rev.to(device)
    cur = rev[:m]
    # block position i = m - 1 - t; searched: i < n_search
    first_t = m - n_search
    # the re-insertion's chain end: candidates before the position 12
    # bytes before the block are cut for positions of its hash
    reach = None
    if start >= MAX_DISTANCE + BLOCK_END_NO_MATCH:
        c = start - BLOCK_END_NO_MATCH
        h_cut = _gram_hash(struct.unpack_from("<I", data, c)[0])
        grams = np.frombuffer(data[start: start + n_search + 3], np.uint8)
        four = (grams[:n_search].astype(np.uint64)
                | grams[1:n_search + 1].astype(np.uint64) << 8
                | grams[2:n_search + 2].astype(np.uint64) << 16
                | grams[3:n_search + 3].astype(np.uint64) << 24)
        hashes = ((four * HASH_MUL) & 0xFFFFFFFF) >> (32 - HASH_BITS)
        on = np.flatnonzero(hashes == h_cut)
        # d <= p - c = i + 12 for those positions, unlimited for the rest
        r = np.full(m, MAX_DISTANCE, np.int64)
        r[m - 1 - on] = on + BLOCK_END_NO_MATCH
        reach = torch.from_numpy(r).to(device)
    best = torch.zeros(m, dtype=torch.int64, device=device)
    d_max = min(MAX_DISTANCE, base + n_search - 1)
    eq_buf = torch.empty((batch, m), dtype=torch.bool, device=device)
    for d0 in range(1, d_max + 1, batch):
        rows = min(batch, d_max + 1 - d0)
        eq = eq_buf[:rows]
        torch.eq(rev[d0: d0 + rows - 1 + m].unfold(0, m, 1), cur[None, :],
                 out=eq)
        # four[:, j]: the 4 bytes at t = j + 3 down to j all match
        four = eq[:, 3:] & eq[:, 2:-1]
        four &= eq[:, 1:-2]
        four &= eq[:, :-3]
        # where a run of at least 4 matches starts (its lowest t)
        starts = four.clone()
        starts[:, 1:] &= ~eq[:, :-4]
        four[:, : max(0, first_t - 3)] = False
        row, j = four.nonzero(as_tuple=True)
        if len(j) == 0:
            continue
        first = starts.view(-1).nonzero().squeeze(1)
        at = row * (m - 3) + j
        # a candidate's run reaches down to its run's start
        run = at - first[torch.searchsorted(first, at, right=True) - 1] + 4
        t = j + 3
        d = row + d0
        if reach is not None:
            keep = d <= reach[t]
            run, d, t = run[keep], d[keep], t[keep]
        # the longest, then the nearest: run << 16 | (65535 - d)
        best.scatter_reduce_(0, t, (run << 16) | (MAX_DISTANCE - d),
                             reduce="amax")
    best = best.flip(0).cpu().numpy()  # block order
    lens[:limit] = best >> 16
    dists[:limit] = np.where(best > 0, MAX_DISTANCE - (best & 0xFFFF), 0)
    return lens, dists


def optimal_parse(lens, dists) -> list:
    """smallz4's backward cost scan: the chosen length at each position (1
    for a literal).  Every length from 4 to the longest match is tried in
    ascending order and kept on a tie (``<=``), so within a tier of equal
    overhead the answer is the least cost and the last length attaining
    it.  Where the tier's costs do not rise going up (``viol``, the next
    rise, lies past it) that is its last length, read without a scan."""
    n = len(lens)
    lens = lens.tolist()
    dists = dists.tolist()
    cost = [0] * (n + 2)
    viol = [n + 1] * (n + 2)  # least j >= k with cost[j] < cost[j + 1]
    choice = [1] * n
    num_lit = BLOCK_END_LITERALS
    for i in range(n - 1 - BLOCK_END_LITERALS, -1, -1):
        num_lit += 1
        c = cost[i + 1] + 1
        if num_lit == 15 or (num_lit >= 15 + 255
                             and (num_lit - 15) % 255 == 0):
            c += 1
        length = lens[i]
        if length >= MIN_MATCH:
            best = 1
            if length >= MAX_SAME_LETTER and dists[i] == 1:
                best = length
                c = cost[i + length] + 4 + (length - 19) // 255
            else:
                extra, lo, hi = 3, MIN_MATCH, 18
                while lo <= length:
                    top = min(hi, length)
                    if viol[i + lo] >= i + top:
                        m, k = cost[i + top], top
                    else:
                        seg = cost[i + lo: i + top + 1]
                        m = min(seg)
                        seg.reverse()
                        k = top - seg.index(m)
                    if m + extra <= c:
                        c, best = m + extra, k
                    lo, hi, extra = hi + 1, hi + 255, extra + 1
            if best != 1:
                choice[i] = best
                num_lit = 0
        cost[i] = c
        viol[i] = i if c < cost[i + 1] else viol[i + 1]
    return choice


def emit(block: bytes, choice, dists) -> bytes:
    """The block's LZ4 sequences for the chosen lengths."""
    out = bytearray()
    bs = len(block)

    def ext(v):
        while v >= 255:
            out.append(255)
            v -= 255
        out.append(v)

    pos, lit_from = 0, 0
    while True:
        while pos < bs and choice[pos] <= 1:
            pos += 1
        num_lit = pos - lit_from
        if pos >= bs:  # the last sequence: literals only
            out.append(min(num_lit, 15) << 4)
            if num_lit >= 15:
                ext(num_lit - 15)
            out += block[lit_from:]
            return bytes(out)
        ml = choice[pos] - MIN_MATCH
        out.append((min(num_lit, 15) << 4) | min(ml, 15))
        if num_lit >= 15:
            ext(num_lit - 15)
        out += block[lit_from: pos]
        d = int(dists[pos])
        out += bytes((d & 0xFF, d >> 8))
        if ml >= 15:
            ext(ml - 15)
        pos += choice[pos]
        lit_from = pos


def encode_block(data: bytes, start: int, end: int, device="cpu") -> bytes:
    """The block [start, end) of a modern frame over ``data`` as smallz4 -9
    writes it: its 4-byte header and its payload."""
    block = data[start:end]
    if longest_run(block) > MAX_SAME_LETTER:
        raise ValueError("the block holds a run of one byte longer than "
                         "65,299, which this reference does not model")
    lens, dists = longest_matches(data, start, end, device=device)
    payload = emit(block, optimal_parse(lens, dists), dists)
    if len(payload) < len(block):
        return struct.pack("<I", len(payload)) + payload
    return struct.pack("<I", len(block) | STORED_FLAG) + block
