"""The host worker pools of the device pipeline, and one block's level-9
match search split over them by position range.

``_pool`` is the port's copy of ``smallz4_tpu/parallel/host.py`` ``_pool``:
the native matcher keeps about 90 MB of thread-local tables warm per
worker, so the threads outlive individual ``compress()`` calls.

``search`` runs one block's host match search (a whole search, a masked
refine or the post-DP distance fix) as position ranges on a pool of its
own, one worker per core, so that a block's search is no longer one
thread's.  The output is bit-identical to the one native call it stands
for.  At level 9 a position's result depends only on the 64 KB window
before it (the reference's intra-block chunk independence, see
``smallz4_tpu/parallel/host.py``), with one exception: the byte-run
shortcut (smallz4.h:631-643).  Inside an equal-byte run, while the
previous position's match has distance 1 and is longer than
MaxSameLetter, the search copies that match shortened by one and skips the
position's table insert.  The shortcut reads the previous position's
result, so it can carry state across a cut, and in a masked refine it also
rewrites unmasked positions.  Cuts therefore snap forward until no giant
run and no incoming distance-1 claim past MaxSameLetter lies within a scan
window of them.  There, neither call takes the shortcut, so both insert
every position and agree from the cut on.  A search whose runs leave no
such cut runs as one call.
"""
from __future__ import annotations

import concurrent.futures as cf
import heapq
import itertools
import os
import threading

import numpy as np

from .. import format as fmt
from .. import native

_POOL: cf.ThreadPoolExecutor | None = None
_POOL_SIZE = 0

# Positions a search scans per range, at least: each range seeds its
# tables with one more 64 KB window of inserts, which stays a small share
# of its own.
_MIN_RANGE = 1 << 18
# How far a masked refine's scan reaches back from its first masked
# position (native/src/tlz4.cpp match_block): one window plus the 12-byte
# boundary lookback.
_SCAN_BACK = fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH
_RUN_MARGIN = 64  # safety margin around the MaxSameLetter threshold
_GIANT = fmt.MAX_SAME_LETTER - _RUN_MARGIN
_ROW = 1 << 14  # a run of _GIANT bytes holds a whole aligned row of these
# A search's cost, by which cuts balance its ranges and the pool orders
# searches, counted over buckets of positions: one for each position
# scanned (its table insert) and _WALK more for each position searched
# (its chain walk, about seven inserts' time on a 4 MiB fixture block).
_BUCKET = 1 << 12
_WALK = 7

_SEARCH = None  # the _SearchPool, started at the first search
_SEARCH_LOCK = threading.Lock()


def _cores() -> int:
    return min(32, os.cpu_count() or 1)


def _pool(threads: int | None) -> cf.ThreadPoolExecutor:
    """The shared executor, grown (never shrunk) to ``threads`` workers
    (default: one per core, at most 32)."""
    global _POOL, _POOL_SIZE
    want = threads or _cores()
    if _POOL is None or _POOL_SIZE < want:
        _POOL = cf.ThreadPoolExecutor(max_workers=want)
        _POOL_SIZE = want
    return _POOL


class _SearchPool:
    """One worker thread a core that runs the native calls of ``search``:
    the cheapest search's first and, among equals, in order of submission,
    so that a block's refine or distance fix passes the whole searches
    queued before it.  The workers wait for nothing but work, so the block
    tasks that wait for them cannot deadlock it, and at most one search a
    core runs at once."""

    def __init__(self, workers: int):
        self._queue = []
        self._ready = threading.Condition()
        self._order = itertools.count()
        for _ in range(workers):
            threading.Thread(target=self._work, daemon=True).start()

    def submit(self, cost: int, fn, *args, **kwargs) -> cf.Future:
        fut = cf.Future()
        with self._ready:
            heapq.heappush(self._queue, (cost, next(self._order), fut, fn,
                                         args, kwargs))
            self._ready.notify()
        return fut

    def _work(self):
        while True:
            with self._ready:
                while not self._queue:
                    self._ready.wait()
                _, _, fut, fn, args, kwargs = heapq.heappop(self._queue)
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except Exception as exc:  # raised where the result is read
                fut.set_exception(exc)


def _search_pool() -> _SearchPool:
    global _SEARCH
    with _SEARCH_LOCK:
        if _SEARCH is None:
            _SEARCH = _SearchPool(_cores())
        return _SEARCH


def _giant_runs(block: np.ndarray) -> list:
    """[start, end) of each equal-byte run of ``block`` at least _GIANT
    bytes long."""
    n = len(block) // _ROW
    if n == 0:
        return []
    rows = block[: n * _ROW].reshape(n, _ROW)
    runs = []
    for r in np.flatnonzero((rows == rows[:, :1]).all(axis=1)):
        a = int(r) * _ROW
        if runs and a < runs[-1][1]:
            continue  # inside the run already found
        b = block[a]
        diff = np.flatnonzero(block[:a] != b)
        start = int(diff[-1]) + 1 if diff.size else 0
        diff = np.flatnonzero(block[a:] != b)
        end = a + int(diff[0]) if diff.size else len(block)
        if end - start >= _GIANT:
            runs.append((start, end))
    return runs


def _bad_spans(block, lens=None, dists=None) -> list:
    """Sorted [start, end) spans of block positions where the byte-run
    shortcut may fire: the giant runs, and after each incoming claim of
    distance 1 longer than _GIANT (a masked refine keeps or copies it) the
    positions it reaches."""
    spans = _giant_runs(block)
    if lens is not None:
        long = np.flatnonzero(lens > _GIANT)
        for j in long[dists[long] == 1]:
            spans.append((int(j), int(j) + int(lens[j]) + 1))
    return sorted(spans)


def _cuts(targets, bs: int, bad) -> list:
    """Increasing cuts near ``targets``: each snapped forward until no span
    of ``bad`` lies within [cut - _SCAN_BACK - _RUN_MARGIN, cut +
    _RUN_MARGIN), one scan window from its neighbours and from both ends
    of the block (so the block's boundary chain cut, 12 bytes before it,
    is out of every later range's windows).  Targets that cannot be met
    are dropped."""
    out = []
    prev = _SCAN_BACK
    for c in targets:
        c = max(int(c), prev + _SCAN_BACK)
        for a, b in bad:
            if a >= c + _RUN_MARGIN:
                break
            if b > c - _SCAN_BACK - _RUN_MARGIN:
                c = b + _SCAN_BACK + _RUN_MARGIN
        if c > bs - _SCAN_BACK:
            break
        out.append(c)
        prev = c
    return out


class _Mask:
    """A boolean mask with its counts by bucket of _BUCKET positions, for
    finding masked positions without a pass over the whole mask."""

    def __init__(self, mask: np.ndarray):
        self.mask = mask
        n = len(mask)
        full = n // _BUCKET
        cnt = np.count_nonzero(mask[: full * _BUCKET].reshape(full, _BUCKET),
                               axis=1)
        if n > full * _BUCKET:
            cnt = np.append(cnt, np.count_nonzero(mask[full * _BUCKET:]))
        self.count = cnt
        self.buckets = np.flatnonzero(cnt)

    def next(self, c: int) -> int:
        """The first masked position at or after ``c``, or -1."""
        i = np.searchsorted(self.buckets, c // _BUCKET)
        if i == self.buckets.size:
            return -1
        b0 = max(c, int(self.buckets[i]) * _BUCKET)
        seg = self.mask[b0: (b0 // _BUCKET + 1) * _BUCKET]
        if seg.any():
            return b0 + int(np.argmax(seg))
        if i + 1 == self.buckets.size:
            return -1
        b0 = int(self.buckets[i + 1]) * _BUCKET
        return b0 + int(np.argmax(self.mask[b0: b0 + _BUCKET]))

    def last(self) -> int:
        b0 = int(self.buckets[-1]) * _BUCKET
        seg = self.mask[b0: b0 + _BUCKET]
        return b0 + len(seg) - 1 - int(np.argmax(seg[::-1]))

    def targets(self, first: int, last: int, k: int) -> list:
        """k - 1 cut targets that split the scan [first - _SCAN_BACK,
        last] into k ranges of equal cost."""
        cost = _WALK * self.count
        b_lo = max(0, first - _SCAN_BACK) // _BUCKET
        cost[b_lo: last // _BUCKET + 1] += _BUCKET
        cum = np.cumsum(cost)
        at = np.searchsorted(cum, [j * int(cum[-1]) // k for j in range(1, k)])
        return [int(b) * _BUCKET for b in at]


def search(ctx: np.ndarray, base: int, bs: int, lookback: int,
           cut_pos: int, lens: np.ndarray, dists: np.ndarray,
           mask: np.ndarray | None = None,
           targets: np.ndarray | None = None) -> int:
    """One block's level-9 host match search, in place, bit-identical to
    the single native call it stands for: ``native.match_block_ex`` when
    ``mask`` (bool) is None, ``native.match_refine`` at the masked
    positions, or ``native.match_refine_dist`` when ``targets`` is given
    too (arguments as theirs, on the uint8 array ``ctx``).  The search
    runs as position ranges on the search pool, one for each _MIN_RANGE
    positions it scans and one per core at most; the caller's thread
    waits.  Returns the number of native calls made."""
    if mask is None:
        first, last = 0, bs - 1
        walks = bs
    else:
        mk = _Mask(mask)
        if mk.buckets.size == 0:
            return 0
        first, last = mk.next(0), mk.last()
        walks = int(mk.count.sum())
    span = last - max(first - _SCAN_BACK, -lookback) + 1
    cost = span + _WALK * walks
    k = min(_cores(), span // _MIN_RANGE)
    cuts = []
    if k > 1:
        block = ctx[base: base + bs]
        if mask is None:
            cuts = _cuts([j * bs // k for j in range(1, k)], bs,
                         _bad_spans(block))
        else:
            cuts = _cuts(mk.targets(first, last, k), bs,
                         _bad_spans(block, lens, dists))
    pool = _search_pool()
    if not cuts:
        if mask is None:
            call = (native.match_block_ex, ctx, base, bs, 9, lookback,
                    cut_pos, lens, dists)
        elif targets is None:
            call = (native.match_refine, ctx, base, bs, lookback, mask, lens,
                    dists, cut_pos)
        else:
            call = (native.match_refine_dist, ctx, base, bs, lookback, mask,
                    targets, lens, dists, cut_pos)
        pool.submit(cost, *call).result()
        return 1
    bounds = [0, *cuts, bs]
    if mask is None:
        futs = [pool.submit(cost, _whole_range, ctx, base, bs, lookback,
                            cut_pos, lens, dists, c0, c1)
                for c0, c1 in zip(bounds, bounds[1:])]
        for f in futs:
            f.result()
        return len(futs)
    # the single call's scan starts here (block coordinates)
    scan0 = first - _SCAN_BACK
    if cut_pos >= 0:
        scan0 = min(scan0, cut_pos - base)
    scan0 = max(scan0, -lookback)
    futs = []
    for j, (c0, c1) in enumerate(zip(bounds, bounds[1:])):
        nxt = mk.next(c1) if c1 < bs else -1
        own = mask[c0:c1].any()
        if not own and nxt < 0:
            continue  # the single call's scan ends before c0
        # the single call scans this range from its start: so must this
        # call, which a masked position just before it makes it do
        early = j > 0 and scan0 <= c0 - 1 - _SCAN_BACK
        s = c0 - 1 if early else c0
        e = nxt if nxt >= 0 else last
        futs.append((c0, min(c1, e + 1), s, pool.submit(
            cost, _masked_range, ctx, base, bs, lookback,
            cut_pos if j == 0 else -1, lens, dists, targets, mask, c0, c1, s,
            e, early, nxt)))
    # every call copies its inputs before any range is written back
    done = [(c0, c1, s, *f.result()) for c0, c1, s, f in futs]
    for c0, c1, s, sl, sd in done:
        lens[c0:c1] = sl[c0 - s: c1 - s]
        dists[c0:c1] = sd[c0 - s: c1 - s]
    return len(futs)


def _whole_range(ctx, base, bs, lookback, cut_pos, lens, dists, c0, c1):
    """Positions [c0, c1) of a whole search, into their own slices: the
    block's end rules, its boundary chain cut in the first range only,
    one window of lookback elsewhere."""
    b0 = base + c0
    native.match_chunk(
        ctx, base=b0, bs=c1 - c0, level=9,
        lookback=lookback if c0 == 0 else min(b0, fmt.MAX_DISTANCE),
        cut_pos=cut_pos if c0 == 0 else -1, block_end=base + bs,
        lens=lens[c0:c1], dists=dists[c0:c1])


def _masked_range(ctx, base, bs, lookback, cut_pos, lens, dists, targets,
                  mask, c0, c1, s, e, early, nxt):
    """A masked search restricted to the masked positions of [c0, c1), on
    private copies of lens and dists over [s, e]: the call starts at block
    position ``s`` and keeps the block's end (so its end rules) and
    lookback.  ``early``: a masked position at ``s`` = c0 - 1 starts the
    scan a window before the range, as the single call's scan does;
    ``nxt`` (>= 0): the first masked position after the range, which
    carries the scan through the range's end.  Neither is copied back.
    Returns the copies."""
    m = np.zeros(bs - s, np.uint8)
    m[c0 - s: c1 - s] = mask[c0:c1]
    if early:
        m[0] = 1
    if nxt >= 0:
        m[nxt - s] = 1
    sl = lens[s: e + 1].copy()
    sd = dists[s: e + 1].copy()
    # in masked mode the runtime touches lens, dists and targets only up
    # to the last masked position, index e - s
    if targets is None:
        native.match_refine(ctx, base=base + s, bs=bs - s,
                            lookback=lookback + s, mask=m, lens=sl, dists=sd,
                            cut_pos=cut_pos)
    else:
        native.match_refine_dist(ctx, base=base + s, bs=bs - s,
                                 lookback=lookback + s, mask=m,
                                 targets=targets[s: e + 1], lens=sl,
                                 dists=sd, cut_pos=cut_pos)
    return sl, sd
