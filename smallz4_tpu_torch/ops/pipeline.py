"""The 'device' engine: the level-9 encode on one torch device.

Port of ``smallz4_tpu/ops/pipeline.py`` ``compress`` and its three search
paths: the chunk engine (``_compress_chunked``: one
``ops.chunkmatch.match_chunks`` call per group of GROUP chunks), and the
sort and walk engines (``_compress_sorted``, the reference's
``_process_block_window``: one ``ops.sortmatch.match_segments`` or
``ops.match_finder.match_segments`` call per dispatch of SEG_BATCH
segments).  Each engine gives the one stream loop (``_stream``) three
steps, dispatch, collect and unpack; the loop schedules the blocks and
finishes each in a worker pool with the one host block tail
(``_host_tail``: refine of uncertified positions, optimal-parse DP and
emit on the host runtime, ``smallz4_tpu_torch.native``).  With
``parity=True`` the stream is bit-identical to ``native.compress(data, 9)``
and ``smallz4 -9``.

Every torch call stays on the calling thread and on the device's current
stream: inputs go up as host-to-device copies, results come back as
non-blocking copies into pinned host buffers, and one CUDA event per group
or dispatch marks them ready.  Pool threads touch only numpy arrays and the
native runtime.

``compress_device_resident`` (the reference's device-resident encode) keeps
a block's claims on the device: the chunk search's raw claims feed the
policy-iteration DP (``ops.parse``) and the sequence emit (``ops.emit``),
and only the compressed bytes come back.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
import warnings

import numpy as np
import torch

from .. import format as fmt
from .. import native
from ..parallel import host as host_par
from ..utils import profiling
from . import chunkmatch as cm
from . import emit as dev_emit
from . import match_finder as mf
from . import parse as dev_parse
from . import sortmatch as sm

HALO = fmt.MAX_DISTANCE  # 64 KB - 1: the dependent-block history window

# sort- and walk-engine segment geometry
SEG = mf.SEG                  # positions searched per segment
TAIL = mf.TAIL                # segment read-ahead (match headroom)
SEG_BUF = mf.SEG_BUF          # segment buffer bytes
SEG_BATCH = 8                 # segments per match_segments dispatch
WINDOW = 8                    # blocks in flight


def _blocks(n: int, block_size: int):
    return [(i, min(i + block_size, n)) for i in range(0, n, block_size)]


def _block_cut(start: int, legacy: bool) -> bool:
    """Whether the block at ``start`` takes the reference's boundary chain
    cut: modern frames, once a whole window of history precedes it."""
    return not legacy and start >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH


def _deep_run_rule(ctxb, base_r, bs, lens, dists, conv, lk):
    """Host certificate for giant byte runs (the reference's rule, copied:
    smallz4_tpu/ops/pipeline.py _deep_run_rule).  When a position's whole
    64 KB window lies inside one equal-byte run, every window candidate
    ties at e = min(run_rest, cap) and the reference keeps the d=1
    achiever, except at e == MaxSameLetter-1, which stays refined."""
    a = ctxb
    n_ctx = len(a)
    if n_ctx == 0:
        return
    new = np.empty(n_ctx, bool)
    new[0] = True
    np.not_equal(a[1:], a[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    ends = np.append(starts[1:], n_ctx)
    if int((ends - starts).max()) <= fmt.MAX_DISTANCE:
        return  # no run can contain a whole window
    rid = np.cumsum(new, dtype=np.int32) - 1
    sl = slice(base_r, base_r + bs)
    rs = starts[rid[sl]]
    re_ = ends[rid[sl]]
    i = np.arange(bs, dtype=np.int64)
    j = base_r + i
    capv = np.maximum(bs - fmt.BLOCK_END_LITERALS - i, 0)
    # rs is clamped at the context start, which only under-reports run
    # depth: sound (misses fall through to the refine path)
    deep = ((j - rs >= fmt.MAX_DISTANCE)
            & (i >= fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH))
    e = np.minimum(re_ - j, capv)
    ok = deep & (e != fmt.MAX_SAME_LETTER - 1)
    if not ok.any():
        return
    m4 = ok & (e >= fmt.MIN_MATCH)
    lens[m4] = e[m4]
    dists[m4] = 1
    m1 = ok & (e < fmt.MIN_MATCH)
    lens[m1] = 1
    dists[m1] = 0
    conv[ok] = True
    lk[ok] = True


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is "
                f"False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _device_pair(on_card: bool, dev: torch.device):
    """(to_dev, to_host): numpy -> device tensor through pinned memory, and
    device tensor -> pinned host tensor by a non-blocking copy.  On the CPU
    both are the identity."""
    def to_dev(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        return t.pin_memory().to(dev, non_blocking=True) if on_card else t

    def to_host(t: torch.Tensor) -> torch.Tensor:
        if not on_card:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t.contiguous(), non_blocking=True)
        return h

    return to_dev, to_host


def _choose_kernel(kernel: str | None, block_size: int) -> str:
    """The search engine: ``kernel`` or, if None, $SMALLZ4_TPU_KERNEL, or
    'chunk'; 'sort' and 'walk' take any block size.  'chunk' needs
    block_size % (GROUP*CHUNK) == 0 and falls back to 'sort' otherwise
    (with a warning when the kernel was asked for).  The reference falls
    back to 'walk' off a TPU because its Pallas kernels need one; the
    port's plain versions run anywhere, so it falls back to 'sort' on the
    CPU as on a GPU."""
    if kernel is None:
        kernel = os.environ.get("SMALLZ4_TPU_KERNEL", "")
    explicit = bool(kernel)
    kernel = kernel or "chunk"
    if kernel == "chunk" and block_size % (cm.GROUP * cm.CHUNK) != 0:
        if explicit:
            warnings.warn(
                f"kernel='chunk' requires block_size % "
                f"{cm.GROUP * cm.CHUNK} == 0 (got {block_size}); falling "
                f"back to kernel='sort'", stacklevel=3)
        kernel = "sort"
    if kernel not in ("chunk", "sort", "walk"):
        raise ValueError(f"unknown device kernel {kernel!r}")
    return kernel


def compress(data, level: int = 9, legacy: bool = False, dictionary=None,
             block_size: int | None = None, parity: bool = True,
             device="cuda", stats: dict | None = None,
             kernel: str | None = None, max_candidates: int = 64) -> bytes:
    """Compress via the device match search on ``device`` (a CUDA device
    runs the hand-written kernels, the CPU their plain versions; a CUDA
    device without CUDA raises).  Levels other than 9 and small-block
    parity streams go to the native encoder, as in the reference.
    ``kernel``: the search engine, 'chunk' (default), 'sort' or 'walk';
    None reads $SMALLZ4_TPU_KERNEL; see ``_choose_kernel`` for the
    fallback.  ``max_candidates``: the walk's candidate rounds per
    position (parity mode refines the positions it leaves unconverged).
    ``stats``, if given, receives the counters (``n_*``) and the self
    seconds of each span of the call (``utils.profiling``) by name."""
    dev = resolve_device(device)
    data = bytes(data)
    if legacy and dictionary:
        raise ValueError("legacy format doesn't support dictionaries")
    if level != 9:
        # capped-chain levels have serial skip/probe semantics: host path
        return native.compress(data, level, legacy=legacy,
                               dictionary=dictionary, block_size=block_size)
    if (legacy and block_size not in (None, fmt.MAX_BLOCK_SIZE_LEGACY)
            and len(data) > block_size):
        # a short non-final legacy block would end the stream early
        raise ValueError(
            "legacy multi-block streams require the fixed 8 MB block size")
    if block_size is None:
        block_size = fmt.MAX_BLOCK_SIZE_LEGACY if legacy else fmt.MAX_BLOCK_SIZE

    # Small-block parity streams go to the sequential native encoder: below
    # 64 KB + 12 the reference's per-block replay diverges from any
    # halo-context reconstruction (the reference pipeline's fine print).
    if (parity and not legacy and len(data) > block_size
            and block_size < fmt.MAX_DISTANCE + fmt.BLOCK_END_NO_MATCH):
        return native.compress(data, level, legacy=legacy,
                               dictionary=dictionary, block_size=block_size)
    kernel = _choose_kernel(kernel, block_size)

    dict_tail = b""
    if dictionary and not legacy:
        dict_tail = bytes(dictionary)[-fmt.MAX_DISTANCE:]
    out = bytearray(fmt.build_frame_header(legacy))
    counters = _Counters()
    blocks = _blocks(len(data), block_size)
    args = (out, data, dict_tail + data, len(dict_tail), blocks, legacy,
            parity, counters, dev)
    with profiling.request("encode", stats, n_bytes=len(data),
                           n_blocks=len(blocks), legacy=int(legacy)):
        if kernel == "chunk":
            _compress_chunked(*args)
        else:
            _compress_sorted(*args, kernel=kernel,
                             max_candidates=max_candidates)
        out += fmt.build_end_mark(legacy)
        if stats is not None:
            stats.update(counters)
        return bytes(out)


class _Counters(dict):
    """A call's ``n_*`` counters; ``add`` may run on any thread."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()

    def add(self, **kv):
        with self._lock:
            for k, v in kv.items():
                self[k] = self.get(k, 0) + v


def _frame_block(out, data, start, end, payload, legacy):
    """Appends the block data[start:end] to the frame ``out``, header
    first: its ``payload`` (compressed bytes, or None) when that is
    shorter than the block or the frame is legacy, which stores nothing;
    otherwise the block's own bytes, stored."""
    stored = not legacy and (payload is None or len(payload) >= end - start)
    body = data[start:end] if stored else payload
    out += fmt.build_block_header(len(body), stored, legacy)
    out += body


def _chunk_rows(arr, start, bs, first, rows, legacy):
    """Inputs of one chunk search over the chunks [first, first + rows) of
    the block [start, start + bs) of ``arr``: (bufs uint8 [rows, CHUNK +
    LOOK], the chunk and its read-ahead; cand int32 [rows], the positions
    to search, where claim validity ends too; lim int32 [rows], the limit
    of a claim's end; cut_gram, cut_pos, the block's boundary cut, bound to
    its chunk 0), numpy arrays and ints."""
    CH = cm.CHUNK
    n = len(arr)
    bufs = np.zeros((rows, CH + cm.LOOK), np.uint8)
    cand = np.zeros(rows, np.int32)
    lim = np.zeros(rows, np.int32)
    for j in range(rows):
        o = (first + j) * CH
        take = max(0, min(CH + cm.LOOK, n - start - o))
        bufs[j, :take] = arr[start + o: start + o + take]
        cand[j] = max(0, min(CH, bs - o))
        lim[j] = bs - o - fmt.BLOCK_END_LITERALS
    if first == 0 and _block_cut(start, legacy):
        g = start - fmt.BLOCK_END_NO_MATCH
        return (bufs, cand, lim, cm.pack_cut_gram(arr[g: g + 4].tobytes()),
                CH - fmt.BLOCK_END_NO_MATCH)
    return bufs, cand, lim, 0, -1


def _context(varr, start, end, d, legacy):
    """(ctx, base): the host search's view of the block [start, end) of a
    frame whose virtual stream ``varr`` starts with ``d`` dictionary
    bytes, the block after its window of history (none in a legacy
    frame), and the block's offset in it."""
    vstart = start + d
    lo = vstart if legacy else max(vstart - HALO, 0)
    return varr[lo: end + d], vstart - lo


def _host_tail(data, varr, d, start, end, legacy, parity, claims, counters):
    """One block's host tail; returns its compressed payload.  ``claims``:
    the device search's (lens, dists, conv, lk, redo), used in place, or
    None for a whole host search.  The last 11 positions become literals;
    the refine searches the positions whose length is uncertified (~lk) in
    parity mode and the chunks the device gave up on (redo) in fast mode,
    or, where that is more than half the block in parity mode, the whole
    block; then the DP, in parity mode the distance fix at the chosen
    matches the device did not certify, and the emit.  Every search is the
    split ``host_par.search``.  Device blocks count ``n_positions``,
    ``n_refine_positions`` and ``n_wholesale_blocks``."""
    bs = end - start
    ctx, base = _context(varr, start, end, d, legacy)
    cut = base - fmt.BLOCK_END_NO_MATCH if _block_cut(start, legacy) else -1
    device = claims is not None
    if device:
        lens, dists, conv, lk, redo = claims
    else:
        lens = np.ones(bs, np.int32)
        dists = np.zeros(bs, np.int32)
        conv = np.zeros(bs, bool)
        lk = np.zeros(bs, bool)
        redo = np.ones(bs, bool)
    tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
    lens[bs - tail:] = 1
    dists[bs - tail:] = 0
    conv[bs - tail:] = True
    lk[bs - tail:] = True
    redo[bs - tail:] = False
    mask = ~lk if parity else redo
    n_refine = int(mask.sum())
    if device:  # certificate miss rate: device blocks only
        counters.add(n_refine_positions=n_refine, n_positions=bs)
    # high-miss regime: a wholesale exact search beats per-position
    # refine and leaves every position exact
    wholesale = parity and n_refine > bs / 2
    with profiling.span("host.refine", n_refine_positions=n_refine,
                        wholesale=int(wholesale), n_ranges=0) as sp:
        if wholesale or n_refine:
            ranges = host_par.search(ctx, base, bs, base, cut, lens, dists,
                                     mask=None if wholesale else mask)
            conv |= mask  # refined positions are fully exact
            sp.count(n_ranges=ranges)
            counters.add(n_searches=1, n_search_ranges=ranges)
            if wholesale and device:
                counters.add(n_wholesale_blocks=1)
    fix = parity and not wholesale and device
    lens_claim = lens.copy() if fix else None
    with profiling.span("host.dp"):
        native.estimate_costs(lens, dists)
    if fix:
        # post-DP distance fix at the chosen match starts only
        need = native.chosen_mask(lens) & ~conv
        n_fix = int(need.sum())
        with profiling.span("host.dist_fix", n_dist_fix_positions=n_fix,
                            n_ranges=0) as sp:
            if n_fix:
                ranges = host_par.search(ctx, base, bs, base, cut,
                                         lens_claim, dists, mask=need,
                                         targets=lens_claim)
                sp.count(n_ranges=ranges)
                counters.add(n_searches=1, n_search_ranges=ranges,
                             n_dist_fix_positions=n_fix)
    with profiling.span("host.emit"):
        return native.emit_block(data[start:end], lens, dists)


def _stream(out, data, varr, d, blocks, legacy, parity, counters, dispatch,
            collect, unpack):
    """The stream loop of every search engine.  The device claims blocks
    from the front, at most WINDOW in flight: ``dispatch(bi, start, end)``
    queues a block's searches (calling thread, span ``stream.dispatch``,
    ``n_groups`` the entries it returns), ``collect(start, end, entries)``
    copies their results to host memory (calling thread,
    ``stream.collect``), and ``unpack(start, end, fetched)`` makes the
    claims for ``_host_tail`` (pool, ``host.unpack``).  In parity mode a
    block's bytes do not depend on its engine, so assist loops (one a core
    or $SMALLZ4_TPU_CPU_ASSIST; none in fast mode by default) take whole
    blocks from the BACK onto the host search.  The join writes the blocks
    in frame order.  ``host.block`` (``assist`` 1 on the host search) and
    ``stream.dispatch`` carry the block's index in the frame, ``block``,
    which joins its spans across threads."""
    pending = []  # (bi, start, end, entries)
    jobs = {}     # bi -> future of the payload

    def finish(bi, start, end, fetched, parent):
        """A block's pool work; spans under ``parent`` (the pool carries
        no context).  ``fetched is None``: an assist block."""
        with profiling.span("host.block", parent=parent,
                            assist=int(fetched is None),
                            n_positions=end - start, block=bi):
            claims = None
            if fetched is not None:
                with profiling.span("host.unpack"):
                    claims = unpack(start, end, fetched)
            return _host_tail(data, varr, d, start, end, legacy, parity,
                              claims, counters)

    n_cores = host_par._cores()
    assist_default = str(n_cores) if parity else "0"
    n_assist = max(0, int(os.environ.get("SMALLZ4_TPU_CPU_ASSIST",
                                         assist_default)))
    fence = threading.Lock()
    claim = {"front": 0, "back": len(blocks)}

    def claim_front():
        with fence:
            if claim["front"] >= claim["back"]:
                return -1
            bi = claim["front"]
            claim["front"] += 1
            return bi

    def assist_loop(parent):
        while True:
            with fence:
                if claim["back"] - 1 < claim["front"]:
                    return
                claim["back"] -= 1
                bi = claim["back"]
            start, end = blocks[bi]
            jobs[bi] = done = cf.Future()
            done.set_result(finish(bi, start, end, None, parent))

    # one worker per core for the finish tail PLUS one per assist loop (an
    # assist occupies its worker for a whole block); the native stages
    # release the GIL; the workers keep their match tables warm
    n_assist = min(n_assist, max(0, len(blocks) - 1))
    pool = host_par._pool(n_cores + n_assist)
    root = profiling.current()
    assist_futures = [pool.submit(assist_loop, root)
                      for _ in range(n_assist)]

    def drain(limit):
        while len(pending) > limit:
            bi, start, end, entries = pending.pop(0)
            with profiling.span("stream.collect"):
                fetched = collect(start, end, entries)
            jobs[bi] = pool.submit(finish, bi, start, end, fetched, root)

    while True:
        bi = claim_front()
        if bi < 0:
            break
        start, end = blocks[bi]
        with profiling.span("stream.dispatch", block=bi) as sp:
            entries = dispatch(bi, start, end)
            sp.count(n_groups=len(entries))
        pending.append((bi, start, end, entries))
        counters.add(n_device_blocks=1)
        drain(WINDOW)
    drain(0)

    with profiling.span("stream.join"):  # the assist's blocks, then order
        for f in assist_futures:
            f.result()
        for bi, (start, end) in enumerate(blocks):
            _frame_block(out, data, start, end, jobs[bi].result(), legacy)


def _compress_chunked(out, data, vdata, d, blocks, legacy, parity, counters,
                      dev):
    """The chunk engine's steps of ``_stream``: one ``match_chunks`` call
    per GROUP chunks; within a block each call carries its last chunk's
    sorted records to the next as the halo.  Each block's leading halo is
    sorted from its raw history bytes, so blocks are independent.  Packed
    results come back to pinned host memory and are unpacked in the pool.

    Contract (checked by the caller): block_size % (GROUP*CHUNK) == 0, so
    every block starts at a call boundary and the boundary cut binds to
    that call's chunk 0.

    Spans: ``stream.group`` a call, inside ``stream.dispatch`` (``block``,
    ``carried`` 1 when its halo is the previous call's records)."""
    CH, G, CAP = cm.CHUNK, cm.GROUP, cm.HEAD_CAP
    # speculative packed prefix copied with every group; a group whose
    # largest head count exceeds it pays one more synchronous copy
    PREFETCH = min(CAP, max(256, CH // 8))
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    varr = np.frombuffer(vdata, np.uint8)
    on_card = dev.type == "cuda"
    to_dev, to_host = _device_pair(on_card, dev)

    def no_history(start):
        """Whether the block at ``start`` begins with an empty halo: every
        legacy block, and the first block of a frame without a
        dictionary."""
        return legacy or (start == 0 and not d)

    def block_halo(start):
        """Sorted halo records for the block at ``start``."""
        if no_history(start):
            return cm.empty_halo(chunk=CH, device=dev)
        hb = np.zeros(CH + cm.LOOK, np.uint8)
        if start == 0:  # dictionary tail, right-aligned (virtual prefix)
            lo_valid = CH - d
            hb[lo_valid:CH] = varr[:d]
        else:           # preceding 64 KiB of the stream
            lo_valid = 0
            hb[:CH] = arr[start - CH: start]
        take = min(cm.LOOK, n - start)
        if take > 0:
            hb[CH: CH + take] = arr[start: start + take]
        return cm.sort_chunk(to_dev(hb), lo_valid, CH, chunk=CH)

    def dispatch(bi, start, end):
        """Queue every group of one block on the device."""
        bs = end - start
        n_groups = -(-bs // (G * CH))
        counters.add(n_device_groups=n_groups, n_carried_halos=n_groups - 1,
                     n_empty_halo_blocks=int(no_history(start)))
        halo = block_halo(start)
        entries = []
        for gi in range(n_groups):
            g0 = gi * G
            with profiling.span("stream.group", block=bi, carried=int(gi > 0),
                                n_positions=min(G * CH, bs - g0 * CH)):
                bufs, cand, lim, cut_gram, cut_pos = _chunk_rows(
                    arr, start, bs, g0, G, legacy)
                cand_d = to_dev(cand)
                # claim validity ends where candidate validity does
                halo, ys = cm.match_chunks(
                    halo, to_dev(bufs), cand_d, cand_d, to_dev(lim),
                    cut_gram, cut_pos, n_chunks=G, head_cap=CAP, chunk=CH)
                counters.add(n_h2d_bytes=bufs.nbytes + cand.nbytes
                             + lim.nbytes)
                bits, packed, counts, cbits, kbits = ys
                # start the host copies now; certificate bits are consumed
                # only by the parity refine
                host = [to_host(a)
                        for a in (bits, counts, packed[:, :PREFETCH])
                        + ((cbits, kbits) if parity else ())]
                done = None
                if on_card:
                    done = torch.cuda.Event()
                    done.record()
                entries.append((g0, packed, host, done))
        return entries

    def collect(start, end, entries):
        return [collect_group(*e) for e in entries]

    def collect_group(g0, packed, host, done):
        if done is not None:
            done.synchronize()
        # own copies: the pinned buffers are released on this thread
        bits_np, counts_np, pk = (h.numpy().copy() for h in host[:3])
        maxp = max(1, int(counts_np.max()))
        if maxp > PREFETCH:
            pk = packed[:, : min(maxp, CAP)].cpu().numpy()
        cbits_np, kbits_np = ((host[3].numpy().copy(), host[4].numpy().copy())
                              if parity else (None, None))
        counters.add(n_d2h_bytes=bits_np.nbytes + pk.nbytes + counts_np.nbytes
                     + (cbits_np.nbytes + kbits_np.nbytes if parity else 0))
        return g0, bits_np, pk, counts_np, cbits_np, kbits_np

    def unpack(start, end, fetched):
        bs = end - start
        lens = np.ones(bs, np.int32)
        dists = np.zeros(bs, np.int32)
        conv = np.ones(bs, bool)
        lk = np.ones(bs, bool)
        redo = np.zeros(bs, bool)
        for g0, bits_np, pk, counts_np, cbits_np, kbits_np in fetched:
            cv_rows = (cm.unpack_bits_rows(cbits_np, CH)
                       if cbits_np is not None else None)
            lk_rows = (cm.unpack_bits_rows(kbits_np, CH)
                       if kbits_np is not None else None)
            for j in range(G):
                o = (g0 + j) * CH
                if o >= bs:
                    break
                w = min(CH, bs - o)
                if counts_np[j] > CAP:  # head overflow: host redoes chunk
                    redo[o: o + w] = True
                    conv[o: o + w] = False
                    lk[o: o + w] = False
                    continue
                l, dd = native.unpack_claims(
                    bits_np[j], pk[j, : counts_np[j]], CH)
                lens[o: o + w] = l[:w]
                dists[o: o + w] = dd[:w]
                if cv_rows is not None:
                    conv[o: o + w] = cv_rows[j, :w]
                if lk_rows is not None:
                    lk[o: o + w] = lk_rows[j, :w]
        _deep_run_rule(*_context(varr, start, end, d, legacy), bs, lens,
                       dists, conv, lk)
        return lens, dists, conv, lk, redo

    _stream(out, data, varr, d, blocks, legacy, parity, counters, dispatch,
            collect, unpack)


def segment_group(varr: np.ndarray, vstart: int, vend: int, group,
                  legacy: bool, block_cut: bool):
    """Inputs of one ``match_segments`` dispatch: the segments starting at
    the virtual-stream offsets ``group`` (at most SEG_BATCH) of the block
    [vstart, vend) of ``varr``.  Each row is [halo | SEG | read-ahead]
    with its valid range; padding rows hold nothing valid.  Returns
    (bufs uint8 [SEG_BATCH, SEG_BUF], start_valid, end_valid int32,
    cut_boundary, limit_final bool), numpy arrays."""
    bufs = np.zeros((SEG_BATCH, SEG_BUF), np.uint8)
    sv = np.full(SEG_BATCH, SEG_BUF, np.int32)
    ev = np.zeros(SEG_BATCH, np.int32)
    cut = np.zeros(SEG_BATCH, bool)
    fin = np.zeros(SEG_BATCH, bool)
    for r, s0 in enumerate(group):
        lo = max(s0 - HALO, vstart if legacy else 0)
        hi = min(s0 + SEG + TAIL, vend)
        hl = s0 - lo
        bufs[r, HALO - hl: HALO - hl + hi - lo] = varr[lo:hi]
        sv[r] = HALO - hl
        ev[r] = HALO - hl + hi - lo
        cut[r] = block_cut and s0 == vstart
        fin[r] = hi == vend
    return bufs, sv, ev, cut, fin


def _compress_sorted(out, data, vdata, d, blocks, legacy, parity, counters,
                     dev, kernel="sort", max_candidates=64):
    """The segment engines' steps of ``_stream`` (the reference's
    ``_process_block_window``): every segment group of a block goes to
    ``sortmatch.match_segments`` (kernel 'sort') or
    ``match_finder.match_segments`` ('walk'); collecting assembles the
    block's claims in position order.  A segment engine certifies a
    position's length and distance together (``conv``), so it stands for
    ``lk`` too, and no chunk is redone."""
    varr = np.frombuffer(vdata, np.uint8)
    on_card = dev.type == "cuda"
    to_dev, to_host = _device_pair(on_card, dev)

    def dispatch(bi, start, end):
        """Queue every segment group of one block on the device."""
        vstart, vend = start + d, end + d
        seg_starts = range(vstart, vend, SEG)
        block_cut = _block_cut(start, legacy)
        return [dispatch_group(vstart, vend, block_cut,
                               seg_starts[g0: g0 + SEG_BATCH])
                for g0 in range(0, len(seg_starts), SEG_BATCH)]

    def dispatch_group(vstart, vend, block_cut, group):
        arrays = segment_group(varr, vstart, vend, group, legacy, block_cut)
        bufs, sv, ev, cut, fin = (to_dev(a) for a in arrays)
        if kernel == "sort":
            res = sm.match_segments(bufs, sv, ev, cut, fin)
        else:
            res = mf.match_segments(bufs, sv, ev, cut,
                                    max_candidates=max_candidates)
        # conv is consumed only by the parity refine
        host = [to_host(a) for a in (res if parity else res[:2])]
        done = None
        if on_card:
            done = torch.cuda.Event()
            done.record()
        counters.add(n_dispatches=1,
                     n_h2d_bytes=sum(a.nbytes for a in arrays),
                     n_d2h_bytes=sum(h.numel() * h.element_size()
                                     for h in host))
        return group, host, done

    def collect(start, end, entries):
        """Wait for one block's dispatches and assemble its position-order
        (lens, dists, conv)."""
        bs = end - start
        vstart, vend = start + d, end + d
        lens = np.empty(bs, np.int32)
        dists = np.empty(bs, np.int32)
        conv = np.ones(bs, bool)
        for group, host, done in entries:
            if done is not None:
                done.synchronize()
            arrays = [h.numpy() for h in host]
            for r, s0 in enumerate(group):
                w = min(SEG, vend - s0)
                o = s0 - vstart
                lens[o: o + w] = arrays[0][r, :w]
                dists[o: o + w] = arrays[1][r, :w]
                if parity:
                    conv[o: o + w] = arrays[2][r, :w]
        return lens, dists, conv

    def unpack(start, end, fetched):
        lens, dists, conv = fetched
        return lens, dists, conv, conv, np.zeros(end - start, bool)

    _stream(out, data, varr, d, blocks, legacy, parity, counters, dispatch,
            collect, unpack)


def _device_resident_block_step(halo, bufs, cand, vhi, lim, cut_gram, cut_pos,
                                blk, n_chunks: int, bs: int):
    """One block of the device-resident encode, all on the device: the
    chunk search's raw claims (``cm.match_chunks_raw``), the last 11
    positions made literals, the policy-iteration DP (``ops.parse``), the
    sequence emit (``ops.emit``) of the chosen matches.  Returns (next
    halo, payload uint8 [bs + bs//255 + 16], n_out, ok, rounds); ok False:
    the DP hit its round cap; rounds: the DP's round count (a device
    scalar, like n_out and ok)."""
    with profiling.span("resident.match"):
        halo, (lens, dists, _conv, _lk) = cm.match_chunks_raw(
            halo, bufs, cand, vhi, lim, cut_gram, cut_pos,
            n_chunks=n_chunks, chunk=cm.CHUNK)
    with profiling.span("resident.dp"):
        lens = lens.reshape(-1)[:bs]
        dists = dists.reshape(-1)[:bs]
        pos = torch.arange(bs, device=lens.device)
        tail = pos >= bs - (fmt.BLOCK_END_NO_MATCH - 1)
        lens = torch.where(tail, 1, lens)
        dists = torch.where(tail, 0, dists)
        choice, _cost, ok, rounds = dev_parse.policy_iteration(lens, dists,
                                                               bs)
    with profiling.span("resident.emit"):
        # the emit reads dists at the chosen matches only
        payload, n_out = dev_emit.emit_block_device(blk, choice, dists)
    return halo, payload, n_out, ok, rounds


def compress_device_resident(data, block_size: int | None = None,
                             report=None, device="cuda") -> bytes:
    """Device-resident level-9-class encode on ``device`` (a CUDA device
    runs the hand-written kernels, the CPU their plain versions; a CUDA
    device without CUDA raises): per block, match (the chunk engine's raw
    claims), optimal parse (``ops.parse``) and sequence emit (``ops.emit``)
    on the device, so only the compressed bytes come back to the host.

    The claims saturate at 65535 and skip the host refine, so the stream is
    valid and -9-class but not bit-identical to ``smallz4 -9``.  Modern
    frames, no dictionary; ``block_size`` (default min(4 MiB, 16 chunks))
    must be a multiple of ``cm.CHUNK``.  A block whose DP hits its round
    cap is redone on the host (exact search, native DP and emit).
    ``report`` (a ``utils.profiling.RunReport``) receives the wall time,
    the self seconds of each span of the call by name (``stages``) and the
    counters n_h2d_bytes and n_d2h_bytes."""
    dev = resolve_device(device)
    t_run = time.perf_counter()
    data = bytes(data)
    CH = cm.CHUNK
    if block_size is None:
        block_size = min(fmt.MAX_BLOCK_SIZE, 16 * CH)
    if block_size % CH != 0:
        raise ValueError(f"device-resident path needs block_size % {CH} == 0")
    n = len(data)
    blocks = _blocks(n, block_size)
    counters = _Counters()
    with profiling.request("encode",
                           report.stages if report is not None else None,
                           n_bytes=n, n_blocks=len(blocks)):
        out = _resident_blocks(data, blocks, counters, dev)
    if report is not None:
        report.operation = "encode"
        report.engine = "device-resident"
        report.bytes_in = n
        report.bytes_out = len(out)
        report.blocks = len(blocks)
        report.wall_s = time.perf_counter() - t_run
        for k, v in counters.items():
            report.counters[k] = report.counters.get(k, 0) + v
    return out


def _resident_blocks(data: bytes, blocks, counters, dev) -> bytes:
    """The frame of ``compress_device_resident``, block after block;
    ``counters`` receives n_h2d_bytes and n_d2h_bytes."""
    CH = cm.CHUNK
    arr = np.frombuffer(data, np.uint8)
    out = bytearray(fmt.build_frame_header(False))
    to_dev, _ = _device_pair(dev.type == "cuda", dev)
    with profiling.span("resident.match"):  # the first block's halo
        halo = cm.empty_halo(chunk=CH, device=dev)  # carried block to block
    for start, end in blocks:
        bs = end - start
        n_chunks = -(-bs // CH)
        with profiling.span("resident.stage"):
            bufs, cand, lim, cut_gram, cut_pos = _chunk_rows(
                arr, start, bs, 0, n_chunks, False)
        counters.add(n_h2d_bytes=bufs.nbytes + bs)
        with profiling.span("resident.upload", n_h2d_bytes=bufs.nbytes + bs):
            # candidate and claim validity end together
            cand_d = to_dev(cand)
            bufs_d, lim_d = to_dev(bufs), to_dev(lim)
            blk_d = to_dev(arr[start:end].copy())
        halo, payload, n_out, ok, rounds = _device_resident_block_step(
            halo, bufs_d, cand_d, cand_d, lim_d, cut_gram, cut_pos, blk_d,
            n_chunks, bs)
        with profiling.span("resident.sync") as sync:
            m, good, n_rounds = torch.stack(
                [n_out.to(torch.int32), ok.to(torch.int32),
                 rounds.to(torch.int32)]).tolist()
            sync.count(n_dp_rounds=n_rounds)
        if not good:
            with profiling.span("resident.fallback"):
                # the DP's round cap: the block is redone by the host tail
                # (whole search, native DP and emit; the report keeps only
                # its byte counters); the stream stays valid, only this
                # block's bytes differ from the device path's
                pay = _host_tail(data, arr, 0, start, end, False, True, None,
                                 _Counters())
                _frame_block(out, data, start, end, pay, False)
            continue
        d2h = m + 8 if m < bs else 8
        counters.add(n_d2h_bytes=d2h)
        with profiling.span("resident.fetch", n_d2h_bytes=d2h):
            pay = payload[:m].cpu().numpy().tobytes() if m < bs else None
            _frame_block(out, data, start, end, pay, False)
    out += fmt.build_end_mark(False)
    return bytes(out)


def decompress(data, dictionary=None, device="cuda") -> bytes:
    """Decode a frame with the device expansion (``ops.decoder``) on
    ``device`` (a CUDA device runs csrc/expand.cu, the CPU the plain
    version; a CUDA device without CUDA raises).

    The host parses each block's sequence table as it goes; block
    expansions chain through a 64 KB history window on the device, so
    consecutive blocks dispatch without host round trips, with at most
    four blocks' results in flight back to the host."""
    from . import decoder

    dev = resolve_device(device)
    dec = decoder.BlockDecoder(fmt.MAX_BLOCK_SIZE_LEGACY, dev)
    hist = dec.hist_device(bytes(dictionary)[-decoder.HIST_CAP:]
                           if dictionary else b"")
    out = bytearray()
    fetch = decoder.Fetch()
    for payload, tables, out_len in decoder.frame_blocks(data):
        if tables is not None:
            out_dev, _ = dec.decode_dev(payload, hist, tables)
            fetch.put(out_dev, out_len)
            hist = decoder._update_hist(hist, out_dev, out_len)
        else:  # a stored block: its bytes as they are, its tail to history
            fetch.put(payload, out_len)
            take = min(out_len, decoder.HIST_CAP)
            stored = np.zeros(decoder.HIST_CAP, np.uint8)  # left-aligned
            stored[:take] = np.frombuffer(payload[-take:], np.uint8)
            hist = decoder._update_hist(hist, decoder._upload(stored, dev),
                                        take)
        for item in fetch.drain(4):  # a small device pipeline in flight
            out += memoryview(item)
    for item in fetch.drain(0):
        out += memoryview(item)
    return bytes(out)
