"""The 'device' engine: the level-9 encode on one torch device.

Port of ``smallz4_tpu/ops/pipeline.py`` ``compress`` and its three search
paths: the chunk engine (``_compress_chunked``: one
``ops.chunkmatch.match_chunks`` call per group of GROUP chunks), and the
sort and walk engines (``_compress_sorted``, the reference's
``_process_block_window``: one ``ops.sortmatch.match_segments`` or
``ops.match_finder.match_segments`` call per dispatch of SEG_BATCH
segments).  The device runs the match search; the host runtime
(``smallz4_tpu_torch.native``) refines uncertified positions, runs the
optimal-parse DP and emits, in a worker pool.  With
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
    counters: dict = {}
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


def _compress_chunked(out, data, vdata, d, blocks, legacy, parity, counters,
                      dev):
    """Chunk-engine stream loop: one ``match_chunks`` call per GROUP
    chunks; within a block each call carries its last chunk's sorted
    records to the next as the halo.  Each block's leading halo is sorted
    from its raw history bytes, so blocks are independent.  Packed results
    come back to pinned host memory; refine (parity mode) + DP + emit run
    in the worker pool.

    Contract (checked by the caller): block_size % (GROUP*CHUNK) == 0, so
    every block starts at a call boundary and the boundary cut binds to
    that call's chunk 0.

    Spans: ``stream.dispatch`` a device-path block and, inside it,
    ``stream.group`` a call (``carried`` 1 when its halo is the previous
    call's records); both, and ``host.block``, carry the block's index
    ``block`` in the frame, which joins a block's spans across threads."""
    CH, G, CAP = cm.CHUNK, cm.GROUP, cm.HEAD_CAP
    # speculative packed prefix copied with every group; a group whose
    # largest head count exceeds it pays one more synchronous copy
    PREFETCH = min(CAP, max(256, CH // 8))
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    on_card = dev.type == "cuda"
    count_lock = threading.Lock()  # finish() runs in the worker pool

    def add(key, v):
        counters[key] = counters.get(key, 0) + v

    def count_search(ranges):
        with count_lock:
            add("n_searches", 1)
            add("n_search_ranges", ranges)

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
            hb[lo_valid:CH] = np.frombuffer(vdata[:d], np.uint8)
        else:           # preceding 64 KiB of the stream
            lo_valid = 0
            hb[:CH] = arr[start - CH: start]
        take = min(cm.LOOK, n - start)
        if take > 0:
            hb[CH: CH + take] = arr[start: start + take]
        return cm.sort_chunk(to_dev(hb), lo_valid, CH, chunk=CH)

    def dispatch_block(bi, start, end):
        """Queue every group of one block on the device."""
        bs = end - start
        n_groups = -(-bs // (G * CH))
        add("n_device_groups", n_groups)
        add("n_carried_halos", n_groups - 1)
        add("n_empty_halo_blocks", int(no_history(start)))
        with profiling.span("stream.dispatch", n_groups=n_groups, block=bi):
            return dispatch_groups(bi, start, bs, n_groups)

    def dispatch_groups(bi, start, bs, n_groups):
        block_cut = _block_cut(start, legacy)
        halo = block_halo(start)
        entries = []
        for gi in range(n_groups):
            g0 = gi * G
            with profiling.span("stream.group", block=bi, carried=int(gi > 0),
                                n_positions=min(G * CH, bs - g0 * CH)):
                bufs = np.zeros((G, CH + cm.LOOK), np.uint8)
                cand = np.zeros(G, np.int32)
                lim = np.zeros(G, np.int32)
                for j in range(G):
                    cs = start + (g0 + j) * CH
                    take = max(0, min(CH + cm.LOOK, n - cs))
                    if take:
                        bufs[j, :take] = arr[cs: cs + take]
                    cand[j] = max(0, min(CH, bs - (g0 + j) * CH))
                    lim[j] = bs - (g0 + j) * CH - fmt.BLOCK_END_LITERALS
                if gi == 0 and block_cut:
                    cut_gram = cm.pack_cut_gram(
                        data[start - fmt.BLOCK_END_NO_MATCH:
                             start - fmt.BLOCK_END_NO_MATCH + 4])
                    cut_pos = CH - fmt.BLOCK_END_NO_MATCH
                else:
                    cut_gram, cut_pos = 0, -1
                cand_d = to_dev(cand)
                # claim validity ends where candidate validity does
                halo, ys = cm.match_chunks(
                    halo, to_dev(bufs), cand_d, cand_d, to_dev(lim),
                    cut_gram, cut_pos, n_chunks=G, head_cap=CAP, chunk=CH)
                add("n_h2d_bytes", bufs.nbytes + cand.nbytes + lim.nbytes)
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

    def collect_block(entries):
        """Wait for one block's results (calling thread); unpacking
        happens in the pool."""
        with profiling.span("stream.collect"):
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
        add("n_d2h_bytes", bits_np.nbytes + pk.nbytes + counts_np.nbytes
            + (cbits_np.nbytes + kbits_np.nbytes if parity else 0))
        return g0, bits_np, pk, counts_np, cbits_np, kbits_np

    def unpack_block(start, end, fetched):
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
        return lens, dists, conv, lk, redo

    def finish(bi, start, end, fetched, parent):
        """Worker-pool tail: unpack + pre-DP length refine (parity /
        overflow) + DP + post-DP distance fix + emit, spans under
        ``parent`` (the pool carries no context).  ``fetched is None`` =
        CPU-assist block: the whole search runs on the host matcher
        (exact, so parity-mode output is independent of which engine a
        block landed on)."""
        bs = end - start
        with profiling.span("host.block", parent=parent,
                            assist=int(fetched is None), n_positions=bs,
                            block=bi):
            return finish_block(start, end, fetched)

    def finish_block(start, end, fetched):
        bs = end - start
        vstart, vend = start + d, end + d
        block_cut = _block_cut(start, legacy)
        lo = vstart if legacy else max(vstart - HALO, 0)
        base_r = vstart - lo
        ctxb = np.frombuffer(vdata[lo:vend], np.uint8)
        cut = (base_r - fmt.BLOCK_END_NO_MATCH) if block_cut else -1
        if fetched is None:
            lens = np.ones(bs, np.int32)
            dists = np.zeros(bs, np.int32)
            conv = np.zeros(bs, bool)
            lk = np.zeros(bs, bool)
            redo = np.ones(bs, bool)
        else:
            with profiling.span("host.unpack"):
                lens, dists, conv, lk, redo = unpack_block(start, end,
                                                           fetched)
                _deep_run_rule(ctxb, base_r, bs, lens, dists, conv, lk)
        tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
        lens[bs - tail:] = 1
        dists[bs - tail:] = 0
        conv[bs - tail:] = True
        lk[bs - tail:] = True
        redo[bs - tail:] = False
        mask = ~lk if parity else redo
        n_refine = int(mask.sum())
        if fetched is not None:  # certificate miss rate: device blocks only
            with count_lock:
                add("n_refine_positions", n_refine)
                add("n_positions", bs)
        # high-miss regime: a wholesale exact search beats per-position
        # refine and leaves every position exact
        wholesale = parity and n_refine > bs / 2
        with profiling.span("host.refine", n_refine_positions=n_refine,
                            wholesale=int(wholesale), n_ranges=0) as sp:
            if wholesale:
                ranges = host_par.search(ctxb, base_r, bs, base_r, cut, lens,
                                         dists)
                conv[:] = True
                if fetched is not None:
                    with count_lock:
                        add("n_wholesale_blocks", 1)
            elif n_refine:
                ranges = host_par.search(ctxb, base_r, bs, base_r, cut, lens,
                                         dists, mask=mask)
                conv |= mask  # refined positions are fully exact
            if wholesale or n_refine:
                sp.count(n_ranges=ranges)
                count_search(ranges)
        lens_claim = lens.copy() if parity else None
        with profiling.span("host.dp"):
            native.estimate_costs(lens, dists)
        if parity and not wholesale and fetched is not None:
            # post-DP distance fix at the chosen match starts only
            need = native.chosen_mask(lens) & ~conv
            n_fix = int(need.sum())
            with profiling.span("host.dist_fix", n_dist_fix_positions=n_fix,
                                n_ranges=0) as sp:
                if n_fix:
                    ranges = host_par.search(
                        ctxb, base_r, bs, base_r, cut, lens_claim, dists,
                        mask=need, targets=lens_claim)
                    sp.count(n_ranges=ranges)
                    count_search(ranges)
                    with count_lock:
                        add("n_dist_fix_positions", n_fix)
        with profiling.span("host.emit"):
            payload = native.emit_block(data[start:end], lens, dists)
        if len(payload) < bs or legacy:
            return payload, False
        return data[start:end], True

    # in-flight blocks (WINDOW) bound device and host result memory
    n_cores = min(32, os.cpu_count() or 1)
    pending = []  # (bi, start, end, entries)
    jobs = {}     # bi -> future of (payload, stored)

    # CPU assist: in parity mode every block encodes to the same bytes
    # whichever engine it lands on, so idle host workers take whole blocks
    # from the BACK of the stream while the device works from the front.
    # Off in fast mode by default (the output would depend on scheduling).
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
            jobs[bi] = _Done(finish(bi, start, end, None, parent))

    # one worker per core for the finish tail PLUS one per assist loop (an
    # assist occupies its worker for a whole block); the native stages
    # release the GIL
    n_assist = min(n_assist, max(0, len(blocks) - 1))
    pool = host_par._pool(n_cores + n_assist)
    root = profiling.current()
    assist_futures = [pool.submit(assist_loop, root)
                      for _ in range(n_assist)]

    def drain(limit):
        while len(pending) > limit:
            bi, start, end, entries = pending.pop(0)
            fetched = collect_block(entries)
            jobs[bi] = pool.submit(finish, bi, start, end, fetched, root)

    while True:
        bi = claim_front()
        if bi < 0:
            break
        start, end = blocks[bi]
        pending.append((bi, start, end, dispatch_block(bi, start, end)))
        add("n_device_blocks", 1)
        drain(WINDOW)
    drain(0)

    with profiling.span("stream.join"):  # the assist's blocks, then order
        for f in assist_futures:
            f.result()
        for bi, (start, end) in enumerate(blocks):
            payload, stored = jobs[bi].result()
            out += fmt.build_block_header(len(payload), stored, legacy)
            out += payload


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
    """Segment-engine stream loop (the reference's
    ``_process_block_window`` over windows of WINDOW blocks): dispatch
    every segment group of the window to ``sortmatch.match_segments``
    (kernel 'sort') or ``match_finder.match_segments`` ('walk'), collect
    the results into host memory, then refine (parity mode), DP and emit
    each block in the worker pool."""
    varr = np.frombuffer(vdata, np.uint8)
    on_card = dev.type == "cuda"
    to_dev, to_host = _device_pair(on_card, dev)
    pool = host_par._pool(None)  # persistent: workers keep warm match tables
    count_lock = threading.Lock()  # finish() runs in the worker pool

    def add(key, v):
        with count_lock:
            counters[key] = counters.get(key, 0) + v

    def finish(start, end, lens, dists, conv, parent):
        bs = end - start
        with profiling.span("host.block", parent=parent, assist=0,
                            n_positions=bs):
            return finish_block(start, end, lens, dists, conv)

    def finish_block(start, end, lens, dists, conv):
        bs = end - start
        vstart, vend = start + d, end + d
        block_cut = _block_cut(start, legacy)
        if parity:
            mask = ~conv
            n_refine = int(mask.sum())
            with profiling.span("host.refine", n_refine_positions=n_refine,
                                wholesale=0, n_ranges=0) as sp:
                if n_refine:
                    lo = vstart if legacy else max(vstart - HALO, 0)
                    base_r = vstart - lo
                    cut = (base_r - fmt.BLOCK_END_NO_MATCH if block_cut
                           else -1)
                    ranges = host_par.search(varr[lo:vend], base_r, bs,
                                             base_r, cut, lens, dists,
                                             mask=mask)
                    sp.count(n_ranges=ranges)
                    add("n_searches", 1)
                    add("n_search_ranges", ranges)
        with profiling.span("host.dp"):
            native.estimate_costs(lens, dists)
        with profiling.span("host.emit"):
            payload = native.emit_block(data[start:end], lens, dists)
        if len(payload) < bs or legacy:
            return payload, False
        return data[start:end], True

    def dispatch(start, end):
        """Queue every segment group of one block on the device."""
        vstart, vend = start + d, end + d
        seg_starts = list(range(vstart, vend, SEG))
        groups = [seg_starts[g0: g0 + SEG_BATCH]
                  for g0 in range(0, len(seg_starts), SEG_BATCH)]
        with profiling.span("stream.dispatch", n_groups=len(groups)):
            return [dispatch_group(vstart, vend, _block_cut(start, legacy),
                                   group) for group in groups]

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
        add("n_dispatches", 1)
        add("n_h2d_bytes", sum(a.nbytes for a in arrays))
        add("n_d2h_bytes", sum(h.numel() * h.element_size() for h in host))
        return group, host, done

    def collect(start, end, entries):
        """Wait for one block's dispatches (calling thread) and assemble
        its position-order arrays."""
        with profiling.span("stream.collect"):
            return collect_block(start, end, entries)

    def collect_block(start, end, entries):
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
        # block-tail rule: the last 11 positions are literals
        tail = min(fmt.BLOCK_END_NO_MATCH - 1, bs)
        lens[bs - tail:] = 1
        dists[bs - tail:] = 0
        conv[bs - tail:] = True
        add("n_positions", bs)
        if parity:
            add("n_refine_positions", int(bs - conv.sum()))
        return lens, dists, conv

    root = profiling.current()
    for w0 in range(0, len(blocks), WINDOW):
        window = blocks[w0: w0 + WINDOW]
        queued = [dispatch(start, end) for start, end in window]
        jobs = [pool.submit(finish, start, end,
                            *collect(start, end, entries), root)
                for (start, end), entries in zip(window, queued)]
        with profiling.span("stream.join"):
            for job in jobs:  # frame order
                payload, stored = job.result()
                out += fmt.build_block_header(len(payload), stored, legacy)
                out += payload


class _Done:
    """A finished result with the future interface (assist blocks)."""

    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


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
    counters: dict = {}
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


def _resident_blocks(data: bytes, blocks, counters: dict, dev) -> bytes:
    """The frame of ``compress_device_resident``, block after block;
    ``counters`` receives n_h2d_bytes and n_d2h_bytes."""
    CH = cm.CHUNK
    n = len(data)
    arr = np.frombuffer(data, np.uint8)
    out = bytearray(fmt.build_frame_header(False))
    to_dev, _ = _device_pair(dev.type == "cuda", dev)

    def add(key, v):
        counters[key] = counters.get(key, 0) + v

    with profiling.span("resident.match"):  # the first block's halo
        halo = cm.empty_halo(chunk=CH, device=dev)  # carried block to block
    for start, end in blocks:
        bs = end - start
        n_chunks = -(-bs // CH)
        with profiling.span("resident.stage"):
            bufs = np.zeros((n_chunks, CH + cm.LOOK), np.uint8)
            cand = np.zeros(n_chunks, np.int32)
            lim = np.zeros(n_chunks, np.int32)
            for j in range(n_chunks):
                cs = start + j * CH
                take = max(0, min(CH + cm.LOOK, n - cs))
                bufs[j, :take] = arr[cs: cs + take]
                cand[j] = max(0, min(CH, bs - j * CH))
                lim[j] = bs - j * CH - fmt.BLOCK_END_LITERALS
            block_cut = _block_cut(start, False)
            if block_cut:
                cut_gram = cm.pack_cut_gram(
                    data[start - fmt.BLOCK_END_NO_MATCH:
                         start - fmt.BLOCK_END_NO_MATCH + 4])
                cut_pos = CH - fmt.BLOCK_END_NO_MATCH
            else:
                cut_gram, cut_pos = 0, -1
        add("n_h2d_bytes", bufs.nbytes + bs)
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
                # the DP's round cap: the block is redone on the host (exact
                # search, native DP and emit); the stream stays valid, only
                # this block's bytes differ from the device path's
                lo = max(start - HALO, 0)
                ctx = arr[lo:end]
                base = start - lo
                lens = np.ones(bs, np.int32)
                dists = np.zeros(bs, np.int32)
                native.match_block_ex(
                    ctx, base=base, bs=bs, level=9, lookback=base,
                    cut_pos=base - fmt.BLOCK_END_NO_MATCH if block_cut
                    else -1, lens=lens, dists=dists)
                native.estimate_costs(lens, dists)
                pay = native.emit_block(data[start:end], lens, dists)
                if len(pay) < bs:
                    out += fmt.build_block_header(len(pay), False, False)
                    out += pay
                else:
                    out += fmt.build_block_header(bs, True, False)
                    out += data[start:end]
            continue
        d2h = m + 8 if m < bs else 8
        add("n_d2h_bytes", d2h)
        with profiling.span("resident.fetch", n_d2h_bytes=d2h):
            if m < bs:
                pay = payload[:m].cpu().numpy().tobytes()
                out += fmt.build_block_header(m, False, False)
                out += pay
            else:  # stored block
                out += fmt.build_block_header(bs, True, False)
                out += data[start:end]
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
