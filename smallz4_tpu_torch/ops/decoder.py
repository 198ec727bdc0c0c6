"""The device decode: block expansion on a torch device.

Port of ``smallz4_tpu/ops/decoder.py``.  The sequence parse of a block is a
serial byte walk and runs on the host (``native.parse_sequences``); the
expansion of its sequence table into output bytes runs on the device.
Every output position resolves its source by pointer chasing: a literal
ends in the payload, a match byte points ``offset`` back (a self-overlapping
match straight at the first ``offset`` bytes of its source), and a chain
that leaves the block ends in the 64 Ki history window (the previous blocks
or a dictionary).  The source pool is ``cat(history, payload)``; a resolved
pointer is ``-(pool_index + 1)``.

``expand_block`` takes a batch of rows ``[B, ...]``: a CPU tensor takes
``expand_block_plain`` (the reference's arithmetic: ``searchsorted``, the
overlap contraction, synchronous pointer doubling until no pointer is live,
one gather), a CUDA tensor ``csrc/expand.cu`` (one launch, no host sync;
see its head): a block of the kernel takes a tile of 8,192 positions in
ticket order, looks its sequences up once (two warp searches of the ends,
the tables staged in shared memory, a max-scan), resolves the chains inside
the tile by pointer doubling in shared memory, publishes its pointers,
chases the rest through earlier tiles with all of a thread's chases in
flight together, and stores its bytes as 16-byte words; a tile inside one
literal run copies the payload.  The wrapper computes the rows' ``ends``
(the reference's cumsum) before the launch.  ``decompress_batch`` decodes
many frames, one expansion a round across the frames, the history of each
chained on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import format as fmt
from .. import native
from . import _cuda

HIST_CAP = 65536


def _bucket(n: int, lo: int) -> int:
    c = lo
    while c < n:
        c *= 2
    return c


def _check_tables(payload, hist, tables, out_cap: int) -> None:
    B = payload.shape[0]
    if payload.dtype != torch.uint8 or payload.dim() != 2 or \
            payload.shape[1] < 1:
        raise ValueError(f"payload must be uint8 [B, pc], pc >= 1, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if hist.dtype != torch.uint8 or tuple(hist.shape) != (B, HIST_CAP):
        raise ValueError(f"hist must be uint8 [{B}, {HIST_CAP}], got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    sc = tables[0].shape[-1]
    for t in tables:
        if t.dtype != torch.int32 or tuple(t.shape) != (B, sc) or sc < 1:
            raise ValueError(f"sequence tables must be int32 [{B}, sc], "
                             f"sc >= 1, got {t.dtype} {tuple(t.shape)}")
    if out_cap < 1:
        raise ValueError(f"out_cap must be >= 1, got {out_cap}")


def expand_block_plain(payload, hist, lit_len, match_len, match_off, lit_src,
                       out_cap: int) -> torch.Tensor:
    """Plain PyTorch version of ``expand_block`` (any device)."""
    _check_tables(payload, hist, (lit_len, match_len, match_off, lit_src),
                  out_cap)
    B, sc = lit_len.shape
    spans = lit_len + match_len
    ends = torch.cumsum(spans, 1, dtype=torch.int32)
    seq_start = ends - spans                       # output offset of each
    match_start = seq_start + lit_len
    pos = torch.arange(out_cap, dtype=torch.int32,
                       device=payload.device).expand(B, out_cap).contiguous()
    # the sequence of each output position
    sid = torch.searchsorted(ends, pos, right=True).clamp_(0, sc - 1)

    def at(t):
        return t.gather(1, sid)

    ms = at(match_start)
    is_lit = pos < ms
    lit_pool = HIST_CAP + at(lit_src) + (pos - at(seq_start))
    # overlap contraction: byte k of a self-overlapping match repeats the
    # first `off` source bytes; off == 0 (a literals-only sequence, which
    # padding lanes past the output can clip onto) ends at pool index 0
    k = pos - ms
    off = at(match_off)
    raw = ms - off + torch.remainder(k, off.clamp(min=1))
    hist_pool = HIST_CAP + raw                     # raw < 0: the history
    ptr = torch.where(
        is_lit, -(lit_pool + 1),
        torch.where((raw >= 0) & (off > 0), raw,
                    torch.where(off > 0, -(hist_pool + 1), -1)))
    while bool((ptr >= 0).any()):
        hop = ptr.gather(1, ptr.clamp(0, out_cap - 1).long())
        ptr = torch.where(ptr >= 0, hop, ptr)
    pool = torch.cat([hist, payload], 1)
    src = (-ptr - 1).clamp_(0, pool.shape[1] - 1)
    return pool.gather(1, src.long())


def expand_block(payload, hist, lit_len, match_len, match_off, lit_src,
                 out_cap: int) -> torch.Tensor:
    """Expand each row's sequence table into ``out_cap`` output bytes.

    payload uint8 [B, pc]; hist uint8 [B, HIST_CAP], its valid bytes
    right-aligned; lit_len, match_len, match_off, lit_src int32 [B, sc],
    padded with zeros (match_off with ones).  Returns uint8 [B, out_cap];
    the caller keeps each row's true length (the sum of its lit_len and
    match_len).  Positions past it hold what the reference's clipping
    gives them.  Offsets are those of an LZ4 table (at most 65,535)."""
    tables = (lit_len, match_len, match_off, lit_src)
    _check_tables(payload, hist, tables, out_cap)
    if not _cuda.on_cuda(payload):
        return expand_block_plain(payload, hist, *tables, out_cap)
    _cuda.check_inputs(payload, hist, *tables)
    B, sc = lit_len.shape
    dev = payload.device
    spans = lit_len + match_len
    if B == 1:
        ends = torch.cumsum(spans, 1, dtype=torch.int32)
    else:  # a scan a row is slow for a few long rows: one scan over the
        # batch, less what precedes each row
        flat = torch.cumsum(spans.view(-1), 0, dtype=torch.int64).view(B, sc)
        ends = (flat - (flat[:, :1] - spans[:, :1])).to(torch.int32)
    out = torch.empty(B, out_cap, dtype=torch.uint8, device=dev)
    ptrs = torch.empty(B, out_cap, dtype=torch.int32, device=dev)
    tile = _cuda.lib().s4_expand_tile()
    state, epoch = _cuda.tile_state("expand", dev, B * -(-out_cap // tile))
    _cuda.launch("expand", "s4_expand", dev, payload.data_ptr(),
                 hist.data_ptr(), ends.data_ptr(),
                 *(t.data_ptr() for t in tables), out.data_ptr(),
                 ptrs.data_ptr(), state.data_ptr(), B, payload.shape[1], sc,
                 out_cap, epoch)
    return out


def _update_hist(hist: torch.Tensor, out: torch.Tensor,
                 out_len) -> torch.Tensor:
    """The right-aligned 64 Ki history window advanced by ``out_len``
    bytes of ``out``: hist [HIST_CAP] and out [oc] with an int, or
    hist [B, HIST_CAP] and out [B, oc] with an int or int tensor [B]."""
    cat = torch.cat([hist, out], -1)
    oc = out.shape[-1]
    if isinstance(out_len, int):
        start = min(max(out_len, 0), oc)  # the reference's clamped slice
        return cat[..., start:start + HIST_CAP].contiguous()
    idx = (out_len.to(device=cat.device, dtype=torch.int64).clamp(0, oc)
           [:, None] + torch.arange(HIST_CAP, device=cat.device))
    return cat.gather(1, idx)


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """numpy -> ``dev``, through pinned memory on a CUDA device."""
    t = torch.from_numpy(a)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _pad_tables(rows, sc: int) -> np.ndarray:
    """int32 [4, B, sc] of the rows' (lit_len, match_len, match_off,
    lit_src), padded as the reference pads them: zeros, match_off ones."""
    tabs = np.zeros((4, len(rows), sc), np.int32)
    tabs[2] = 1
    for i, row in enumerate(rows):
        for t, a in zip(tabs, row):
            t[i, :len(a)] = a
    return tabs


class Fetch:
    """Device results brought to the host in order: each is copied with a
    non-blocking copy into pinned memory as soon as it is enqueued, and
    read once its event has passed."""

    def __init__(self):
        self.pending = []  # (host tensor or bytes, event or None, length)

    def put(self, item, length: int) -> None:
        if isinstance(item, torch.Tensor) and item.device.type == "cuda":
            host = torch.empty(item.shape, dtype=item.dtype, pin_memory=True)
            ev = torch.cuda.Event()
            # the copy runs on item's device's current stream: record there
            with torch.cuda.device(item.device):
                host.copy_(item, non_blocking=True)
                ev.record()
            item = host
        else:
            ev = None
        self.pending.append((item, ev, length))

    def drain(self, keep: int):
        """Yield all but the newest ``keep`` results, oldest first: bytes
        as put, a tensor as a numpy view of its first ``length`` bytes
        (of each row)."""
        while len(self.pending) > keep:
            item, ev, length = self.pending.pop(0)
            if ev is not None:
                ev.synchronize()
            yield (item if isinstance(item, bytes)
                   else item.numpy()[..., :length])


class BlockDecoder:
    """Pads host sequence tables to static shapes and drives expand_block
    (port of smallz4_tpu/ops/decoder.py TpuBlockDecoder).

    Shapes round up to the reference's power-of-two buckets: payload,
    sequence and output capacities, so a block's padding lanes hold what
    the reference's hold."""

    def __init__(self, out_cap: int, device="cuda"):
        self.out_cap = out_cap
        self.device = torch.device(device)

    def upload(self, payload: bytes, tables):
        """One block's expansion inputs on the device, padded to their
        buckets: (payload [1, pc], tables [4, 1, sc], out_cap, out_len)."""
        out_len = int(tables[0].sum() + tables[1].sum())
        if out_len > self.out_cap:
            raise ValueError("block exceeds declared maximum size")
        oc = min(_bucket(out_len, 4096), _bucket(self.out_cap, 4096))
        pay = np.zeros((1, _bucket(len(payload), 1024)), np.uint8)
        pay[0, :len(payload)] = np.frombuffer(payload, np.uint8)
        tabs = _upload(_pad_tables([tables], _bucket(len(tables[0]), 256)),
                       self.device)
        return _upload(pay, self.device), tabs, oc, out_len

    def decode_dev(self, payload: bytes, hist_dev: torch.Tensor,
                   tables=None):
        """Dispatch one block expansion; history and output stay on the
        device.  ``tables``: the payload's parsed sequence table, parsed
        here if None.  Returns (out_dev [out bucket], out_len)."""
        if tables is None:
            tables = native.parse_sequences(payload)
        pay, tabs, oc, out_len = self.upload(payload, tables)
        res = expand_block(pay, hist_dev[None], *tabs, out_cap=oc)
        return res[0], out_len

    def hist_device(self, hist: bytes) -> torch.Tensor:
        h = np.zeros(HIST_CAP, np.uint8)
        hl = min(len(hist), HIST_CAP)
        if hl:
            h[HIST_CAP - hl:] = np.frombuffer(hist[-hl:], np.uint8)
        return _upload(h, self.device)

    def decode(self, payload: bytes, hist: bytes) -> bytes:
        res, out_len = self.decode_dev(payload, self.hist_device(hist))
        return res[:out_len].cpu().numpy().tobytes()


def frame_blocks(data):
    """Walk a frame (after its leading skippable frames): yield
    (payload, tables, out_len) of each block, ``tables`` the parsed
    sequence table of a compressed block and None for a stored one.  Block
    checksums are skipped; a legacy frame ends at its data's end or after
    a short compressed block."""
    data = fmt.skip_skippable(bytes(data))
    info = fmt.parse_frame_header(data)
    block_cap = (fmt.MAX_BLOCK_SIZE_LEGACY if info.legacy
                 else fmt.MAX_BLOCK_SIZE)
    pos = info.header_size
    while True:
        if pos + 4 > len(data):
            if info.legacy:
                return
            raise fmt.FormatError("out of data")
        size, is_comp = fmt.parse_block_header(data[pos:pos + 4], info.legacy)
        pos += 4
        if size == 0:
            return
        if pos + size > len(data):
            raise fmt.FormatError("out of data")
        payload = data[pos:pos + size]
        pos += size
        if is_comp:
            tables = native.parse_sequences(payload)
            out_len = int(tables[0].sum() + tables[1].sum())
            if out_len > block_cap:
                # a corrupt frame must not size the device buffers
                raise fmt.FormatError("block exceeds declared maximum size")
        else:
            tables, out_len = None, size
        yield payload, tables, out_len
        if info.has_block_checksum:
            pos += 4
        if info.legacy and is_comp and out_len < fmt.MAX_BLOCK_SIZE_LEGACY:
            return


def decompress_batch(frames, dictionary: bytes | None = None,
                     device="cuda") -> list:
    """Decode many independent LZ4 frames with batched device expansion.

    Round r expands block r of every frame in one ``expand_block`` call,
    with each frame's 64 KB history chained on the device between rounds;
    the host parses every frame up front.  A stored block rides the same
    call as one literal run.  Returns the decoded bytes of each frame, in
    order.  ``device``: a CUDA device (the default; raises without CUDA)
    or 'cpu' (the plain version)."""
    from .pipeline import resolve_device

    dev = resolve_device(device)
    B = len(frames)
    if B == 0:
        return []
    per_frame = []  # per frame: [(payload, tables, out_len), ...]
    for data in frames:
        blocks = []
        for payload, tables, out_len in frame_blocks(data):
            if tables is None:  # stored block = one literal-run sequence
                tables = (np.asarray([out_len], np.int32),
                          *(np.zeros(1, np.int32) for _ in range(3)))
            blocks.append((payload, tables, out_len))
        per_frame.append(blocks)

    dec = BlockDecoder(HIST_CAP, dev)
    hist = dec.hist_device(bytes(dictionary)[-HIST_CAP:] if dictionary
                           else b"")[None].expand(B, HIST_CAP).contiguous()
    empty = (b"", (np.zeros(0, np.int32),) * 4, 0)
    fetch = Fetch()
    outs = [[] for _ in range(B)]
    rounds = range(max(len(b) for b in per_frame))
    landing = iter(rounds)

    def take(arrs):  # keep only each frame's real bytes of landed rounds
        for arr in arrs:
            r = next(landing)
            for i, pf in enumerate(per_frame):
                if r < len(pf) and pf[r][2]:
                    outs[i].append(arr[i, :pf[r][2]].tobytes())

    for r in rounds:
        rows = [pf[r] if r < len(pf) else empty for pf in per_frame]
        oc = _bucket(max(max(o for _, _, o in rows), 1), 4096)
        pc = _bucket(max(max(len(p) for p, _, _ in rows), 1), 1024)
        sc = _bucket(max(max(len(t[0]) for _, t, _ in rows), 1), 256)
        pay = np.zeros((B, pc), np.uint8)
        for i, (p, _t, _o) in enumerate(rows):
            pay[i, :len(p)] = np.frombuffer(p, np.uint8)
        tabs = _upload(_pad_tables([t for _, t, _ in rows], sc), dev)
        out = expand_block(_upload(pay, dev), hist, *tabs, out_cap=oc)
        lens = np.asarray([o for _, _, o in rows], np.int64)
        hist = _update_hist(hist, out, _upload(lens, dev))
        fetch.put(out, oc)
        take(fetch.drain(2))  # 2 rounds' padded copies in flight, no more
    take(fetch.drain(0))
    return [b"".join(o) for o in outs]
