"""Chunk-merge match search: plain PyTorch and the CUDA kernels.

Port of ``smallz4_tpu/ops/chunkmatch.py``, the level-9 device search.
Each 64 Ki-position chunk is sorted once into 20-byte suffix order
(``sort_chunk``), merged with its predecessor's sorted records, probed at
static suffix-order offsets (``probe``), compacted back to position order
(``compact``), extended and certified by batched tensor passes, and
head/delta-packed for the host (``pack_results``).  The docstring of the
reference module derives the certificates; this module computes the same
arrays, bit for bit.

Record planes are one int32 tensor ``[6, n]`` or, batched over chunks,
``[B, 6, n]``: five big-endian words of bytes pos+0..19 (sort keys,
compared unsigned), then ``combo = invalid(bit 31) | pos`` (the last key).

Every kernel wrapper takes its plain PyTorch version (``*_plain``) for CPU
tensors and its CUDA kernel (``csrc/``) for CUDA tensors.  The batched
``match_chunks`` runs a group of chunks with one launch per kernel: the
reference's scan carries only the previous chunk's sorted records, so all
chunks sort first and chunk i's halo is chunk i-1's sorted output.
"""
from __future__ import annotations

import os as _os

import numpy as np
import torch

from .. import format as fmt

from . import _cuda, sortnet
from .sortmatch import chain

CHUNK = 1 << 16          # positions per chunk
POS_BITS = 17
POS_MASK = (1 << POS_BITS) - 1
INVALID_BIT = sortnet.SIGN  # bit 31 of combo

#: byte-verification words per record (the reference's switch).  Only the
#: default 5 is ported; 7 raises NotImplementedError where records are made.
VERIFY_WORDS = int(_os.environ.get("SMALLZ4_TPU_VERIFY_WORDS", "5"))
if VERIFY_WORDS not in (5, 7):
    raise ValueError(f"SMALLZ4_TPU_VERIFY_WORDS must be 5 or 7, "
                     f"got {VERIFY_WORDS}")
LOOK = 4 * VERIFY_WORDS  # lookahead bytes per chunk buffer

NEAR_PROBES = tuple(range(1, 9))
EDGE = NEAR_PROBES[-1]   # contiguous-window edge (the certificate anchor)
MAX_FAR_PROBE = 1024     # bounds the probe kernel's shared-memory halo
MAX_PROBES = 32          # probe kernel's offset table


def _far_probes(text: str | None) -> tuple[int, ...]:
    """The far probe offsets of ``$SMALLZ4_TPU_FAR_PROBES``: any comma list
    of positive integers, as the reference takes it (0 or a negative
    offset crashes the reference); unset or empty, the default set."""
    if not text:
        return (12, 16, 24, 32, 48, 64, 96, 128, 160)
    try:
        far = tuple(int(x) for x in text.split(","))
    except ValueError:
        far = ()
    if not far or min(far) < 1:
        raise ValueError(f"SMALLZ4_TPU_FAR_PROBES must be a comma list of "
                         f"positive integers: {text!r}")
    return far


def _check_kernel_probes(probes: tuple[int, ...]) -> None:
    """Refuse a probe set beyond the design of csrc/probe.cu: near probes
    1..EDGE, then increasing far offsets up to MAX_FAR_PROBE (its
    shared-memory halo), at most MAX_PROBES in all (its offset table)."""
    far = probes[len(NEAR_PROBES):]
    if any(b <= a for a, b in zip((EDGE,) + far, far)):
        limit = f"far offsets must increase from above {EDGE}"
    elif far and far[-1] > MAX_FAR_PROBE:
        limit = f"far offsets must be at most {MAX_FAR_PROBE}"
    elif len(probes) > MAX_PROBES:
        limit = f"at most {MAX_PROBES} probes in all"
    else:
        return
    raise ValueError(f"the CUDA probe does not take the far probe set "
                     f"{','.join(map(str, far))}: {limit} (the plain "
                     f"version on the CPU takes it)")


FAR_PROBES = _far_probes(_os.environ.get("SMALLZ4_TPU_FAR_PROBES"))
PROBES = NEAR_PROBES + FAR_PROBES
KEY_REACH = 20           # bytes covered by the lexicographic sort key
EXT_REACH = 4 * VERIFY_WORDS  # byte-verified LCP reach
CHAIN_STEPS = 16         # doubling covers runs/matches to 64 Ki
HEAD_CAP = 1 << 15       # fetched head slots per chunk (overflow: host redo)
GROUP = 64               # chunks per match_chunks call (4 MiB at CHUNK)


def _require_supported() -> None:
    if VERIFY_WORDS != 5:
        raise NotImplementedError(
            "SMALLZ4_TPU_VERIFY_WORDS=7 is not ported yet (ROADMAP.md, "
            "queue 1: VERIFY_WORDS=7)")


def pack_cut_gram(b4: bytes) -> int:
    """Boundary-cut gram in the probe's key encoding (big-endian int32,
    matching make_records' first plane)."""
    v = int.from_bytes(b4, "big")
    return v - (1 << 32) if v >= 1 << 31 else v


def _per_row(v, B: int, device) -> torch.Tensor:
    """Scalar or [B] values -> int32 [B] tensor on ``device``."""
    t = torch.as_tensor(v, dtype=torch.int32, device=device)
    return t.expand(B).contiguous() if t.dim() == 0 else t.contiguous()


def _rows(x: torch.Tensor, dims: int):
    """Add a batch dimension if ``x`` has ``dims`` dims; returns
    (batched x, whether it was added)."""
    return (x.unsqueeze(0), True) if x.dim() == dims else (x, False)


def make_records(buf: torch.Tensor, valid_lo, valid_hi,
                 chunk: int = CHUNK) -> torch.Tensor:
    """Record planes for one chunk (``buf`` uint8 [chunk + LOOK]) or a batch
    (``[B, chunk + LOOK]``).  Positions with local index outside
    [valid_lo, valid_hi) are marked non-candidates (combo bit 31).  Words
    are big-endian so unsigned word order is byte order."""
    _require_supported()
    x, added = _rows(buf, 1)
    if x.dtype != torch.uint8 or x.shape[-1] != chunk + LOOK:
        raise ValueError(f"buf must be uint8 [..., {chunk + LOOK}], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B = x.shape[0]
    c = x.to(torch.int64)
    g = (c[:, :-3] << 24) | (c[:, 1:-2] << 16) | (c[:, 2:-1] << 8) | c[:, 3:]
    g = torch.where(g >= 1 << 31, g - (1 << 32), g).to(torch.int32)
    words = [g[:, 4 * i: chunk + 4 * i] for i in range(5)]
    pos = torch.arange(chunk, dtype=torch.int32, device=x.device)
    lo = _per_row(valid_lo, B, x.device)[:, None]
    hi = _per_row(valid_hi, B, x.device)[:, None]
    valid = (pos >= lo) & (pos < hi)
    combo = torch.where(valid, pos, pos | INVALID_BIT)
    out = torch.stack(words + [combo], dim=1)
    return out[0] if added else out


def sort_chunk(buf: torch.Tensor, valid_lo, valid_hi, chunk: int = CHUNK,
               lean: bool = False) -> torch.Tensor:
    """Sort one chunk's (or a batch of chunks') records into 20-byte suffix
    order (bytes 0..19, invalid flag, pos).  ``lean`` picks a TPU network
    variant in the reference and is ignored."""
    del lean
    return sortnet.sort_records(make_records(buf, valid_lo, valid_hi, chunk),
                                n_keys=6, unique=True)


def empty_halo(chunk: int = CHUNK, lean: bool = False,
               device="cpu") -> torch.Tensor:
    """All-invalid sorted halo planes (stream or legacy block start)."""
    del lean
    zeros = torch.zeros(chunk + LOOK, dtype=torch.uint8, device=device)
    return sort_chunk(zeros, 0, 0, chunk=chunk)


def planes_from_reference(planes_np, device="cpu") -> torch.Tensor:
    """The reference's record planes (a tuple of uint32 or int32 numpy
    arrays, as ``sort_chunk`` / ``match_chunks`` return them) -> the port's
    int32 tensor ``[6, ...]`` moved to the front, bit for bit."""
    arrs = [np.ascontiguousarray(np.asarray(p)) for p in planes_np]
    for a in arrs:
        if a.dtype not in (np.uint32, np.int32):
            raise TypeError(f"record planes must be uint32 or int32: {a.dtype}")
    stacked = np.stack([a.view(np.int32) for a in arrs], axis=-2)
    return torch.from_numpy(stacked).to(device)


def planes_to_reference(planes: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Inverse of planes_from_reference: a tuple of uint32 numpy planes."""
    arr = planes.detach().to("cpu").contiguous().numpy().view(np.uint32)
    return tuple(np.ascontiguousarray(arr[..., i, :])
                 for i in range(arr.shape[-2]))


def _lcp_be(xors) -> torch.Tensor:
    """Byte LCP (0..4*len(xors)) from XORed big-endian word pairs."""
    def bc(x):  # leading equal bytes of one BE xor word
        return torch.where(((x >> 24) & 0xFF) != 0, 0,
               torch.where(((x >> 16) & 0xFF) != 0, 1,
               torch.where(((x >> 8) & 0xFF) != 0, 2,
               torch.where(x != 0, 3, 4)))).to(torch.int32)

    lcp = bc(xors[0])
    for i, x in enumerate(xors[1:], start=1):
        lcp = torch.where(lcp == 4 * i, 4 * i + bc(x), lcp)
    return lcp


def probe_plain(merged: torch.Tensor, cut_gram: torch.Tensor,
                cut_pos: torch.Tensor, match_limit: torch.Tensor,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``probe`` (any device): direct per-probe
    5-word LCPs over rolled planes; rolled-in slots are masked by range."""
    B, _, n = merged.shape
    slot = torch.arange(n, dtype=torch.int32, device=merged.device)
    vw = [merged[:, i] for i in range(5)]
    combo = merged[:, 5]
    cg, cp, ml = cut_gram[:, None], cut_pos[:, None], match_limit[:, None]
    raw = combo & POS_MASK
    local = raw - chunk
    cap = torch.where(local >= 0, torch.clamp_min(ml - local, 0), 1 << 30)
    best_len = torch.zeros_like(combo)
    best_dist = torch.zeros_like(combo)
    elcp_lo = torch.full_like(combo, -1)
    elcp_hi = torch.full_like(combo, -1)
    gap = torch.zeros_like(combo)
    for sk in PROBES:
        for sgn in (1, -1):
            k = sk * sgn
            in_range = (slot + k >= 0) & (slot + k < n)
            nb = [torch.roll(w, -k, dims=-1) for w in vw]
            nb_combo = torch.roll(combo, -k, dims=-1)
            lcp = _lcp_be([w ^ v for w, v in zip(vw, nb)])
            if sk == EDGE:
                e = torch.where(in_range, torch.clamp_max(lcp, KEY_REACH), -1)
                if sgn > 0:
                    elcp_hi = e
                else:
                    elcp_lo = e
            nb_raw = nb_combo & POS_MASK
            d = raw - nb_raw
            if sk == 1 and sgn == -1:
                gap = torch.where(in_range & (nb_combo >= 0) & (d >= 1)
                                  & (lcp >= KEY_REACH), d, 0)
            ok = (in_range & (nb_combo >= 0) & (d >= 1)
                  & (d <= fmt.MAX_DISTANCE)
                  & ~((nb[0] == cg) & (nb_raw < cp)))
            lcp_eff = torch.minimum(torch.where(ok, lcp, 0), cap)
            better = (lcp_eff > best_len) | (
                (lcp_eff == best_len) & (lcp_eff >= 1) & (d < best_dist))
            upd = better & ok
            best_len = torch.where(upd, lcp_eff, best_len)
            best_dist = torch.where(upd, d, best_dist)

    th = torch.clamp(best_len, fmt.MIN_MATCH, KEY_REACH)
    cert_fail = (elcp_lo >= th) | (elcp_hi >= th)
    th_len = torch.clamp(best_len + 1, fmt.MIN_MATCH, KEY_REACH)
    len_fail = ((elcp_lo >= th_len) | (elcp_hi >= th_len)
                | (best_len >= KEY_REACH))
    gap_hit = (best_dist == gap) & (gap >= 1)
    trunc = (best_len >= EXT_REACH) & (cap > EXT_REACH)
    flags = (trunc.int() | (cert_fail.int() << 1) | (len_fail.int() << 2)
             | (gap_hit.int() << 3))
    payload = (best_len << 16) | best_dist
    key = torch.where(local >= 0, (local << 4) | flags, 16 * chunk)
    return payload, key


def probe(merged: torch.Tensor, cut_gram: torch.Tensor, cut_pos: torch.Tensor,
          match_limit: torch.Tensor,
          chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour probes over merged records ``[B, 6, 2*chunk]``, sorted by
    their five key words as ``merge_sorted`` leaves them, with per-row int32
    scalars ``[B]``.  Returns (payload = len<<16 | dist,
    key = local<<4 | flags, halo records 16*chunk), each ``[B, 2*chunk]``.
    The CUDA kernel composes each probe's LCP from the adjacent LCPs, which
    equals the direct compare of ``probe_plain`` only on key-sorted
    records."""
    _require_supported()
    B, P, n = merged.shape
    if P != 6 or n != 2 * chunk or merged.dtype != torch.int32:
        raise ValueError(f"merged planes must be int32 [B, 6, {2 * chunk}], "
                         f"got {merged.dtype} {tuple(merged.shape)}")
    if not _cuda.on_cuda(merged):
        return probe_plain(merged, cut_gram, cut_pos, match_limit, chunk)
    _check_kernel_probes(PROBES)
    _cuda.check_inputs(merged, cut_gram, cut_pos, match_limit)
    payload = torch.empty(B, n, dtype=torch.int32, device=merged.device)
    key = torch.empty_like(payload)
    offsets = np.asarray(PROBES, np.int32)
    _cuda.launch("probe", "s4_probe", merged.device, merged.data_ptr(),
                 payload.data_ptr(), key.data_ptr(), cut_gram.data_ptr(),
                 cut_pos.data_ptr(), match_limit.data_ptr(), B, n, chunk,
                 offsets.ctypes.data, len(offsets))
    return payload, key


def compact_plain(key: torch.Tensor, payload: torch.Tensor,
                  chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``compact`` (any device): the reference's
    stable compaction of key < 16*chunk, then the sort by key."""
    B = key.shape[0]
    keep = key < 16 * chunk
    if int(keep.sum()) != B * chunk:
        raise ValueError("each row must hold exactly `chunk` current records")
    c_key = key[keep].view(B, chunk)
    c_pay = payload[keep].view(B, chunk)
    order = torch.sort(c_key, dim=1, stable=True).indices
    return c_key.gather(1, order), c_pay.gather(1, order)


def _check_kernel_rows(name: str, B: int, chunk: int, low: int) -> None:
    """Refuse a batch beyond the CUDA kernel's design, whose limits
    ``csrc/<name>.cu`` exports (the plain versions on the CPU take it)."""
    lib = _cuda.lib()
    chunk_max = getattr(lib, f"s4_{name}_max_chunk")()
    rows_max = getattr(lib, f"s4_{name}_max_rows")()
    if not low <= chunk <= chunk_max:
        limit = f"chunk from {low} to {chunk_max}"
    elif B > rows_max:
        limit = f"at most {rows_max} rows"
    else:
        return
    raise ValueError(f"the CUDA {name} does not take [{B}, {chunk}]: {limit}"
                     f" (the plain version on the CPU takes it)")


def compact(key: torch.Tensor, payload: torch.Tensor,
            chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Current-chunk probe results in position order: (key, payload), each
    ``[B, chunk]``, from the probe's ``[B, 2*chunk]`` outputs."""
    if not _cuda.on_cuda(key):
        return compact_plain(key, payload, chunk)
    B, n = key.shape
    if (n != 2 * chunk or payload.shape != key.shape
            or key.dtype != torch.int32 or payload.dtype != torch.int32):
        raise ValueError(f"the CUDA compact takes int32 key and payload of "
                         f"shape [B, 2*chunk], got {key.dtype} "
                         f"{tuple(key.shape)}, {payload.dtype} "
                         f"{tuple(payload.shape)}, chunk {chunk}")
    _check_kernel_rows("compact", B, chunk, 1)
    _cuda.check_inputs(key, payload)
    okey = torch.empty(B, chunk, dtype=torch.int32, device=key.device)
    opay = torch.empty_like(okey)
    _cuda.launch("compact", "s4_compact", key.device, key.data_ptr(),
                 payload.data_ptr(), okey.data_ptr(), opay.data_ptr(), B, n,
                 chunk)
    return okey, opay


def _shift_up(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """out[..., i] = x[..., i + s], filled past the end."""
    n = x.shape[-1]
    if s >= n:
        return torch.full_like(x, fill)
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)


def _claims(s_key, s_pay, cut_pos, valid_lo, valid_hi, match_limit,
            chunk: int):
    """The reference's tensor passes after the unsort (chunkmatch.py
    probe_pair: same-distance doubling, induction, LK anchors and adoption,
    the nearest-sharer rule, 65535 saturation), batched over rows."""
    flags0 = s_key & 15
    lens0 = (s_pay >> 16) & 0xFFFF
    dists0 = s_pay & 0xFFFF

    # same-distance doubling: the reference's tensor loop computes what
    # sortmatch.chain does (its zero fill past the row fails
    # nb_dist == dists0 >= 1 as p + s < n does)
    lens1 = chain(lens0, dists0, CHAIN_STEPS)

    pos = torch.arange(chunk, dtype=torch.int32, device=s_key.device)
    valid = (pos >= valid_lo[:, None]) & (pos < valid_hi[:, None])
    cap = torch.clamp_min(match_limit[:, None] - pos, 0)
    lens2 = torch.minimum(lens1, cap)
    match = valid & (lens2 >= fmt.MIN_MATCH)
    lens = torch.where(match, lens2, 1)
    dists = torch.where(match, dists0, 0)

    truncated = (flags0 & 1) != 0
    cert_fail = (flags0 & 2) != 0
    len_fail = (flags0 & 4) != 0
    gap_hit = (flags0 & 8) != 0
    no_cut = (cut_pos < 0)[:, None]
    conv = (~truncated & ~cert_fail) | ~valid
    conv = conv | (match & (lens2 >= cap) & (dists0 == 1))

    # backward induction certificate
    next_is_decay = _shift_up(lens2, 1, 0) == lens2 - 1
    chain_ok = (match & (lens2 >= fmt.MIN_MATCH + 1) & (lens2 < cap)
                & next_is_decay & (_shift_up(dists, 1, 0) == dists) & no_cut)
    c, ok = conv, chain_ok
    s = 1
    for _ in range(CHAIN_STEPS):
        c = c | (ok & _shift_up(c, s, False))
        ok = ok & _shift_up(ok, s, False)
        s *= 2
    conv = c

    # length-known certificate: anchors, then backward adoption
    msl_ok = lens2 < fmt.MAX_SAME_LETTER
    lenok = ~len_fail & ~truncated & (lens2 < cap) & match
    anchors = (conv | (lenok & msl_ok)
               | (match & (lens2 >= cap) & msl_ok & no_cut))
    adopt_ok = (match & (lens2 >= fmt.MIN_MATCH + 1) & (lens2 < cap)
                & msl_ok & next_is_decay & no_cut)
    lk, ok = anchors, adopt_ok
    s = 1
    for _ in range(CHAIN_STEPS):
        lk = lk | (ok & _shift_up(lk, s, False))
        ok = ok & _shift_up(ok, s, False)
        s *= 2

    # nearest-sharer distance rule
    conv = conv | (lk & match & (lens2 >= KEY_REACH) & gap_hit & no_cut)
    lk = lk | conv

    saturated = lens > 65535
    conv = conv & ~saturated
    lk = lk & ~saturated
    return torch.clamp_max(lens, 65535), dists, conv, lk


def _merged_input(halos: torch.Tensor, cur: torch.Tensor, chunk: int):
    """[B, 6, 2*chunk] merge input: row i = (halos[i], cur[i] with combo
    rebased by +chunk, so halo records sort first within a key group)."""
    B = cur.shape[0]
    x = torch.empty(B, 6, 2 * chunk, dtype=torch.int32, device=cur.device)
    x[:, :, :chunk] = halos
    x[:, :, chunk:] = cur
    x[:, 5, chunk:] += chunk
    return x


def _probe_rows(x, cut_gram, cut_pos, valid_lo, valid_hi, match_limit,
                chunk: int):
    B, dev = x.shape[0], x.device
    cg, cp, vlo, vhi, ml = (_per_row(v, B, dev) for v in (
        cut_gram, cut_pos, valid_lo, valid_hi, match_limit))
    merged = sortnet.merge_sorted(x, n_keys=6, unique=True)
    p_pay, p_key = probe(merged, cg, cp, ml, chunk)
    s_key, s_pay = compact(p_key, p_pay, chunk)
    return _claims(s_key, s_pay, cp, vlo, vhi, ml, chunk)


def probe_pair(halo: torch.Tensor, cur: torch.Tensor, cut_gram, cut_pos,
               valid_lo, valid_hi, match_limit, chunk: int = CHUNK,
               lean: bool = False):
    """Match search for every position of chunk i (``cur``, sorted) against
    the merged (chunk i-1 = ``halo``, chunk i) candidates.  Planes are
    ``[6, chunk]`` or batched ``[B, 6, chunk]``; scalars are ints or
    ``[B]``.  Returns (lens, dists) int32 and (conv, lk) bool, each
    ``[chunk]`` or ``[B, chunk]`` in position order."""
    del lean
    h, _ = _rows(halo, 2)
    c, added = _rows(cur, 2)
    out = _probe_rows(_merged_input(h, c, chunk), cut_gram,
                      cut_pos, valid_lo, valid_hi, match_limit, chunk)
    return tuple(o[0] for o in out) if added else out


def pack_results_plain(lens, dists, conv, lk, chunk: int):
    """Plain PyTorch version of ``pack_results`` (any device)."""
    B = lens.shape[0]
    prev_len = torch.roll(lens, 1, dims=-1)
    prev_dist = torch.roll(dists, 1, dims=-1)
    pred_len = torch.where(prev_len == 65535, 65535,
                           torch.where(prev_len >= 5, prev_len - 1, 1))
    pred_dist = torch.where(prev_len >= 5, prev_dist, 0)
    head = (lens != pred_len) | (dists != pred_dist)
    head[:, 0] = True

    weights = torch.tensor([1 << i for i in range(32)], dtype=torch.int64,
                           device=lens.device)

    def words(flag):
        w = (flag.view(B, chunk // 32, 32).to(torch.int64) * weights).sum(-1)
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)

    pay = ((torch.clamp_max(lens, 65535).to(torch.int64) << 16)
           | (dists & 0xFFFF).to(torch.int64))
    pay = torch.where(pay >= 1 << 31, pay - (1 << 32), pay).to(torch.int32)
    rank = torch.cumsum(head, dim=1) - 1
    dest = torch.where(head, rank, chunk)  # non-heads land in a spill column
    packed = torch.zeros(B, chunk + 1, dtype=torch.int32, device=lens.device)
    packed.scatter_(1, dest, torch.where(head, pay, 0))
    count = head.sum(dim=1).to(torch.int32)
    return words(head), packed[:, :chunk], count, words(conv), words(lk)


def pack_results(lens: torch.Tensor, dists: torch.Tensor, conv: torch.Tensor,
                 lk: torch.Tensor, chunk: int = CHUNK):
    """Pack position-order claims ``[B, chunk]`` (int32 lens/dists, bool
    conv/lk) into (head bitmask words [B, chunk/32], compacted head words
    [B, chunk] (zero past the count), head count [B], conv and lk bitmask
    words).  Host inverse: ``native.unpack_claims``."""
    B = lens.shape[0]
    if (any(t.shape != (B, chunk) for t in (lens, dists, conv, lk))
            or lens.dtype != torch.int32
            or dists.dtype != torch.int32 or conv.dtype != torch.bool
            or lk.dtype != torch.bool or chunk % 32):
        raise ValueError("pack_results takes int32 lens/dists and bool "
                         "conv/lk of shape [B, chunk], chunk % 32 == 0")
    if not _cuda.on_cuda(lens):
        return pack_results_plain(lens, dists, conv, lk, chunk)
    _check_kernel_rows("pack", B, chunk, 32)
    _cuda.check_inputs(lens, dists, conv, lk)
    lens, dists, conv, lk = map(_cuda.aligned, (lens, dists, conv, lk))
    dev = lens.device
    bits = torch.empty(B, chunk // 32, dtype=torch.int32, device=dev)
    cbits = torch.empty_like(bits)
    kbits = torch.empty_like(bits)
    packed = torch.empty(B, chunk, dtype=torch.int32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    _cuda.launch("pack", "s4_pack", dev, lens.data_ptr(), dists.data_ptr(),
                 conv.data_ptr(), lk.data_ptr(), bits.data_ptr(),
                 packed.data_ptr(), count.data_ptr(), cbits.data_ptr(),
                 kbits.data_ptr(), B, chunk)
    return bits, packed, count, cbits, kbits


def match_chunks_raw(halo: torch.Tensor, bufs: torch.Tensor, cand_hi,
                     valid_hi, match_limit, cut_gram, cut_pos,
                     n_chunks: int = GROUP, chunk: int = CHUNK):
    """``match_chunks`` without the head/delta pack: (next halo [6, chunk],
    (lens, dists int32, conv, lk bool)) stacked over chunks, each
    [n_chunks, chunk], kept on the device (lens saturate at 65535, dists
    are at most 65535: the reference's uint16 values).  The front half of
    the device-resident encode (match -> ops.parse -> ops.emit)."""
    if bufs.shape[0] != n_chunks:
        raise ValueError(f"bufs holds {bufs.shape[0]} chunks, not {n_chunks}")
    dev = bufs.device
    cut_gram = torch.as_tensor(cut_gram, dtype=torch.int32, device=dev)
    cut_pos = torch.as_tensor(cut_pos, dtype=torch.int32, device=dev)
    if cut_gram.dim() == 0:
        first = torch.arange(n_chunks, device=dev) == 0
        cut_gram = torch.where(first, cut_gram, 0).to(torch.int32)
        cut_pos = torch.where(first, cut_pos, -1).to(torch.int32)
    cur = sort_chunk(bufs, 0, cand_hi, chunk=chunk)
    # the scan carry: chunk i's halo is chunk i-1's sorted records
    halos = torch.cat([halo.unsqueeze(0), cur[:-1]])
    claims = _probe_rows(_merged_input(halos, cur, chunk), cut_gram, cut_pos,
                         0, valid_hi, match_limit, chunk)
    return cur[-1], claims


def match_chunks(halo: torch.Tensor, bufs: torch.Tensor, cand_hi, valid_hi,
                 match_limit, cut_gram, cut_pos, n_chunks: int = GROUP,
                 head_cap: int = HEAD_CAP, chunk: int = CHUNK,
                 lean: bool = False):
    """The device encode of ``n_chunks`` consecutive chunks (``bufs`` uint8
    [n_chunks, chunk + LOOK]) after the chunk whose sorted planes are
    ``halo`` ([6, chunk]).  Equals the reference's stepwise scan.  Scalar
    ``cut_gram``/``cut_pos`` apply to chunk 0 only; [n_chunks] tensors give
    every chunk its own cut.  Returns (next halo [6, chunk], (bits,
    packed[:, :head_cap], n_heads, conv_bits, lk_bits)) stacked over
    chunks."""
    del lean
    halo, claims = match_chunks_raw(halo, bufs, cand_hi, valid_hi,
                                    match_limit, cut_gram, cut_pos,
                                    n_chunks=n_chunks, chunk=chunk)
    bits, packed, count, cbits, kbits = pack_results(*claims, chunk)
    return halo, (bits, packed[:, :head_cap], count, cbits, kbits)


def unpack_bits_rows(bits, chunk):
    """Bitmask words [R, chunk//32] -> bool [R, chunk]."""
    words = np.ascontiguousarray(np.asarray(bits)).astype(np.uint32)
    R = words.shape[0]
    return np.unpackbits(words.view(np.uint8).reshape(R, -1), axis=1,
                         bitorder="little")[:, :chunk].astype(bool)


def unpack_rows(bits, packed, chunk: int = CHUNK):
    """Vectorized numpy inverse of pack_results over stacked rows.

    bits: int-like [R, chunk//32] head bitmask words; packed: [R, >=1]
    compacted head words.  Returns (lens, dists) as int32 [R, chunk].
    Decay-fill: from each head, len decreases by 1 and dist holds until the
    prediction floors at the literal (1, 0)."""
    head = unpack_bits_rows(bits, chunk)
    pos = np.arange(chunk, dtype=np.int32)
    seg = np.cumsum(head, axis=1, dtype=np.int32) - 1  # head rank per pos
    start = np.maximum.accumulate(np.where(head, pos, 0), axis=1)
    pk = np.asarray(packed)
    vals = np.take_along_axis(pk, np.minimum(seg, pk.shape[1] - 1), axis=1)
    base = (vals >> 16) & 0xFFFF
    fill = base - (pos - start)
    # saturated heads (65535) predict 65535 until the next head
    fill = np.where(base == 65535, 65535, fill)
    lens = np.where(fill >= fmt.MIN_MATCH, fill, 1).astype(np.int32)
    dists = np.where(lens >= fmt.MIN_MATCH, vals & 0xFFFF, 0).astype(np.int32)
    return lens, dists
