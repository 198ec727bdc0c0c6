#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (smallz4_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; needs one CUDA device, nvcc and g++, no
network and no arguments.  Phases:

  0. card: name and power limit (nvidia-smi); no CUDA -> exit 2;
  1. build: compile csrc/*.cu for sm_90a and the port's native runtime
     (timed);
  2. chunk-engine kernels: on one full group (64 chunks x 64 Ki positions)
     of the committed real-data fixture, each CUDA kernel against its plain
     PyTorch version on the card, exact equality, both timed with CUDA
     events, the kernel also by torch.profiler (its device time and device
     launches per call); the chain at [64, 65536] with 16 steps, whose plain
     version is the tensor loop it replaces; the sort's and the merge's
     achieved GB/s over the bytes their passes move, the probe's over the
     tiles and halos it stages, the compaction's over every key, the kept
     payloads and its outputs, the pack's over its read-once bytes; the
     chain, the compaction and the pack must be one device launch a call;
     plus the device time of one whole match_chunks group;
  2b. sort-engine kernels: on one full match_segments dispatch (8 segments
     of the fixture, a live boundary cut in row 0, one padding row), the
     record sort at [8, 5, 2^17] with two keys, the neighbour scan (with the
     unsort; two launches a call, its bound from the operations that
     scan_work counts on these records), the chain (14 steps) and the run
     lengths against their plain versions; plus the device time of one
     whole dispatch;
  2c. walk-engine kernels: on the same dispatch, the run lengths at
     [8, 133119], gram_hash and the walk (max_candidates=64, ext_cap=512)
     against their plain versions; the walk's achieved GB/s over its staged
     bytes and its reads outside them (counted by one more launch with the
     kernel's stats); plus the device time of one whole walk match_segments
     dispatch;
  2d. worst cases: the run lengths on rows that are one run and on runs
     that cross every tile edge, the chain on rows of distance 1 with long
     lengths, the compaction at [64, 65536] on rows whose current records
     all come before the halo's, all after them, or interleaved at random,
     the pack at [64, 65536] on rows where every position is a head, slot
     0 is the only head (conv and lk all ones) or the heads lie in the last
     eighth (conv and lk all zeros), at the production shapes, the scan
     on the rows of scan_rows at [8, 5, 2^17] (one gram, distinct grams,
     position order, every record invalid), exact and timed; a chain row
     longer than the one-launch path takes chain_wide, a scan row longer
     than the two-kernel route scan_direct; each of these kernels must be
     one device launch a call, the scan two;
  3. chunk engine end to end, with SMALLZ4_TPU_CPU_ASSIST=0 so every block
     goes through the device: compress(data, 9) on the 10 MB fixture
     (modern and legacy) and on make_corpus(8 MiB) must equal
     native.compress byte for byte and decode back; one parity=False stream
     must round-trip; launch counters must match the groups run;
  3b. sort engine end to end: the fixture at 1 MiB blocks (the fallback
     route) and at 4 MiB blocks with kernel="sort", equal to native and
     decoding back, one launch of each sort-engine kernel per dispatch; one
     parity=False sort-engine stream must round-trip;
  3c. walk engine end to end: the fixture at 4 MiB blocks with
     kernel="walk", equal to native and decoding back, one launch of
     gram_hash, walk and run_lengths per dispatch; one parity=False
     walk-engine stream must round-trip;
  3d. device decode: the block expansion (csrc/expand.cu) against its
     plain version, exact over all out_cap bytes, on real blocks (with and
     without history, a dictionary block), on its worst cases at 4 MiB (a
     chain 1M deep, one run, offsets into the history, literals only,
     sequence ends and offsets at tile edges) and on a batch of 8 rows
     with 2 padding rows, timed, one launch of the kernel a call on every
     case (torch.profiler); then decompress(engine="device") on every
     stream of phases 3-3c and a dictionary frame, and decompress_batch on
     16 mixed frames, each equal to its input, one expand launch a
     compressed block or batch round, with the decode rates beside
     native.decompress's; and the host side of one realcorpus device
     decode stage by stage (parse, padding and uploads, expansion, copy
     back; host clock);
  3e. device-resident encode (match_chunks_raw -> the policy-iteration DP
     of csrc/parse.cu -> the emit of csrc/emit.cu): compress_device_resident of
     the fixture at 1 MiB and 4 MiB blocks, with the launch counters set to
     0 just before each, must decode back and equal the stream built with
     the DP's plain version on the card; a block may take the host fallback
     only where the plain DP also hits the round cap; the rounds and ok of
     every block, the encode rate and d2h bytes per input byte beside the
     chunk engine's parity rate of phase 3; then the DP kernel against its
     plain version (choice, cost, converged, rounds: exact) on the claims
     of every 1 MiB block and of the first 4 MiB block as the encode gave
     them, and on its worst cases (parse_worst: a 65,535-long repeat, a
     distance-1 run past MAX_SAME_LETTER, 1 MiB of random bytes, claims
     where every position is an entry, claims landing on tile edges and
     on limit, N not a multiple of the tile, seeded claims across many
     tiles, a 1 MiB block cut after one round and the 4 MiB block after
     one and two), each converged choice equal to native.estimate_costs,
     one launch of the kernel a call (torch.profiler), timed on the 4 MiB
     block with its entries a tile and the bytes its design moves; the
     emit kernel against its plain version (all output bytes, n_out) and
     native.emit_block (the payload) on the DP's parse of that block, an
     all-literal 4 MiB block and a 4 MiB block of one byte value, two
     device launches a call (torch.profiler), timed beside the plain
     version and the bound; and the block step by stage.

Prints a {"kernels": [...]} JSON line (each kernel's launches on its main
path, error, kernel / plain / library time and bound; the chain once for
the chunk engine and once for the sort engine, the run lengths once for the
sort engine and once for the walk engine, scan_direct for phase 2d's long
scan rows, the expansion for the decode),
the nvidia-smi line,
and as the last line {"ok": true, "device": {...}}.  Any failure raises
(exit != 0) before that line.
"""
from __future__ import annotations

import hashlib
import json
import lzma
import os
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "benchdata" / "realcorpus.bin.xz"

KERNELS = [  # (counter, source, replaced TPU kernel, engine path)
    ("sort_records", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:164", "chunk"),
    ("merge_sorted", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:276", "chunk"),
    ("probe", "smallz4_tpu_torch/csrc/probe.cu",
     "smallz4_tpu/ops/chunkmatch.py:199", "chunk"),
    ("compact", "smallz4_tpu_torch/csrc/compact.cu",
     "smallz4_tpu/ops/chunkmatch.py:396", "chunk"),
    # the reference's chunk engine runs this doubling as XLA passes
    # (smallz4_tpu/ops/chunkmatch.py:686-695), the body of _chain_kernel
    ("chain", "smallz4_tpu_torch/csrc/sortmatch.cu",
     "smallz4_tpu/ops/sortmatch.py:159", "chunk"),
    ("pack", "smallz4_tpu_torch/csrc/pack.cu",
     "smallz4_tpu/ops/chunkmatch.py:428", "chunk"),
    ("scan", "smallz4_tpu_torch/csrc/sortmatch.cu",
     "smallz4_tpu/ops/sortmatch.py:102", "sort"),
    # the scan's one-launch route: small batches and rows past
    # s4_scan_row_max (phase 2d)
    ("scan_direct", "smallz4_tpu_torch/csrc/sortmatch.cu",
     "smallz4_tpu/ops/sortmatch.py:102", "long rows"),
    ("chain", "smallz4_tpu_torch/csrc/sortmatch.cu",
     "smallz4_tpu/ops/sortmatch.py:159", "sort"),
    ("run_lengths", "smallz4_tpu_torch/csrc/runlen.cu",
     "smallz4_tpu/ops/pallas_kernels.py:145", "sort"),
    ("run_lengths", "smallz4_tpu_torch/csrc/runlen.cu",
     "smallz4_tpu/ops/pallas_kernels.py:145", "walk"),
    ("gram_hash", "smallz4_tpu_torch/csrc/gramhash.cu",
     "smallz4_tpu/ops/pallas_kernels.py:49", "walk"),
    # XLA in the reference (its lockstep while loops), not Pallas
    ("walk", "smallz4_tpu_torch/csrc/walk.cu",
     "smallz4_tpu/ops/match_finder.py:75", "walk"),
    # XLA in the reference (its pointer-doubling while loop), not Pallas
    ("expand", "smallz4_tpu_torch/csrc/expand.cu",
     "smallz4_tpu/ops/decoder.py:28", "decode"),
    # the device-resident encode (match_chunks_raw -> parse -> emit); at
    # 4 MiB blocks its chunk groups have phase 2's shapes
    ("sort_records", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:164", "resident"),
    ("merge_sorted", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:276", "resident"),
    ("probe", "smallz4_tpu_torch/csrc/probe.cu",
     "smallz4_tpu/ops/chunkmatch.py:199", "resident"),
    ("compact", "smallz4_tpu_torch/csrc/compact.cu",
     "smallz4_tpu/ops/chunkmatch.py:396", "resident"),
    ("chain", "smallz4_tpu_torch/csrc/sortmatch.cu",
     "smallz4_tpu/ops/sortmatch.py:159", "resident"),
    # XLA in the reference (its policy-iteration while loop), not Pallas
    ("parse", "smallz4_tpu_torch/csrc/parse.cu",
     "smallz4_tpu/ops/parse.py:153", "resident"),
    # XLA in the reference (static rounds), not Pallas
    ("emit", "smallz4_tpu_torch/csrc/emit.cu",
     "smallz4_tpu/ops/emit.py:67", "resident"),
]
CHUNK_KERNELS = ("sort_records", "merge_sorted", "probe", "compact", "chain",
                 "pack")
SORT_KERNELS = ("sort_records", "scan", "chain", "run_lengths")
WALK_KERNELS = ("gram_hash", "walk", "run_lengths")
RESIDENT_KERNELS = ("sort_records", "merge_sorted", "probe", "compact",
                    "chain", "parse", "emit")
# integer operations of one walk round of an active lane (activity test,
# two clipped byte gathers, the distance-1 branch, the update, the hop) and
# of one extension word (two clipped word gathers, xor, test, add, clamp)
WALK_OPS_PER_HOP = 20
WALK_OPS_PER_WORD = 12

# H100 SXM peaks (NVIDIA's data sheet, at a 700 W power limit): HBM rate,
# and the 32-bit rate outside the tensor cores (67 TFLOP/s float32), taken
# as the ceiling of the kernels' 32-bit integer operations
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def real_corpus() -> bytes:
    from bench import REAL_FIXTURE_SHA256

    data = lzma.decompress(FIXTURE.read_bytes())
    digest = hashlib.sha256(data).hexdigest()
    if digest != REAL_FIXTURE_SHA256:
        raise RuntimeError(f"{FIXTURE} sha256 {digest} != pinned "
                           f"{REAL_FIXTURE_SHA256}")
    return data


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(torch, fn, reps: int, name: str = "",
              own: bool = False) -> tuple[float, float]:
    """(device time in ms, device launches of the kernels whose name holds
    ``name``, all by default) per call of fn(), from a torch.profiler trace
    of reps calls after one warm-up: the trace's raw kernel records (not
    copies, fills or the window's own annotation) launched inside the
    calls' time window, one per correlation id, their own intervals
    summed, without the host's enqueue; with ``own``, only the intervals of
    the kernels whose name holds ``name``.  A kernel belongs to the window
    when the host-side launch that shares its correlation id lies inside
    it, both ends on the host's clock (the card's timestamps, converted,
    stray by hundreds of microseconds from the host's).  A session can
    lose the records of its first call's kernels, so each session makes
    one more warm-up call before its window, and one call after it, so
    that no kernel of the window is the session's last.  A trace that lost
    the record of a launch in the window is taken again, up to six times,
    until one holds them all, else the fullest one counts."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    best: dict = {}
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            with record_function("timed calls"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            fn()  # the window's last kernel is not the session's last
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        on_card = [e.device_type() == torch.autograd.DeviceType.CUDA
                   for e in events]
        window = next(e for e, card in zip(events, on_card)
                      if not card and e.name() == "timed calls")
        launched = {e.correlation_id() for e, card in zip(events, on_card)
                    if not card and "Launch" in e.name()
                    and window.start_ns() <= e.start_ns() <= window.end_ns()}
        kernels = {e.correlation_id(): (e.end_ns() - e.start_ns(),
                                        name in e.name())
                   for e, card in zip(events, on_card)
                   if card and e.name() != "timed calls"
                   and not e.name().startswith(("Memcpy", "Memset"))
                   and e.correlation_id() in launched}
        if len(kernels) > len(best):
            best = kernels
        if best and len(best) == len(launched):
            break
    return (sum(ns for ns, hit in best.values() if hit or not own)
            / 1e6 / reps, sum(hit for _, hit in best.values()) / reps)


def max_err(torch, got, want) -> int:
    """Largest absolute difference of two integer results (tuples too)."""
    if isinstance(got, tuple):
        return max(max_err(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    return int((got.long() - want.long()).abs().max())


def nbytes(*tensors) -> int:
    """Bytes of tensors (tuples flattened), each counted once."""
    total = 0
    for t in tensors:
        total += (nbytes(*t) if isinstance(t, tuple)
                  else t.numel() * t.element_size())
    return total


def bound(moved_bytes: int, ops: float) -> tuple[float, str]:
    """(least time in ms, what bounds it): the bytes a kernel must move
    over the HBM rate against its operations over the peak rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(torch, cases, phase: str, shape_note: str,
                  kernel_name: str = "") -> dict:
    """cases: name -> (kernel fn, plain fn, input tensors, op count).
    Each kernel must equal its plain version exactly (integers:
    tolerance 0); both are timed with CUDA events, the kernel also by the
    profiler (device time per call, and the device launches a call of
    the kernels whose name holds ``kernel_name``, all by default)."""
    results = {}
    for name, (kern, plain, inputs, ops) in cases.items():
        got = kern()
        err = max_err(torch, got, plain())
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3)
        dev_ms, per_call = device_ms(torch, kern, 5, kernel_name)
        bound_ms, bound_by = bound(nbytes(*inputs) + nbytes(got), ops)
        log(f"[{phase}] {name:13s} max_abs_err {err} (tolerance 0: exact "
            f"integers)  kernel {ms:.4f} ms (device {dev_ms:.4f} ms, "
            f"{per_call:g} launches a call)  plain {plain_ms:.4f} ms  bound "
            f"{bound_ms * 1e3:.2f} us ({bound_by})  ({shape_note})")
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max err {err})")
        # no single PyTorch call computes these functions (the sort at the
        # sort-engine shape gets its library time in phase 2b)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None, "device_ms": dev_ms,
                         "device_launches_per_call": per_call}
    return results


def require_one_launch(results: dict, names, where: str) -> None:
    """The redesigned kernels run as one device launch a call."""
    for name in names:
        per_call = results[name]["device_launches_per_call"]
        log(f"[{where}] {name:13s} {per_call:g} device launch(es) a call "
            f"(torch.profiler)")
        if per_call != 1:
            raise AssertionError(f"{name}: {per_call} device launches a "
                                 f"call, not 1")


def log_sort_rate(_cuda, phase: str, name: str, res: dict, x,
                  merge: bool) -> None:
    """The design's bytes for a sort or merge of x ([B, P, n]): one read and
    one write of x for the tile sort and for each merge pass (the merge is
    one pass), over the kernel time."""
    n = x.shape[-1]
    passes = 1 if merge else 1 + (n // _cuda.lib().s4_sort_tile(n)
                                  ).bit_length() - 1
    moved = passes * 2 * nbytes(x)
    log(f"[{phase}] {name:13s} {passes} pass(es) x 2 x {nbytes(x) / 1e6:.2f}"
        f" MB = {moved / 1e6:.2f} MB moved: {moved / res['ms'] / 1e6:.2f} "
        f"GB/s achieved ({moved / res['ms'] * 1e3 / HBM_BYTES_PER_S:.2%} of"
        f" {HBM_BYTES_PER_S / 1e12:.2f} TB/s); read-once bound "
        f"{res['bound_ms'] * 1e3:.2f} us")


def log_floor_rate(phase: str, name: str, res: dict, moved: int,
                   what: str) -> None:
    """A kernel's achieved rate over the bytes its design moves (its own
    floor), by the profiler's device time and by CUDA events (which carry
    the host's enqueue of a short call), beside the read-once bound."""
    rate = {k: moved / res[k] / 1e6 for k in ("device_ms", "ms")}
    log(f"[{phase}] {name:13s} design bytes ({what}) {moved / 1e6:.2f} MB: "
        f"floor {moved / HBM_BYTES_PER_S * 1e6:.2f} us at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; achieved "
        f"{rate['device_ms']:.2f} GB/s by device time "
        f"({rate['device_ms'] * 1e9 / HBM_BYTES_PER_S:.2%}), "
        f"{rate['ms']:.2f} GB/s by events; read-once bound "
        f"{res['bound_ms'] * 1e3:.2f} us")


def probe_design_bytes(_cuda, merged, halo: int) -> int:
    """csrc/probe.cu's staged bytes: every block reads the six planes of its
    tile and a +-halo of records (clipped to the row) and writes two int32
    outputs a slot."""
    B, P, n = merged.shape
    tile = _cuda.lib().s4_probe_tile()
    recs = sum(min(t0 + tile + halo, n) - max(t0 - halo, 0)
               for t0 in range(0, n, tile))
    return B * recs * P * 4 + 2 * B * n * 4


def walk_stage_stats(torch, _cuda, wargs, want) -> tuple[int, int, int]:
    """One uncounted launch of s4_walk with its stats counters: (bytes the
    blocks staged, reads outside the staged window, output bytes).  Its
    outputs must equal ``want``."""
    ctx, g, prev, runs, sv, ev, base, search_len, maxc, ext_cap = wargs
    B, n = ctx.shape
    lens = torch.empty(B, search_len, dtype=torch.int32, device=ctx.device)
    dists = torch.empty_like(lens)
    conv = torch.empty(B, search_len, dtype=torch.bool, device=ctx.device)
    stats = torch.zeros(2, dtype=torch.int64, device=ctx.device)
    err = _cuda.lib().s4_walk(
        *(a.data_ptr() for a in (ctx, g, prev, runs, sv, ev, lens, dists,
                                 conv)),
        B, n, base, search_len, maxc, ext_cap, stats.data_ptr(),
        torch.cuda.current_stream(ctx.device).cuda_stream)
    torch.cuda.synchronize()
    if err != 0 or max_err(torch, (lens, dists, conv), want) != 0:
        raise AssertionError(f"s4_walk with stats: error {err} or outputs "
                             f"differ from the wrapper's")
    staged, far = (int(v) for v in stats.tolist())
    return staged, far, nbytes(lens, dists, conv)


def worst_cases(torch, np, _cuda, sm, pk, cm, dev, chunk_shape, sort_shape,
                walk_shape, scan_shape) -> dict:
    """Phase 2d: the run lengths on rows that are one run and on
    alternating runs of a tile's length, each across a tile edge, at the
    sort and walk shapes; the chain on rows of distance 1 and length 20
    (every claim grows to its row's end) at the chunk and sort shapes; the
    compaction and the pack on the rows of compact_rows and pack_rows at
    the chunk shape; the scan at ``scan_shape`` on the rows of scan_rows
    (one gram, distinct grams, position order, every record invalid; two
    launches a call, its probe and unsort kernels); a row longer than the
    one-launch chain path and one longer than the scan's two-kernel route
    (scan_direct).
    Exact, and timed; returns scan_direct's record for the kernels
    line."""
    tile = _cuda.lib().s4_run_lengths_tile()
    B, CH = chunk_shape
    cases = {}
    for seed, order in enumerate(COMPACT_ORDERS):
        k, p = (torch.from_numpy(a).to(dev)
                for a in compact_rows(np, B, CH, order, seed))
        cases[f"compact [{B}, {2 * CH}] {order}"] = (
            lambda k=k, p=p: cm.compact(k, p, CH),
            lambda k=k, p=p: cm.compact_plain(k, p, CH))
    for seed, case in enumerate(PACK_CASES):
        rows = [torch.from_numpy(a).to(dev)
                for a in pack_rows(np, B, CH, case, seed)]
        cases[f"pack [{B}, {CH}] {case}"] = (
            lambda rows=rows: cm.pack_results(*rows, chunk=CH),
            lambda rows=rows: cm.pack_results_plain(*rows, chunk=CH))
    for shape in (sort_shape, walk_shape):
        alt = (np.arange(shape[1]) + tile // 2) // tile % 2
        for kind, x in (("one run", np.full(shape, 7, np.uint8)),
                        ("runs across tile edges",
                         np.tile(alt.astype(np.uint8), (shape[0], 1)))):
            xd = torch.from_numpy(x).to(dev)
            cases[f"run_lengths {list(shape)} {kind}"] = (
                lambda xd=xd: pk.run_lengths(xd),
                lambda xd=xd: pk.run_lengths_plain(xd))
    for shape, steps in ((chunk_shape, 16), (sort_shape, 14)):
        lens = torch.full(shape, 20, dtype=torch.int32, device=dev)
        ones = torch.ones(shape, dtype=torch.int32, device=dev)
        cases[f"chain {list(shape)} steps {steps} dist 1, len 20"] = (
            lambda lens=lens, ones=ones, steps=steps: sm.chain(lens, ones,
                                                               steps),
            lambda lens=lens, ones=ones, steps=steps: sm.chain_plain(
                lens, ones, steps))
    # the scan: its probe and unsort kernels, two launches a call
    SB, _, SN = scan_shape
    for seed, case in enumerate(c for c in SCAN_CASES if c != "mixed"):
        rec = torch.from_numpy(scan_rows(np, case, SB, SN, seed)).to(dev)
        cases[f"scan [{SB}, 5, {SN}] {case}"] = (
            lambda rec=rec: sm.neighbor_scan(rec),
            lambda rec=rec: sm.neighbor_scan_plain(rec))
    for name, (kern, plain) in cases.items():
        err = max_err(torch, kern(), plain())
        ms = cuda_ms(torch, kern, 10)
        dev_ms, per_call = device_ms(torch, kern, 5)
        log(f"[2d] {name}: max_abs_err {err}  kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f} ms, {per_call:g} launches a call)")
        want = 2 if name.startswith("scan") else 1
        if err != 0 or per_call != want:
            raise AssertionError(f"{name}: error {err}, {per_call} launches")
    n = _cuda.lib().s4_chain_row_max() + 7
    rng = np.random.default_rng(6)
    lens, dists = (torch.from_numpy(rng.integers(0, 5, (2, n), dtype=np.int32)
                                    ).to(dev) for _ in range(2))
    before = dict(_cuda.LAUNCHES)
    err = max_err(torch, sm.chain(lens, dists, 14),
                  sm.chain_plain(lens, dists, 14))
    took = {k: _cuda.LAUNCHES[k] - before[k] for k in ("chain", "chain_wide")}
    log(f"[2d] chain [2, {n}] steps 14 (past the one-launch row of "
        f"{n - 7}): max_abs_err {err}, launches {took}")
    if err != 0 or took != {"chain": 0, "chain_wide": 1}:
        raise AssertionError(f"wide chain: error {err}, launches {took}")
    # a scan row past the two-kernel route: scan_direct, timed for its
    # record, its launches counted from 0 over one call
    n = _cuda.lib().s4_scan_row_max() + 7
    rec = torch.from_numpy(scan_rows(np, "mixed", 2, n, 7)).to(dev)
    direct = check_kernels(torch, {"scan_direct": (
        lambda: sm.neighbor_scan(rec), lambda: sm.neighbor_scan_plain(rec),
        (rec[:, 0], rec[:, 2:]), scan_work(torch, rec)["ops"])}, "2d",
        f"2 x {n} records, past the two-kernel route's {n - 7}"
    )["scan_direct"]
    _cuda.reset_counts()
    sm.neighbor_scan(rec)
    took = {k: _cuda.LAUNCHES[k] for k in ("scan", "scan_direct")}
    log(f"[2d] scan [2, 5, {n}]: launches {took}")
    if took != {"scan": 0, "scan_direct": 1}:
        raise AssertionError(f"long scan rows: launches {took}")
    direct["launches"] = took["scan_direct"]
    return direct


def sort_dispatch(torch, np, dev, real: bytes) -> types.SimpleNamespace:
    """Phase 2b's segment dispatch: 7 segments of ``real`` from 1 MiB (the
    block's boundary cut live in row 0) and one padding row, on ``dev``:
    its inputs (sbufs, sv, ev, scut, sfin), the searched positions, the
    unsorted records ``rec`` [8, 5, 2^17] and the sorted ``srec`` (two
    keys, as match_segments sorts them)."""
    from smallz4_tpu_torch.ops import pipeline, sortnet
    from smallz4_tpu_torch.ops import sortmatch as sm

    s_start, s_bs = 1 << 20, 7 * pipeline.SEG
    seg_group = list(range(s_start, s_start + s_bs, pipeline.SEG))
    arrays = pipeline.segment_group(np.frombuffer(real, np.uint8), s_start,
                                    s_start + s_bs, seg_group, False, True)
    sbufs, sv, ev, scut, sfin = (torch.from_numpy(a).to(dev) for a in arrays)
    rec, _ = sm.segment_records(sbufs, sv, ev, scut)
    return types.SimpleNamespace(
        sbufs=sbufs, sv=sv, ev=ev, scut=scut, sfin=sfin, rec=rec,
        srec=sortnet.sort_records(rec, n_keys=2),
        searched=sum(min(pipeline.SEG, s_start + s_bs - s0)
                     for s0 in seg_group))


SCAN_CASES = ("one gram", "distinct grams", "position order",
              "every record invalid", "mixed")
SCAN_INVALID = 1 << 30  # pos_t offset of a record that may not match


def scan_rows(np, case: str, B: int, n: int, seed: int):
    """Sorted records int32 [B, 5, n] (k1, k2, pos_t, e1, e2) for the
    neighbour scan, each row sorted by (k1, k2) unsigned then pos_t, as
    sort_records(n_keys=2) sorts them, its raw positions a permutation of
    [0, n).  "mixed": 12 grams in long groups, a fifth of the records
    invalid (+2^30), k2 with equal high halves in a third of the records,
    payload bytes of 3 values (LCPs of every length); "one gram": one gram
    across the row (every probe meets its gram), else as "mixed";
    "distinct grams": every gram distinct (no probe gets past its compare);
    "position order": grams pos >> 6, k2 0, all valid, so the slots are the
    positions (the stores of a scatter by position coalesce); "every record
    invalid": "mixed" with every record +2^30."""
    if case not in SCAN_CASES:
        raise ValueError(f"unknown case {case!r}")
    rng = np.random.default_rng(seed)
    out = np.empty((B, 5, n), np.int32)
    for b in range(B):
        raw = rng.permutation(n).astype(np.int64)
        k2 = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        k2[:n // 3] &= np.uint32(0xFFFF0000)
        k1 = (rng.integers(0, 12, n).astype(np.uint32)
              * np.uint32(0x01010101))
        invalid = rng.random(n) < 0.2
        if case == "one gram":
            k1[:] = 0x61616161
        elif case == "distinct grams":  # an odd factor is a bijection
            k1 = rng.permutation(n).astype(np.uint32) * np.uint32(0x9E3779B1)
        elif case == "position order":
            raw = np.arange(n, dtype=np.int64)
            k1 = (raw >> 6).astype(np.uint32)
            k2[:] = 0
            invalid[:] = False
        elif case == "every record invalid":
            invalid[:] = True
        pos_t = np.where(invalid, raw + SCAN_INVALID, raw).astype(np.int32)
        e = rng.integers(0, 3, (n, 8), dtype=np.uint8)
        planes = (k1, k2, pos_t, e[:, :4].copy().view("<u4").ravel(),
                  e[:, 4:].copy().view("<u4").ravel())
        order = np.lexsort((pos_t, k2, k1))
        out[b] = np.stack([p[order].view(np.int32) for p in planes])
    return out


# integer operations of the scan's work, counted from its data (scan_work):
# a probe that reads its neighbour's gram (load, compare and exit test), a
# probe that meets its gram (distance and its range test), a candidate
# (two xors, the byte count of the 64-bit xor, the score and its max)
SCAN_OPS_COMPARE = 3
SCAN_OPS_LIVE = 2
SCAN_OPS_CANDIDATE = 8


def scan_work(torch, srec) -> dict:
    """The neighbour scan's work on sorted records [B, 5, n], counted with
    tensor ops: "slots"; "in_range", probes inside the row (what a scan
    without an early exit compares); "compared", probes up to and with the
    first one in each direction whose gram differs (equal grams are
    contiguous in a sorted row, so none past it can meet its gram); "live",
    probes that meet their gram; "candidates", live probes at a distance of
    1..65535; "ops", the integer operations of that work (SCAN_OPS_*)."""
    from smallz4_tpu_torch.ops import sortmatch as sm

    B, _, n = srec.shape
    k1, pos = srec[:, 0], srec[:, 2]
    slot = torch.arange(n, device=srec.device)
    work = dict.fromkeys(("in_range", "compared", "live", "candidates"), 0)
    for sgn in (1, -1):
        still = torch.ones_like(k1, dtype=torch.bool)  # nearer grams equal
        for sk in sm.PROBES:
            k = sk * sgn
            in_range = (slot + k >= 0) & (slot + k < n)
            eq = in_range & (torch.roll(k1, -k, -1) == k1)
            d = pos - torch.roll(pos, -k, -1)
            work["in_range"] += int(in_range.sum()) * B
            work["compared"] += int((in_range & still).sum())
            work["live"] += int(eq.sum())
            work["candidates"] += int((eq & (d >= 1) & (d <= 65535)).sum())
            still = still & eq
    work["slots"] = B * n
    work["ops"] = (SCAN_OPS_COMPARE * work["compared"]
                   + SCAN_OPS_LIVE * work["live"]
                   + SCAN_OPS_CANDIDATE * work["candidates"])
    return work


COMPACT_ORDERS = ("current first", "halo first", "interleaved")
PACK_CASES = ("every head", "slot 0 only", "last tile only")


def compact_rows(np, B: int, chunk: int, order: str, seed: int):
    """Probe outputs (key, payload), int32 [B, 2*chunk], for the compaction:
    each row's chunk current records (key = local << 4 | flags, local a
    random permutation of [0, chunk)) and chunk halo records (key
    16*chunk), in slot order ``order``: every current record ahead of every
    halo record, the reverse, or a random interleave; random payloads."""
    rng = np.random.default_rng(seed)
    local = rng.permuted(np.tile(np.arange(chunk, dtype=np.int32), (B, 1)),
                         axis=1)
    cur = (local << 4) | rng.integers(0, 16, (B, chunk), dtype=np.int32)
    halo = np.full((B, chunk), 16 * chunk, np.int32)
    key = np.concatenate([halo, cur] if order == "halo first"
                         else [cur, halo], axis=1)
    if order == "interleaved":
        key = rng.permuted(key, axis=1)
    elif order not in COMPACT_ORDERS:
        raise ValueError(f"unknown order {order!r}")
    payload = rng.integers(-2**31, 2**31, key.shape).astype(np.int32)
    return np.ascontiguousarray(key), payload


def pack_rows(np, B: int, chunk: int, case: str, seed: int):
    """Claims (lens, dists int32; conv, lk bool), each [B, chunk], for the
    pack.  "every head": random lengths (past 65,535 too) and distances
    1..65535 that differ from the predecessor's, random conv and lk (head
    count = chunk, no zero tail); "slot 0 only": saturated 65535 /
    distance-1 claims, conv and lk all ones (head count 1); "last tile
    only": the same up to the row's last eighth, "every head" claims in it,
    conv and lk all zeros."""
    rng = np.random.default_rng(seed)
    shape = (B, chunk)
    lens = rng.integers(0, 1 << 17, shape).astype(np.int32)
    step = rng.integers(1, 65535, shape)
    dists = (1 + np.cumsum(step, axis=1) % 65535).astype(np.int32)
    conv = rng.random(shape) < 0.5
    lk = rng.random(shape) < 0.5
    if case == "every head":
        return lens, dists, conv, lk
    if case not in PACK_CASES:
        raise ValueError(f"unknown case {case!r}")
    flat = chunk if case == "slot 0 only" else chunk - chunk // 8
    lens[:, :flat] = 65535
    dists[:, :flat] = 1
    ones = case == "slot 0 only"
    return (lens, dists, np.full(shape, ones), np.full(shape, ones))


EXPAND_CASES = ("deep chain", "one run", "history offsets", "literals only",
                "tile edges", "padding")
# match offsets of the "tile edges" row: either side of 4 Ki and 8 Ki, and
# the largest LZ4 offset
EDGE_OFFSETS = (4095, 4096, 4097, 8191, 8192, 8193, 65535)


def expand_row(np, case: str, n: int, seed: int):
    """One row of the block expansion's worst cases at n output bytes
    (n a multiple of 4): (payload uint8, hist uint8 [65536] random,
    (lit_len, match_len, match_off, lit_src) int32), numpy.  "deep chain":
    4 literals, then matches of length 4 at offset 4 (the overlap
    contraction does nothing, the chain is n/4 deep); "one run": 1 literal
    and one match at offset 1; "history offsets": random sequences
    (literals 0..3, matches 4..19 at offsets 1..65535, so chains leave the
    block through the history), then a literals-only sequence; "literals
    only": one literal run; "tile edges": sequences that end at k * 4096 - 1,
    k * 4096 and k * 4096 + 1 in turn (one target a 4 Ki step), matches at
    the EDGE_OFFSETS (lengths 4..19), now and then a match of 4,100..9,000
    at an offset below 8 Ki (it overlaps itself across tiles), once the
    row passes n/8 a literal run of 19,385 bytes and a match of 17,161 at
    offset 1 (each longer than two 8 Ki tiles) where they fit, then a
    literal run to the end; "padding": an empty row (out_len 0)."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 256, 65536, dtype=np.uint8)
    i32 = np.int32
    if case == "deep chain":
        k = (n - 4) // 4
        ll, ml, mo = np.zeros(k, i32), np.full(k, 4, i32), np.full(k, 4, i32)
        ll[0] = 4
        return (rng.integers(0, 256, 4, dtype=np.uint8), hist,
                (ll, ml, mo, np.zeros(k, i32)))
    if case == "one run":
        return (rng.integers(0, 256, 1, dtype=np.uint8), hist,
                tuple(np.asarray([v], i32) for v in (1, n - 1, 1, 0)))
    if case == "literals only":
        return (rng.integers(0, 256, n, dtype=np.uint8), hist,
                tuple(np.asarray([v], i32) for v in (n, 0, 0, 0)))
    if case == "padding":
        return (np.zeros(0, np.uint8), hist,
                tuple(np.zeros(0, i32) for _ in range(4)))
    if case == "tile edges":
        return _tile_edges_row(np, rng, hist, n)
    if case != "history offsets":
        raise ValueError(f"unknown case {case!r}")
    m = n // 12 + 1  # more sequences than the row can hold
    ll = rng.integers(0, 4, m).astype(i32)
    ml = rng.integers(4, 20, m).astype(i32)
    mo = rng.integers(1, 65536, m).astype(i32)
    ends = np.cumsum(ll + ml)
    k = int(np.searchsorted(ends, n - 8, side="right"))  # whole ones that fit
    ll, ml, mo = ll[:k + 1], ml[:k + 1], mo[:k + 1]
    ll[k] = n - int(ends[k - 1] if k else 0)  # the final literal run
    ml[k], mo[k] = 0, 0
    ls = (np.cumsum(ll) - ll).astype(i32)
    return (rng.integers(0, 256, int(ll.sum()), dtype=np.uint8), hist,
            (ll, ml, mo, ls))


def _tile_edges_row(np, rng, hist, n: int):
    """expand_row's "tile edges" row (see there)."""
    seqs = []  # (lit_len, match_len, match_off)
    pos, step, long_done = 0, 0, False
    while True:
        target = (step // 3 + 1) * 4096 + step % 3 - 1
        while target - pos < 8:  # past a long run: the next edge ahead
            step += 3
            target = (step // 3 + 1) * 4096 + step % 3 - 1
        if target > n - 1:
            break
        if rng.integers(0, 8) == 0 and pos + 9003 < n:  # overlaps itself
            seqs.append((int(rng.integers(0, 4)), int(rng.integers(4100, 9001)),
                         int(rng.choice(EDGE_OFFSETS[:6]))))
            pos += seqs[-1][0] + seqs[-1][1]
            continue
        while target - pos >= 30:
            ll = int(rng.integers(0, 4))
            seqs.append((ll, int(rng.integers(4, min(19, target - pos - ll - 7)
                                              + 1)),
                         int(rng.choice(EDGE_OFFSETS))))
            pos += seqs[-1][0] + seqs[-1][1]
        ll = int(rng.integers(0, min(3, target - pos - 4) + 1))
        seqs.append((ll, target - pos - ll, int(rng.choice(EDGE_OFFSETS))))
        pos = target
        step += 1
        if not long_done and pos >= n // 8 and pos + 36546 + 8 <= n:
            seqs.append((19385, 17161, 1))  # 2 x 8192 + 3001, + 777
            pos += 36546
            long_done = True
    seqs.append((n - pos, 0, 0))
    ll, ml, mo = (np.asarray(c, np.int32) for c in zip(*seqs))
    ls = (np.cumsum(ll) - ll).astype(np.int32)
    return (rng.integers(0, 256, int(ll.sum()), dtype=np.uint8), hist,
            (ll, ml, mo, ls))


def expand_batch(np, rows):
    """Rows (payload, hist, tables) stacked as ops.decoder.decompress_batch
    stacks a round: payload [B, pc], hist [B, 65536], tables [4, B, sc],
    padded to its power-of-two buckets, and the round's out_cap."""
    from smallz4_tpu_torch.ops import decoder

    oc = decoder._bucket(max(max(int(t[0].sum() + t[1].sum())
                                 for _, _, t in rows), 1), 4096)
    pc = decoder._bucket(max(max(len(p) for p, _, _ in rows), 1), 1024)
    sc = decoder._bucket(max(max(len(t[0]) for _, _, t in rows), 1), 256)
    pay = np.zeros((len(rows), pc), np.uint8)
    for i, (p, _, _) in enumerate(rows):
        pay[i, :len(p)] = p
    return (pay, np.stack([h for _, h, _ in rows]),
            decoder._pad_tables([t for _, _, t in rows], sc), oc)


def group_inputs(np, cm, fmt, data: bytes, start: int, bs: int):
    """The pipeline's inputs for the first group of the block at ``start``
    (same construction as ops/pipeline.py dispatch_block)."""
    CH, G = cm.CHUNK, cm.GROUP
    arr = np.frombuffer(data, np.uint8)
    n = len(data)
    bufs = np.zeros((G, CH + cm.LOOK), np.uint8)
    cand = np.zeros(G, np.int32)
    lim = np.zeros(G, np.int32)
    for j in range(G):
        cs = start + j * CH
        take = max(0, min(CH + cm.LOOK, n - cs))
        bufs[j, :take] = arr[cs: cs + take]
        cand[j] = max(0, min(CH, bs - j * CH))
        lim[j] = bs - j * CH - fmt.BLOCK_END_LITERALS
    hb = np.zeros(CH + cm.LOOK, np.uint8)
    hb[:CH] = arr[start - CH: start]
    hb[CH:] = arr[start: start + cm.LOOK]
    cut = start - fmt.BLOCK_END_NO_MATCH
    cut_gram = cm.pack_cut_gram(data[cut: cut + 4])
    return bufs, cand, lim, hb, cut_gram, CH - fmt.BLOCK_END_NO_MATCH


def chunk_group(torch, np, dev, data: bytes) -> types.SimpleNamespace:
    """The first chunk group of block 1 of ``data`` (a live boundary cut
    and a history halo) on ``dev``, staged as match_chunks stages it: its
    inputs (bufs, cand, lim, halo, the scalar cut_gram and cut_pos and the
    per-row cg and cp) and its records up to the probe (recs, the sorted
    srt, the merge input x and the merged records)."""
    from smallz4_tpu_torch import format as fmt
    from smallz4_tpu_torch.ops import chunkmatch as cm
    from smallz4_tpu_torch.ops import sortnet

    CH, G = cm.CHUNK, cm.GROUP
    start = G * CH
    bufs, cand, lim, hb, cut_gram, cut_pos = group_inputs(
        np, cm, fmt, data, start, min(fmt.MAX_BLOCK_SIZE, len(data) - start))
    bufs, cand, lim = (torch.from_numpy(a).to(dev) for a in (bufs, cand, lim))
    halo = cm.sort_chunk(torch.from_numpy(hb).to(dev), 0, CH, chunk=CH)
    first = torch.arange(G, device=dev) == 0
    recs = cm.make_records(bufs, 0, cand, chunk=CH)
    srt = sortnet.sort_records(recs, n_keys=6, unique=True)
    x = cm._merged_input(torch.cat([halo[None], srt[:-1]]), srt, CH)
    return types.SimpleNamespace(
        bufs=bufs, cand=cand, lim=lim, halo=halo, cut_gram=cut_gram,
        cut_pos=cut_pos, cg=torch.where(first, cut_gram, 0).to(torch.int32),
        cp=torch.where(first, cut_pos, -1).to(torch.int32), recs=recs,
        srt=srt, x=x, merged=sortnet.merge_sorted(x, n_keys=6, unique=True))


def encode_run(torch, _cuda, native, pipeline, name, data, expect, **kw):
    """One device encode with the launch counters set to 0 just before it:
    the stream must equal native.compress and decode back, and the counts
    must equal ``expect``.  Returns (launch counts, stats, stream)."""
    native_kw = {k: v for k, v in kw.items() if k in ("legacy", "block_size")}
    t = time.perf_counter()
    want = native.compress(data, 9, **native_kw)
    native_s = time.perf_counter() - t
    stats: dict = {}
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t = time.perf_counter()
    got = pipeline.compress(data, 9, device="cuda", stats=stats, **kw)
    wall = time.perf_counter() - t
    counts = dict(_cuda.LAUNCHES)
    stats["wall_s"] = wall
    if got != want:
        raise AssertionError(f"{name}: stream != native.compress(data, 9)"
                             f" ({len(got)} vs {len(want)} bytes)")
    if native.decompress(got) != data:
        raise AssertionError(f"{name}: native.decompress round trip")
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    log(f"    {name}: {len(data)} B -> {len(got)} B, equal to native; "
        f"{len(data) / wall / 1e6:.3f} MB/s e2e ({wall:.3f} s); refine "
        f"{stats['n_refine_positions']}/{stats['n_positions']} positions; "
        f"launches {counts}")
    log(f"    native.compress {len(data) / native_s / 1e6:.3f} MB/s "
        f"({native_s:.3f} s); span self seconds (host clock, pool threads "
        f"summed): " + ", ".join(f"{k} {v:.3f}" for k, v in stats.items()
                                if not k.startswith("n_") and k != "wall_s"))
    return counts, stats, got


def dictionary_frame(native, real: bytes):
    """(data, frame, dictionary): 32 KiB that repeat the dictionary's tail,
    then 512 KiB of the fixture, compressed against the fixture's first
    64 KiB, so matches reach back past position 0 into the dictionary."""
    h = 1 << 16
    data = real[h // 2:h] + real[2 << 20:(2 << 20) + (1 << 19)]
    return data, native.compress(data, 9, dictionary=real[:h]), real[:h]


def expand_rows(np, real: bytes, streams: dict, dframe):
    """Phase 3d's expansion cases: (name -> rows (payload, hist, tables)),
    (name -> the bytes its row must expand to, for the real blocks)), from
    the "realcorpus" stream (4 MiB blocks) and the "realcorpus_1MiB" one
    in ``streams`` and the dictionary frame ``dframe``."""
    from smallz4_tpu_torch.ops import decoder

    H, mib = decoder.HIST_CAP, 1 << 20

    def block(frame, k, tail):
        payload, tables, _ = list(decoder.frame_blocks(frame))[k]
        hist = np.zeros(H, np.uint8)
        hist[H - len(tail):] = np.frombuffer(tail, np.uint8)
        return np.frombuffer(payload, np.uint8), hist, tables

    ddata, dfr, dictionary = dframe
    rows = {
        "realcorpus block 1": [block(streams["realcorpus"], 0, b"")],
        "realcorpus block 2": [block(streams["realcorpus"], 1,
                                     real[4 * mib - H:4 * mib])],
        "dictionary block": [block(dfr, 0, dictionary)],
        **{f"{case} 4 MiB": [expand_row(np, case, 4 * mib, i)]
           for i, case in enumerate(EXPAND_CASES) if case != "padding"},
        "batch of 8 rows": [block(streams["realcorpus_1MiB"], k,
                                  real[max(k * mib - H, 0):k * mib])
                            for k in range(6)]
                           + [expand_row(np, "padding", 0, 9)] * 2,
    }
    expect = {"realcorpus block 1": real[:4 * mib],
              "realcorpus block 2": real[4 * mib:8 * mib],
              "dictionary block": ddata}
    return rows, expect


def expand_cases(torch, np, dev, real: bytes, made, dframe) -> dict:
    """Phase 3d, the kernel: s4_expand against its plain version, exact over
    all out_cap bytes, on block 1 of the realcorpus frame of phase 3 (no
    history) and block 2 (the history is block 1's tail), on the first block
    of the dictionary frame, on the worst cases of expand_row at 4 MiB (a
    chain 1M deep, one run, offsets into the history, literals only, tile
    edges) and on a batch of 8 rows (6 blocks of the 1 MiB-block frame of
    phase 3b, each with its history, and 2 padding rows). The real blocks
    must expand to their data. Timed; the bound counts each row's real
    payload, sequences and reachable history and all the output. The kernel
    must launch once a call on every case (torch.profiler, its records by
    name; a call's other launches are the ends' scan). Returns the
    realcorpus block's results, the others under "cases"."""
    from smallz4_tpu_torch.ops import decoder

    H = decoder.HIST_CAP
    rows, expect = expand_rows(np, real,
                               {name: got for name, _, got in made}, dframe)
    cases = {}
    for name, rs in rows.items():
        pay, hist, tabs, oc = expand_batch(np, rs)
        pay, hist, tabs = (torch.from_numpy(a).to(dev)
                           for a in (pay, hist, tabs))
        args = (pay, hist, *tabs)
        if name in expect:
            got = decoder.expand_block(*args, out_cap=oc)[0].cpu().numpy()
            if got[:len(expect[name])].tobytes() != expect[name]:
                raise AssertionError(f"{name} does not expand to its data")
        # the bytes the function needs: each row's real payload and
        # sequences (not the buckets' padding, which it never reads), the
        # history back to its farthest match source, and all the output
        inputs = []
        for i, (p, _, (ll, ml, mo, _)) in enumerate(rs):
            far = (mo - (np.cumsum(ll + ml) - ml))[ml > 0]
            reach = int(min(max(far.max(initial=0), 0), H))
            inputs += [pay[i, :len(p)], tabs[:, i, :len(ll)],
                       hist[i, H - reach:]]
        res = check_kernels(torch, {"expand": (
            lambda a=args, oc=oc: decoder.expand_block(*a, out_cap=oc),
            lambda a=args, oc=oc: decoder.expand_block_plain(*a, out_cap=oc),
            tuple(inputs), 0)}, "3d",
            f"{name}: {len(rs)} x {oc} output bytes, sc {tabs.shape[-1]}",
            kernel_name="expand_kernel")
        cases[name] = r = res["expand"]
        # one launch of the kernel a call, whatever the chains' depth
        per_call = r["device_launches_per_call"]
        log(f"[3d] {name}: the bound is "
            f"{r['bound_ms'] / r['device_ms']:.2%} of the device time; "
            f"{per_call:g} launch(es) of s4_expand's kernel a call")
        if per_call != 1:
            raise AssertionError(f"{name}: s4_expand's kernel launched "
                                 f"{per_call:g} times a call")
    main_case = dict(cases.pop("realcorpus block 1"))
    main_case["cases"] = cases
    return main_case


def decode_stages(torch, np, dev, frame: bytes, data: bytes,
                  reps: int = 3) -> dict:
    """Phase 3d, the host side of a device decode of ``frame`` (the
    realcorpus stream at 4 MiB blocks): its stages on the host clock, each
    ended by a sync, summed over the blocks, medians of ``reps`` runs, in
    ms: the block walk with native.parse_sequences ("parse"), padding the
    payload and tables and their uploads ("pad_upload", BlockDecoder.upload),
    the expansion ("expand"), the copy of the block back and the history
    update ("copy_back"); beside them one whole decompress(engine="device"),
    which overlaps the copies back with the next blocks."""
    import statistics

    import smallz4_tpu_torch
    from smallz4_tpu_torch import format as fmt
    from smallz4_tpu_torch.ops import decoder

    runs = {k: [] for k in ("parse", "pad_upload", "expand", "copy_back",
                            "decompress")}
    for _ in range(reps):
        took = dict.fromkeys(runs, 0.0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        blocks = list(decoder.frame_blocks(frame))
        took["parse"] = time.perf_counter() - t
        dec = decoder.BlockDecoder(fmt.MAX_BLOCK_SIZE_LEGACY, dev)
        hist = dec.hist_device(b"")
        out = bytearray()
        for payload, tables, _ in blocks:
            t = time.perf_counter()
            pay, tabs, oc, out_len = dec.upload(payload, tables)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = decoder.expand_block(pay, hist[None], *tabs, out_cap=oc)[0]
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            out += res[:out_len].cpu().numpy().tobytes()
            hist = decoder._update_hist(hist, res, out_len)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            took["pad_upload"] += t1 - t
            took["expand"] += t2 - t1
            took["copy_back"] += t3 - t2
        if bytes(out) != data:
            raise AssertionError("staged decode != input")
        t = time.perf_counter()
        got = smallz4_tpu_torch.decompress(frame, engine="device")
        took["decompress"] = time.perf_counter() - t
        if got != data:
            raise AssertionError("device decode != input")
        for k, v in took.items():
            runs[k].append(v * 1e3)
    return {k: statistics.median(v) for k, v in runs.items()}


def decode_run(torch, np, _cuda, native, api, real: bytes, made,
               dframe) -> dict:
    """Phase 3d, end to end, with the launch counters set to 0 just before
    it: decompress(engine="device") on every stream of phases 3-3c (modern
    and legacy, 1 MiB and 4 MiB blocks) and on the dictionary frame, and
    decompress_batch(engine="device") on 16 frames of mixed kinds; each
    output must equal its input, expand must launch once a compressed block
    and once a batch round.  Logs the decode rate (MB/s of output, host
    clock) beside native.decompress's.  Returns the launch counts."""
    from smallz4_tpu_torch.ops import decoder

    def n_comp(frame):
        return sum(t is not None for _, t, _ in decoder.frame_blocks(frame))

    runs = [(name, data, got, None) for name, data, got in made]
    ddata, dfr, dictionary = dframe
    runs.append(("dictionary frame", ddata, dfr, dictionary))
    rng = np.random.default_rng(11)
    kb = 100_000
    kinds = ([(real[k * 2 * kb:(k + 1) * 2 * kb], {}) for k in range(4)]
             + [(rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(), {})
                for _ in range(2)]
             + [(real[(1 << 20) + k * 2 * kb:(1 << 20) + (k + 1) * 2 * kb],
                 {"block_size": 1 << 16}) for k in range(3)]
             + [(real[(2 << 20) + k * kb:(2 << 20) + (k + 1) * kb],
                 {"legacy": True}) for k in range(3)]
             + [(b"", {}), (b"short", {}), (real[:100], {}),
                (real[:5000], {})])
    batch = [(raw, native.compress(raw, 9, **kw)) for raw, kw in kinds]
    torch.cuda.synchronize()
    _cuda.reset_counts()
    for name, data, frame, dic in runs:
        before = _cuda.LAUNCHES["expand"]
        t = time.perf_counter()
        got = api.decompress(frame, dictionary=dic, engine="device")
        wall = time.perf_counter() - t
        took = _cuda.LAUNCHES["expand"] - before
        if got != data:
            raise AssertionError(f"{name}: device decode != input")
        if took != n_comp(frame):
            raise AssertionError(f"{name}: {took} expand launches, "
                                 f"{n_comp(frame)} compressed blocks")
        t = time.perf_counter()
        native.decompress(frame, dictionary=dic)
        native_s = time.perf_counter() - t
        log(f"[3d] decode {name}: {len(frame)} B -> {len(data)} B, equal to "
            f"the input; {len(data) / wall / 1e6:.3f} MB/s device decode "
            f"({wall:.3f} s, {took} expand launches); native.decompress "
            f"{len(data) / native_s / 1e6:.3f} MB/s")
    before = _cuda.LAUNCHES["expand"]
    t = time.perf_counter()
    got = api.decompress_batch([f for _, f in batch], engine="device")
    wall = time.perf_counter() - t
    took = _cuda.LAUNCHES["expand"] - before
    counts = dict(_cuda.LAUNCHES)
    rounds = max(len(list(decoder.frame_blocks(f))) for _, f in batch)
    if got != [raw for raw, _ in batch]:
        raise AssertionError("decompress_batch != the inputs")
    if took != rounds:
        raise AssertionError(f"decompress_batch: {took} expand launches, "
                             f"{rounds} rounds")
    total = sum(len(raw) for raw, _ in batch)
    t = time.perf_counter()
    for _, f in batch:
        native.decompress(f)
    native_s = time.perf_counter() - t
    log(f"[3d] decompress_batch of {len(batch)} frames (compressed, stored, "
        f"multi-block, legacy, short): {total} B, equal to the inputs; "
        f"{total / wall / 1e6:.3f} MB/s ({wall:.3f} s, {took} expand "
        f"launches = rounds); native.decompress loop "
        f"{total / native_s / 1e6:.3f} MB/s")
    if any(v for k, v in counts.items() if k != "expand"):
        raise AssertionError(f"decode launched other kernels: {counts}")
    return counts


# integer operations of the DP's work on a block, as one backward scan does
# it (parse_work): a position's literal candidate, each tier-1 length it
# scans, each further tier it queries
PARSE_OPS_LITERAL = 6
PARSE_OPS_LENGTH = 3
PARSE_OPS_TIER = 12


def parse_work(torch, lens, dists, n: int) -> int:
    """The DP's operations on these claims (PARSE_OPS_*): every position's
    literal, every length 4..18 its clamped claim reaches, every tier >= 2
    it reaches; the MAX_SAME_LETTER shortcut scans nothing."""
    from smallz4_tpu_torch.ops import parse

    L, run_sc, _ = parse._claims(lens, dists, n)
    scanned = (L >= 4) & ~run_sc
    t1 = torch.where(scanned, torch.clamp_max(L, 18) - 3, 0)
    tiers = torch.where(scanned & (L > 18), (L - 19) // 255 + 1, 0)
    return int(PARSE_OPS_LITERAL * n + PARSE_OPS_LENGTH * int(t1.sum())
               + PARSE_OPS_TIER * int(tiers.sum()))


# bytes of one policy-iteration round of csrc/parse.cu: a position's
# outside the global rounds (steps and first jumps: the choice read, an
# 8-byte word and a literal-cost byte written; costs: the word read, its
# exit's word gathered, the cost written; the table: an 8-byte word
# written; the improvement: the staged cost, lens, dists, the literal cost,
# the choice read and written), an entry's (its mark, its list slot
# written and read, its word read), and an entry's share of one global
# round (its exit's word gathered, its word written)
PARSE_ROUND_BYTES = 13 + 20 + 8 + 21
PARSE_ENTRY_BYTES = 4 + 8 + 8
PARSE_GLOBAL_BYTES = 16
PARSE_TILE = 2048  # positions a tile of csrc/parse.cu (THREADS x PER)


def parse_entries(torch, choice, n: int) -> tuple[int, int]:
    """(entries, global rounds) of csrc/parse.cu's evaluation of the policy
    ``choice``: the positions below limit = n - 5 where a first jump from
    an earlier tile lands, and the synchronous pointer-jumping rounds over
    them until every entry's exit is in the absorbing tail, after each
    tile resolved its own jumps."""
    N = choice.shape[0]
    idx = torch.arange(N, device=choice.device)
    limit = n - 5
    first = torch.where(idx >= limit, idx, torch.clamp_max(
        idx + torch.clamp_min(choice.long(), 1), N - 1))
    tend = (idx // PARSE_TILE + 1) * PARSE_TILE
    ex = first.clone()
    while True:  # inside the tiles
        inside = (ex < tend) & (ex < limit)
        if not bool(inside.any()):
            break
        ex = torch.where(inside, ex[ex], ex)
    entries = torch.unique(first[(first >= tend) & (first < limit)])
    rounds = 0
    while bool((ex[entries] < limit).any()):
        ex[entries] = ex[ex[entries]]
        rounds += 1
    return int(entries.numel()), rounds


# the DP's synthetic worst cases (parse_claims) and their N in phase 3e
PARSE_CASES = {"periodic": 4 << 20, "tile edges": 4 << 20,
               "limit landing": 1 << 20, "odd N": (1 << 20) + 777,
               "synthetic": 4 << 20}


def parse_claims(np, case: str, N: int, seed: int):
    """Claims of the DP's synthetic worst cases for the two-level
    evaluation of csrc/parse.cu: (lens, dists int32 [N], n), numpy, every
    claim in the DP's legal range (4 <= length <= n - 5 - i, else 1),
    distances 2..65,535.  "periodic": the claims of a periodic input of
    period 700 saturated at 65,535, the longest claim of the device
    search: literals for the first period, then min(65,535, limit - i) at
    distance 700, so every first jump is distinct and leaves its tile (the
    unsaturated claims would all land on limit): every position is an
    entry; "tile edges": literals, and at every tile edge e
    = k * PARSE_TILE claims whose jumps land on e - 1, e and e + 1, of
    lengths 4, 18, 19, 300, PARSE_TILE + 3 and 3 * PARSE_TILE + 1 (inside
    the tile, across one edge, across several); "limit landing": n = N -
    1,000 (the rest padding), literals, claims of lengths 4 to 2 *
    PARSE_TILE + 7 whose jumps land exactly on limit = n - 5, and a chain
    of 40 matches whose last lands there; "odd N" (N need not be a
    multiple of the tile): n = N - 300, claims as "synthetic";
    "synthetic": seeded claims, 40% literals, 30% lengths 4..18, 20%
    19..PARSE_TILE (across at most one tile edge), 10% PARSE_TILE..65,535
    (across many)."""
    rng = np.random.default_rng(seed)
    n = N - {"limit landing": 1000, "odd N": 300}.get(case, 0)
    limit = n - 5
    lens = np.ones(N, np.int64)
    idx = np.arange(N)
    if case == "periodic":
        lens = np.where(idx >= 700, 65535, 1)
    elif case in ("synthetic", "odd N"):
        kind = rng.random(N)
        lens = np.select(
            [kind < 0.4, kind < 0.7, kind < 0.9],
            [1, rng.integers(4, 19, N), rng.integers(19, PARSE_TILE + 1, N)],
            rng.integers(PARSE_TILE, 65536, N))
    elif case == "tile edges":
        for e in range(PARSE_TILE, N, PARSE_TILE):
            for d in (-1, 0, 1):
                for length in (4, 18, 19, 300, PARSE_TILE + 3,
                               3 * PARSE_TILE + 1):
                    if e + d - length >= 0:
                        lens[e + d - length] = length
    elif case == "limit landing":
        for length in (4, 5, 18, 19, 255, 300, PARSE_TILE,
                       2 * PARSE_TILE + 7):
            lens[limit - length] = length
        p = limit
        for _ in range(40):
            length = int(rng.integers(4, 600))
            p -= length
            lens[p] = length
    else:
        raise ValueError(f"unknown case {case!r}")
    lens = np.minimum(lens, np.maximum(limit - idx, 0))
    lens = np.where(lens >= 4, lens, 1)
    dists = np.where(lens > 1, 700 if case == "periodic"
                     else rng.integers(2, 65536, N), 0)
    return lens.astype(np.int32), dists.astype(np.int32), n


def native_claims(np, native, data: bytes):
    """Level-9 claims of one block by the native search, the last 11
    positions literals: (lens, dists) int32 numpy."""
    n = len(data)
    lens = np.zeros(n, np.int32)
    dists = np.zeros(n, np.int32)
    native.match_block_ex(np.frombuffer(data, np.uint8), base=0, bs=n,
                          level=9, lookback=0, cut_pos=-1, lens=lens,
                          dists=dists)
    lens[n - 11:] = 1
    dists[n - 11:] = 0
    return lens, dists


def resident_run(torch, _cuda, pipeline, parse, real: bytes, block: int,
                 plain: bool = False):
    """One compress_device_resident of ``real`` at ``block`` on the card,
    the launch counters set to 0 just before it; with ``plain`` the DP runs
    its plain version on the card.  Records each block's DP inputs
    (lens, dists, n), rounds and converged flag and the step's ok.
    Returns (stream, wall s, launch counts, report, blocks)."""
    from smallz4_tpu_torch.utils.profiling import RunReport

    blocks = []
    dp_fn = parse.policy_iteration_plain if plain else parse.policy_iteration
    orig_dp = parse.policy_iteration
    orig_step = pipeline._device_resident_block_step

    def dp(lens, dists, n, max_iters=48):
        choice, cost, conv, rounds = dp_fn(lens, dists, n, max_iters)
        blocks.append({"lens": lens, "dists": dists, "n": n,
                       "rounds": rounds, "conv": conv})
        return choice, cost, conv, rounds

    def step(*args):
        out = orig_step(*args)
        blocks[-1].update(ok=out[3], args=args)
        return out

    rep = RunReport(operation="encode", engine="")
    parse.policy_iteration = dp
    pipeline._device_resident_block_step = step
    try:
        torch.cuda.synchronize()
        _cuda.reset_counts()
        t = time.perf_counter()
        frame = pipeline.compress_device_resident(real, block_size=block,
                                                  report=rep, device="cuda")
        wall = time.perf_counter() - t
        counts = dict(_cuda.LAUNCHES)
    finally:
        parse.policy_iteration = orig_dp
        pipeline._device_resident_block_step = orig_step
    for b in blocks:
        b.update(rounds=int(b["rounds"]), conv=bool(b["conv"]),
                 ok=bool(b["ok"]))
    return frame, wall, counts, rep, blocks


def resident_encode(torch, _cuda, native, pipeline, parse, real: bytes,
                    block: int, chunk_rate: float):
    """Phase 3e, end to end: the device-resident encode of ``real`` at
    ``block``, then the same with the DP's plain version; the streams must
    be equal and decode back, each block's fallback (ok False) must be one
    where the plain DP also hit the cap, and the launches one of each match
    kernel and of the parse a block (the sort once more for the empty
    halo).  Returns (launch counts, blocks)."""
    name = f"realcorpus at {block >> 20} MiB blocks"
    frame, wall, counts, rep, blocks = resident_run(
        torch, _cuda, pipeline, parse, real, block)
    plain_frame, plain_wall, _, _, plain_blocks = resident_run(
        torch, _cuda, pipeline, parse, real, block, plain=True)
    if native.decompress(frame) != real:
        raise AssertionError(f"{name}: device-resident stream does not "
                             f"decode back")
    if frame != plain_frame:
        raise AssertionError(f"{name}: stream != the plain DP's stream")
    for k, (b, pb) in enumerate(zip(blocks, plain_blocks)):
        if not b["ok"] and pb["ok"]:
            raise AssertionError(f"{name}: block {k} took the host fallback "
                                 f"but the plain DP converged")
    n_blocks = len(blocks)
    expect = ({k: 0 for k in _cuda.LAUNCHES}
              | {k: n_blocks for k in RESIDENT_KERNELS}
              | {"sort_records": n_blocks + 1})
    if counts != expect:
        raise AssertionError(f"{name}: launches {counts} != {expect}")
    d2h = rep.counters.get("n_d2h_bytes", 0)
    log(f"[3e] device-resident {name}: {len(real)} B -> {len(frame)} B, "
        f"decodes back, equal to the plain DP's stream; "
        f"{len(real) / wall / 1e6:.3f} MB/s ({wall:.3f} s; plain DP "
        f"{len(real) / plain_wall / 1e6:.3f} MB/s); d2h {d2h} B = "
        f"{d2h / len(real):.4f} B an input byte; chunk engine parity "
        f"{chunk_rate:.3f} MB/s (phase 3); ratio "
        f"{len(frame) / len(real):.4f}; span self seconds (host clock) "
        + ", ".join(f"{k} {v:.3f} s" for k, v in rep.stages.items())
        + f"; launches {counts}")
    log(f"[3e]   rounds a block {[b['rounds'] for b in blocks]}, ok "
        f"{[b['ok'] for b in blocks]} (plain DP: rounds "
        f"{[b['rounds'] for b in plain_blocks]}); host fallback blocks "
        f"{[k for k, b in enumerate(blocks) if not b['ok']]}")
    return counts, blocks


def parse_check(torch, np, native, parse, name: str, lens, dists, n: int,
                max_iters: int = 48) -> dict:
    """The DP kernel against its plain version on the card (choice, cost,
    converged, rounds: exact), the converged choice against
    native.estimate_costs, one launch of the kernel a call
    (torch.profiler; a trace that lost the kernel's records in all of
    device_ms's retakes is taken anew, up to three times).  Returns the
    kernel's device time, launches a call, rounds and error."""
    got = parse.policy_iteration(lens, dists, n, max_iters)
    want = parse.policy_iteration_plain(lens, dists, n, max_iters)
    err = max_err(torch, got, want)
    rounds, conv = int(got[3]), bool(got[2])
    native_eq = None
    if conv:
        ref = lens[:n].cpu().numpy().copy()
        native.estimate_costs(ref, dists[:n].cpu().numpy().copy())
        native_eq = bool(np.array_equal(got[0][:n].cpu().numpy(), ref))
    for _ in range(3):  # a session can lose kernel records (device_ms)
        dev_ms, per_call = device_ms(torch, lambda: parse.policy_iteration(
            lens, dists, n, max_iters), 2, name="parse", own=True)
        if per_call == 1:
            break
    log(f"[3e] parse {name}: n {n}, max_iters {max_iters}: max_abs_err {err}"
        f" (tolerance 0), rounds {rounds}, converged {conv}, equal to "
        f"native.estimate_costs {native_eq}; kernel {dev_ms:.4f} ms device, "
        f"{per_call:g} launch(es) a call")
    if err != 0 or native_eq is False or per_call != 1:
        raise AssertionError(f"parse {name}: error {err}, native "
                             f"{native_eq}, {per_call} launches a call")
    return {"err": err, "device_ms": dev_ms, "rounds": rounds}


def parse_worst(torch, np, native, dev, mib_block0, big_block) -> dict:
    """The DP's worst cases of phase 3e: name -> (lens, dists int32 on
    ``dev``, n, max_iters).  By the native search (native_claims): a
    65,535-long repeat of a 700-byte fragment, a distance-1 run past
    MAX_SAME_LETTER, 1 MiB of random bytes; parse_claims' cases (periodic,
    tile edges and the synthetic claims at 4 MiB, limit landing at 1 MiB,
    odd N at 2^20 + 777); the first 1 MiB
    block (``mib_block0``) cut after one improvement and the first 4 MiB
    block (``big_block``) after one and after two."""
    rng = np.random.default_rng(12)
    frag = rng.integers(0, 256, 700, dtype=np.uint8).tobytes()
    worst = {}
    for name, data in {
        "repeat 65535": (frag * 100)[:700 + 65535] + b"end of block" * 4,
        "run past MAX_SAME_LETTER": b"Q" * (65299 + 4000) + b"tail" * 40,
        "random 1 MiB": rng.integers(0, 256, 1 << 20,
                                     dtype=np.uint8).tobytes(),
    }.items():
        lens, dists = (torch.from_numpy(a).to(dev)
                       for a in native_claims(np, native, data))
        worst[name] = (lens, dists, len(data), 48)
    for case, N in PARSE_CASES.items():
        lens, dists, n = parse_claims(np, case, N, seed=13)
        worst[case] = (torch.from_numpy(lens).to(dev),
                       torch.from_numpy(dists).to(dev), n, 48)
    worst["realcorpus 1 MiB block 0, cut"] = (
        mib_block0["lens"], mib_block0["dists"], mib_block0["n"], 1)
    for cut in (1, 2):
        worst[f"realcorpus 4 MiB block 0, cut at {cut}"] = (
            big_block["lens"], big_block["dists"], big_block["n"], cut)
    return worst


def parse_cases(torch, np, native, parse, dev, mib_blocks,
                big_block) -> dict:
    """Phase 3e, the kernel: parse_check on the DP inputs of every 1 MiB
    block (``mib_blocks``) and of the first 4 MiB block (``big_block``) of
    the encodes, and on the worst cases of parse_worst; check_kernels on
    the 4 MiB block (its record for the kernels line); the design's bytes
    and entries.  Returns the record."""
    err = 0
    for k, b in enumerate(mib_blocks):
        err = max(err, parse_check(torch, np, native, parse,
                                   f"realcorpus 1 MiB block {k}", b["lens"],
                                   b["dists"], b["n"])["err"])
    for name, (lens, dists, n, max_iters) in parse_worst(
            torch, np, native, dev, mib_blocks[0], big_block).items():
        err = max(err, parse_check(torch, np, native, parse, name, lens,
                                   dists, n, max_iters)["err"])
    lens, dists, n = big_block["lens"], big_block["dists"], big_block["n"]
    work = parse_work(torch, lens, dists, n)
    res = check_kernels(torch, {"parse": (
        lambda: parse.policy_iteration(lens, dists, n),
        lambda: parse.policy_iteration_plain(lens, dists, n),
        (lens, dists), work)}, "3e",
        f"the first 4 MiB block, {big_block['rounds']} rounds",
        kernel_name="parse")["parse"]
    res["max_abs_err"] = max(err, res["max_abs_err"])
    evals = big_block["rounds"] + 1
    choice = parse.estimate_costs_device(lens, dists, n)[0]
    entries, rounds = parse_entries(torch, choice, n)
    tiles = -(-lens.shape[0] // PARSE_TILE)
    design = evals * (PARSE_ROUND_BYTES * n + entries * (
        PARSE_ENTRY_BYTES + PARSE_GLOBAL_BYTES * rounds))
    log(f"[3e] parse: the bound is {res['bound_ms'] / res['device_ms']:.2%} "
        f"of the device time ({work} counted operations); "
        f"{res['device_ms'] / evals:.4f} ms a policy evaluation "
        f"({big_block['rounds']} improvements + 1); the final policy has "
        f"{entries} entries ({entries / tiles:.2f} a tile) and {rounds} "
        f"global rounds; design bytes: {evals} rounds x ({PARSE_ROUND_BYTES}"
        f" B x {n} positions + {entries} entries x ({PARSE_ENTRY_BYTES} + "
        f"{PARSE_GLOBAL_BYTES} x {rounds}) B) = {design / 1e9:.4f} GB, "
        f"{design / res['device_ms'] / 1e6:.1f} GB/s achieved by device "
        f"time")
    return res


def emit_blocks(torch, np, native, parse, dev, real: bytes, lens, dists,
                n: int) -> dict:
    """The emit's three 4 MiB blocks, name -> (bytes, lens, dists on dev):
    the device DP's parse of ``real``'s block (its claims ``lens``,
    ``dists`` on dev, the first ``n`` positions the block), random bytes
    all literals (one sequence of 4,194,304 literals), and one byte value
    parsed by the native DP (matches of 65,535 from every position)."""
    from smallz4_tpu_torch import format as fmt

    choice = parse.estimate_costs_device(lens, dists, n)[0]
    one = b"z" * fmt.MAX_BLOCK_SIZE
    olens, odists = native_claims(np, native, one)
    native.estimate_costs(olens, odists)
    rand = np.random.default_rng(11).integers(
        0, 256, fmt.MAX_BLOCK_SIZE, dtype=np.uint8).tobytes()
    ones = torch.ones(len(rand), dtype=torch.int32, device=dev)
    return {"emit": (real[:n], choice, torch.where(choice > 1, dists, 0)),
            "emit literals": (rand, ones, torch.zeros_like(ones)),
            "emit one byte": (one, torch.from_numpy(olens).to(dev),
                              torch.from_numpy(odists).to(dev))}


def emit_cases(torch, np, native, parse, emit, dev, real: bytes, big_block,
               parse_ms: float) -> dict:
    """Phase 3e, the emit: check_kernels on the kernel (csrc/emit.cu)
    against its plain version (all output bytes and n_out) on emit_blocks
    (the resident encode's claims of the first 4 MiB block), each payload
    equal to native.emit_block, two device launches a call; the bound
    counts the block, lens, dists and the payload.  Then the block step by
    stage.  Returns the first block's record."""
    from smallz4_tpu_torch.ops import pipeline

    blocks = emit_blocks(torch, np, native, parse, dev, real,
                         big_block["lens"], big_block["dists"],
                         big_block["n"])
    cases, paid = {}, {}
    for name, (data, ln, ds) in blocks.items():
        blk = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
        out, n_out = emit.emit_block_device(blk, ln, ds)
        want = native.emit_block(data, ln.cpu().numpy(), ds.cpu().numpy())
        if out[:int(n_out)].cpu().numpy().tobytes() != want:
            raise AssertionError(f"{name}: emit_block_device != "
                                 f"native.emit_block")
        cases[name] = (lambda a=(blk, ln, ds): emit.emit_block_device(*a),
                       lambda a=(blk, ln, ds): emit.emit_block_plain(*a),
                       (blk, ln, ds), 0)
        paid[name] = nbytes(blk, ln, ds) + int(n_out)
    results = check_kernels(torch, cases, "3e", "4 MiB blocks",
                            kernel_name="emit")
    for name, res in results.items():
        res["bound_ms"], res["bound_by"] = bound(paid[name], 0)
        log(f"[3e] {name:13s} payload {paid[name] - nbytes(*cases[name][2])}"
            f" B; bound {res['bound_ms'] * 1e3:.2f} us (bytes: block, lens, "
            f"dists, payload), {res['bound_ms'] / res['device_ms']:.2%} of "
            f"the device time")
        if res["device_launches_per_call"] != 2:
            raise AssertionError(f"{name}: {res['device_launches_per_call']}"
                                 f" device launches a call, not 2")
    e_ms = results["emit"]["ms"]
    # the block step by stage (CUDA events): the raw match, the DP, the emit
    from smallz4_tpu_torch.ops import chunkmatch as cm

    args = big_block["args"]
    halo, bufs, cand, vhi, lim, cg, cp, _, n_chunks, _ = args
    m_ms = cuda_ms(torch, lambda: cm.match_chunks_raw(
        halo, bufs, cand, vhi, lim, cg, cp, n_chunks=n_chunks,
        chunk=cm.CHUNK), 3)
    s_ms = cuda_ms(torch, lambda: pipeline._device_resident_block_step(
        *args), 3)
    log(f"[3e] device-resident block step, the first 4 MiB block (CUDA "
        f"events): {s_ms:.4f} ms = match_chunks_raw {m_ms:.4f} + the DP "
        f"{parse_ms:.4f} + the emit {e_ms:.4f} + the rest "
        f"{s_ms - m_ms - parse_ms - e_ms:.4f}")
    return results["emit"]


def main() -> int:
    import torch

    if not (ROOT / "smallz4_tpu_torch").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    os.environ["SMALLZ4_TPU_CPU_ASSIST"] = "0"
    import numpy as np

    import bench
    import smallz4_tpu_torch
    from smallz4_tpu_torch import format as fmt
    from smallz4_tpu_torch import native
    from smallz4_tpu_torch.ops import _cuda, sortnet
    from smallz4_tpu_torch.ops import chunkmatch as cm
    from smallz4_tpu_torch.ops import emit, parse
    from smallz4_tpu_torch.ops import match_finder as mf
    from smallz4_tpu_torch.ops import pallas_kernels as pk
    from smallz4_tpu_torch.ops import pipeline
    from smallz4_tpu_torch.ops import sortmatch as sm

    # -- phase 0: card ---------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[0] card: {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # -- phase 1: build --------------------------------------------------
    t = time.perf_counter()
    path, build_log = _cuda.build()
    _cuda.lib()
    log(f"[1] built {path.relative_to(ROOT)} in "
        f"{time.perf_counter() - t:.3f} s")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("    ptxas:", line.strip())
    t = time.perf_counter()
    lib_path = native.build()
    native._load()
    log(f"[1] native runtime {lib_path.relative_to(ROOT)} ready in "
        f"{time.perf_counter() - t:.3f} s")

    # -- phase 2: chunk-engine kernels against their plain versions --------
    real = real_corpus()
    CH, G = cm.CHUNK, cm.GROUP
    grp = chunk_group(torch, np, dev, real)
    bufs_d, cand_d, lim_d, halo, cg, cp = (grp.bufs, grp.cand, grp.lim,
                                           grp.halo, grp.cg, grp.cp)
    recs, x, merged = grp.recs, grp.x, grp.merged
    p_pay, p_key = cm.probe(merged, cg, cp, lim_d, CH)
    s_key, s_pay = cm.compact(p_key, p_pay, CH)
    # the chain's input in _claims: the claims in position order
    c_lens, c_dists = (s_pay >> 16) & 0xFFFF, s_pay & 0xFFFF
    claims = cm._claims(s_key, s_pay, cp, torch.zeros_like(cand_d), cand_d,
                        lim_d, CH)
    packed = cm.pack_results(*claims, chunk=CH)
    n_rec = G * CH
    # operation counts: compares of n log2 n sorting (6 key words), of a
    # merge (6 words per output), ~15 word operations per probe, a few per
    # record for compaction and packing
    cases = {
        "sort_records": (
            lambda: sortnet.sort_records(recs, n_keys=6, unique=True),
            lambda: sortnet.sort_records_plain(recs, n_keys=6, unique=True),
            (recs,), n_rec * 16 * 6),
        "merge_sorted": (
            lambda: sortnet.merge_sorted(x, n_keys=6, unique=True),
            lambda: sortnet.merge_sorted_plain(x, n_keys=6, unique=True),
            (x,), 2 * n_rec * 6),
        "probe": (lambda: cm.probe(merged, cg, cp, lim_d, CH),
                  lambda: cm.probe_plain(merged, cg, cp, lim_d, CH),
                  (merged, cg, cp, lim_d),
                  2 * n_rec * 2 * len(cm.PROBES) * 15),
        # the bytes it must read: every key, and the payloads of the kept
        # records only (as many as s_pay's)
        "compact": (lambda: cm.compact(p_key, p_pay, CH),
                    lambda: cm.compact_plain(p_key, p_pay, CH),
                    (p_key, s_pay), 2 * n_rec * 3),
        # plain: the tensor loop the kernel replaces in _claims
        "chain": (lambda: sm.chain(c_lens, c_dists, cm.CHAIN_STEPS),
                  lambda: sm.chain_plain(c_lens, c_dists, cm.CHAIN_STEPS),
                  (c_lens, c_dists), n_rec * cm.CHAIN_STEPS * 6),
        "pack": (lambda: cm.pack_results(*claims, chunk=CH),
                 lambda: cm.pack_results_plain(*claims, chunk=CH),
                 tuple(claims), n_rec * 10),
    }
    results = check_kernels(torch, cases, "2", f"{G} x {CH} positions")
    require_one_launch(results, ("chain", "compact", "pack"), "2")
    log_sort_rate(_cuda, "2", "sort_records", results["sort_records"], recs,
                  False)
    log_sort_rate(_cuda, "2", "merge_sorted", results["merge_sorted"], x,
                  True)
    log_floor_rate("2", "probe", results["probe"],
                   probe_design_bytes(_cuda, merged, max(cm.PROBES)),
                   "staged tiles and halos + outputs")
    log_floor_rate("2", "compact", results["compact"],
                   nbytes(p_key, s_pay, s_key, s_pay),
                   "every key, the kept payloads, the outputs")
    log_floor_rate("2", "pack", results["pack"], nbytes(*claims, *packed),
                   "read once")
    n_heads = packed[2]
    log(f"[2] head counts: min {int(n_heads.min())} max {int(n_heads.max())}"
        f" mean {float(n_heads.float().mean()):.1f} (HEAD_CAP {cm.HEAD_CAP})")

    def group():
        return cm.match_chunks(halo, bufs_d, cand_d, cand_d, lim_d,
                               grp.cut_gram, grp.cut_pos, n_chunks=G,
                               chunk=CH)

    group_ms = cuda_ms(torch, group, 5)
    log(f"[2] match_chunks, one group ({G * CH} positions): "
        f"{group_ms:.3f} ms device = "
        f"{G * CH / group_ms / 1e3:.2f} MB/s device-only match rate")

    # -- phase 2b: sort-engine kernels against their plain versions --------
    disp = sort_dispatch(torch, np, dev, real)
    sbufs, sv, ev, scut, sfin = (disp.sbufs, disp.sv, disp.ev, disp.scut,
                                 disp.sfin)
    rec, srec = disp.rec, disp.srec
    B, n = pipeline.SEG_BATCH, sm.N_ENTRIES
    lens0, dists0, _ = sm.neighbor_scan(srec)
    rl_in = sbufs[:, :n].contiguous()
    work = scan_work(torch, srec)
    log(f"[2b] scan work on this dispatch: {work['slots']} slots, "
        f"{work['in_range']} probes in range, {work['compared']} compared "
        f"up to the first other gram, {work['live']} meet their gram, "
        f"{work['candidates']} candidates; {work['ops']} counted operations")
    scases = {
        "sort_records": (lambda: sortnet.sort_records(rec, n_keys=2),
                         lambda: sortnet.sort_records_plain(rec, n_keys=2),
                         (rec,), B * n * 17 * 3),
        "scan": (lambda: sm.neighbor_scan(srec),
                 lambda: sm.neighbor_scan_plain(srec),
                 (srec[:, 0], srec[:, 2:]), work["ops"]),
        "chain": (lambda: sm.chain(lens0, dists0, 14),
                  lambda: sm.chain_plain(lens0, dists0, 14),
                  (lens0, dists0), B * n * 14 * 6),
        "run_lengths": (lambda: pk.run_lengths(rl_in),
                        lambda: pk.run_lengths_plain(rl_in),
                        (rl_in,), B * n * 15),
    }
    sresults = check_kernels(torch, scases, "2b",
                             f"{B} x {n} records, one dispatch")
    require_one_launch(sresults, ("chain", "run_lengths"), "2b")
    scan_calls = sresults["scan"]["device_launches_per_call"]
    log(f"[2b] scan          {scan_calls:g} device launches a call (its "
        f"probe and unsort kernels; torch.profiler)")
    if scan_calls != 2:
        raise AssertionError(f"scan: {scan_calls} device launches a call, "
                             f"not 2")
    log_sort_rate(_cuda, "2b", "sort_records", sresults["sort_records"], rec,
                  False)
    results = {(k, "chunk"): v for k, v in results.items()}
    results["sort_records", "chunk"]["sort_engine"] = \
        sresults.pop("sort_records")
    results.update({(k, "sort"): v for k, v in sresults.items()})

    # library yardstick of the 2-key sort: one stable torch.sort of the two
    # key words packed into int64 (unsigned order), then a gather of the
    # planes; its ties keep position order, the kernel's break by pos_t
    def packed_sort():
        key = (((rec[:, 0].long() & 0xFFFFFFFF) - (1 << 31)) << 32) \
            | (rec[:, 1].long() & 0xFFFFFFFF)
        order = torch.sort(key, dim=-1, stable=True).indices
        return rec.gather(2, order[:, None].expand_as(rec))

    lib_ms = cuda_ms(torch, packed_sort, 10)
    lib_diff = int((packed_sort() != srec).any(1).sum())
    results["sort_records", "chunk"]["sort_engine"]["library_ms"] = lib_ms
    log(f"[2b] library yardstick: stable torch.sort of packed int64 keys + "
        f"gather {lib_ms:.4f} ms; records placed unlike the kernel (ties of "
        f"both key words): {lib_diff} of {B * n}")

    def dispatch():
        return sm.match_segments(sbufs, sv, ev, scut, sfin)

    disp_ms = cuda_ms(torch, dispatch, 5)
    disp_dev, disp_launches = device_ms(torch, dispatch, 3)
    searched = disp.searched
    log(f"[2b] match_segments, one dispatch ({B} rows, {searched} searched "
        f"positions): {disp_ms:.3f} ms device = "
        f"{searched / disp_ms / 1e3:.2f} MB/s device-only match rate; "
        f"profiler {disp_dev:.4f} ms device in {disp_launches:g} launches")

    # -- phase 2c: walk-engine kernels against their plain versions -------
    base, wk = mf.HALO, 64
    wg, wprev, wruns = mf.walk_inputs(sbufs, sv, ev, scut, base)
    wargs = (sbufs, wg, wprev, wruns, sv, ev, base, mf.SEG, wk, mf.EXT_CAP)
    work: dict = {}
    wconv = mf.walk_plain(*wargs, counts=work)[2]
    log(f"[2c] walk work on this dispatch: {work['hops']} candidate hops, "
        f"{work['ext_words']} extension words; converged "
        f"{float(wconv.float().mean()):.4%} of its {wconv.numel()} lanes")
    wcases = {
        "run_lengths": (lambda: pk.run_lengths(sbufs),
                        lambda: pk.run_lengths_plain(sbufs), (sbufs,),
                        B * mf.SEG_BUF * 15),
        "gram_hash": (lambda: pk.gram_hash(sbufs),
                      lambda: pk.gram_hash_plain(sbufs), (sbufs,),
                      B * mf.SEG_BUF * 8),
        "walk": (lambda: mf.walk(*wargs), lambda: mf.walk_plain(*wargs),
                 (sbufs, wg, wprev, wruns, sv, ev),
                 work["hops"] * WALK_OPS_PER_HOP
                 + work["ext_words"] * WALK_OPS_PER_WORD),
    }
    wresults = check_kernels(torch, wcases, "2c",
                             f"{B} x {mf.SEG_BUF} bytes, one dispatch, "
                             f"max_candidates={wk}")
    require_one_launch(wresults, ("run_lengths",), "2c")
    results.update({(k, "walk"): v for k, v in wresults.items()})
    staged, far, out_bytes = walk_stage_stats(torch, _cuda, wargs,
                                              mf.walk(*wargs))
    log(f"[2c] walk          staged {staged} bytes (predecessor windows "
        f"read as int32, bytes, run lengths), {far} reads outside the "
        f"staged window")
    log_floor_rate("2c", "walk", results["walk", "walk"],
                   staged + 32 * far + out_bytes,
                   "staged + one 32-byte sector a far read + outputs")

    def walk_dispatch():
        return mf.match_segments(sbufs, sv, ev, scut, max_candidates=wk)

    wdisp_ms = cuda_ms(torch, walk_dispatch, 5)
    log(f"[2c] walk match_segments, one dispatch ({B} rows, {searched} "
        f"searched positions): {wdisp_ms:.3f} ms device = "
        f"{searched / wdisp_ms / 1e3:.2f} MB/s device-only match rate")

    # -- phase 2d: worst cases of the chain, run lengths, compact, pack ----
    scan_direct = worst_cases(torch, np, _cuda, sm, pk, cm, dev, (G, CH),
                            (B, n), (B, mf.SEG_BUF), tuple(srec.shape))

    # -- phase 3: chunk engine end to end ---------------------------------
    def chunk_expected(data, block):
        groups = sum(-(-(min(s + block, len(data)) - s) // (G * CH))
                     for s in range(0, len(data), block))
        blocks = -(-len(data) // block)
        # one launch of each a group; the sort also sorts each block's halo
        return ({k: 0 for k in _cuda.LAUNCHES}
                | {k: groups for k in CHUNK_KERNELS}
                | {"sort_records": groups + blocks})

    launches = None
    made = []  # (name, data, stream) of every device encode, for phase 3d
    for name, data, legacy in (
            ("realcorpus", real, False),
            ("make_corpus_8MiB", bench.make_corpus(8 << 20), False),
            ("realcorpus_legacy", real, True)):
        block = fmt.MAX_BLOCK_SIZE_LEGACY if legacy else fmt.MAX_BLOCK_SIZE
        log(f"[3] chunk engine, {name}")
        counts, st, got = encode_run(torch, _cuda, native, pipeline, name,
                                     data, chunk_expected(data, block),
                                     legacy=legacy)
        made.append((name, data, got))
        if name == "realcorpus":
            chunk_rate = len(data) / st["wall_s"] / 1e6
        launches = launches or counts
    public = smallz4_tpu_torch.compress(real, 9)  # the default: the card
    if public != native.compress(real, 9):
        raise AssertionError("public API stream != native.compress")
    raw = pipeline.compress(real, 9, parity=False, device=dev)
    if native.decompress(raw) != real:
        raise AssertionError("parity=False stream does not round-trip")
    log(f"[3] public API (default engine and device) stream equal to native;"
        f" parity=False: {len(raw)} B, round-trips "
        f"({len(raw) / len(public) - 1:+.4%} vs parity)")

    # -- phase 3b: sort engine end to end ---------------------------------
    def sort_expected(data, block):
        segs = [-(-(min(s + block, len(data)) - s) // pipeline.SEG)
                for s in range(0, len(data), block)]
        n_disp = sum(-(-k // pipeline.SEG_BATCH) for k in segs)
        return {k: 0 for k in _cuda.LAUNCHES} | {k: n_disp
                                                  for k in SORT_KERNELS}

    sort_launches = None
    for name, block, kernel in (("realcorpus_1MiB", 1 << 20, None),
                                ("realcorpus_4MiB_sort", fmt.MAX_BLOCK_SIZE,
                                 "sort")):
        exp = sort_expected(real, block)
        log(f"[3b] sort engine, {name} ({exp['scan']} dispatches)")
        counts, _, got = encode_run(torch, _cuda, native, pipeline, name,
                                    real, exp, block_size=block,
                                    kernel=kernel)
        made.append((name, real, got))
        sort_launches = sort_launches or counts
    raw = pipeline.compress(real, 9, block_size=1 << 20, parity=False,
                            device=dev)
    if native.decompress(raw) != real:
        raise AssertionError("sort-engine parity=False stream does not "
                             "round-trip")
    log(f"[3b] sort engine parity=False (1 MiB blocks): {len(raw)} B, "
        f"round-trips")

    # -- phase 3c: walk engine end to end ---------------------------------
    exp = sort_expected(real, fmt.MAX_BLOCK_SIZE)
    n_disp = exp["scan"]
    exp = {k: 0 for k in _cuda.LAUNCHES} | {k: n_disp for k in WALK_KERNELS}
    log(f"[3c] walk engine, realcorpus_4MiB_walk ({n_disp} dispatches, "
        f"max_candidates=64)")
    walk_launches, _, got = encode_run(torch, _cuda, native, pipeline,
                                       "realcorpus_4MiB_walk", real, exp,
                                       block_size=fmt.MAX_BLOCK_SIZE,
                                       kernel="walk")
    made.append(("realcorpus_4MiB_walk", real, got))
    raw = pipeline.compress(real, 9, parity=False, kernel="walk", device=dev)
    if native.decompress(raw) != real:
        raise AssertionError("walk-engine parity=False stream does not "
                             "round-trip")
    log(f"[3c] walk engine parity=False (4 MiB blocks): {len(raw)} B, "
        f"round-trips")

    # -- phase 3d: device decode ------------------------------------------
    dframe = dictionary_frame(native, real)
    results["expand", "decode"] = expand_cases(torch, np, dev, real, made,
                                               dframe)
    decode_launches = decode_run(torch, np, _cuda, native, smallz4_tpu_torch,
                                 real, made, dframe)
    stages = decode_stages(torch, np, dev, made[0][2], real)
    log(f"[3d] decode stages, realcorpus at 4 MiB blocks (host clock, ms, "
        f"the blocks summed, medians of 3): parse {stages['parse']:.3f}, "
        f"pad+upload {stages['pad_upload']:.3f}, expand (synced) "
        f"{stages['expand']:.3f}, copy back {stages['copy_back']:.3f}; sum "
        f"{sum(v for k, v in stages.items() if k != 'decompress'):.3f}; "
        f"decompress(engine=\"device\") {stages['decompress']:.3f}")

    # -- phase 3e: the device-resident encode ------------------------------
    _, mib_blocks = resident_encode(torch, _cuda, native, pipeline, parse,
                                    real, 1 << 20, chunk_rate)
    resident_launches, big_blocks = resident_encode(
        torch, _cuda, native, pipeline, parse, real, fmt.MAX_BLOCK_SIZE,
        chunk_rate)
    results["parse", "resident"] = parse_cases(
        torch, np, native, parse, dev, mib_blocks, big_blocks[0])
    results["emit", "resident"] = emit_cases(
        torch, np, native, parse, emit, dev, real, big_blocks[0],
        results["parse", "resident"]["ms"])
    for name in RESIDENT_KERNELS[:-2]:  # phase 2's measurements
        results[name, "resident"] = {k: v for k, v
                                     in results[name, "chunk"].items()
                                     if k != "sort_engine"}

    results["sort_records", "chunk"]["sort_engine"]["launches"] = \
        sort_launches["sort_records"]
    results["scan_direct", "long rows"] = scan_direct
    path_launches = {"chunk": launches, "sort": sort_launches,
                     "walk": walk_launches, "decode": decode_launches,
                     "resident": resident_launches,
                     "long rows": {"scan_direct": scan_direct["launches"]}}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "path": path,
                "launches": path_launches[path][name],
                **results[name, path]} for name, src, rep, path in KERNELS]
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError(f"{k['name']} never launched on the "
                                 f"{k['path']} engine's path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
