#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (smallz4_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the repository root; needs one CUDA device and nvcc, no network
and no arguments.  Phases:

  0. card: name and power limit (nvidia-smi); no CUDA -> exit 2;
  1. build: compile csrc/*.cu for sm_90a (timed);
  2. kernels: on one full group (64 chunks x 64 Ki positions) of the
     committed real-data fixture, each CUDA kernel against its plain
     PyTorch version on the card, exact equality, both timed with CUDA
     events; plus the device time of one whole match_chunks group;
  3. end to end, with SMALLZ4_TPU_CPU_ASSIST=0 so every block goes through
     the device: the port's compress(data, 9) on the 10 MB fixture (modern
     and legacy frames) and on make_corpus(8 MiB) must equal
     native.compress byte for byte and decode back; one parity=False
     stream must round-trip; launch counters must match the groups run.

Prints a {"kernels": [...]} JSON line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Any failure raises (exit != 0) before
that line.
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

ROOT = pathlib.Path(__file__).resolve().parent
FIXTURE = ROOT / "benchdata" / "realcorpus.bin.xz"

KERNELS = [  # (counter, source, replaced TPU kernel)
    ("sort_records", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:164"),
    ("merge_sorted", "smallz4_tpu_torch/csrc/sortnet.cu",
     "smallz4_tpu/ops/sortnet.py:276"),
    ("probe", "smallz4_tpu_torch/csrc/probe.cu",
     "smallz4_tpu/ops/chunkmatch.py:199"),
    ("compact", "smallz4_tpu_torch/csrc/compact.cu",
     "smallz4_tpu/ops/chunkmatch.py:396"),
    ("pack", "smallz4_tpu_torch/csrc/pack.cu",
     "smallz4_tpu/ops/chunkmatch.py:428"),
]


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


def max_err(torch, got, want) -> int:
    """Largest absolute difference of two integer results (tuples too)."""
    if isinstance(got, tuple):
        return max(max_err(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} "
                             f"!= {tuple(want.shape)} {want.dtype}")
    return int((got.long() - want.long()).abs().max())


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
    from smallz4_tpu import format as fmt
    from smallz4_tpu import native
    from smallz4_tpu_torch.ops import _cuda, sortnet
    from smallz4_tpu_torch.ops import chunkmatch as cm
    from smallz4_tpu_torch.ops import pipeline

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
    if native._load() is None:  # builds native/libtlz4.so if missing
        raise RuntimeError("native runtime missing and not buildable")
    log(f"[1] native runtime ready in {time.perf_counter() - t:.3f} s")

    # -- phase 2: kernels against their plain versions ---------------------
    real = real_corpus()
    CH, G = cm.CHUNK, cm.GROUP
    start = G * CH  # block 1: live boundary cut and a history halo
    bs = min(fmt.MAX_BLOCK_SIZE, len(real) - start)
    bufs, cand, lim, hb, cut_gram, cut_pos = group_inputs(
        np, cm, fmt, real, start, bs)
    bufs_d = torch.from_numpy(bufs).to(dev)
    cand_d = torch.from_numpy(cand).to(dev)
    lim_d = torch.from_numpy(lim).to(dev)
    halo = cm.sort_chunk(torch.from_numpy(hb).to(dev), 0, CH, chunk=CH)
    first = torch.arange(G, device=dev) == 0
    cg = torch.where(first, cut_gram, 0).to(torch.int32)
    cp = torch.where(first, cut_pos, -1).to(torch.int32)

    recs = cm.make_records(bufs_d, 0, cand_d, chunk=CH)
    srt = sortnet.sort_records(recs, n_keys=6, unique=True)
    x = cm._merged_input(torch.cat([halo[None], srt[:-1]]), srt, CH)
    merged = sortnet.merge_sorted(x, n_keys=6, unique=True)
    p_pay, p_key = cm.probe(merged, cg, cp, lim_d, CH)
    s_key, s_pay = cm.compact(p_key, p_pay, CH)
    claims = cm._claims(s_key, s_pay, cp, torch.zeros_like(cand_d), cand_d,
                        lim_d, CH)
    packed = cm.pack_results(*claims, chunk=CH)
    cases = {
        "sort_records": (
            lambda: sortnet.sort_records(recs, n_keys=6, unique=True),
            lambda: sortnet.sort_records_plain(recs, n_keys=6, unique=True)),
        "merge_sorted": (
            lambda: sortnet.merge_sorted(x, n_keys=6, unique=True),
            lambda: sortnet.merge_sorted_plain(x, n_keys=6, unique=True)),
        "probe": (lambda: cm.probe(merged, cg, cp, lim_d, CH),
                  lambda: cm.probe_plain(merged, cg, cp, lim_d, CH)),
        "compact": (lambda: cm.compact(p_key, p_pay, CH),
                    lambda: cm.compact_plain(p_key, p_pay, CH)),
        "pack": (lambda: cm.pack_results(*claims, chunk=CH),
                 lambda: cm.pack_results_plain(*claims, chunk=CH)),
    }
    results = {}
    for name, (kern, plain) in cases.items():
        err = max_err(torch, kern(), plain())
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3)
        log(f"[2] {name:13s} max_abs_err {err} (tolerance 0: exact "
            f"integers)  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  ({G} x {CH} positions)")
        if err != 0:
            raise AssertionError(f"{name}: kernel != plain (max err {err})")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    n_heads = packed[2]
    log(f"[2] head counts: min {int(n_heads.min())} max {int(n_heads.max())}"
        f" mean {float(n_heads.float().mean()):.1f} (HEAD_CAP {cm.HEAD_CAP})")

    def group():
        return cm.match_chunks(halo, bufs_d, cand_d, cand_d, lim_d, cut_gram,
                               cut_pos, n_chunks=G, chunk=CH)

    group_ms = cuda_ms(torch, group, 5)
    log(f"[2] match_chunks, one group ({G * CH} positions): "
        f"{group_ms:.3f} ms device = "
        f"{G * CH / group_ms / 1e3:.2f} MB/s device-only match rate")

    # -- phase 3: end to end ----------------------------------------------
    def expected(data, legacy, block):
        groups = sum(-(-(min(s + block, len(data)) - s) // (G * CH))
                     for s in range(0, len(data), block))
        blocks = -(-len(data) // block)
        return {"sort_records": groups + blocks, "merge_sorted": groups,
                "probe": groups, "compact": groups, "pack": groups}

    runs = [("realcorpus", real, False),
            ("make_corpus_8MiB", bench.make_corpus(8 << 20), False),
            ("realcorpus_legacy", real, True)]
    launches = None
    for name, data, legacy in runs:
        block = fmt.MAX_BLOCK_SIZE_LEGACY if legacy else fmt.MAX_BLOCK_SIZE
        t = time.perf_counter()
        want = native.compress(data, 9, legacy=legacy)
        native_s = time.perf_counter() - t
        stats: dict = {}
        _cuda.reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = pipeline.compress(data, 9, legacy=legacy, device=dev,
                                stats=stats)
        wall = time.perf_counter() - t
        counts = dict(_cuda.LAUNCHES)
        if launches is None:
            launches = counts
        if got != want:
            raise AssertionError(f"{name}: stream != native.compress(data, 9)"
                                 f" ({len(got)} vs {len(want)} bytes)")
        if native.decompress(got) != data:
            raise AssertionError(f"{name}: native.decompress round trip")
        exp = expected(data, legacy, block)
        if counts != exp:
            raise AssertionError(f"{name}: launches {counts} != {exp}")
        log(f"[3] {name}: {len(data)} B -> {len(got)} B, equal to native; "
            f"{len(data) / wall / 1e6:.3f} MB/s e2e ({wall:.3f} s); device "
            f"span of the match calls {stats['device_match_ms']:.3f} ms; "
            f"refine {stats['n_refine_positions']}/{stats['n_positions']} "
            f"positions; launches {counts}")
        log(f"    native.compress {len(data) / native_s / 1e6:.3f} MB/s "
            f"({native_s:.3f} s); host clock: dispatch "
            f"{stats['device_dispatch']:.3f} s, collect "
            f"{stats['device_sync']:.3f} s, refine+DP+emit tail "
            f"{stats['host_refine_dp_emit']:.3f} s")
    public = smallz4_tpu_torch.compress(real, 9, engine="device", device=dev)
    if public != native.compress(real, 9):
        raise AssertionError("public API stream != native.compress")
    raw = pipeline.compress(real, 9, parity=False, device=dev)
    if native.decompress(raw) != real:
        raise AssertionError("parity=False stream does not round-trip")
    log(f"[3] public API stream equal to native; parity=False: {len(raw)} B,"
        f" round-trips ({len(raw) / len(public) - 1:+.4%} vs parity)")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **results[name]} for name, src, rep in KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
