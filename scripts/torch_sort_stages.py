#!/usr/bin/env python3
"""Stage times of the port's record sort (csrc/sortnet.cu) on one CUDA card.

    python3 scripts/torch_sort_stages.py

Run from the repository root.  At the main path's two sort shapes (the
chunk group's [64, 6, 65536] with 6 keys, unique; the sort engine's
[8, 5, 2^17] with 2 keys and the pos tiebreak), it times with CUDA events
the whole sort, the tile sort alone (the same records cut into rows of one
tile) and each merge pass alone (merge_sorted on rows of two sorted runs of
the pass's width), and prints each stage's GB/s over the bytes it moves
(one read and one write of the array) beside the card's name and power
limit.  Each shape runs twice: on the records that chip_smoke.py's phases 2
and 2b build from the committed real-data fixture (text, so the first two
key words often tie), and on random records, seeded.  Keys are distinct in
both, as on the main path.
"""
from __future__ import annotations

import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from smallz4_tpu_torch import format as fmt  # noqa: E402
from smallz4_tpu_torch.ops import _cuda, pipeline, sortnet  # noqa: E402
from smallz4_tpu_torch.ops import chunkmatch as cm  # noqa: E402
from smallz4_tpu_torch.ops import sortmatch as sm  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def cuda_ms(fn, reps: int = 20) -> float:
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


def records(seed: int, B: int, P: int, n: int, n_keys: int, unique: bool):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (B, P, n), dtype=np.uint64).astype(np.uint32)
    pos = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.uint32)
    if unique:  # the last key carries the position, as combo does
        x[:, n_keys - 1] = (x[:, n_keys - 1] & ~np.uint32(n - 1)) | pos
    else:  # pos as the signed tiebreak
        x[:, n_keys] = pos
    return torch.from_numpy(x.view(np.int32)).cuda()


def real_records() -> tuple[torch.Tensor, torch.Tensor]:
    """The chunk group's and the sort-engine dispatch's records of
    chip_smoke.py phases 2 and 2b."""
    dev = torch.device("cuda")
    data = chip_smoke.real_corpus()
    start = cm.GROUP * cm.CHUNK
    bs = min(fmt.MAX_BLOCK_SIZE, len(data) - start)
    bufs, cand, *_ = chip_smoke.group_inputs(np, cm, fmt, data, start, bs)
    chunk = cm.make_records(torch.from_numpy(bufs).to(dev), 0,
                            torch.from_numpy(cand).to(dev), chunk=cm.CHUNK)
    s_start = 1 << 20
    arrays = pipeline.segment_group(
        np.frombuffer(data, np.uint8), s_start, s_start + 7 * pipeline.SEG,
        list(range(s_start, s_start + 7 * pipeline.SEG, pipeline.SEG)),
        False, True)
    sbufs, sv, ev, scut, _ = (torch.from_numpy(a).to(dev) for a in arrays)
    return chunk, sm.segment_records(sbufs, sv, ev, scut)[0]


def rows_of(x: torch.Tensor, width: int) -> torch.Tensor:
    """[B, P, n] -> [B * n / width, P, width]: the same records in rows of
    `width`."""
    B, P, n = x.shape
    return (x.view(B, P, n // width, width).permute(0, 2, 1, 3)
            .reshape(B * n // width, P, width).contiguous())


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    _cuda.lib()
    chunk, seg = real_records()
    for name, (x, k, u) in {
            "real chunk sort [64, 6, 65536], 6 keys, unique": (chunk, 6, True),
            "random chunk sort": (records(1, 64, 6, 1 << 16, 6, True), 6,
                                  True),
            "real sort-engine sort [8, 5, 2^17], 2 keys + tiebreak": (
                seg, 2, False),
            "random sort-engine sort": (records(2, 8, 5, 1 << 17, 2, False),
                                        2, False),
    }.items():
        B, P, n = x.shape
        size = x.numel() * 4
        tile = _cuda.lib().s4_sort_tile(n)
        stages = [("whole sort", lambda: sortnet.sort_records(x, k, unique=u),
                   None)]
        tiles = rows_of(x, tile)
        stages.append((f"tile sort ({tile})",
                       lambda: sortnet.sort_records(tiles, k, unique=u), 2))
        w = tile
        while w < n:
            runs = sortnet.sort_records(rows_of(x, w), k, unique=u)
            pairs = runs.view(B * n // (2 * w), 2, P, w).permute(0, 2, 1, 3) \
                .reshape(B * n // (2 * w), P, 2 * w).contiguous()
            stages.append((f"merge pass w={w}",
                           lambda p=pairs: sortnet.merge_sorted(p, k, unique=u),
                           2))
            w *= 2
        print(f"{name}: {size / 1e6:.2f} MB, tile {tile}")
        total = 0.0
        for label, fn, mult in stages:
            ms = cuda_ms(fn)
            if mult is None:
                print(f"  {label:22s} {ms:.4f} ms")
                continue
            total += ms
            rate = mult * size / (ms / 1e3)
            print(f"  {label:22s} {ms:.4f} ms  {rate / 1e9:.1f} GB/s "
                  f"({rate / HBM_BYTES_PER_S:.1%} of 3.35 TB/s)")
        print(f"  {'sum of stages':22s} {total:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
