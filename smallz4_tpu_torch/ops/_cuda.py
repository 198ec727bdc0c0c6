"""Build, binding and launch counters for the hand-written CUDA kernels.

The sources in ``smallz4_tpu_torch/csrc/*.cu`` expose a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` (one process per
source, all started together) and linked into
``smallz4_tpu_torch/build/libs4kernels.so``, which is rebuilt whenever a
source or flag changes (a stamp file beside it holds their hash) and loaded
with ``ctypes``.  A file lock makes concurrent processes build it once.
Every entry point returns ``cudaGetLastError()`` after its launches; a
non-zero code raises here.

``LAUNCHES`` counts, per kernel wrapper, the calls that went to the card.
``tile_state`` keeps the tile counter and status words of the kernels whose
tiles wait on earlier tiles (run lengths, block expansion, the sequence
emit), and the grid barrier and round flags of the parse.  Nothing is
imported or built when this module is imported.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
LIB_NAME = "libs4kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: wrapper name -> number of launches on a CUDA device
LAUNCHES = {"sort_records": 0, "merge_sorted": 0, "probe": 0, "compact": 0,
            "pack": 0, "scan": 0, "scan_direct": 0, "chain": 0,
            "chain_wide": 0, "run_lengths": 0, "gram_hash": 0, "walk": 0,
            "expand": 0, "parse": 0, "emit": 0}
EPOCH_MAX = (1 << 30) - 1  # epochs of the status words of tile_state

_lock = threading.Lock()
_lib = None
#: (kernel, device index, stream handle) -> [state, epoch of its last call]
_STATE: dict = {}
_STATE_LOCK = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # in, out, tmp, B, P, n, n_keys, unique, stream
    "s4_sort_records": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, B, P, n, n_keys, unique, stream
    "s4_merge_halves": [_P, _P, _I, _I, _I, _I, _I, _P],
    # n -> records per tile of s4_sort_records (no launch)
    "s4_sort_tile": [_I],
    # planes, payload, key, cut_gram, cut_pos, match_limit, B, n, chunk,
    # probes (host int32 array), n_probes, stream
    "s4_probe": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P],
    # -> slots a block of s4_probe covers (no launch)
    "s4_probe_tile": [],
    # key, payload, okey, opay, B, n, chunk, stream
    "s4_compact": [_P, _P, _P, _P, _I, _I, _I, _P],
    # -> the largest chunk and row count of s4_compact (no launch)
    "s4_compact_max_chunk": [],
    "s4_compact_max_rows": [],
    # lens, dists, conv, lk, bits, packed, count, cbits, kbits, B, chunk,
    # stream
    "s4_pack": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # -> the largest chunk and row count of s4_pack (no launch)
    "s4_pack_max_chunk": [],
    "s4_pack_max_rows": [],
    # rec, olen, odist, oflag, entries, table, B, n, stream
    "s4_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # rec, olen, odist, oflag, B, n, stream
    "s4_scan_direct": [_P, _P, _P, _P, _I, _I, _P],
    # -> longest row and most rows of s4_scan, most records of a batch the
    # wrapper sends to s4_scan_direct (no launch)
    "s4_scan_row_max": [],
    "s4_scan_max_rows": [],
    "s4_scan_direct_max": [],
    # n -> int32 words of s4_scan's table a row (no launch)
    "s4_scan_table_row": [_I],
    # lens, dists, out, B, n, steps, stream
    "s4_chain": [_P, _P, _P, _I, _I, _I, _P],
    # -> longest row of s4_chain (no launch)
    "s4_chain_row_max": [],
    # lens, dists, out, tmp, B, n, steps, stream
    "s4_chain_wide": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, out, state, B, n, epoch, stream
    "s4_run_lengths": [_P, _P, _P, _I, _I, ctypes.c_uint, _P],
    # -> bytes a block of s4_run_lengths scans (no launch)
    "s4_run_lengths_tile": [],
    # x, grams, hashes, B, n, stream
    "s4_gram_hash": [_P, _P, _P, _I, _I, _P],
    # ctx, grams, prev, runs, start_valid, end_valid, lens, dists, conv, B,
    # n, base, search_len, max_candidates, ext_cap, stats (uint64 [2] or
    # null), stream
    "s4_walk": [_P] * 9 + [_I] * 6 + [_P, _P],
    # payload, hist, ends, lit_len, match_len, match_off, lit_src, out,
    # ptrs, state, B, pc, sc, oc, epoch, stream
    "s4_expand": [_P] * 10 + [_I] * 4 + [ctypes.c_uint, _P],
    # -> output positions a block of s4_expand resolves (no launch)
    "s4_expand_tile": [],
    # lens, dists, choice, cost, flags, scratch, state, N, n, max_iters,
    # epoch, stream
    "s4_parse": [_P] * 7 + [_I] * 3 + [ctypes.c_uint, _P],
    # -> the most positions of s4_parse; N -> its scratch bytes (no launch)
    "s4_parse_max_n": [],
    "s4_parse_scratch_bytes": [_I],
    # block, lens, dists, out, meta, scratch, state, N, epoch, stream
    "s4_emit": [_P] * 7 + [_I, ctypes.c_uint, _P],
    # -> the most positions of s4_emit; N -> its status and scratch words
    # (no launch)
    "s4_emit_max_n": [],
    "s4_emit_status_words": [_I],
    "s4_emit_scratch_words": [_I],
}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first failure; return
    their joined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n"
                               f"{out}")
    return "".join(outs)


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels unless the library matches the current sources;
    returns (library path, compiler log of this build or '')."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / (LIB_NAME + ".lock"), "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)  # released when the file closes
        if (lib_path.is_file() and stamp.is_file()
                and stamp.read_text() == digest):
            return lib_path, ""
        nvcc = _nvcc()
        tag = f"{os.getpid()}"
        objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in _sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(_sources(), objs)])
        tmp = BUILD_DIR / f".{LIB_NAME}.{tag}"
        log += _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, lib_path)  # atomic: a loader sees old or new
        stamp.write_text(digest)
    (BUILD_DIR / "nvcc.log").write_text(log)
    return lib_path, log


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            handle = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.s4_error_string.argtypes = [ctypes.c_int]
            handle.s4_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check_inputs(*tensors: torch.Tensor) -> None:
    """Kernel inputs: one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """The kernels read 16-byte words: copy a view that starts off that
    boundary."""
    return x.clone() if x.data_ptr() % 16 else x


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel route), False for a CPU tensor (the
    plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def tile_state(kernel: str, device: torch.device,
               tiles: int) -> tuple[torch.Tensor, int]:
    """The state of ``kernel``'s next call on ``device``'s current stream
    and the call's epoch: int64 words, word 0 the tile counter, then room
    for ``tiles`` status words.  Zeroed when made, grown, or when the
    epochs run out; otherwise reused, since a status word carries the epoch
    of the call that wrote it and a call's epoch is unique on its stream."""
    key = (kernel, device.index, torch.cuda.current_stream(device).cuda_stream)
    with _STATE_LOCK:
        entry = _STATE.get(key)
        if (entry is None or entry[0].numel() < tiles + 1
                or entry[1] >= EPOCH_MAX):
            entry = [torch.zeros(tiles + 1, dtype=torch.int64,
                                 device=device), 0]
            _STATE[key] = entry
        entry[1] += 1
        return entry[0], entry[1]


def launch(counter: str, fn: str, device: torch.device, *args) -> None:
    """Call entry point ``fn`` on ``device``'s current stream; raise on an
    error, count the launch otherwise."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, fn)(*args, stream)
    if err != 0:
        msg = handle.s4_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")
    LAUNCHES[counter] += 1
