#!/usr/bin/env python3
"""Time the policy-iteration DP (csrc/parse.cu s4_parse).

    python3 scripts/torch_parse_times.py [DIR ...]
    python3 scripts/torch_parse_times.py --cut SRC_DIR OUT_DIR

Runs on one CUDA card, on each tree given (default: this checkout), in the
order given, so that a parent and a change can be timed in turns in one
call (copy the parent's package into a git-ignored directory and give its
path, e.g. ``parent . . parent``).  Each tree runs in a process of its own,
so every tree loads its own package and builds its own kernel library.

The cases are made once, by this checkout's package in a process of their
own, and kept in its git-ignored ``smallz4_tpu_torch/build/``: the DP
inputs of the first 4 MiB block and of the ten 1 MiB blocks of the
device-resident encode of the real-data fixture (``chip_smoke.
resident_run``), and every worst case of phase 3e (``chip_smoke.
parse_worst``).  On every case each tree's kernel is compared with its
plain version (choice, cost, converged, rounds; printed, not enforced) and
timed five times: the mean of 3 calls after one by CUDA events, and from
torch.profiler traces of 3 calls the kernel's device time and its launches
a call.  Prints the card, then per tree and case the rounds and the
medians with the five readings.

``--cut`` writes a copy of SRC_DIR's package to OUT_DIR (give a directory
that ``.gitignore`` lists) whose ``parse.cu`` records, in block 0, the
SM clock at the kernel's start, after every grid barrier and at its end,
and holds a second kernel that only crosses grid barriers.  Timed like any
tree, such a copy also prints each case's time split by phase (the clock
between two records goes to the phase whose comment precedes the later
barrier, scaled to the kernel's median device time) and the time of the
same number of grid barriers alone on the same grid.  The kernel itself
keeps no switch for this.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent.parent
ROUNDS = 5
INPUTS = HERE / "smallz4_tpu_torch" / "build" / "parse_inputs.npz"
TRACE_MAX = 8192

# the cut copy's additions to parse.cu: the clock records of block 0 ...
TRACE_DEFS = f"""
__device__ long long s4_trace_t[{TRACE_MAX}];
__device__ int s4_trace_line[{TRACE_MAX}];
__device__ int s4_trace_n;

__device__ __forceinline__ void s4_trace(int line) {{
  if (blockIdx.x == 0 && threadIdx.x == 0) {{
    const int k = s4_trace_n;
    if (k < {TRACE_MAX}) {{
      s4_trace_t[k] = clock64();
      s4_trace_line[k] = line;
      s4_trace_n = k + 1;
    }}
  }}
}}

extern "C" int s4_trace_reset() {{
  const int zero = 0;
  return (int)cudaMemcpyToSymbol(s4_trace_n, &zero, sizeof zero);
}}

extern "C" int s4_trace_read(long long* t, int* line, int max) {{
  int k = 0;
  if (cudaMemcpyFromSymbol(&k, s4_trace_n, sizeof k) != cudaSuccess)
    return -1;
  k = k < max ? k : max;
  if (cudaMemcpyFromSymbol(t, s4_trace_t, k * sizeof(long long)) !=
          cudaSuccess ||
      cudaMemcpyFromSymbol(line, s4_trace_line, k * sizeof(int)) !=
          cudaSuccess)
    return -1;
  return k;
}}
"""
# ... and the kernel of grid barriers alone, on the DP's grid
BARRIER_KERNEL = """
namespace {
__global__ void __launch_bounds__(THREADS)
s4_barrier_kernel(unsigned long long* state, int k) {
  unsigned* count = reinterpret_cast<unsigned*>(state + 1);
  unsigned* gen = reinterpret_cast<unsigned*>(state + 2);
  unsigned* bar = count;
  (void)gen;
  (void)bar;
  for (int i = 0; i < k; ++i) CALL

}
}  // namespace

extern "C" int s4_parse_barriers(unsigned long long* state, int k, int N,
                                 void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, parse_kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (N + TILE - 1) / TILE;
  const int grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  void* args[] = {&state, &k};
  err = cudaLaunchCooperativeKernel((const void*)s4_barrier_kernel,
                                    dim3(grid), dim3(THREADS), args, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
"""
# a call of the kernel's grid barrier (its arguments are plain names)
GRID_SYNC = re.compile(r"grid_sync\(\w+(?:, \w+)*\);")
# a phase comment of the kernel's loop (P0..P5, E1..E3), at 2 or 4 spaces
PHASE = re.compile(r"^ {2,4}// ((?:P|E)\d[^:]*):")


def _helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _med(xs) -> str:
    return (f"{statistics.median(xs):.4f} "
            f"({', '.join(f'{x:.4f}' for x in xs)})")


def _edit(text: str, old: str, new: str, at_least: int = 1) -> str:
    if text.count(old) < at_least or (at_least == 1 and text.count(old) > 1):
        raise ValueError(f"parse.cu: {old!r} found {text.count(old)} times")
    return text.replace(old, new)


def make_cut(src: pathlib.Path, out: pathlib.Path) -> None:
    """Copy src's package to out with the clock records and the barrier
    kernel in parse.cu (see the module docstring)."""
    if out.exists():
        shutil.rmtree(out)
    shutil.copytree(src / "smallz4_tpu_torch", out / "smallz4_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    cu = out / "smallz4_tpu_torch" / "csrc" / "parse.cu"
    text = cu.read_text()
    text = _edit(text, "#include <stdint.h>\n",
                 "#include <stdint.h>\n" + TRACE_DEFS)
    call = GRID_SYNC.search(text).group(0)
    text = _edit(text, call, call + "\n    s4_trace(__LINE__);", 2)
    text = _edit(text, "warp = threadIdx.x >> 5;\n",
                 "warp = threadIdx.x >> 5;\n  s4_trace(__LINE__);\n")
    text = _edit(text, "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
                 "    flags[0]", "  s4_trace(__LINE__);\n"
                 "  if (blockIdx.x == 0 && threadIdx.x == 0) {\n    flags[0]")
    cu.write_text(text + BARRIER_KERNEL.replace("CALL", call))


def _labels(cu: pathlib.Path) -> dict:
    """Line number -> the phase comment above it (the kernel's start line:
    'start'; the record after the loop: 'last P4')."""
    labels, phase = {}, "start"
    for k, line in enumerate(cu.read_text().splitlines(), 1):
        m = PHASE.match(line)
        if m:
            phase = m.group(1)
        if "s4_trace(__LINE__)" in line:
            labels[k] = phase
        if "flags[0] = changed" in line:
            labels[k - 2] = "last P4"  # the record just before the flags
    return labels


def prepare() -> int:
    """The cases, by this checkout's package, saved to INPUTS."""
    cs = _helpers()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch

    from smallz4_tpu_torch import native
    from smallz4_tpu_torch.ops import _cuda, parse, pipeline

    dev = torch.device("cuda", 0)
    real = cs.real_corpus()
    mib = cs.resident_run(torch, _cuda, pipeline, parse, real, 1 << 20)[4]
    big = cs.resident_run(torch, _cuda, pipeline, parse, real, 4 << 20)[4]
    cases = {"realcorpus 4 MiB block 0": (big[0]["lens"], big[0]["dists"],
                                          big[0]["n"], 48)}
    for k, b in enumerate(mib):
        cases[f"realcorpus 1 MiB block {k}"] = (b["lens"], b["dists"],
                                                b["n"], 48)
    cases.update(cs.parse_worst(torch, np, native, dev, mib[0], big[0]))
    arrays, keys, meta = {}, {}, []
    for name, (lens, dists, n, max_iters) in cases.items():
        pair = []
        for t in (lens, dists):
            if t.data_ptr() not in keys:
                keys[t.data_ptr()] = f"a{len(arrays)}"
                arrays[keys[t.data_ptr()]] = t.cpu().numpy()
            pair.append(keys[t.data_ptr()])
        meta.append([name, *pair, int(n), int(max_iters)])
    tmp = INPUTS.with_suffix(".tmp.npz")
    np.savez(tmp, meta=np.asarray(json.dumps(meta)), **arrays)
    tmp.replace(INPUTS)
    return 0


def _split(torch, lib, kern, labels: dict) -> tuple[dict, int]:
    """One traced call: label -> [clock cycles, records], and the grid
    barriers crossed."""
    torch.cuda.synchronize()
    if lib.s4_trace_reset() != 0:
        raise RuntimeError("s4_trace_reset failed")
    kern()
    torch.cuda.synchronize()
    t = (ctypes.c_longlong * TRACE_MAX)()
    line = (ctypes.c_int * TRACE_MAX)()
    k = lib.s4_trace_read(t, line, TRACE_MAX)
    if k < 2:
        raise RuntimeError(f"s4_trace_read gave {k} records")
    parts: dict = {}
    for j in range(1, k):
        part = parts.setdefault(labels[line[j]], [0, 0])
        part[0] += t[j] - t[j - 1]
        part[1] += 1
    return parts, k - 2


def time_tree(root: pathlib.Path) -> int:
    cs = _helpers()
    sys.path[:0] = [str(root), str(HERE)]  # the package from the tree first
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from smallz4_tpu_torch.ops import _cuda, parse

    dev = torch.device("cuda", 0)
    lib = _cuda.lib()
    traced = hasattr(lib, "s4_trace_read")
    if traced:
        lib.s4_trace_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
        lib.s4_parse_barriers.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_void_p]
        labels = _labels(root / "smallz4_tpu_torch" / "csrc" / "parse.cu")
    print(f"{cs.card_line()} | tree {root}{' (cut copy)' if traced else ''}",
          flush=True)
    data = np.load(INPUTS)
    for name, lk, dk, n, max_iters in json.loads(str(data["meta"])):
        lens, dists = (torch.from_numpy(data[k]).to(dev) for k in (lk, dk))

        def kern(lens=lens, dists=dists, n=n, max_iters=max_iters):
            return parse.policy_iteration(lens, dists, n, max_iters)

        got = kern()
        equal = all(torch.equal(g, w) for g, w in zip(
            got, parse.policy_iteration_plain(lens, dists, n, max_iters)))
        ev, dv, per = [], [], set()
        for _ in range(ROUNDS):
            ev.append(cs.cuda_ms(torch, kern, 3))
            d, launches = cs.device_ms(torch, kern, 3, "parse", own=True)
            dv.append(d)
            per.add(launches)
        print(f"{name}: N {lens.shape[0]}, n {n}, max_iters {max_iters}, "
              f"rounds {int(got[3])}, converged {bool(got[2])}, equal to "
              f"plain {equal}; device ms {_med(dv)}; events ms {_med(ev)}; "
              f"launches a call {sorted(per)}", flush=True)
        if not traced:
            continue
        parts, barriers = _split(torch, lib, kern, labels)
        total = sum(c for c, _ in parts.values())
        ms = statistics.median(dv)
        state = _cuda.tile_state("parse", dev, 5)[0]
        stream = torch.cuda.current_stream(dev).cuda_stream

        def alone(state=state, N=lens.shape[0], k=barriers, s=stream):
            if lib.s4_parse_barriers(state.data_ptr(), k, N, s) != 0:
                raise RuntimeError("s4_parse_barriers failed")

        b_ms = statistics.median(cs.cuda_ms(torch, alone, 3)
                                 for _ in range(ROUNDS))
        print(f"  split by phase (block 0's clock, of {ms:.4f} ms): "
              + "; ".join(f"{k} {c / total * ms:.4f} ms in {r} records"
                          for k, (c, r) in parts.items())
              + f"; {barriers} grid barriers alone {b_ms:.4f} ms "
              f"({b_ms / max(barriers, 1) * 1e3:.2f} us each)", flush=True)
    return 0


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--cut"] and len(args) == 3:
        make_cut(pathlib.Path(args[1]).resolve(),
                 pathlib.Path(args[2]).resolve())
        return 0
    if args[:1] == ["--prepare"]:
        return prepare()
    if args[:1] == ["--tree"]:
        return time_tree(pathlib.Path(args[1]))
    if not INPUTS.is_file():
        INPUTS.parent.mkdir(parents=True, exist_ok=True)
        rc = subprocess.run([sys.executable, __file__, "--prepare"]).returncode
        if rc:
            return rc
    rc = 0
    for root in [pathlib.Path(a).resolve() for a in args] or [HERE]:
        rc |= subprocess.run([sys.executable, __file__, "--tree",
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
