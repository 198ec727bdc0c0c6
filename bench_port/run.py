"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control 1 | --fault <name>]

From the root of a checkout.  The cell, its configuration, its traffic and
its metrics are found by name from ``BENCHMARK.json`` (see
``lib/harness.py``).  Needs a CUDA card: without one, or with fewer cards
than the cell asks for, it exits with code 2 and prints no result.  The
last line of standard output is the result's JSON object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the last key of the result.  ``--control 1`` runs the
configuration's control in the program's place, and ``--fault <name>``
breaks the timed path as ``faults/<name>.py`` says: both prove that the
check fails; the benchmark's own runs never do either.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()

    # every cache of the run at a fixed path inside the checkout; the
    # program builds its kernels into smallz4_tpu_torch/build/
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    from bench_port.lib import devtrace, harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(bench, args.workload)

    import torch

    chips = int(cell.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    import smallz4_tpu_torch  # noqa: F401
    import smallz4_tpu_torch.ops.pipeline  # noqa: F401
    if "jax" in sys.modules or any(m.startswith("smallz4_tpu.")
                                   or m == "smallz4_tpu"
                                   for m in sys.modules):
        print("the JAX package was imported", file=sys.stderr)
        return 2

    if args.fault:
        harness.load_py("faults", args.fault).install(setattr)
    print(f"card: {devtrace.card_line()}", flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         T_START, control=bool(args.control))
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
