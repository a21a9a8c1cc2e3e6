"""The benchmark of crop2seg_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json: set-up (weights and inputs made on the
card from the seed, the warm-up), a window of ``--seconds`` of the cell's
traffic, the comparison with the plain reference, and one JSON result line
as the last line of standard output (the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``). The numbers compared
are the last lines of standard error, each beside its limit.

    python3 portbench/run.py --workload <cell> --seed <n> --calibrate 12

prints, for 12 seeds from ``--seed`` on, the compared numbers of the
program and, on the first three, of the control and the faults: the
readings that ``limits/<cell>.json`` is set from. No window, no result
line.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def _environment() -> None:
    """Keep every cache inside the checkout, at fixed paths, JAX out of
    libraries that would load it, and the host's thread pools at one thread
    (the timed paths run on the card; idle pool threads only contend with
    the thread that issues the work)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", type=int, default=0,
                    help="print the compared numbers of this many seeds and stop")
    args = ap.parse_args()
    _environment()

    import torch

    from portbench.harness import common

    try:
        run = common.make_run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                              T_START)
    except LookupError as e:
        print(e, file=sys.stderr)
        return 2
    chips = run.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from portbench.harness import program, serve, train

    run.program = program
    driver = {"tile": serve, "train": train}[run.mix["kind"]]
    if args.calibrate:
        driver.calibrate(run, [args.seed + i for i in range(args.calibrate)])
        print(f"card: {_card()}", file=sys.stderr)
        return 0
    result = driver.run_cell(run)
    trace = result.pop("trace")
    if trace is not None:
        common.write_summary(run, trace)
        result["breakdown"] = common.breakdown(trace)
    result["checks"] = result.pop("checks")           # the last key of the line
    found = common.loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {_card()}", file=sys.stderr)
    print("set-up: " + ", ".join(f"{stage} {t:.2f} s" for stage, t in run.marks),
          file=sys.stderr)
    gaps = sorted(b - a for a, b in zip(run.unit_ends, run.unit_ends[1:]))
    print(f"units issued: {len(gaps)}, host seconds each: min {gaps[0]:.4f}, median "
          f"{gaps[len(gaps) // 2]:.4f}, max {gaps[-1]:.4f}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
