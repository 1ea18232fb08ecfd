#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on CUDA device 0.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell from BENCHMARK.json, makes its inputs from the seed, sets
up the program, warms up the cell's shapes, measures for --seconds in a
closed loop, checks the sampled answers against the plain reference, and
prints one JSON line last on standard output. --trace 1 reports the
per-layer metrics (synced spans and a profiler trace) in place of the
end-to-end ones. Each compared number and its limit are the last lines
on standard error. Exits non-zero, with no result, without enough CUDA
devices, when the program cannot be imported, or when JAX or the JAX
package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Build and kernel caches at fixed paths inside the checkout.
    cache = REPO / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    from portbench import harness

    cell = harness.Cell.load(harness.load_benchmark(REPO / "BENCHMARK.json"), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    print(f"portbench: {cell.name} seed {args.seed} on {card_line()}", file=sys.stderr, flush=True)
    try:
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    except harness.BannedImport as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
