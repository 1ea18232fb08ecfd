#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on CUDA device 0.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds 3] [--out readings.json]

Runs the cell once per seed in this one process, as run.py does (short
window, the same sampled check), and prints each compared number: the
program's runs give the lower readings. With --control-seeds it also runs
the control, the reference in TF32 put in the program's place
(entries' `control`), whose numbers are the upper readings. Writes every
result to --out as JSON lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(harness.load_benchmark(REPO / "BENCHMARK.json"), args.workload)
    lines = []
    for control, group in ((False, args.seeds), (True, args.control_seeds)):
        for seed in group:
            out = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                                   control=control)
            row = {"workload": cell.name, "side": "control" if control else "program", "seed": seed,
                   "correct": out["correct"], "attempted": out["attempted"],
                   "checks": {k: v["value"] for k, v in out["checks"].items()},
                   "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
            print(json.dumps(row), flush=True)
            lines.append(row)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
