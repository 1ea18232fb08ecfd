"""Cells of BENCHMARK.json cut to a size the CPU tests hold."""

from __future__ import annotations

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

RAW = harness.load_json(REPO / "BENCHMARK.json")
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]   # BENCHMARK.json's, then withheld.json's
SIZES = {"clustered": {"rows": 2048}, "notes": {"notes": 600}}


def cell(name: str) -> harness.Cell:
    c = harness.Cell.load(BENCH, name)
    c.config["corpus"].update(SIZES[c.config["corpus"]["generator"]])
    c.traffic["pool"] = 2 * c.traffic["batch"] if c.traffic["batch"] > 1 else 64
    return c


def run(name: str, seed: int = 2**31 + 7, trace: bool = False, control: bool = False,
        seconds: float = 0.3) -> dict:
    import time

    return harness.run_cell(cell(name), seed, seconds, trace, "cpu", time.perf_counter(),
                            control=control)
