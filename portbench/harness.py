"""One run of one benchmark cell: set-up, warm-up, a timed window, the check.

A cell of BENCHMARK.json names a configuration (configs/<config>.json) and
a traffic mix (traffic/<mix>.json). The configuration names its corpus
generator (corpora/<generator>.py); the mix names its entry module
(entries/<entry>.py); each metric of BENCHMARK.json is read by
metrics/<name>.py. Nothing in this file names a cell, a configuration, a
mix or a metric, so a new one is new files and new BENCHMARK.json entries.

An entry module is a module with:
  setup(ctx) -> system          the program's set-up on ctx.device
  control(ctx) -> system        the reference in a lower precision, with
                                the system's surface (calibrate.py only)
  requests(ctx) -> list         the cell's calls, cycled in the window
  call(system, request) -> out  one call; its results are on the host
  size(request) -> int          queries in the call
  span_points(system) -> [(owner, attribute, span name)]   traced run
  work(system, ctx) -> dict     shapes the metric readers need
  check(ctx, samples) -> {name: (value, limit)}   the plain reference
A metric reader is a module with read(run) -> float or None.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from portbench import tracing
from portbench.seeds import stream_seed

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package the program was ported from.
BANNED = ("jax", "jaxlib", "flax", "c99_vectordb_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    """BENCHMARK.json with the cells of withheld.json after its own: cells
    proved correct on the card but kept out of BENCHMARK.json (PERF.md §7),
    which run.py still runs by name."""
    bench = load_json(path)
    extra = load_json(HERE / "withheld.json")
    return dict(bench, **{k: bench[k] + extra[k] for k in ("configs", "workloads", "per_layer")})


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py, loaded by file (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module '{name}' ({path})")
    key = f"portbench_{kind}_{name.replace('.', '_')}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    try:
        spec.loader.exec_module(module)
    except BaseException:
        del sys.modules[key]
        raise
    return module


def banned_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in BANNED)


@dataclass
class Cell:
    """A BENCHMARK.json workload with its configuration, mix and metrics."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @classmethod
    def load(cls, bench: dict, name: str) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload '{name}' in BENCHMARK.json")
        w = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, int(w["chips"]), load_json(REPO / configs[w["config"]]["file"]),
                   load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   mine(bench["end_to_end"]), mine(bench["per_layer"]))


@dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    corpus: Any = None
    pool: Any = None
    workdir: Path | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclass
class Run:
    """What a window produced, for the metric readers."""
    setup_s: float
    window_s: float = 0.0
    latencies_s: list[float] = field(default_factory=list)
    attempted: int = 0
    returned: int = 0
    failed: int = 0
    mem_peak_bytes: int = 0
    trace: tracing.Trace | None = None
    work: dict = field(default_factory=dict)


class Reservoir:
    """A uniform sample of `size` calls of the window, drawn from the seed."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng(stream_seed(seed, "check-sample"))
        self.items: list[tuple[int, Any, Any]] = []
        self.seen = 0

    def offer(self, request, out) -> None:
        if len(self.items) < self.size:
            self.items.append((self.seen, request, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = (self.seen, request, out)
        self.seen += 1


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             control: bool = False) -> dict:
    """One run; returns the result line's object (its `checks` last)."""
    device = torch.device(device)
    if cell.traffic["loop"] != "closed" or cell.traffic["callers"] != 1:
        raise ValueError("the harness drives one caller in a closed loop")
    env = dict(os.environ)
    entry = load_module("entries", cell.traffic["entry"])
    gen = load_module("corpora", cell.config["corpus"]["generator"])
    workdir = Path(tempfile.mkdtemp(prefix="portbench_"))
    try:
        ctx = Context(cell, seed, device, workdir=workdir)
        ctx.corpus = gen.make(cell.config["corpus"], seed, device)
        ctx.pool = gen.queries(cell.config["corpus"], cell.traffic["pool"], seed, device)
        cuda = device.type == "cuda"
        inputs_peak = 0
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            inputs_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        system = (entry.control if control else entry.setup)(ctx)
        requests = entry.requests(ctx)
        for r in requests[: cell.traffic["warmup_calls"]]:
            entry.call(system, r)
        tracer = tracing.Tracer(device)
        tracer.sync()
        gc.collect()
        gc.freeze()
        run = Run(setup_s=time.perf_counter() - t_start)
        sample = Reservoir(cell.traffic["check_calls"], seed)
        if trace and not control:
            for owner, attr, name in entry.span_points(system):
                tracer.patch(owner, attr, name)
            try:
                with tracer.profiled():
                    _window(entry, system, requests, seconds, run, sample)
            finally:
                tracer.restore()
            run.trace = tracer.trace
        else:
            _window(entry, system, requests, seconds, run, sample)
        tracer.sync()
        if cuda:
            run.mem_peak_bytes = torch.cuda.max_memory_allocated(device)
        found = banned_modules()
        if found:
            raise BannedImport(found)
        run.work = {} if control else entry.work(system, ctx)
        del system
        gc.unfreeze()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = entry.check(ctx, sample.items)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        os.environ.clear()
        os.environ.update(env)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (run.failed == 0 and len(sample.items) > 0
               and all(v <= lim for v, lim in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(run.mem_peak_bytes, inputs_peak)}
    out = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if run.trace is not None and run.trace.window is not None:
        lo, hi = run.trace.window
        dev["busy_s"] = tracing.busy_ns(run.trace) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = tracing.breakdown(run.trace)
    out["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return out


class BannedImport(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package are loaded: " + ", ".join(names))
        self.names = names


def _window(entry, system, requests, seconds: float, run: Run, sample: Reservoir) -> None:
    """The closed loop: one caller, each call issued when the last returned,
    until `seconds` have passed; the window ends when the last call returns."""
    j = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        req = requests[j % len(requests)]
        n = entry.size(req)
        s = time.perf_counter()
        try:
            out = entry.call(system, req)
        except Exception as exc:  # a failed call is counted and judged, not fatal
            print(f"portbench: call {j} failed: {exc!r}", file=sys.stderr)
            run.failed += n
            out = None
        e = time.perf_counter()
        run.latencies_s.append(e - s)
        run.attempted += n
        if out is not None:
            run.returned += n
            sample.offer(req, out)
        j += 1
        if e >= deadline:
            break
    run.window_s = e - t0
