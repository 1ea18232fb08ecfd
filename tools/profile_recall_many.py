#!/usr/bin/env python3
"""Where a warm MemoDB.recall_many call spends its time on the card.

    python3 tools/profile_recall_many.py [--notes 100000] [--batch 128] [--k 10]

Builds a MemoDB of seeded synthetic notes (chip_smoke.synthetic_notes) on
CUDA device 0, warms it, then reports for a 128-query call:
  - the call's time on the host clock, unwrapped (median of 10);
  - the stages of the same call, each measured inside it (median of 10):
    its store and index stat checks (`_store`, `_index`), `embed_texts`
    and `index.search` are wrapped with a device synchronisation on both
    sides, and hit assembly is timed directly from search's return to the
    call's return (`collect` and the fill check; one pass when the filter
    is pushed down or absent);
  - a CUDA-only torch.profiler trace of 5 unwrapped calls: device time by
    kernel, and the summed device time against the wall time (the device's
    busy share).
Prints the card line from nvidia-smi first. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--notes", type=int, default=100_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profile_recall_many: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from c99_vectordb_tpu_torch import api
    from torch.profiler import ProfilerActivity, profile

    card = chip_smoke.card_line()
    print(f"card: {card}", flush=True)
    records, queries = chip_smoke.synthetic_notes(args.notes, args.seed)
    queries = (queries * (args.batch // len(queries) + 1))[: args.batch]
    with tempfile.TemporaryDirectory(prefix="profile_", dir=str(Path.cwd())) as tmp:
        db = api.MemoDB("notes", cwd=tmp, device="cuda")
        db.save_many(records)
        for _ in range(3):
            db.recall_many(queries, k=args.k)

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            db.recall_many(queries, k=args.k)
            return t0, time.perf_counter()

        plain = []
        for _ in range(10):
            t0, t1 = call()
            plain.append((t1 - t0) * 1e3)

        spans: dict[str, tuple[float, float]] = {}

        def timed(name, fn):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                spans[name] = (t0, time.perf_counter())
                return out
            return wrapper

        index = db._index()
        db._store = timed("stat checks: _store", db._store)
        db._index = timed("stat checks: _index", db._index)
        index.search = timed("index.search", index.search)
        embed_texts = api.embed_texts
        api.embed_texts = timed("embed_texts", embed_texts)
        stages: dict[str, list[float]] = {}
        try:
            for _ in range(10):
                spans.clear()
                t0, t1 = call()
                row = {name: (b - a) * 1e3 for name, (a, b) in spans.items()}
                row["hit assembly (search return -> call return)"] = (
                    t1 - spans["index.search"][1]) * 1e3
                row["whole call (wrapped)"] = (t1 - t0) * 1e3
                for name, ms in row.items():
                    stages.setdefault(name, []).append(ms)
        finally:
            api.embed_texts = embed_texts
            del db._store, db._index, index.search
        print(f"recall_many B={args.batch} k={args.k} notes={args.notes}: whole call "
              f"(unwrapped) median {statistics.median(plain):.3f} ms [host clock, {card}]",
              flush=True)
        for name, values in stages.items():
            print(f"  {name}: median {statistics.median(values):.3f} ms", flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                db.recall_many(queries, k=args.k)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        events.sort(key=lambda e: e.self_device_time_total, reverse=True)
        device_ms = sum(e.self_device_time_total for e in events) / 1e3
        print(f"profiler (CUDA activity only): 5 calls, wall {wall:.3f} ms, device time "
              f"{device_ms:.3f} ms, device busy share {device_ms / wall:.4f} [{card}]",
              flush=True)
        for e in events[:12]:
            print(f"  {e.self_device_time_total / 1e3 / 5:9.4f} ms/call  x{e.count // 5:<4d} "
                  f"{e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
