"""Entry module: an index's `search(queries, k, id_mask=mask)` under
VectorDBBench's int filter.

VectorDBBench's filtered cases give every row a scalar int field `id` and
every query the filter `id >= round(filter_rate * N)`: `filter_rate` is
the share of rows filtered OUT. Here the field is the row's id (its
position), so the filter is one (N,) bool array over the id space, True
where a row passes. It is built once in `setup` from the traffic's
`filter_rate` and the same object goes into every call, as a deployment
with one fixed filter passes it. Calls and requests are entries/search.py's.
The check judges the sampled lists against exact float64 distances with
the filtered-out rows at +inf (reference/exact.py), and counts the
returned ids that fail the filter.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import harness
from portbench.reference.exact import ExactStore, score_lists
from portbench.reference.filtered import FilteredSearchControl
from portbench.seeds import stream_seed

search = harness.load_module("entries", "search")
requests, size = search.requests, search.size


@dataclass
class Filtered:
    index: object          # the program's index, or the control
    mask: np.ndarray       # (N,) bool keyed by id: True where the row passes


def passing(ctx) -> np.ndarray:
    """The filter `id >= round(filter_rate * N)` over the corpus's ids."""
    n = len(ctx.corpus.ids)
    return np.arange(n, dtype=np.int64) >= round(ctx.traffic["filter_rate"] * n)


def setup(ctx) -> Filtered:
    return Filtered(search.setup(ctx), passing(ctx))


def control(ctx) -> Filtered:
    mask = passing(ctx)
    excluded = torch.from_numpy(~mask).to(ctx.device)
    return Filtered(FilteredSearchControl(ctx.corpus.rows, ctx.device, excluded), mask)


def call(system: Filtered, req):
    return system.index.search(req.queries, req.k, id_mask=system.mask)


def span_points(system: Filtered):
    return [(system.index, "search", "search")]


def work(system: Filtered, ctx) -> dict:
    """The filtered scan's shapes, the passing rows counted from the entry's
    own mask; raises where the program staged a mask that keeps others (a
    program without the filter layer's counters is not asked)."""
    from c99_vectordb_tpu_torch.models import devbuild

    t, index = ctx.traffic, system.index
    live = int(system.mask[ctx.corpus.ids].sum())
    staged = getattr(devbuild, "COUNTERS", {}).get("mask_live_rows")
    if staged is not None and staged != live:
        raise RuntimeError(f"the program's staged mask keeps {staged} rows; the filter passes {live}")
    return {"filter": {"rows": live, "ids": int(system.mask.size), "dim": index.dim,
                       "batch": t["batch"], "k": t["k"], "dtype": index.scan_dtype}}


def leaks(ids: np.ndarray, mask: np.ndarray) -> int:
    """Returned ids (>= 0) that are not ids of rows the filter passes."""
    ok = np.zeros(ids.shape, dtype=bool)
    inside = (ids >= 0) & (ids < mask.size)
    ok[inside] = mask[ids[inside]]
    return int(((ids >= 0) & ~ok).sum())


def check(ctx, samples) -> dict:
    """Exact top-k over the passing rows of a seeded subset of the sampled
    calls' queries; the filter's leaks over every sampled list."""
    t, lim = ctx.traffic, ctx.config["check"]
    mask = passing(ctx)
    rows, ids, dists = [], [], []
    for _, req, (d, i) in samples:
        rows.append(req.rows)
        ids.append(np.asarray(i))
        dists.append(np.asarray(d))
    rows, ids, dists = np.concatenate(rows), np.concatenate(ids), np.concatenate(dists)
    rng = np.random.default_rng(stream_seed(ctx.seed, "check-queries"))
    pick = np.sort(rng.permutation(len(rows))[: t["check_queries"]])
    store = ExactStore(ctx.corpus.rows, ctx.device, excluded=torch.from_numpy(~mask).to(ctx.device))
    misses, gap = 0, 0.0
    for s in range(0, len(pick), search.QUERY_CHUNK):
        p = pick[s : s + search.QUERY_CHUNK]
        m, g = score_lists(store.distances(ctx.pool[rows[p]]), ids[p], dists[p], t["k"],
                           lim["tie_tol"])
        misses, gap = misses + m, max(gap, g)
    return {"id_misses": (misses, lim["id_misses"]),
            "filter_leaks": (leaks(ids, mask), lim["filter_leaks"]),
            "dist_gap": (gap, lim["dist_gap"])}
