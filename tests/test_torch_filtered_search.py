"""VectorDBBench's int-filter cases (Performance768D1M1P / 99P) on
FlatIndex, on the CPU at a small size.

Each case's filter is `id >= round(filter_rate * N)` over the row ids,
filter_rate 0.01 (99% of rows pass) or 0.99 (1% pass). Here: masked
searches against a float64 exact top-k over the passing rows, on the card's
route (the kernel wrapper's plain version on CPU tensors) and the CPU
route; a low-pass mask's compacted staging at and around its gate; the
filter layer's counters and its spans; the benchmark's two
filtered cells through the harness at a tiny size, and planted faults
that must read not correct; the filtered roofline's arithmetic and its
readers.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.models import devbuild, flat
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.utils import timing
from portbench import harness, tracing
from portbench.reference import bound, filter_bound

REPO = Path(__file__).resolve().parent.parent
N, DIM, K = 4000, 64, 10
CAP = 4096                   # next_pow2(N): the rows the route hands the scan
GATE = CAP // 64             # a mask keeping at most this many rows is compacted
RATES = (0.01, 0.99)
CELLS = {0.99: "cohere768_1m_flat_idfilter.search_b128_f99p",
         0.01: "cohere768_1m_flat_idfilter.search_b128_f1p"}
# Returned distances against float64: unit rows put every squared distance
# in [0, 4], and float32's rounding of the sums that make it stays within
# a few units of 4 * 2**-23 (about 4.8e-7); 2e-6 leaves room for those.
DIST_TOL = 2e-6


def _mask(rate: float, n: int = N) -> np.ndarray:
    return np.arange(n) >= round(rate * n)


@pytest.fixture(scope="module")
def corpus():
    gen = harness.load_module("corpora", "clustered")
    spec = {"rows": N, "dim": DIM, "centers": 64, "noise": 0.6}
    return gen.make(spec, 11, "cpu").rows, gen.queries(spec, 24, 11, "cpu")


def _index(rows) -> FlatIndex:
    index = FlatIndex(dim=DIM, device="cpu")
    index.add(rows, np.arange(len(rows), dtype=np.int64))
    return index


def _exact(rows, queries, mask, k):
    """float64 top-k over the passing rows, ties by id."""
    x = torch.from_numpy(rows).double()
    q = torch.from_numpy(queries).double()
    d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    d[:, ~torch.from_numpy(mask)] = torch.inf
    order = np.lexsort((np.broadcast_to(np.arange(len(rows)), d.shape), d.numpy()), axis=1)[:, :k]
    return np.take_along_axis(d.numpy(), order, 1), order


@pytest.mark.parametrize("rerank_route", [True, False], ids=["card_route", "cpu_route"])
@pytest.mark.parametrize("rate", RATES)
def test_masked_search_is_exact_over_the_passing_rows(corpus, rate, rerank_route):
    rows, queries = corpus
    mask = _mask(rate)
    d, i = _index(rows)._search(queries, K, mask, rerank_route=rerank_route)
    want_d, want_i = _exact(rows, queries, mask, K)
    np.testing.assert_array_equal(i, want_i)
    assert mask[i].all()
    np.testing.assert_allclose(d, want_d, rtol=0, atol=DIST_TOL)


@pytest.mark.parametrize("rate", RATES)
def test_counters_count_searches_builds_and_rows(corpus, rate):
    rows, queries = corpus
    index = _index(rows)
    mask = _mask(rate)
    f0, d0 = dict(flat.COUNTERS), dict(devbuild.COUNTERS)

    def moved(counters, before):
        return {k: counters[k] - before[k] for k in ("masked_searches", "scanned_rows",
                                                    "mask_builds", "mask_hits") if k in counters}

    for _ in range(5):
        index.search(queries, K, id_mask=mask)
    assert moved(flat.COUNTERS, f0) == {"masked_searches": 5, "scanned_rows": 5 * CAP}
    assert moved(devbuild.COUNTERS, d0) == {"mask_builds": 1, "mask_hits": 4}
    assert devbuild.COUNTERS["mask_live_rows"] == int(mask.sum())
    # A new mask object is a new build, with the rows it keeps.
    other = _mask(0.5)
    index.search(queries, K, id_mask=other)
    assert moved(devbuild.COUNTERS, d0) == {"mask_builds": 2, "mask_hits": 4}
    assert devbuild.COUNTERS["mask_live_rows"] == int(other.sum())
    # An unmasked search scans as many rows and is not a masked search.
    index.search(queries, K)
    assert moved(flat.COUNTERS, f0) == {"masked_searches": 6, "scanned_rows": 7 * CAP}


@pytest.mark.parametrize("masked", [True, False])
def test_mask_span_once_a_masked_search(corpus, masked):
    rows, queries = corpus
    index = _index(rows)
    mask = _mask(0.99) if masked else None
    timing.reset()
    timing.enable(True)
    try:
        for _ in range(3):
            index.search(queries, K, id_mask=mask)
        table = timing.snapshot()
    finally:
        timing.enable(False)
        timing.reset()
    if masked:
        assert table["flat.mask"][0] == 3 == table["flat.scan"][0]
        assert table["flat.mask"][1] <= table["flat.scan"][1]
    else:
        assert "flat.mask" not in table


def _passing(case: str) -> np.ndarray:
    """A mask passing the last `case` rows, or ("scattered") 40 rows drawn
    across the store."""
    if case == "scattered":
        mask = np.zeros(N, bool)
        mask[np.random.default_rng(5).choice(N, 40, replace=False)] = True
        return mask
    return np.arange(N) >= N - int(case)


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["0", "1", "40", str(GATE), str(GATE + 1), "scattered"])
def test_compact_staging_at_its_gate(corpus, case):
    """At or under the gate the card's route scans the mask's compacted rows
    (at least 1024, whole 128-row tiles); above it the whole store. Either
    way the results are exact over the passing rows, and equal an index of
    only those rows searched with no mask."""
    rows, queries = corpus
    mask = _passing(case)
    passing = int(mask.sum())
    compact = passing <= GATE
    f0 = dict(flat.COUNTERS)
    d, i = _index(rows)._search(queries, K, mask, rerank_route=True)
    assert flat.COUNTERS["compact_searches"] - f0["compact_searches"] == int(compact)
    assert flat.COUNTERS["scanned_rows"] - f0["scanned_rows"] == (1024 if compact else CAP)
    assert devbuild.COUNTERS["mask_live_rows"] == passing
    want_d, want_i = _exact(rows, queries, mask, K)
    found = np.isfinite(want_d)
    assert found.sum(1).tolist() == [min(passing, K)] * len(queries)
    np.testing.assert_array_equal(i[found], want_i[found])
    np.testing.assert_allclose(d[found], want_d[found], rtol=0, atol=DIST_TOL)
    assert (i[~found] == -1).all() and np.isinf(d[~found]).all()
    alone = FlatIndex(dim=DIM, device="cpu")
    alone.add(rows[mask], np.flatnonzero(mask))
    _same((d, i), alone._search(queries, K, None, rerank_route=True))


@pytest.mark.parametrize("mutation", ["add", "remove_ids"])
def test_add_and_remove_drop_the_compact_staging(corpus, mutation):
    rows, queries = corpus
    mask = _mask(0.99)
    held = np.flatnonzero(mask)[::4]
    index = FlatIndex(dim=DIM, device="cpu")
    if mutation == "add":
        rest = np.setdiff1d(np.arange(N), held)
        index.add(rows[rest], rest)
    else:
        index.add(rows, np.arange(N, dtype=np.int64))
    index._search(queries, K, mask, rerank_route=True)
    live = mask.copy()
    if mutation == "add":
        index.add(rows[held], held)
    else:
        assert index.remove_ids(held) == len(held)
        live[held] = False
    f0, d0 = dict(flat.COUNTERS), dict(devbuild.COUNTERS)
    d, i = index._search(queries, K, mask, rerank_route=True)
    assert devbuild.COUNTERS["mask_builds"] - d0["mask_builds"] == 1
    assert devbuild.COUNTERS["mask_live_rows"] == int(live.sum())
    assert flat.COUNTERS["compact_searches"] - f0["compact_searches"] == 1
    want_d, want_i = _exact(rows, queries, live, K)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_allclose(d, want_d, rtol=0, atol=DIST_TOL)


@pytest.mark.parametrize("rate", RATES)
def test_compact_span_once_a_build(corpus, rate):
    """`flat.compact` covers a compacted build inside `flat.mask`: once on a
    build, never on a hit, never above the gate."""
    rows, queries = corpus
    index = _index(rows)
    mask = _mask(rate)
    timing.reset()
    timing.enable(True)
    try:
        for _ in range(3):
            index._search(queries, K, mask, rerank_route=True)
        table = timing.snapshot()
    finally:
        timing.enable(False)
        timing.reset()
    assert table["flat.mask"][0] == 3
    if rate == 0.99:
        assert table["flat.compact"][0] == 1
        assert table["flat.compact"][1] <= table["flat.mask"][1]
    else:
        assert "flat.compact" not in table


def _tiny_cell(rate: float) -> harness.Cell:
    c = harness.Cell.load(harness.load_benchmark(REPO / "BENCHMARK.json"), CELLS[rate])
    c.config["corpus"].update(rows=2048)
    c.traffic["pool"] = 256
    return c


def _run(monkeypatch, rate: float, trace: bool = False, control: bool = False) -> dict:
    monkeypatch.setattr(harness, "banned_modules", lambda: [])   # this process holds jax
    return harness.run_cell(_tiny_cell(rate), 2**33 + 9, 0.3, trace, "cpu", time.perf_counter(),
                            control=control)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("rate", RATES)
def test_cell_runs_correct_on_cpu(monkeypatch, rate, trace):
    out = _run(monkeypatch, rate, trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"id_misses", "filter_leaks", "dist_gap"}
    assert out["checks"]["filter_leaks"]["value"] == 0
    if trace:
        # The CPU has no device operations: the roofline and the idle share
        # read nothing here (their readers are held to a trace below).
        assert set(out["metrics"]) == {"filter.search_ms"}
    else:
        assert {"qps", "p95_ms", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("rate", RATES)
def test_tf32_control_reads_not_correct(monkeypatch, rate):
    out = _run(monkeypatch, rate, control=True)
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > out["checks"]["dist_gap"]["limit"]
    assert out["checks"]["filter_leaks"]["value"] == 0


def _ignores_mask(search):
    def broken(self, queries, k, id_mask=None):
        return search(self, queries, k)
    return broken


def _drops_a_row(search):
    """Each call answers as if one passing row, its first query's nearest,
    were not there: k of the k + 1 nearest, that row left out."""
    def broken(self, queries, k, id_mask=None):
        d, i = search(self, queries, k + 1, id_mask=id_mask)
        keep = i != i[0, 0]
        keep[keep.sum(1) > k, k] = False
        return d[keep].reshape(-1, k), i[keep].reshape(-1, k)
    return broken


@pytest.mark.parametrize("rate,fault,check", [
    (0.99, _ignores_mask, "filter_leaks"),
    (0.01, _ignores_mask, "filter_leaks"),
    (0.99, _drops_a_row, "id_misses"),
])
def test_planted_fault_reads_not_correct(monkeypatch, rate, fault, check):
    monkeypatch.setattr(FlatIndex, "search", fault(FlatIndex.search))
    # No staged mask's gauge left by an earlier test: the check alone has to
    # catch the fault (a program that ignores the mask builds none).
    monkeypatch.setitem(devbuild.COUNTERS, "mask_live_rows", None)
    out = _run(monkeypatch, rate)
    assert not out["correct"]
    assert out["checks"][check]["value"] > 0


def test_work_holds_the_program_to_the_entry_mask(monkeypatch):
    from types import SimpleNamespace

    entry = harness.load_module("entries", "filtered_search")
    ctx = SimpleNamespace(corpus=SimpleNamespace(ids=np.arange(100)),
                          traffic={"batch": 8, "k": 10, "filter_rate": 0.99})
    system = entry.Filtered(SimpleNamespace(dim=16, scan_dtype="float32"), entry.passing(ctx))
    monkeypatch.setitem(devbuild.COUNTERS, "mask_live_rows", 1)
    assert entry.work(system, ctx)["filter"] == {"rows": 1, "ids": 100, "dim": 16, "batch": 8,
                                                  "k": 10, "dtype": "float32"}
    monkeypatch.setitem(devbuild.COUNTERS, "mask_live_rows", 2)
    with pytest.raises(RuntimeError, match="keeps 2 rows"):
        entry.work(system, ctx)
    monkeypatch.delattr(devbuild, "COUNTERS")       # a program without the counters
    assert entry.work(system, ctx)["filter"]["rows"] == 1


def test_filter_bound_at_the_99p_shape():
    b, d, k, n_ids, passing = 128, 768, 10, 1_000_000, 10_000
    want = passing * d * 4 + passing * 4 + n_ids + b * d * 4 + b * k * 8
    assert want == 32_163_456
    assert filter_bound.filter_scan_bytes(passing, n_ids, d, b, k, "float32") == want
    assert filter_bound.filter_scan_ops(passing, d, b) == 2 * b * passing * d
    s, by = filter_bound.filter_scan_bound_s(passing, n_ids, d, b, k, "float32")
    assert by == "bytes" and s == pytest.approx(want / 3.35e12, rel=1e-12)


@pytest.mark.parametrize("n,b", [(1_000_000, 128), (131_072, 1), (4096, 1024)])
def test_filter_bound_at_full_pass_is_the_scan_bound_plus_the_mask(n, b):
    d, k = 768, 10
    assert (filter_bound.filter_scan_bytes(n, n, d, b, k, "float32")
            == bound.scan_bytes(n, d, b, k, "float32") + n)
    assert filter_bound.filter_scan_ops(n, d, b) == bound.scan_ops(n, d, b)
    s, by = filter_bound.filter_scan_bound_s(n, n, d, b, k, "float32")
    t_bytes = (bound.scan_bytes(n, d, b, k, "float32") + n) / bound.HBM_BYTES_PER_S
    t_ops = bound.scan_ops(n, d, b) / bound.PEAK_OPS_PER_S["float32"]
    assert s == pytest.approx(max(t_bytes, t_ops), rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_filter_readers_on_a_trace():
    w = {"rows": 10_000, "ids": 1_000_000, "dim": 768, "batch": 128, "k": 10, "dtype": "float32"}
    # Two search spans (2 ms and 1 ms on the host's clock; 100 us each on
    # the profiler's), 40 us of device work in each; a 20 us operation
    # outside them; a 1 ms window.
    trace = tracing.Trace(
        spans=[("search", 0.0, 2e-3), ("search", 3e-3, 4e-3)],
        marks=[("search", 0, 100_000), ("search", 200_000, 300_000)],
        device_ops=[(10_000, 50_000, "scan"), (210_000, 250_000, "scan"),
                    (500_000, 520_000, "copy")],
        window=(0, 1_000_000))
    run = harness.Run(setup_s=1.0, trace=trace, work={"filter": w})
    read = {name: harness.load_module("metrics", name).read(run)
            for name in ("filter.search_ms", "filter.scan_roofline", "filter.idle_pct")}
    bound_s, _ = filter_bound.filter_scan_bound_s(**{
        "passing": 10_000, "ids": 1_000_000, "d": 768, "b": 128, "k": 10, "dtype": "float32"})
    assert read["filter.search_ms"] == pytest.approx(1.5)
    assert read["filter.scan_roofline"] == pytest.approx(100.0 * 2 * bound_s / 80e-6)
    assert read["filter.idle_pct"] == pytest.approx(90.0)
    empty = harness.Run(setup_s=1.0)
    assert all(harness.load_module("metrics", name).read(empty) is None
               for name in ("filter.search_ms", "filter.scan_roofline", "filter.idle_pct"))
