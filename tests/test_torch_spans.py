"""The port's spans (utils/timing.span) and the ones FlatIndex carries.

Disabled (the default), a span is one shared no-op: no clock read, nothing
recorded, no profiler range. Enabled, each of FlatIndex's spans counts once
a search call (the staging once after an add), the inner ones nest inside
`flat.search` under a profiler, and results are bit-equal either way. The
`cuda`-marked case runs the card's kernel route (on the card:
`python -m pytest --noconftest -m cuda tests/test_torch_spans.py`); this
file imports no jax.
"""

import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.utils import timing

DIM = 16
INNER = ("flat.upload", "flat.scan", "flat.rerank", "flat.fetch")


@pytest.fixture
def spans():
    timing.reset()
    timing.enable(True)
    yield timing
    timing.enable(False)
    timing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda:0")


def _index(n: int, device="cpu", seed: int = 5):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    queries = rng.standard_normal((7, DIM)).astype(np.float32)
    index = FlatIndex(dim=DIM, device=device)
    index.add(vecs, np.arange(n, dtype=np.int64) * 3)
    return index, queries


def _expected(rerank_route: bool, first: bool) -> set[str]:
    names = {"flat.search"} | {n for n in INNER if rerank_route or n != "flat.rerank"}
    return names | {"flat.stage"} if first else names


def _c99_events(prof) -> list[tuple[str, int, int]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("c99vdb.") or e.name() == "outer":
            if e.device_type() == torch.autograd.DeviceType.CPU:
                s = int(e.start_ns())
                out.append((e.name(), s, s + int(e.duration_ns())))
    return out


@pytest.mark.parametrize("name", ["flat.search", "flat.stage", "anything"])
def test_disabled_span_reads_no_clock_and_records_nothing(monkeypatch, name):
    assert not timing.enabled()

    def no_clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(timing.time, "perf_counter_ns", no_clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.span(name):
            torch.ones(4).sum()
    assert timing.span(name) is timing.span("other")
    assert timing.snapshot() == {}
    assert not any(e.name().startswith("c99vdb.") for e in prof.profiler.kineto_results.events())


@pytest.mark.parametrize("n", [300, 1500])   # topk_program + staged rerank; the kernel wrapper
@pytest.mark.parametrize("rerank_route", [True, False])
def test_each_span_once_a_call(spans, rerank_route, n):
    index, queries = _index(n)
    assert spans.snapshot()["flat.add"][0] == 1
    for call in range(3):
        spans.reset()
        index._search(queries, 5, None, rerank_route=rerank_route)
        table = spans.snapshot()
        assert set(table) == _expected(rerank_route, first=call == 0)
        assert all(count == 1 for count, _ in table.values())
        inner = sum(table[name][1] for name in INNER if name in table)
        assert 0 < inner <= table["flat.search"][1]


@pytest.mark.parametrize("rerank_route", [True, False])
def test_marks_nest_inside_an_outer_range(spans, rerank_route):
    index, queries = _index(1500)
    index._search(queries, 5, None, rerank_route=rerank_route)   # staged outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            index._search(queries, 5, None, rerank_route=rerank_route)
    marks = {name: (s, e) for name, s, e in _c99_events(prof)}
    want = {"outer"} | {"c99vdb." + n for n in _expected(rerank_route, first=False)}
    assert set(marks) == want
    lo, hi = marks["outer"]
    s0, e0 = marks["c99vdb.flat.search"]
    assert lo <= s0 <= e0 <= hi
    inner = [marks["c99vdb." + n] for n in INNER if "c99vdb." + n in marks]
    assert all(s0 <= s <= e <= e0 for s, e in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))   # in order, disjoint


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rerank_route", [True, False])
def test_results_bit_equal_with_spans_on_and_off(rerank_route, masked):
    index, queries = _index(1500)
    mask = np.arange(4500) % 2 == 0 if masked else None
    off = index._search(queries, 9, mask, rerank_route=rerank_route)
    timing.enable(True)
    try:
        on = index._search(queries, 9, mask, rerank_route=rerank_route)
    finally:
        timing.enable(False)
        timing.reset()
    for a, b in zip(off, on):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("enabled", [False, True])
def test_stage_keeps_its_line_and_trace(capsys, monkeypatch, tmp_path, enabled):
    monkeypatch.setenv("C99VDB_TRACE", str(tmp_path))
    timing.enable(enabled)
    try:
        with timing.stage(True, "load index"):
            torch.ones(8).sum()
    finally:
        timing.enable(False)
        timing.reset()
    assert re.fullmatch(r"\[timing\] load index: [0-9]+\.[0-9] ms\n", capsys.readouterr().err)
    assert (tmp_path / "load_index" / "trace.json").read_text().lstrip().startswith("{")


@pytest.mark.cuda
def test_spans_on_the_card_route(cuda, spans):
    index, queries = _index(4096, device=cuda)
    off_table = spans.snapshot()
    spans.enable(False)
    off = index.search(queries, 10)
    spans.enable(True)
    spans.reset()
    on = index.search(queries, 10)
    table = spans.snapshot()
    assert off_table["flat.add"][0] == 1
    assert set(table) == _expected(True, first=False)
    assert all(count == 1 for count, _ in table.values())
    for a, b in zip(off, on):
        assert np.array_equal(a, b)
