"""The metric arithmetic on hand-made inputs."""

from types import SimpleNamespace

import pytest

from tiny import harness  # noqa: F401  (puts the repository on the path)
from portbench import stats, tracing
from portbench.reference import bound


def read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_p95_counts_every_call_stall_included():
    lat = [0.010] * 95 + [0.011] * 4 + [2.0]
    assert stats.percentile(lat, 95) == 0.010
    lat = [0.010] * 94 + [2.0] * 6
    assert read("p95_ms", SimpleNamespace(latencies_s=lat)) == pytest.approx(2000.0)
    assert stats.percentile([3.0], 95) == 3.0


def test_qps_over_the_whole_window():
    assert read("qps", SimpleNamespace(returned=1280, window_s=2.0)) == 640.0


def test_idle_share_unions_overlapping_intervals():
    t = tracing.Trace(window=(0, 1000),
                      device_ops=[(100, 300, "a"), (200, 400, "b"), (350, 380, "c"),
                                  (900, 1200, "d"), (-50, 20, "e")])
    assert tracing.busy_ns(t) == 20 + 300 + 100
    assert read("device.idle_pct", SimpleNamespace(trace=t)) == pytest.approx(58.0)
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["a", 200e-9]
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(580e-9)


def test_idle_gaps_by_innermost_span():
    t = tracing.Trace(window=(0, 100), device_ops=[(10, 20, "k"), (60, 70, "k")],
                      marks=[("api", 5, 95), ("search", 8, 25), ("embed", 30, 40)])
    gaps = dict(tracing.breakdown(t)["idle_gaps"])
    assert gaps["harness"] == pytest.approx(10e-9)       # 0-5 and 95-100
    assert gaps["api"] == pytest.approx(53e-9)           # 5-8, 25-30, 40-60, 70-95
    assert gaps["search"] == pytest.approx(2e-9 + 5e-9)  # 8-10, 20-25
    assert gaps["embed"] == pytest.approx(10e-9)         # 30-40


def test_device_time_inside_spans():
    t = tracing.Trace(window=(0, 100), device_ops=[(10, 20, "k"), (15, 30, "k"), (50, 60, "k")],
                      marks=[("search", 12, 40), ("search", 45, 55), ("embed", 0, 5)])
    assert tracing.device_ns_in(t, "search") == (2, 18 + 5)


def test_self_time_subtracts_nested_spans():
    t = tracing.Trace(spans=[("embed", 1.0, 1.2), ("search", 1.3, 1.5), ("api", 1.0, 2.0),
                             ("embed", 3.0, 3.1), ("api", 3.0, 3.5)])
    assert stats.self_ms(t, "api") == pytest.approx(1e3 * (0.6 + 0.4) / 2)
    assert stats.span_mean_ms(t, "embed") == pytest.approx(150.0)
    assert stats.span_mean_ms(t, "rank") is None


def test_bound_counts_by_hand():
    # 1M x 768 f32, B = 128, k = 10: bytes = store + norms + queries + outputs.
    n, d, b, k = 1_000_000, 768, 128, 10
    assert bound.scan_bytes(n, d, b, k, "float32") == n * d * 4 + n * 4 + b * d * 4 + b * k * 8
    assert bound.scan_ops(n, d, b) == 2 * 128 * 1_000_000 * 768
    t, by = bound.scan_bound_s(n, d, b, k, "float32")
    assert by == "bytes" and t == pytest.approx(3_076_403_712 / 3.35e12)
    t, by = bound.scan_bound_s(131_072, 384, 4096, 10, "float32")
    assert by == "operations" and t == pytest.approx(2 * 4096 * 131_072 * 384 / 495e12)
    assert bound.scan_bytes(10, 4, 2, 3, "int8") == 40 + 40 + 8 + 48 + 8


def test_roofline_reads_every_search_span():
    t = tracing.Trace(window=(0, 10**7), device_ops=[(0, 2_000_000, "k"), (3_000_000, 5_000_000, "k")],
                      marks=[("search", 0, 2_500_000), ("search", 2_900_000, 5_100_000)])
    work = {"scan": {"rows": 1_000_000, "dim": 768, "batch": 1, "k": 10, "dtype": "float32"}}
    got = read("scan_roofline", SimpleNamespace(trace=t, work=work))
    want, _ = bound.scan_bound_s(1_000_000, 768, 1, 10, "float32")
    assert got == pytest.approx(100 * 2 * want / 4e-3)
    assert read("scan_roofline", SimpleNamespace(trace=t, work={})) is None
