"""The program's own spans (`c99_vectordb_tpu_torch.utils.timing`) under the
benchmark: no run turns them on, and should something turn them on, their
`c99vdb.` profiler ranges leave every metric and the breakdown as they
were."""

from types import SimpleNamespace

import pytest
import torch

from tiny import cell, harness, run
from portbench import tracing

CELLS = ["cohere768_1m_flat.search_b128", "cohere768_1m_flat.search_b1"]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def read(name, run_):
    return harness.load_module("metrics", name).read(run_)


def timing():
    from c99_vectordb_tpu_torch.utils import timing

    return timing


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_runs_leave_the_spans_off(name, trace, monkeypatch):
    t = timing()
    turned = []
    monkeypatch.setattr(t, "enable", lambda on: turned.append(on))
    entry = harness.load_module("entries", cell(name).traffic["entry"])
    call = entry.call

    def checked(system, req):
        assert not t.enabled()
        return call(system, req)

    monkeypatch.setattr(entry, "call", checked)
    out = run(name, trace=trace)
    assert out["correct"], out["checks"]
    assert turned == [] and t.snapshot() == {}
    if trace:
        assert list(out) == KEYS[:5] + ["breakdown", "checks"]
        assert not any(label.startswith("c99vdb.") for label, _ in out["breakdown"]["idle_gaps"])
    else:
        assert list(out) == KEYS
        assert set(out["metrics"]) == {"qps", "p95_ms", "setup_s"}   # no device memory on the CPU


class Event:
    """A profiler event as Tracer._read sees it."""

    def __init__(self, name, start, end, on_device=False, annotation=False):
        self._args = (name, start, end - start, on_device, annotation)

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def duration_ns(self):
        return self._args[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._args[3] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._args[4]


HARNESS_EVENTS = [
    Event("portbench.window", 0, 10_000),
    Event("portbench.search", 100, 4_100), Event("portbench.search", 5_000, 9_000),
    Event("portbench.search", 100, 4_100, on_device=True, annotation=True),
    Event("scan_topk_f32_kernel", 600, 3_000, on_device=True),
    Event("merge_splits_kernel", 3_100, 3_300, on_device=True),
    Event("Memcpy DtoH", 3_800, 3_900, on_device=True),
    Event("scan_topk_f32_kernel", 5_900, 8_000, on_device=True),
    Event("aten::copy_", 3_700, 4_000),
]
PROGRAM_EVENTS = [
    Event("c99vdb.flat.search", 150, 4_050), Event("c99vdb.flat.upload", 160, 300),
    Event("c99vdb.flat.scan", 300, 700), Event("c99vdb.flat.rerank", 700, 900),
    Event("c99vdb.flat.fetch", 900, 4_000),
    Event("c99vdb.flat.search", 5_050, 8_950), Event("c99vdb.flat.upload", 5_060, 5_400),
    Event("c99vdb.flat.scan", 5_400, 5_950), Event("c99vdb.flat.fetch", 6_000, 8_900),
    Event("c99vdb.flat.scan", 5_400, 5_950, on_device=True, annotation=True),
]
WORK = {"scan": {"rows": 1_000_000, "dim": 768, "batch": 1, "k": 10, "dtype": "float32"}}


def traced(events):
    tracer = tracing.Tracer(torch.device("cpu"))
    tracer.trace.spans = [("search", 1e-7, 4.1e-6), ("search", 5e-6, 9e-6)]
    tracer._read(events)
    return SimpleNamespace(trace=tracer.trace, work=WORK)


def test_harness_metrics_read_the_same_with_program_marks():
    """The program's host ranges and their device-side annotations are
    neither marks nor device operations to the harness."""
    before, after = traced(HARNESS_EVENTS), traced(HARNESS_EVENTS + PROGRAM_EVENTS)
    assert before.trace.window == after.trace.window == (0, 10_000)
    assert before.trace.device_ops == after.trace.device_ops
    assert before.trace.marks == after.trace.marks
    assert read("device.idle_pct", before) == pytest.approx(100 * (1 - 4_800 / 10_000))
    assert tracing.device_ns_in(before.trace, "search") == (2, 2_700 + 2_100)
    for name in ("search.ms", "scan_roofline", "device.idle_pct"):
        assert read(name, after) == read(name, before) is not None
    b0, b1 = tracing.breakdown(before.trace), tracing.breakdown(after.trace)
    assert b0 == b1
    assert dict(b0["idle_gaps"]) == pytest.approx({"search": 3_200e-9, "harness": 2_000e-9})
