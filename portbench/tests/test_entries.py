"""Each entry module, end to end on the CPU at a tiny size: the program's
CPU route agrees with the reference, and the result line keeps to the
schema, untraced and traced."""

import json
import re
import subprocess
import sys

import pytest

from tiny import BENCH, CELLS, REPO, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def schema(out, names):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) <= set(names)
    for name, m in out["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and isinstance(m["value"], float)
    for name, c in out["checks"].items():
        assert NAME.match(name) and set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_cpu(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    schema(out, [m["name"] for m in BENCH["end_to_end"]])
    assert {"qps", "p95_ms", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_traced_on_cpu(name):
    out = run(name, trace=True)
    assert out["correct"], out["checks"]
    schema(out, [m["name"] for m in BENCH["per_layer"]])
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    assert {"search.ms", "rank.ms", "embed.ms", "api.host_ms"} & set(out["metrics"])


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_banned_module_ends_the_run(monkeypatch):
    import types

    from portbench import harness

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.BannedImport):
        run(CELLS[0])
