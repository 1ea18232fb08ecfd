"""Per-rank ingest (ShardedFlatIndex.add_local) and the front end of a
sharded index (parallel/serve.py ShardServer) at W in {1, 2, 4} gloo ranks
on the CPU, with the streamed corpus and reference of the sharded cell
(portbench/corpora/clustered_stream.py, portbench/reference/streamed.py).

A module fixture spawns every W once, and a W = 2 run whose follower dies
(tests/torch_shard_serve_worker.py, one process per rank, all at once);
each case below is one test over what the ranks wrote. The in-process
tests run one rank without a process group. This file imports no jax.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import torch_shard_serve_worker as worker
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex, ShardServer, serve, sharded
from c99_vectordb_tpu_torch.utils import timing
from portbench import harness
from portbench.reference.streamed import score, stream_topk, tf32

WORLDS = (1, 2, 4)
JOIN_TIMEOUT_S = 120
REPO = Path(__file__).resolve().parent.parent
GEN = harness.load_module("corpora", "clustered_stream")
CELL = "deep1b_640m_sharded_flat.sharded_search_b128"


def _spawn(root: Path, world: int, mode: str) -> list[subprocess.Popen]:
    out = root / f"{mode}{world}"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cpu")
    return [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), "--world", str(world), "--rank", str(r),
         "--store", str(out / "store"), "--out", str(out), "--mode", mode],
        stdout=(out / f"log{r}").open("w"), stderr=subprocess.STDOUT, env=env, cwd=str(out))
        for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank 0's results, ...], "kill": (rank codes, rank 0's result)}."""
    root = tmp_path_factory.mktemp("serve")
    procs = {w: _spawn(root, w, "cases") for w in WORLDS}
    procs["kill"] = _spawn(root, 2, "kill")
    codes = {}
    try:
        for key, ps in procs.items():
            codes[key] = [p.wait(timeout=JOIN_TIMEOUT_S) for p in ps]
    except subprocess.TimeoutExpired:
        for p in (p for ps in procs.values() for p in ps):
            p.kill()
        pytest.fail(f"the ranks did not end within {JOIN_TIMEOUT_S} s")
    for w in WORLDS:
        logs = [(root / f"cases{w}" / f"log{r}").read_text()[-3000:] for r in range(w)]
        assert codes[w] == [0] * w, (w, codes[w], logs)
    out = {}
    for w in WORLDS:
        out[w] = []
        for r in range(w):
            with np.load(root / f"cases{w}" / f"r{r}.npz") as z:
                out[w].append({key: z[key] for key in z.files})
    with np.load(root / "kill2" / "kill.npz") as z:
        out["kill"] = (codes["kill"], {key: z[key] for key in z.files})
    return out


def got(runs, w, case, rank=0):
    pre = case + "."
    return {k[len(pre):]: v for k, v in runs[w][rank].items() if k.startswith(pre)}


def not_correct(misses, gap) -> bool:
    return misses > worker.CHECK["id_misses"] or gap > worker.CHECK["dist_gap"]


# -- across ranks ------------------------------------------------------------------


@pytest.mark.parametrize("w", WORLDS)
def test_front_end_over_per_rank_ingest_equals_whole_corpus_bit_for_bit(runs, w):
    r = got(runs, w, "parity")
    assert bool(r["same_shard"]) and int(r["ntotal"]) == worker.PARITY_ROWS
    for a, b in (("ld", "wd"), ("li", "wi"), ("ld3", "wd3"), ("li3", "wi3"), ("lkd", "wkd"),
                 ("lki", "wki")):
        assert r[a].dtype == r[b].dtype and np.array_equal(r[a], r[b]), a


@pytest.mark.parametrize("w", WORLDS)
def test_front_end_holds_against_the_streamed_reference(runs, w):
    r = got(runs, w, "reference")
    assert int(r["n"]) == worker.SPEC["rows"]
    assert int(r["misses"]) == 0 and float(r["gap"]) <= worker.CHECK["dist_gap"]
    np.testing.assert_array_equal(r["i"], r["ref_i"])   # no exact ties in this corpus


@pytest.mark.parametrize("w", [2, 4])
def test_a_rank_dropped_from_the_merge_reads_not_correct(runs, w):
    r = got(runs, w, "fault_drop")
    assert not_correct(int(r["misses"]), float(r["gap"]))


@pytest.mark.parametrize("w", WORLDS)
def test_ids_reconstruct_state_and_removal_after_per_rank_ingest(runs, w):
    r = got(runs, w, "state")
    x, ids, _ = worker.parity_data()
    np.testing.assert_array_equal(r["ids"], r["whole_ids"])
    np.testing.assert_array_equal(r["ids"], ids)
    np.testing.assert_array_equal(r["rec"], x[4321])
    np.testing.assert_array_equal(r["vectors"], x)
    np.testing.assert_array_equal(r["state_ids"], ids)
    assert int(r["removed"]) == int(r["whole_removed"]) == len(ids[::7])
    np.testing.assert_array_equal(r["after"], r["whole_after"])
    assert int(r["ntotal_after"]) == len(ids) - len(ids[::7])


@pytest.mark.parametrize("w", [2, 4])
def test_overlapping_ranks_are_refused_on_every_rank(runs, w):
    msgs = {str(got(runs, w, "layout", r)["raised"]) for r in range(w)}
    assert len(msgs) == 1
    (msg,) = msgs
    assert f"rank {w - 2}'s last id" in msg and f"rank {w - 1}'s first id 0" in msg


@pytest.mark.parametrize("w", WORLDS)
def test_counters_count_staged_rows_and_gathered_candidates(runs, w):
    for rank in range(w):
        c = got(runs, w, "counters", rank)
        lo, hi = worker.load_layout(worker.PARITY_ROWS, w, rank)
        slo, shi = GEN.make(worker.SPEC, 0, "cpu").rank_range(rank, w)
        assert int(c["staged_live_rows"]) == 2 * (hi - lo) + (shi - slo)
        per_rank = 3 * 5 * 10 + 2 * 3 + 5 * 10 + 2 * 3 + 2 * 5 * 10 + 32 * 10 * (2 if w > 1 else 1)
        assert int(c["merge_candidates"]) == w * per_rank


def test_a_killed_follower_ends_the_caller_with_an_error(runs):
    codes, r = runs["kill"]
    assert codes[1] != 0 and codes[0] == 0
    assert str(r["raised"]) and float(r["seconds"]) < 60


# -- one rank, in process ------------------------------------------------------------


def _streamed(spec=worker.SPEC, seed=worker.SEED):
    corpus = GEN.make(spec, seed, "cpu")
    index = ShardedFlatIndex(dim=spec["dim"], device="cpu")
    index.add_local(corpus.rank_chunks(0, 1, "cpu"), rows=corpus.rows)
    return corpus, index, GEN.queries(spec, 16, seed, "cpu")


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_generator_chunks_do_not_depend_on_the_rank_count(world):
    corpus = GEN.make(worker.SPEC, worker.SEED, "cpu")
    whole = torch.cat([corpus.chunk(c, "cpu") for c in range(corpus.chunks)])
    assert whole.shape == (worker.SPEC["rows"], worker.SPEC["dim"]) and corpus.chunks == 6
    torch.testing.assert_close(whole.norm(dim=1), torch.ones(len(whole)))
    parts, ids = [], []
    for rank in range(world):
        fresh = GEN.make(worker.SPEC, worker.SEED, "cpu")   # another rank's process
        for v, i in fresh.rank_chunks(rank, world, "cpu"):
            parts.append(v)
            ids.append(i)
    assert torch.equal(torch.cat(parts), whole)
    assert torch.equal(torch.cat(ids), torch.arange(len(whole)))
    assert not torch.equal(GEN.make(worker.SPEC, worker.SEED + 1, "cpu").chunk(0, "cpu"),
                           whole[:1000])


def test_generator_makes_no_rows_until_asked(monkeypatch):
    monkeypatch.setattr(torch, "randn", lambda *a, **k: pytest.fail("a row was drawn"))
    corpus = GEN.make(dict(worker.CARD_SPEC, rows=640_000_000), 7, "cpu")
    assert corpus.chunks == 640 and corpus.rank_range(3, 4) == (480_000_000, 640_000_000)


def test_reference_keeps_the_lowest_id_among_tied_rows():
    rows = torch.ones((50, 4))
    blocks = [(0, rows[:20]), (20, rows[20:])]
    d, i, watched, n = stream_topk(blocks, np.zeros((1, 4), np.float32), 5, "cpu",
                                   watch=np.array([[3, 49, 60, 0, 1]]))
    assert i.tolist() == [[0, 1, 2, 3, 4]] and n == 50
    assert torch.isinf(watched[0, 2]) and (watched[0, [0, 1, 3, 4]] == 4.0).all()


def test_tf32_rerank_reads_not_correct(monkeypatch):
    """A planted fault: the per-shard rerank computes its distances from
    TF32-rounded rows, a precision below the configuration's float32."""
    corpus, index, pool = _streamed()
    ref_d, _, _, n = stream_topk(corpus.blocks("cpu"), pool, worker.K, "cpu")

    def judged(d, i):
        watched = stream_topk(corpus.blocks("cpu"), pool, worker.K, "cpu", watch=i)[2]
        return score(ref_d, watched, i, d, n, worker.CHECK["tie_tol"])

    d, i = index._search(pool, worker.K, None, kernel_route=True)
    assert not not_correct(*judged(d, i))
    real = sharded.exact_rerank_rows
    monkeypatch.setattr(sharded, "exact_rerank_rows",
                        lambda vectors, *a: real(tf32(vectors), *a))
    assert not_correct(*judged(*index._search(pool, worker.K, None, kernel_route=True)))


@pytest.mark.parametrize("scan_dtype", ["float32", "int8"])
def test_add_local_stages_what_load_stages(scan_dtype):
    x, ids, q = worker.parity_data()
    whole = ShardedFlatIndex(dim=worker.PARITY_DIM, scan_dtype=scan_dtype, device="cpu")
    whole.load(x, ids)
    local = ShardedFlatIndex(dim=worker.PARITY_DIM, scan_dtype=scan_dtype, device="cpu")
    local.add_local(worker.chunked(x, ids, 0, len(x), 1234), rows=len(x))
    assert local.ntotal == whole.ntotal == len(x)
    for a, b in zip(whole._stage(), local._stage()):
        assert torch.equal(a, b)
    for route in (True, False):
        for a, b in zip(whole._search(q, 7, None, route), local._search(q, 7, None, route)):
            assert np.array_equal(a, b)
    local.add(x[:3] + 1, np.arange(3) + 10**6)   # parks in the tail, as after a staging
    assert local.ntotal == len(x) + 3 and local._tail.count == 3


@pytest.mark.parametrize("case", ["descending", "short", "long", "wide", "negative", "non_empty"])
def test_add_local_refuses_a_broken_layout(case):
    v = np.ones((4, 8), np.float32)
    index = ShardedFlatIndex(dim=8, device="cpu")
    chunks, rows = [(v, np.arange(4))], 4
    if case == "descending":
        chunks = [(v, np.arange(4)), (v, np.arange(4) + 2)]
        rows = 8
    elif case == "short":
        rows = 5
    elif case == "long":
        rows = 3
    elif case == "wide":
        chunks = [(np.ones((4, 9), np.float32), np.arange(4))]
    elif case == "negative":
        chunks = [(v, np.arange(4) - 1)]
    else:
        index.add(v, np.arange(4))
    with pytest.raises(ValueError, match="add_local"):
        index.add_local(chunks, rows=rows)


@pytest.fixture
def spans():
    timing.reset()
    timing.enable(True)
    yield timing
    timing.enable(False)
    timing.reset()


def test_spans_and_counters_of_ingest_and_search(spans):
    before = dict(sharded.COUNTERS)
    requests = serve.COUNTERS["requests"]
    corpus, index, pool = _streamed()
    table = spans.snapshot()
    assert table["sharded.ingest"][0] == 1 and table["sharded.stage"][0] == corpus.chunks
    assert table["sharded.stage"][1] <= table["sharded.ingest"][1]
    assert sharded.COUNTERS["staged_live_rows"] - before["staged_live_rows"] == corpus.rows
    server = ShardServer(index)
    assert server.is_root
    for call in range(3):
        spans.reset()
        server.search(pool, 5)
        assert {n: c for n, (c, _) in spans.snapshot().items()} == dict.fromkeys(
            ("sharded.fanout", "sharded.scan", "sharded.merge", "sharded.fetch"), 1)
    spans.reset()
    index.search_device(pool, 5)
    index._search(pool, 5, None, kernel_route=True)
    assert {n: c for n, (c, _) in spans.snapshot().items()} == {
        "sharded.scan": 2, "sharded.rerank": 1, "sharded.merge": 2, "sharded.fetch": 1}
    assert serve.COUNTERS["requests"] - requests == 3
    assert sharded.COUNTERS["merge_candidates"] - before["merge_candidates"] == 5 * 16 * 5


def test_spans_nest_inside_the_search_and_leave_results_alone(spans):
    _, index, pool = _streamed()
    server = ShardServer(index)
    on = server.search(pool, 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            server.search(pool, 5)
    marks = {e.name(): (int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns()))
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CPU
             and (e.name().startswith("c99vdb.") or e.name() == "outer")}
    names = ["c99vdb.sharded." + n for n in ("fanout", "scan", "merge", "fetch")]
    assert set(marks) == {"outer", *names}
    inner = [marks[n] for n in names]
    assert all(marks["outer"][0] <= s <= e <= marks["outer"][1] for s, e in inner)
    assert all(a[1] <= b[0] for a, b in zip(inner, inner[1:]))
    spans.enable(False)
    off = server.search(pool, 5)
    assert all(np.array_equal(a, b) for a, b in zip(on, off))
    spans.reset()
    server.search(pool, 5)
    assert spans.snapshot() == {}


# -- the benchmark entry -------------------------------------------------------------


def _tiny_cell(chips: int) -> harness.Cell:
    c = harness.Cell.load(harness.load_benchmark(REPO / "BENCHMARK.json"), CELL)
    c.config["corpus"].update(rows=6000, chunk_rows=1000)
    c.traffic["pool"] = 256
    c.chips = chips
    return c


def test_entry_fails_before_any_process_without_the_per_rank_ingest(monkeypatch):
    import time

    entry = harness.load_module("entries", "sharded_search")
    monkeypatch.delattr(ShardedFlatIndex, "add_local")
    monkeypatch.setattr(subprocess, "Popen", lambda *a, **k: pytest.fail("a process started"))
    with pytest.raises(RuntimeError, match="add_local"):
        harness.run_cell(_tiny_cell(4), 5, 0.2, False, "cpu", time.perf_counter())
    assert entry.RANKS.procs == []


def test_entry_runs_correct_and_leaves_no_follower(monkeypatch):
    import time

    entry = harness.load_module("entries", "sharded_search")
    monkeypatch.setenv("C99VDB_PLATFORM", "cpu")
    monkeypatch.setattr(harness, "banned_modules", lambda: [])   # this process holds jax
    started = []
    real = subprocess.Popen

    def popen(*a, **k):
        started.append(real(*a, **k))
        return started[-1]

    monkeypatch.setattr(subprocess, "Popen", popen)
    out = harness.run_cell(_tiny_cell(2), 2**33 + 5, 0.5, True, "cpu", time.perf_counter())
    assert out["correct"], out["checks"]
    assert {"shard.merge_ms", "shard.fanout_ms"} <= set(out["metrics"])
    assert len(started) == 1 and [p.returncode for p in started] == [0]
    assert entry.RANKS.procs == [] and entry.RANKS.server is None
