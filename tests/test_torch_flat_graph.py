"""FlatIndex's choice between the eager route and a captured CUDA graph of
its search (models/flat.py GraphCache, SearchGraph), on the CPU.

The choice is pure Python: a card, no mask, the kernel route, and a key
(B, k) seen before on the same staging. These tests hold it without a
card; tests/test_torch_flat_graph_cuda.py holds the graphs' results on
one. This file imports no jax.
"""

import numpy as np
import pytest

from c99_vectordb_tpu_torch.models import flat
from c99_vectordb_tpu_torch.models.flat import FlatIndex, GraphCache, kernel_route
from c99_vectordb_tpu_torch.ops import topk_cuda

DIM = 16


def _index(n: int = 1500, seed: int = 3):
    rng = np.random.default_rng(seed)
    index = FlatIndex(dim=DIM, device="cpu")
    index.add(rng.standard_normal((n, DIM)).astype(np.float32), np.arange(n, dtype=np.int64) * 2)
    return index, rng.standard_normal((7, DIM)).astype(np.float32)


def test_a_key_is_eager_then_captured_then_replayed():
    cache = GraphCache()
    route = dict(cuda=True, masked=False, kernel=True)
    assert cache.step((7, 10), **route) == "eager"
    assert cache.step((7, 10), **route) == "capture"
    cache.put((7, 10), "graph")
    assert [cache.step((7, 10), **route) for _ in range(3)] == ["replay"] * 3
    assert cache.step((7, 20), **route) == "eager"          # another k is another key
    assert cache.step((8, 10), **route) == "eager"          # another B too
    assert len(cache) == 3


@pytest.mark.parametrize("cuda, masked, kernel", [(False, False, True), (True, True, True),
                                                  (True, False, False), (False, True, False)])
def test_off_the_graph_route_every_call_is_eager(cuda, masked, kernel):
    cache = GraphCache()
    steps = [cache.step((7, 10), cuda=cuda, masked=masked, kernel=kernel) for _ in range(4)]
    assert steps == ["eager"] * 4
    assert len(cache) == 0 and (7, 10) not in cache


def test_the_least_recently_used_key_goes():
    cache = GraphCache(keys=2)
    route = dict(cuda=True, masked=False, kernel=True)
    for key in ((1, 10), (2, 10)):
        cache.step(key, **route)
        cache.step(key, **route)
        cache.put(key, f"graph {key}")
    assert cache.step((1, 10), **route) == "replay"         # (2, 10) is now the oldest
    assert cache.step((3, 10), **route) == "eager"
    assert len(cache) == 2 and (2, 10) not in cache and (1, 10) in cache
    assert cache.step((2, 10), **route) == "eager"          # seen afresh: evicts (1, 10)
    assert (1, 10) not in cache and cache[(3, 10)] is None


def test_the_default_cap_is_the_module_constant():
    assert GraphCache().keys == flat.GRAPH_KEYS >= 1


@pytest.mark.parametrize("cap, k_scan, want", [(1024, 20, True), (1 << 20, 1024, True),
                                               (512, 20, False), (4096, 1025, False)])
def test_kernel_route(cap, k_scan, want):
    assert kernel_route(cap, k_scan) is want


@pytest.mark.parametrize("mutation", ["add", "remove_ids"])
def test_a_new_staging_starts_a_new_cache(mutation):
    """The staging is part of the key: after add or remove_ids, a key seen
    before is seen afresh, so no graph holding the old pointers replays."""
    index, queries = _index()
    route = dict(cuda=True, masked=False, kernel=True)
    index.search(queries, 10)
    old = index._graphs
    old.step((7, 10), **route)
    old.put((7, 10), "graph on the old staging")
    assert old.step((7, 10), **route) == "replay"
    if mutation == "add":
        index.add(np.ones((1, DIM), np.float32), np.array([1], np.int64))
    else:
        assert index.remove_ids([0]) == 1
    assert index._graphs is not old and len(index._graphs) == 0
    assert index._graphs.step((7, 10), **route) == "eager"


def test_cpu_searches_are_eager_and_leave_the_cache_empty():
    index, queries = _index()
    before = dict(flat.COUNTERS)
    for masked in (False, False, False, True):
        mask = np.ones(3000, bool) if masked else None
        index.search(queries, 10, id_mask=mask)
        index._search(queries, 10, mask, rerank_route=True)
    assert flat.COUNTERS["eager_searches"] == before["eager_searches"] + 8
    assert flat.COUNTERS["graph_captures"] == before["graph_captures"]
    assert flat.COUNTERS["graph_replays"] == before["graph_replays"]
    assert len(index._graphs) == 0


def test_a_replay_counts_the_launches_its_capture_made():
    f = topk_cuda.fused_l2_topk
    saved = (f.launches, dict(f.launches_by_mode), dict(f.launches_by_qtile))
    try:
        before = topk_cuda.launch_counts()
        topk_cuda._count_launch("float32", 128)               # what a capture counts
        delta = topk_cuda.launch_counts() - before
        assert delta == {"launches": 1, "float32": 1, 128: 1}
        topk_cuda.add_launch_counts(delta, -1)                # taken back: nothing ran
        assert topk_cuda.launch_counts() == before
        for _ in range(3):
            topk_cuda.add_launch_counts(delta)                # three replays
        assert f.launches == before["launches"] + 3
        assert f.launches_by_mode["float32"] == before["float32"] + 3
        assert f.launches_by_qtile[128] == before[128] + 3
        assert f.launches_by_mode["int8"] == before["int8"]
    finally:
        f.launches = saved[0]
        f.launches_by_mode.update(saved[1])
        f.launches_by_qtile.update(saved[2])


def test_empty_index_and_empty_batch_skip_the_cache():
    index = FlatIndex(dim=DIM, device="cpu")
    d, i = index.search(np.zeros((3, DIM), np.float32), 4)
    assert d.shape == (3, 4) and np.isinf(d).all() and (i == -1).all()
    assert len(index._graphs) == 0
    full, _ = _index()
    d, i = full.search(np.zeros((0, DIM), np.float32), 4)
    assert d.shape == (0, 4) and i.shape == (0, 4) and i.dtype == np.int64
    assert len(full._graphs) == 0
