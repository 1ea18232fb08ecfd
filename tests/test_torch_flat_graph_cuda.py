"""FlatIndex's CUDA graph route on the card (models/flat.py SearchGraph):
every replayed search bit-equal to an eager search of the same store.

The eager side is a twin index holding the same rows whose graph cache
keeps no key (GraphCache(keys=0)), so each of its calls is a key's first
sighting and runs eagerly. Every test here is marked `cuda` and skips
without a card. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_flat_graph_cuda.py -q
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from c99_vectordb_tpu_torch.models import flat
from c99_vectordb_tpu_torch.models.flat import FlatIndex, GraphCache
from c99_vectordb_tpu_torch.ops import topk_cuda

pytestmark = pytest.mark.cuda

DIM = 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda", 0)


def _rows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32), np.arange(n, dtype=np.int64) * 3 + 1


def _pair(cuda, n=20000, seed=1, scan_dtype="float32"):
    """(index, eager twin) over the same rows."""
    x, ids = _rows(n, seed)
    index = FlatIndex(dim=DIM, scan_dtype=scan_dtype, device=cuda)
    twin = FlatIndex(dim=DIM, scan_dtype=scan_dtype, device=cuda)
    for ix in (index, twin):
        ix.add(x, ids)
    twin._graphs = GraphCache(keys=0)
    return index, twin


def _queries(b: int, seed: int):
    return np.random.default_rng(1000 + seed).standard_normal((b, DIM)).astype(np.float32)


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _counters():
    return dict(flat.COUNTERS)


@pytest.mark.parametrize("k", [10, 20])
@pytest.mark.parametrize("b", [1, 7, 128, 200])
def test_replays_are_bit_equal_to_eager_searches(cuda, b, k):
    index, twin = _pair(cuda)
    c0, l0 = _counters(), topk_cuda.fused_l2_topk.launches
    for call in range(5):
        q = _queries(b, call)
        got = index.search(q, k)
        _same(got, twin.search(q, k))
        assert got[1].dtype == np.int64 and got[1].shape == (b, k)
    c1 = _counters()
    assert c1["graph_captures"] - c0["graph_captures"] == 1
    assert c1["graph_replays"] - c0["graph_replays"] == 3
    assert c1["eager_searches"] - c0["eager_searches"] == 1 + 5          # index's first, twin's five
    assert topk_cuda.fused_l2_topk.launches - l0 == 10


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
def test_replays_in_the_other_scan_modes(cuda, scan_dtype):
    index, twin = _pair(cuda, scan_dtype=scan_dtype)
    c0 = _counters()
    for call in range(4):
        q = _queries(64, call)
        _same(index.search(q, 10), twin.search(q, 10))
    assert _counters()["graph_replays"] - c0["graph_replays"] == 2


def test_k_past_the_store_pads_as_eager(cuda):
    """1000 rows (cap 1024) at k 1100: the kernel's 1024-deep shortlist,
    k_eff 1024, and the host pads to k with (inf, -1)."""
    index, twin = _pair(cuda, n=1000)
    for call in range(3):
        q = _queries(3, call)
        got = index.search(q, 1100)
        _same(got, twin.search(q, 1100))
        assert np.isinf(got[0][:, 1000:]).all() and (got[1][:, 1000:] == -1).all()
    assert index._graphs[(3, 1100)] is not None


def test_add_restages_and_captures_afresh(cuda):
    index, twin = _pair(cuda)
    c0 = _counters()
    q = _queries(16, 0)
    for _ in range(3):
        _same(index.search(q, 10), twin.search(q, 10))
    old = index._graphs[(16, 10)]
    # The queries themselves as new rows: each must now be its own nearest.
    new_ids = np.arange(16, dtype=np.int64) * 3 + 2
    for ix in (index, twin):
        ix.add(q, new_ids)
    twin._graphs = GraphCache(keys=0)
    assert (16, 10) not in index._graphs
    for call in range(3):
        got = index.search(q, 10)
        _same(got, twin.search(q, 10))
        np.testing.assert_array_equal(got[1][:, 0], new_ids)
    new = index._graphs[(16, 10)]
    assert new is not old
    c1 = _counters()
    assert c1["graph_captures"] - c0["graph_captures"] == 2
    assert c1["graph_replays"] - c0["graph_replays"] == 2


def test_returned_arrays_outlive_the_next_call(cuda):
    index, _ = _pair(cuda)
    for call in range(3):
        index.search(_queries(32, call), 10)
    graph = index._graphs[(32, 10)]
    first = index.search(_queries(32, 7), 10)
    kept = (first[0].copy(), first[1].copy())
    second = index.search(_queries(32, 8), 10)
    assert not np.array_equal(second[1], kept[1])
    _same(first, kept)
    for arr in first + second:
        assert not np.shares_memory(arr, graph.d_np) and not np.shares_memory(arr, graph.i_np)


def test_masked_and_deep_searches_stay_eager(cuda):
    index, twin = _pair(cuda)
    mask = np.arange(70000) % 2 == 1
    c0 = _counters()
    for call in range(3):
        q = _queries(8, call)
        _same(index.search(q, 10, id_mask=mask), twin.search(q, 10, id_mask=mask))
        _same(index.search(q, 600, id_mask=None), twin.search(q, 600))   # k_scan 1200 > 1024
    c1 = _counters()
    assert c1["graph_captures"] == c0["graph_captures"]
    assert c1["graph_replays"] == c0["graph_replays"]
    assert c1["eager_searches"] - c0["eager_searches"] == 12
    assert len(index._graphs) == 0


def test_each_replay_counts_one_launch(cuda):
    index, _ = _pair(cuda)
    q = _queries(128, 0)
    index.search(q, 10)
    index.search(q, 10)                              # captured here
    f = topk_cuda.fused_l2_topk
    before = (f.launches, f.launches_by_mode["float32"], f.launches_by_qtile[128])
    for _ in range(4):
        index.search(q, 10)
    assert (f.launches, f.launches_by_mode["float32"], f.launches_by_qtile[128]) == tuple(
        v + 4 for v in before)


def test_the_cache_holds_its_cap(cuda):
    index, twin = _pair(cuda)
    index._graphs = GraphCache(keys=2)
    c0 = _counters()
    for b in (1, 2, 3, 1):
        for call in range(3):
            q = _queries(b, call)
            _same(index.search(q, 10), twin.search(q, 10))
        assert len(index._graphs) <= 2
    assert (2, 10) not in index._graphs and (1, 10) in index._graphs
    assert _counters()["graph_captures"] - c0["graph_captures"] == 4


def test_the_profiler_sees_the_replayed_kernels(cuda):
    index, _ = _pair(cuda)
    q = _queries(128, 0)
    for _ in range(3):
        index.search(q, 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        index.search(q, 10)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() != torch.autograd.DeviceType.CPU]
    assert any("scan_topk_f32_wgmma_kernel" in n for n in names), names
    assert any("merge_splits_kernel" in n for n in names), names
