"""VectorDBBench's int-filter cases on the card: FlatIndex.search with
`id_mask` = `id >= round(filter_rate * N)`, filter_rate 0.01 and 0.99, at
262,144 x 768 clustered unit rows, B = 128 and B = 1.

Each search is held against float64 exact distances over the passing rows
(portbench/reference/exact.py's judge, as the benchmark's filtered cells
hold theirs), and the search that builds the mask staging is bit-equal to
the one after it that reuses it. At 0.99 the 2,621 passing rows are at
most 1/64 of the store, so the kernel scans their compacted staging (2,688
rows, whole 128-row tiles); its results are bit-equal to an index that
holds only those rows, searched with no mask. Every test here is marked `cuda` and
skips without a card. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_filtered_search_cuda.py -q
"""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.models import devbuild, flat
from c99_vectordb_tpu_torch.models.flat import FlatIndex
from portbench import harness
from portbench.reference.exact import ExactStore, score_lists

pytestmark = pytest.mark.cuda

N, DIM, K = 262_144, 768, 10
SPEC = {"rows": N, "dim": DIM, "centers": 1024, "noise": 0.6}
# The limits of the benchmark's filtered cells (their configuration's check).
TIE_TOL, DIST_GAP = 2e-5, 1e-5
# The rows each rate's search hands the kernel: the store at 0.01; at 0.99
# its 2,621 passing rows, compacted and padded to 21 tiles of 128.
SCANNED = {0.01: N, 0.99: 2688}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the flat kernel has no CPU mode (run on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def corpus(cuda):
    gen = harness.load_module("corpora", "clustered")
    rows = gen.make(SPEC, 2**31 + 25, cuda).rows
    index = FlatIndex(dim=DIM, device=cuda)
    index.add(rows, np.arange(N, dtype=np.int64))
    return index, rows, gen.queries(SPEC, 128, 2**31 + 25, cuda)


@pytest.mark.parametrize("b", [128, 1])
@pytest.mark.parametrize("rate", [0.01, 0.99])
def test_masked_search_is_exact_and_bit_equal_on_a_hit(cuda, corpus, rate, b):
    index, rows, queries = corpus
    q = queries[:b]
    mask = np.arange(N) >= round(rate * N)
    f0, d0 = dict(flat.COUNTERS), dict(devbuild.COUNTERS)
    built = index.search(q, K, id_mask=mask)
    hit = index.search(q, K, id_mask=mask)
    assert devbuild.COUNTERS["mask_builds"] - d0["mask_builds"] == 1
    assert devbuild.COUNTERS["mask_hits"] - d0["mask_hits"] == 1
    assert devbuild.COUNTERS["mask_live_rows"] == int(mask.sum())
    assert flat.COUNTERS["masked_searches"] - f0["masked_searches"] == 2
    assert flat.COUNTERS["scanned_rows"] - f0["scanned_rows"] == 2 * SCANNED[rate]
    assert flat.COUNTERS["compact_searches"] - f0["compact_searches"] == (2 if rate == 0.99 else 0)
    for a, w in zip(built, hit):
        assert a.dtype == w.dtype and a.shape == w.shape == (b, K)
        np.testing.assert_array_equal(a, w)
    d, i = built
    assert mask[i].all()
    store = ExactStore(rows, cuda, excluded=torch.from_numpy(~mask).to(cuda))
    misses, gap = score_lists(store.distances(q), i, d, K, TIE_TOL)
    assert misses == 0 and gap <= DIST_GAP, (misses, gap)


@pytest.mark.parametrize("b", [128, 1])
@pytest.mark.parametrize("rate", [0.99, 0.01])
def test_masked_search_bit_equal_to_an_index_of_the_passing_rows(cuda, corpus, rate, b):
    index, rows, queries = corpus
    q = queries[:b]
    mask = np.arange(N) >= round(rate * N)
    keep = np.flatnonzero(mask)
    alone = FlatIndex(dim=DIM, device=cuda)
    alone.add(rows[keep], keep)
    f0 = dict(flat.COUNTERS)
    masked = [index.search(q, K, id_mask=mask) for _ in range(3)]
    assert flat.COUNTERS["compact_searches"] - f0["compact_searches"] == (3 if rate == 0.99 else 0)
    # The index of the passing rows takes its eager, capture and replay routes.
    for got in masked:
        want = alone.search(q, K)
        for a, w in zip(got, want):
            assert a.dtype == w.dtype and a.shape == w.shape == (b, K)
            np.testing.assert_array_equal(a, w)
