"""The port's filter masks on the CPU: every index family turns an
external-id `id_mask` into its device keep table once per mask object
(models/devbuild.MaskCache), so a second search with the same object
reads the mask no more. The card routes run on CPU tensors, where each
kernel wrapper takes its plain version."""

import numpy as np
import pytest
import torch

from c99_vectordb_tpu_torch.models.flat import FlatIndex
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex
from c99_vectordb_tpu_torch.models.ivf_pq import IVFPQIndex
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex

DIM = 32
N = 1500


class CountingMask:
    """A bool mask that counts how often it is read as an array."""

    def __init__(self, mask):
        self.mask = mask
        self.reads = 0

    def __array__(self, dtype=None, copy=None):
        self.reads += 1
        return self.mask if dtype is None else self.mask.astype(dtype)


def _corpus():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((N, DIM)).astype(np.float32)
    ids = np.sort(rng.permutation(2 * N)[:N]).astype(np.int64)
    q = (x[::300] + 0.01).astype(np.float32)
    mask = rng.random(2 * N + 7) < 0.4
    return x, ids, q, mask


def _built(family, x, ids):
    if family == "flat":
        index = FlatIndex(dim=DIM, device="cpu")
        return index, lambda q, m: index._search(q, 10, m, rerank_route=True)
    if family == "sharded_flat":
        index = ShardedFlatIndex(dim=DIM, device="cpu")
        return index, lambda q, m: index._search(q, 10, m, kernel_route=True)
    if family == "ivf_flat":
        index = IVFFlatIndex(dim=DIM, nlist=8, nprobe=3, device="cpu")
    else:
        index = IVFPQIndex(dim=DIM, nlist=8, nprobe=3, m=8, refine_factor=10, device="cpu")
    index.train(torch.from_numpy(x))
    return index, lambda q, m: index._search(q, 10, id_mask=m, card_route=True)


@pytest.mark.parametrize("family", ["flat", "ivf_flat", "ivf_pq", "sharded_flat"])
def test_keep_table_built_once_per_mask_object(family):
    x, ids, q, mask = _corpus()
    index, search = _built(family, x, ids)
    index.add(x, ids)
    counted = CountingMask(mask)
    first = search(q, counted)
    second = search(q, counted)
    assert counted.reads == 1
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    hits = first[1][first[1] >= 0]
    assert hits.size and mask[hits].all()
    # A mask read as an array gives what the plain mask gives.
    plain = search(q, mask)
    for a, b in zip(first, plain):
        np.testing.assert_array_equal(a, b)
