"""PyTorch port, ops/kmeans.py against the JAX package's ops/kmeans.py on the
CPU (numpy inputs made from a seed, handed to both), including the PQ
subspace trainers `train_kmeans_multi` / `assign_clusters_multi`.

Tolerances: on well-separated blobs the assignments are identical and the
centroids agree within 1e-4 (both sum the same rows, in another order). On
the unstructured Gaussian corpora of the IVF tests, farthest-first seeding
can break a near-tie differently, so the k-means objective must agree
within 2% and the assignments (matched by nearest centroid) on at least 90%
of rows. init="sample" draws another permutation than jax.random, so only
its properties are tested."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c99_vectordb_tpu.ops import kmeans as jk
from c99_vectordb_tpu_torch.ops import kmeans as tk


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 10.0
    points = np.concatenate(
        [c + rng.standard_normal((200, 32)).astype(np.float32) for c in centers])
    return points, centers


def _objective(points, cents, assign):
    return float(((points - cents[assign]) ** 2).sum(1).mean())


@pytest.mark.parametrize("k,iters,seed", [(16, 15, 0), (8, 5, 1), (16, 3, 7)])
def test_separated_blobs_match_jax(blobs, k, iters, seed):
    points, _ = blobs
    want = jk.train_kmeans(points, k, iters=iters, seed=seed)
    got = tk.train_kmeans(points, k, iters=iters, seed=seed, device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(tk.assign_clusters(points, got, device="cpu"),
                                  jk.assign_clusters(points, want))


def test_recovers_blobs_and_assignment_is_argmin(blobs):
    points, centers = blobs
    got = tk.train_kmeans(points, 16, iters=15, seed=0, device="cpu")
    d = ((centers[:, None, :] - got[None, :, :]) ** 2).sum(-1)
    assert (d.min(axis=1) < 32.0 * 4).all()
    assign = tk.assign_clusters(points, got, device="cpu")
    full = ((points[:, None, :] - got[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(assign, full.argmin(axis=1))
    assert assign.dtype == np.int32


def test_assign_clusters_matches_jax_on_given_centroids():
    rng = np.random.default_rng(11)
    data = rng.standard_normal((5000, 24)).astype(np.float32)
    cents = rng.standard_normal((37, 24)).astype(np.float32)
    np.testing.assert_array_equal(tk.assign_clusters(data, cents, chunk=700, device="cpu"),
                                  jk.assign_clusters(data, cents, chunk=700))
    out = tk.assign_clusters(torch.from_numpy(data), torch.from_numpy(cents), out_device=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
    assert tk.assign_clusters(np.zeros((0, 24), np.float32), cents, device="cpu").shape == (0,)


@pytest.mark.parametrize("n,k,seed", [(512, 8, 1), (600, 6, 10), (2000, 16, 0), (1000, 32, 9)])
def test_objective_and_agreement_on_gaussian_corpora(n, k, seed):
    """The unstructured corpora of test_devbuild.py / test_ivf.py."""
    data = np.random.default_rng(seed).standard_normal((n, 24)).astype(np.float32)
    want = jk.train_kmeans(data, k, iters=10, seed=0)
    got = tk.train_kmeans(data, k, iters=10, seed=0, device="cpu")
    wa, ga = jk.assign_clusters(data, want), tk.assign_clusters(data, got, device="cpu")
    ow, og = _objective(data, want, wa), _objective(data, got, ga)
    assert abs(og - ow) <= 0.02 * ow, (og, ow)
    # Match clusters by nearest centroid, then compare assignments.
    match = ((got[:, None, :] - want[None, :, :]) ** 2).sum(-1).argmin(axis=1)
    assert np.mean(match[ga] == wa) >= 0.90


def test_lloyd_and_maximin_match_jax_programs():
    """From one init, one Lloyd program; empty clusters keep their
    centroid; the farthest-first seeding picks the same rows."""
    rng = np.random.default_rng(4)
    data = rng.standard_normal((3000, 16)).astype(np.float32)
    init = data[:10].copy()
    init[9] = 1e3                                  # gets no rows: stays put
    want = np.asarray(jk._lloyd_program(3000, 16, 10, 6, 1000)(
        jnp.asarray(data), jnp.ones((3000,), jnp.float32), jnp.asarray(init)))
    got = tk._lloyd(torch.from_numpy(data), torch.from_numpy(init), 6, 1000).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[9], init[9])
    blob = np.concatenate([c + rng.standard_normal((50, 16)).astype(np.float32)
                           for c in rng.standard_normal((12, 16)).astype(np.float32) * 20])
    want = np.asarray(jk._maximin_init_program(600, 16, 12)(
        jnp.asarray(blob), jnp.ones((600,), jnp.float32)))
    np.testing.assert_array_equal(tk._maximin(torch.from_numpy(blob), 12).numpy(), want)


def test_deterministic_and_tensor_input(blobs):
    points, _ = blobs
    a = tk.train_kmeans(points[:500], 8, iters=3, seed=7, device="cpu")
    b = tk.train_kmeans(points[:500], 8, iters=3, seed=7, device="cpu")
    np.testing.assert_array_equal(a, b)
    dev = tk.train_kmeans(torch.from_numpy(points[:500]), 8, iters=3, seed=7, out_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), a)


def test_sample_init_properties():
    """Mass-proportional seeding: deterministic, different from maximin,
    more centroids on the heavy component, seeds drawn from the data."""
    rng = np.random.default_rng(7)
    big = rng.standard_normal((900, 8)).astype(np.float32)
    tiny = rng.standard_normal((20, 8)).astype(np.float32) + 50.0
    data = np.concatenate([big, tiny])
    c_s = tk.train_kmeans(data, 16, iters=4, init="sample", device="cpu")
    np.testing.assert_array_equal(c_s, tk.train_kmeans(data, 16, iters=4, init="sample",
                                                       device="cpu"))
    c_m = tk.train_kmeans(data, 16, iters=4, init="maximin", device="cpu")
    assert not np.allclose(c_s, c_m)
    a = tk.assign_clusters(data, c_s, device="cpu")
    assert len(np.unique(a[:900])) > len(np.unique(a[900:]))
    seeds = tk.train_kmeans(data, 16, iters=0, init="sample", device="cpu")
    assert all((np.abs(data - s).sum(1) == 0).any() for s in seeds)
    assert len({tuple(s) for s in seeds}) == 16


def test_errors():
    with pytest.raises(ValueError, match="at least"):
        tk.train_kmeans(np.zeros((3, 8), np.float32), 8, device="cpu")
    with pytest.raises(ValueError):
        tk.train_kmeans(np.zeros((30, 8), np.float32), 4, init="nope", device="cpu")


# -- the PQ subspace trainers ------------------------------------------------------


def _subs(m, n, d, seed, spread=8.0):
    """(m, n, d) subspace data with well-separated blobs in each subspace."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((m, 8, d)).astype(np.float32) * spread
    pick = rng.integers(0, 8, (m, n))
    return (np.take_along_axis(centers, pick[:, :, None], axis=1)
            + rng.standard_normal((m, n, d)).astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("m,n,d,k,seed", [(3, 600, 8, 8, 2), (4, 1000, 4, 8, 0),
                                          (2, 300, 6, 16, 5)])
def test_multi_trainers_match_jax(m, n, d, k, seed):
    subs = _subs(m, n, d, seed)
    want = jk.train_kmeans_multi(subs, k, iters=5, seed=seed)
    got = tk.train_kmeans_multi(subs, k, iters=5, seed=seed, device="cpu")
    assert got.shape == (m, k, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        tk.assign_clusters_multi(subs, got, chunk=257, device="cpu"),
        jk.assign_clusters_multi(subs, want))


def test_multi_maximin_and_lloyd_match_jax_programs():
    """The seeding picks the same rows as the JAX package's vmapped
    maximin over the padded sample (its mask hides the padding), and one
    Lloyd program from one init agrees, empty clusters kept."""
    import jax

    subs = _subs(3, 605, 4, seed=3)
    padded, valid = jk._pad_rows_multi(subs, 8)
    init_j = np.asarray(jax.vmap(lambda x, v: jk._maximin_core(x, v, 12), in_axes=(0, None))(
        jnp.asarray(padded), jnp.asarray(valid)))
    init_t = tk._maximin_multi(torch.from_numpy(subs), 12).numpy()
    np.testing.assert_array_equal(init_t, init_j)
    init = init_t.copy()
    init[:, 11] = 1e3                                 # gets no rows: stays put
    padded, valid = jk._pad_rows_multi(subs, 121)
    want = np.asarray(jk._lloyd_multi_program(3, padded.shape[1], 4, 12, 6, 121)(
        jnp.asarray(padded), jnp.asarray(valid), jnp.asarray(init)))
    got = tk._lloyd_multi(torch.from_numpy(subs), torch.from_numpy(init), 6, 121).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[:, 11], init[:, 11])


def test_multi_deterministic_tensor_input_and_errors():
    subs = _subs(2, 400, 4, seed=9)
    a = tk.train_kmeans_multi(subs, 8, iters=3, seed=1, device="cpu")
    b = tk.train_kmeans_multi(torch.from_numpy(subs), 8, iters=3, seed=1, out_device=True)
    assert isinstance(b, torch.Tensor)
    np.testing.assert_array_equal(a, b.numpy())
    out = tk.assign_clusters_multi(torch.from_numpy(subs), b, out_device=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.int32 and out.shape == (2, 400)
    assert tk.assign_clusters_multi(np.zeros((2, 0, 4), np.float32), a,
                                    device="cpu").shape == (2, 0)
    with pytest.raises(ValueError, match="at least"):
        tk.train_kmeans_multi(subs[:, :5], 8, device="cpu")
