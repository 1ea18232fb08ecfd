"""The ranking distance at widths where the port does not follow XLA's
summation order bit for bit.

`ops/distances.pairwise_sq_l2` sums each row in XLA's CPU order for D <= 32
and for multiples of 32 (test_torch_cli_surface.py::test_ranking_bits_match_jax
holds those widths bit for bit, the embedder's 384 among them). At other
widths XLA's order is not a simple one, and the two packages' distances
differ in the last bits. This file states the tolerance there:

  * every distance is within ULP_TOL units in the last place of the JAX
    package's distance of the same id. Each package rounds a sum of D
    non-negative squares; the port's order rounds at most 31 + ceil(D/32) - 1
    times along any path (62 at D = 1000), so a first-order worst case is
    tens of ulps, while the largest difference measured on these inputs is
    7 ulps (D = 1000). 16 ulps is twice that, and stays far inside the worst case;
  * the ranked ids are the JAX package's, except where two entries swap:
    the JAX distance of the id the port ranks at position p is within the
    same tolerance of the JAX distance at p (a swap among entries whose
    JAX scores lie within ULP_TOL of each other).
"""

from __future__ import annotations

import numpy as np
import pytest

from c99_vectordb_tpu.models.flat import FlatIndex as JFlat
from c99_vectordb_tpu_torch.models.flat import FlatIndex as TFlat

ULP_TOL = 16
N_ROWS, N_QUERIES = 3000, 8


def _by_id(dists, ids):
    """(B, n) distances in ranked order -> indexed by id."""
    out = np.empty_like(dists)
    for r in range(dists.shape[0]):
        out[r, ids[r]] = dists[r]
    return out


def _check(td, ti, jd, ji):
    assert (np.sort(ti, axis=1) == np.arange(N_ROWS)).all()
    # every distance within ULP_TOL ulps of the JAX distance of the same id
    j_by_id = _by_id(jd, ji)
    assert (np.abs(_by_id(td, ti) - j_by_id) <= ULP_TOL * np.spacing(j_by_id)).all()
    # ids equal but for swaps among entries within the tolerance
    j_of_t = np.take_along_axis(j_by_id, ti, axis=1)
    assert (np.abs(j_of_t - jd) <= ULP_TOL * np.spacing(jd)).all()


@pytest.mark.parametrize("route", ["ranked_many", "ranked_all"])
@pytest.mark.parametrize("d", [33, 48, 100, 200, 500, 1000])
def test_ranking_within_ulps_of_jax(d, route):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((N_ROWS, d)).astype(np.float32)
    q = rng.standard_normal((N_QUERIES, d)).astype(np.float32)
    ids = np.arange(N_ROWS, dtype=np.int64)
    j = JFlat(dim=d)
    j.add(x, ids)
    t = TFlat(dim=d, device="cpu")
    t.add(x, ids)
    if route == "ranked_many":
        jd, ji, jn = j.ranked_many_device(q)
        td, ti, tn = t.ranked_many_device(q)
        assert jn == tn == N_ROWS
        jd, ji = np.asarray(jd)[:, :jn], np.asarray(ji)[:, :jn]
        td, ti = td.numpy()[:, :tn], ti.numpy()[:, :tn]
    else:
        pairs = [(j.ranked_all(qr), t.ranked_all(qr)) for qr in q]
        jd = np.stack([p[0][0] for p in pairs])
        ji = np.stack([p[0][1] for p in pairs])
        td = np.stack([p[1][0] for p in pairs])
        ti = np.stack([p[1][1] for p in pairs])
    _check(td, ti, jd, ji)
