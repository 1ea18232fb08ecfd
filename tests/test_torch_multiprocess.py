"""The port's 8-process mesh: the twin of tests/test_multiprocess.py over
torch.distributed. Eight gloo processes (tests/torch_multiprocess_worker.py)
form a ("host", "chip") = (2, 4) mesh and run sharded_search_2level and the
two-level ShardedIVFPQIndex across the process boundary; each holds the
replicated results against a numpy oracle (benchmarks/mp_worker.py's
arrays and checks). The ranks join within JOIN_TIMEOUT_S or the test
fails."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch_multiprocess_worker as worker

WORLD = 8
JOIN_TIMEOUT_S = 240
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp8")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", C99VDB_PLATFORM="cpu")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, "--world", str(WORLD), "--rank", str(r), "--store",
         str(out / "store"), "--out", str(out)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(out)) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append((p.communicate(timeout=JOIN_TIMEOUT_S)[0], p.returncode))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {WORLD} ranks did not join within {JOIN_TIMEOUT_S} s")
    for r, (log, rc) in enumerate(logs):
        assert rc == 0 and "PARITY OK" in log, f"rank {r} rc {rc}:\n{log[-3000:]}"
    res = []
    for r in range(WORLD):
        with np.load(out / f"r{r}.npz") as z:
            res.append({key: z[key] for key in z.files})
    return res


def test_two_level_flat_search_across_processes(ranks):
    """sharded_search_2level on the (2, 4) mesh: the oracle's ids and
    distances on every rank."""
    db, _, queries = worker.data()
    want_d, want_i = worker.oracle(db, queries, worker.K)
    for r in ranks:
        np.testing.assert_array_equal(r["flat_i"], want_i)
        np.testing.assert_allclose(r["flat_d"], want_d, rtol=1e-4, atol=1e-4)


def test_two_level_ivf_pq_across_processes(ranks):
    """The two-level ShardedIVFPQIndex (8 shards over 2 x 4 processes):
    exact distances, recall@5 >= 0.8 against the oracle, the 1-D 8-rank
    mesh's results bit for bit, and the same results on every rank."""
    db, _, queries = worker.data()
    _, want_i = worker.oracle(db, queries, worker.K)
    first = ranks[0]
    assert int(first["pq2_shards"]) == int(first["pq1_shards"]) == WORLD
    hits = sum(len(set(a) & set(b)) for a, b in zip(first["pq2_i"].tolist(), want_i.tolist()))
    assert hits / want_i.size >= 0.8
    np.testing.assert_array_equal(first["pq2_i"], first["pq1_i"])
    np.testing.assert_array_equal(first["pq2_d"], first["pq1_d"])
    for r in ranks[1:]:
        for key, value in first.items():
            np.testing.assert_array_equal(r[key], value, err_msg=key)
