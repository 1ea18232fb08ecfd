"""The per-rank ingest and the front end over NCCL on four cards: four ranks
(tests/torch_shard_serve_worker.py --mode card), one per card, each
ingesting its 1,000,000 rows of a 4,000,000 x 96 streamed corpus
(portbench/corpora/clustered_stream.py), rank 0 calling three times
through ShardServer and the others following, then one id removed on each
rank (the count summed by an all_reduce); rank 0's answers are held
against the streamed float64 reference (portbench/reference/streamed.py)
under the sharded cell's limits.

Marked `cuda`; skips without four CUDA cards. Imports neither jax nor the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_shard_serve_cuda.py -q
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_shard_serve_worker as worker

pytestmark = pytest.mark.cuda
WORLD = 4
JOIN_TIMEOUT_S = 600
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA cards (NCCL across cards; the kernel has no CPU mode)")
    out = tmp_path_factory.mktemp("card")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="4", C99VDB_PLATFORM="cuda")
    procs = [subprocess.Popen(
        [sys.executable, worker.__file__, "--world", str(WORLD), "--rank", str(r), "--store",
         str(out / "store"), "--out", str(out), "--mode", "card", "--device", "cuda"],
        stdout=(out / f"log{r}").open("w"), stderr=subprocess.STDOUT, env=env)
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=JOIN_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the {WORLD} ranks did not end within {JOIN_TIMEOUT_S} s")
    logs = [(out / f"log{r}").read_text()[-3000:] for r in range(WORLD)]
    assert codes == [0] * WORLD, (codes, logs)
    res = []
    for r in range(WORLD):
        with np.load(out / f"card_r{r}.npz") as z:
            res.append({key: z[key] for key in z.files})
    return res


def test_every_rank_stages_its_own_rows_over_nccl(ranks):
    per = worker.CARD_SPEC["rows"] // WORLD
    for r in ranks:
        assert str(r["backend"]) == "nccl" and int(r["staged"]) == per
        assert int(r["removed"]) == WORLD


def test_front_end_answers_hold_against_the_streamed_reference(ranks):
    r = ranks[0]
    assert int(r["n"]) == worker.CARD_SPEC["rows"] and bool(r["same"])
    assert int(r["misses"]) == worker.CHECK["id_misses"]
    assert float(r["gap"]) <= worker.CHECK["dist_gap"]
    assert r["i"].shape == (32, worker.K) and (r["i"] >= 0).all()
