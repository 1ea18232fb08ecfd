"""PyTorch port's memo CLI against the JAX package's across the index
families it has (flat, ivf_flat, ivf_pq, sharded_flat, sharded_ivf and
sharded_ivf_pq at one rank, the bf16 and int8 scan stores, ksub 16, a
pure-code IVF-PQ file), files cross-read between the two CLIs, and `serve
--batch`'s sub-batches. Every comparison runs both CLIs on the same files
(the runner of tests/test_torch_cli_golden.py: same argv, stdin and
starting files; equal (rc, stdout, stderr), YAML and index bytes);
C99VDB_PLATFORM=cpu throughout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_cli_golden import Pair, restore, snapshot

from c99_vectordb_tpu_torch.models.flat import FlatIndex as TFlat
from c99_vectordb_tpu_torch.models.ivf_flat import IVFFlatIndex as TIVF
from c99_vectordb_tpu_torch.models.ivf_pq import IVFPQIndex as TPQ
from c99_vectordb_tpu_torch.ops import distances as tdist
from c99_vectordb_tpu_torch.parallel import ShardedFlatIndex as TSharded
from c99_vectordb_tpu_torch.parallel import ShardedIVFIndex as TShardedIVF
from c99_vectordb_tpu_torch.parallel import ShardedIVFPQIndex as TShardedPQ
from c99_vectordb_tpu_torch.storage.index_io import read_index

INPUT = """\
---
metadata: {source: user}
body: the cat sat on the mat
---
metadata: {source: agent}
body: quarterly tax filings are due in april
---
metadata: {source: user}
body: morning run along the river
"""
WORDS = ("tea coffee morning meeting project deadline budget review design kernel memory "
         "cache index vector search query filter record note user agent system garden "
         "river mountain travel flight hotel").split()
QUERIES = "cat mat\ntax april\nriver run\nsailing\ncat sat mat\n"


def note_bodies(n: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(3, 12)))) for _ in range(n)]


def notes_yaml(n: int, seed: int) -> str:
    return "".join(f"---\nmetadata: {{source: s{i % 3}, n: {i}}}\nbody: {body}\n"
                   for i, body in enumerate(note_bodies(n, seed)))


def queries(n: int, seed: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(" ".join(rng.choice(WORDS, size=int(rng.integers(1, 5)))) + "\n"
                   for _ in range(n))


@pytest.fixture
def pair(tmp_path, monkeypatch, capsys):
    p = Pair(tmp_path, monkeypatch, capsys)
    (tmp_path / "in.yaml").write_text(INPUT)
    return p


def engine(monkeypatch, kind, **env):
    monkeypatch.setenv("C99VDB_INDEX", kind)
    monkeypatch.setenv("C99VDB_NLIST", "2")
    monkeypatch.setenv("C99VDB_NPROBE", "2")
    monkeypatch.setenv("C99VDB_PQ_M", "8")
    for key, value in env.items():
        monkeypatch.setenv(key, value)


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq", "sharded_flat",
                                  "sharded_ivf", "sharded_ivf_pq"])
def test_save_recall_reindex_cycle(pair, monkeypatch, kind):
    engine(monkeypatch, kind)
    rc, out, _ = pair.run("-f", "db", "save", "in.yaml")
    assert rc == 0 and out.splitlines()[0] == "Memorized: 'the cat sat on the mat' (ID: 0)"
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "cat sat mat")
    lines = out.splitlines()
    assert lines[1].startswith("  [0] Score: ") and lines[2] == "      the cat sat on the mat"
    rc, out, _ = pair.run("-f", "db", "-v", "reindex")
    assert out.splitlines()[0] == "Rebuilt index from db.yaml"
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "quarterly tax april")
    assert out.splitlines()[1].startswith("  [1] Score: ")
    pair.run("-f", "db", "recall", "--yaml", "-k", "3", "--filter", "{source: user}", "run")
    pair.run("-f", "db", "serve", "-k", "2", "--batch", "2", stdin=QUERIES)


@pytest.mark.parametrize("scan_dtype", ["bfloat16", "int8"])
def test_flat_scan_dtype_cycle(pair, monkeypatch, scan_dtype):
    engine(monkeypatch, "flat", C99VDB_SCAN_DTYPE=scan_dtype)
    assert pair.run("-f", "db", "save", "in.yaml")[0] == 0
    assert pair.run("-f", "db", "reindex")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "cat sat mat")
    assert out.splitlines()[2] == "      the cat sat on the mat"
    pair.run("-f", "db", "serve", "--yaml", "-k", "3", "--batch", "4", stdin=QUERIES)


def test_sharded_flat_int8_cycle(pair, monkeypatch):
    """C99VDB_INDEX=sharded_flat with the SQ8 scan store (one rank: no
    process group), through both CLIs: save, reindex, recall, serve
    --batch, then an incremental save and recall."""
    engine(monkeypatch, "sharded_flat", C99VDB_SCAN_DTYPE="int8")
    assert pair.run("-f", "db", "save", "in.yaml")[0] == 0
    assert pair.run("-f", "db", "reindex")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "cat sat mat")
    assert out.splitlines()[2] == "      the cat sat on the mat"
    pair.run("-f", "db", "serve", "--yaml", "-k", "3", "--batch", "4", stdin=QUERIES)
    (pair.root / "more.yaml").write_text("---\nbody: a brand new note about sailing\n")
    assert pair.run("-f", "db", "save", "more.yaml")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "sailing note")
    assert out.splitlines()[1].startswith("  [3] Score: ")


def test_sharded_ivf_int8_cycle(pair, monkeypatch):
    """C99VDB_INDEX=sharded_ivf with the SQ8 scan store and a bf16 rerank
    store (one rank: no process group), through both CLIs: save, reindex,
    recall, serve --batch, then an incremental save and recall."""
    engine(monkeypatch, "sharded_ivf", C99VDB_SCAN_DTYPE="int8", C99VDB_RERANK_DTYPE="bfloat16")
    assert pair.run("-f", "db", "save", "in.yaml")[0] == 0
    assert pair.run("-f", "db", "reindex")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "cat sat mat")
    assert out.splitlines()[2] == "      the cat sat on the mat"
    pair.run("-f", "db", "serve", "--yaml", "-k", "3", "--batch", "4", stdin=QUERIES)
    (pair.root / "more.yaml").write_text("---\nbody: a brand new note about sailing\n")
    assert pair.run("-f", "db", "save", "more.yaml")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "sailing note")
    assert out.splitlines()[1].startswith("  [3] Score: ")


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_incremental_add_after_train(pair, monkeypatch, kind):
    engine(monkeypatch, kind)
    pair.run("-f", "db", "save", "in.yaml")
    (pair.root / "more.yaml").write_text("---\nbody: a brand new note about sailing\n")
    rc, out, _ = pair.run("-f", "db", "save", "more.yaml")
    assert rc == 0 and out == "Memorized: 'a brand new note about sailing' (ID: 3)\n"
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "sailing note")
    assert out.splitlines()[1].startswith("  [3] Score: ")
    pair.run("-f", "db", "serve", "-k", "4", "--batch", "3", stdin=QUERIES)


def test_ivf_pq_ksub16_cycle(pair, monkeypatch):
    engine(monkeypatch, "ivf_pq", C99VDB_PQ_KSUB="16")
    assert pair.run("-f", "db", "save", "in.yaml")[0] == 0
    assert pair.run("-f", "db", "reindex")[0] == 0
    rc, out, _ = pair.run("-f", "db", "recall", "-k", "1", "cat sat mat")
    assert out.splitlines()[2] == "      the cat sat on the mat"
    pair.run("-f", "db", "serve", "-k", "2", "--batch", "8", stdin=QUERIES)


def test_ivf_flat_bf16_stores_and_pad_cap(pair, monkeypatch):
    engine(monkeypatch, "ivf_flat", C99VDB_SCAN_DTYPE="bfloat16",
           C99VDB_RERANK_DTYPE="bfloat16", C99VDB_PAD_CAP="8")
    (pair.root / "many.yaml").write_text(notes_yaml(40, seed=5))
    pair.run("-f", "db", "save", "many.yaml")
    pair.run("-f", "db", "reindex")
    pair.run("-f", "db", "recall", "--yaml", "-k", "5", "tea coffee")
    pair.run("-f", "db", "serve", "-k", "5", "--batch", "16", stdin=queries(20, seed=6))


def test_verbose_geometry_warning_on_heavy_tailed_corpus(pair, monkeypatch):
    """-v reindex of an IVF index over a corpus piled into one cell prints
    the geometry warning (devbuild.geometry_advice), the same line as the
    JAX CLI; without -v stderr stays empty."""
    engine(monkeypatch, "ivf_flat", C99VDB_NLIST="16")
    docs = "".join("---\nbody: the same note again\n" for _ in range(280))
    (pair.root / "skew.yaml").write_text(docs + notes_yaml(40, seed=7))
    pair.run("-f", "db", "save", "skew.yaml")
    rc, _, err = pair.run("-f", "db", "-v", "reindex")
    assert rc == 0 and "Warning: heavy-tailed corpus geometry" in err
    assert pair.run("-f", "db", "reindex")[2] == ""


def test_pure_code_ivf_pq_file_serves_per_query(pair, monkeypatch):
    """An IVF-PQ file without a refine store (refine=False, written by the
    API) has no batched ranking: serve --batch answers it one query at a
    time with the ADC ranking, as the JAX CLI does."""
    from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex as JPQ
    from c99_vectordb_tpu.ops.embed import embed_texts
    from c99_vectordb_tpu.storage.index_io import write_index

    (pair.root / "many.yaml").write_text(notes_yaml(60, seed=8))
    pair.run("-f", "db", "save", "many.yaml")
    import yaml

    bodies = [d["body"] for d in yaml.safe_load_all((pair.root / "db.yaml").read_text())]
    index = JPQ(dim=384, nlist=2, nprobe=2, m=8, refine=False)
    x = embed_texts(bodies)
    index.train(x)
    index.add(x, np.arange(len(bodies), dtype=np.int64))
    write_index(index, pair.root / "db.memo")
    calls = []
    real = TPQ.ranked_many_device
    monkeypatch.setattr(TPQ, "ranked_many_device",
                        lambda self, q: calls.append(q) or real(self, q))
    pair.run("-f", "db", "recall", "-k", "4", "tea coffee")
    pair.run("-f", "db", "serve", "-k", "4", "--batch", "8", stdin=queries(10, seed=9))
    assert calls == []  # the per-query route: no batched ranking was asked for


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq", "sharded_flat",
                                  "sharded_ivf", "sharded_ivf_pq"])
def test_cross_read(pair, monkeypatch, kind, writer):
    """A DB saved (and reindexed) by either CLI recalls and serves with the
    same bytes through both."""
    engine(monkeypatch, kind)
    (pair.root / "many.yaml").write_text(notes_yaml(50, seed=10))
    save = pair.run_jax if writer == "jax" else pair.run_torch
    assert save("-f", "db", "save", "many.yaml")[0] == 0
    assert save("-f", "db", "reindex")[0] == 0
    pair.run("-f", "db", "recall", "-k", "5", "tea budget")
    pair.run("-f", "db", "recall", "--yaml", "-k", "5", "--filter", "{source: s1}", "garden")
    pair.run("-f", "db", "serve", "-k", "3", "--batch", "4", stdin=queries(9, seed=11))


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq", "sharded_flat",
                                  "sharded_ivf", "sharded_ivf_pq"])
@pytest.mark.parametrize("per_batch", [1, 3])
def test_serve_batch_sub_batches(pair, monkeypatch, kind, per_batch):
    """--batch 8 under a budget that holds `per_batch` queries' outputs
    ranks in ceil(8 / per_batch) >= 3 sub-batches, each within the budget,
    and prints the same bytes as --batch 1 (and as the JAX CLI)."""
    engine(monkeypatch, kind)
    (pair.root / "many.yaml").write_text(notes_yaml(30, seed=12))
    pair.run("-f", "db", "save", "many.yaml")
    rows = read_index(pair.root / "db.memo", device="cpu").ranked_rows()
    budget = per_batch * rows * tdist.RANKED_BYTES_PER_ROW
    monkeypatch.setattr(tdist, "RANKED_MANY_BUDGET_BYTES", budget)
    cls = {"flat": TFlat, "ivf_flat": TIVF, "ivf_pq": TPQ, "sharded_flat": TSharded,
           "sharded_ivf": TShardedIVF, "sharded_ivf_pq": TShardedPQ}[kind]
    seen = []
    real = cls.ranked_many_device

    def spy(self, q):
        seen.append((type(q), q.shape[0]))
        out = real(self, q)
        assert out[0].numel() * 4 + out[1].numel() * 4 <= budget
        return out

    monkeypatch.setattr(cls, "ranked_many_device", spy)
    stream = queries(8, seed=13)
    single = pair.run_torch("-f", "db", "serve", "-k", "3", stdin=stream)
    assert seen == []
    batched = pair.run("-f", "db", "serve", "-k", "3", "--batch", "8", stdin=stream)
    assert batched == single
    assert [n for _, n in seen] == [per_batch] * (8 // per_batch) + (
        [8 % per_batch] if 8 % per_batch else [])
    assert len(seen) >= 3 and all(t is torch.Tensor for t, _ in seen)


def test_serve_batch_keeps_the_block_on_the_device(pair, monkeypatch):
    """The batch is embedded with embed_texts_device and handed to
    ranked_many_device as a tensor: the host-array embedder is never
    called, and the block is not padded."""
    from c99_vectordb_tpu_torch.ops import embed

    pair.run("-f", "db", "save", "in.yaml")
    monkeypatch.setattr(embed, "embed_texts", lambda *a, **k: pytest.fail("host embed"))
    shapes = []
    real = TFlat.ranked_many_device
    monkeypatch.setattr(TFlat, "ranked_many_device",
                        lambda self, q: shapes.append(tuple(q.shape)) or real(self, q))
    rc, out, err = pair.run_torch("-f", "db", "serve", "-k", "1", "--batch", "4",
                                  stdin="cat\ntax\nriver\n")
    assert rc == 0 and err == "" and out.count("Top 1 results:") == 3
    assert shapes == [(3, 384)]


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq", "sharded_flat",
                                  "sharded_ivf", "sharded_ivf_pq"])
def test_ranked_device_accepts_tensors(monkeypatch, tmp_path, kind):
    """ranked_all_device / ranked_many_device take a tensor on the
    index's device as well as a numpy array, with the same bits."""
    from c99_vectordb_tpu_torch.commands import build_index_from_store
    from c99_vectordb_tpu_torch.ops.embed import embed_texts_device

    engine(monkeypatch, kind)
    index = build_index_from_store(note_bodies(40, seed=14), device="cpu")
    q = embed_texts_device(["tea coffee", "river"], device="cpu")
    d_np, i_np, n = index.ranked_all_device(q[0].numpy())
    d_t, i_t, n_t = index.ranked_all_device(q[0])
    assert n == n_t == 40
    assert torch.equal(d_np, d_t) and torch.equal(i_np, i_t)
    dm, im, _ = index.ranked_many_device(q)
    assert torch.equal(dm[0], d_t) and torch.equal(im[0], i_t)
    dm2, im2, _ = index.ranked_many_device(q.numpy())
    assert torch.equal(dm, dm2) and torch.equal(im, im2)
    assert index.ranked_rows() == dm.shape[1]


def test_restore_round_trip(tmp_path):
    """The runner's snapshot/restore keeps nested files and drops new ones."""
    (tmp_path / "a" / "b").mkdir(parents=True)
    (tmp_path / "a" / "b" / "x.yaml").write_text("x")
    before = snapshot(tmp_path)
    (tmp_path / "y.memo").write_bytes(b"y")
    restore(tmp_path, before)
    assert snapshot(tmp_path) == before


@pytest.mark.parametrize("kind", ["flat", "ivf_flat", "ivf_pq"])
def test_ranked_many_matches_jax(kind):
    """The batched ranking behind serve --batch (tests/test_ranked_many.py's
    cases) equals the JAX package's bit for bit on Gaussian rows, and each
    row equals the one-query ranking."""
    from c99_vectordb_tpu.models.flat import FlatIndex as JFlat
    from c99_vectordb_tpu.models.ivf_flat import IVFFlatIndex as JIVF
    from c99_vectordb_tpu.models.ivf_pq import IVFPQIndex as JPQ

    rng = np.random.default_rng(11)
    points = rng.standard_normal((512, 32)).astype(np.float32)
    ids = np.arange(512, dtype=np.int64)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    if kind == "flat":
        j = JFlat(dim=32)
    else:
        j = JIVF(dim=32, nlist=8) if kind == "ivf_flat" else JPQ(dim=32, nlist=8, m=4)
        j.train(points)
    j.add(points, ids)
    cls = {"flat": TFlat, "ivf_flat": TIVF, "ivf_pq": TPQ}[kind]
    t = cls.from_state(*j.state(), device="cpu")
    jd, ji, jn = j.ranked_many_device(q)
    td, ti, tn = t.ranked_many_device(q)
    assert jn == tn == 512
    np.testing.assert_array_equal(td.numpy()[:, :tn], np.asarray(jd)[:, :jn])
    np.testing.assert_array_equal(ti.numpy()[:, :tn], np.asarray(ji)[:, :jn])
    for r in range(5):
        d1, i1, _ = t.ranked_all_device(q[r])
        assert torch.equal(d1[:tn], td[r, :tn]) and torch.equal(i1[:tn], ti[r, :tn])


def test_pure_code_pq_has_no_batched_ranking():
    rng = np.random.default_rng(11)
    points = rng.standard_normal((512, 32)).astype(np.float32)
    t = TPQ(dim=32, nlist=8, m=4, refine=False, device="cpu")
    t.train(points)
    t.add(points, np.arange(512, dtype=np.int64))
    assert t.ranked_many_device(points[:3]) is None and t.ranked_rows() is None
