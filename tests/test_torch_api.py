"""PyTorch port, MemoDB against the JAX package's MemoDB: the same calls on
two databases in two directories, the JAX one on its CPU backend and the
port's with device="cpu".

After every call: the hits agree (ids, bodies, metadata; scores within
1e-6, ids equal except swaps among hits whose scores agree within 1e-6),
and the YAML record files are byte-identical, as are the TPUVDB01 index
files (the embeddings are bit-identical)."""

import numpy as np
import pytest

from c99_vectordb_tpu.api import MemoDB as JMemoDB
from c99_vectordb_tpu_torch.api import MemoDB as TMemoDB

TOL = 1e-6


def assert_hits_match(want, got):
    assert len(want) == len(got)
    scores = {h.doc_id: h.score for h in want}
    for w, g in zip(want, got):
        assert abs(w.score - g.score) <= TOL, (w, g)
        if w.doc_id != g.doc_id:
            tied = g.doc_id in scores and abs(scores[g.doc_id] - g.score) <= TOL
            assert tied or abs(g.score - want[-1].score) <= TOL, (w, g)
        else:
            assert (w.body, w.metadata) == (g.body, g.metadata)


class Pair:
    def __init__(self, tmp_path):
        (tmp_path / "jax").mkdir()
        (tmp_path / "torch").mkdir()
        self.j = JMemoDB("notes", cwd=str(tmp_path / "jax"))
        self.t = TMemoDB("notes", cwd=str(tmp_path / "torch"), device="cpu")

    def files_match(self):
        for a, b in ((self.j.records_path, self.t.records_path),
                     (self.j.index_path, self.t.index_path)):
            assert a.exists() == b.exists()
            if a.exists():
                assert a.read_bytes() == b.read_bytes(), a.name

    def same(self, fn):
        """Apply fn to both databases; compare results and files."""
        jr, tr = fn(self.j), fn(self.t)
        if isinstance(jr, list) and jr and isinstance(jr[0], list):
            assert len(jr) == len(tr)
            for a, b in zip(jr, tr):
                assert_hits_match(a, b)
        elif isinstance(jr, list) and jr and hasattr(jr[0], "score"):
            assert_hits_match(jr, tr)
        else:
            assert jr == tr
        self.files_match()
        return tr


@pytest.fixture
def pair(tmp_path):
    return Pair(tmp_path)


def test_save_and_recall(pair):
    assert pair.same(lambda db: db.save("I prefer tea over coffee", metadata={"source": "user"})) == 0
    pair.same(lambda db: db.save("quarterly tax filings", metadata={"source": "agent"}))
    hits = pair.same(lambda db: db.recall("tea preference", k=1))
    assert hits[0].doc_id == 0 and hits[0].metadata == {"source": "user"}
    pair.same(lambda db: db.recall("tea preference", k=5))


def test_save_many_and_len(pair):
    ids = pair.same(lambda db: db.save_many([
        {"body": "alpha note", "metadata": {"n": 1}},
        {"body": "beta note", "metadata": {"n": 2}},
    ]))
    assert ids == [0, 1]
    assert pair.same(len) == 2
    for bad in ([], [{"body": ""}], ["x"], [{"body": "ok", "metadata": [1]}]):
        with pytest.raises(ValueError):
            pair.t.save_many(bad)


def test_filter_recall_and_analyze(pair):
    pair.same(lambda db: db.save("red apples", metadata={"color": "red", "p": 1}))
    pair.same(lambda db: db.save("green apples", metadata={"color": "green", "p": 2}))
    pair.same(lambda db: db.save("plain apples"))
    for pushdown in (False, True):
        hits = pair.same(lambda db: db.recall("apples", k=5, filter="{color: green}",
                                              pushdown=pushdown))
        assert [h.doc_id for h in hits] == [1]
    assert pair.same(lambda db: list(db.analyze("{p: {$gte: 2}}"))) == [(1, {"color": "green", "p": 2})]
    mask = pair.t.metadata_mask("{color: red}")
    assert mask.tolist() == [True, False, False]
    assert pair.t.metadata_mask("{color: red}") is mask  # memoized per filter and file state


def test_overwrite(pair):
    pair.same(lambda db: db.save("original"))
    pair.same(lambda db: db.save("other"))
    pair.same(lambda db: db.save("replacement text", doc_id=0))
    hits = pair.same(lambda db: db.recall("replacement text", k=1))
    assert hits[0].doc_id == 0
    with pytest.raises(KeyError, match="override id 5"):
        pair.t.save("nope", doc_id=5)


def test_delete_reindex_clean(pair):
    pair.same(lambda db: db.save_many([{"body": f"note number {i} about tea"} for i in range(6)]))
    pair.same(lambda db: db.save("delete me", metadata={"deleted": True}))
    assert pair.same(lambda db: db.delete(2)) is True
    assert pair.same(lambda db: db.delete(2)) is False
    assert pair.same(lambda db: db.delete(99)) is False
    hits = pair.same(lambda db: db.recall_many(["tea"], k=10))
    assert all(h.doc_id != 2 for h in hits[0])
    assert pair.same(lambda db: db.reindex()) == 2
    assert pair.same(len) == 5
    pair.same(lambda db: db.recall("note", k=3))
    assert pair.same(lambda db: db.clean()) is True
    assert pair.same(lambda db: db.clean()) is False
    assert pair.same(lambda db: db.recall("anything")) == []
    assert pair.same(lambda db: db.recall_many(["anything"])) == [[]]


def test_recall_many_batched(pair):
    pair.same(lambda db: db.save_many([
        {"body": f"note about {'tea' if i % 2 else 'coffee'} number {i}",
         "metadata": {"source": "user" if i % 2 else "agent"}}
        for i in range(20)
    ]))
    single = pair.same(lambda db: [db.recall(q, k=3) for q in ("tea", "coffee")])
    batched = pair.same(lambda db: db.recall_many(["tea", "coffee"], k=3))
    for s, b in zip(single, batched):
        assert [h.doc_id for h in b] == [h.doc_id for h in s]
    pair.same(lambda db: db.recall_many(["tea"], k=3, filter="{source: user}"))
    assert pair.same(lambda db: db.recall_many([], k=3)) == []


def test_recall_many_widens_through_filter_misses(pair):
    pair.same(lambda db: db.save_many([
        {"body": f"coffee note {i}", "metadata": {"source": "user" if i % 8 == 0 else "agent"}}
        for i in range(40)
    ]))
    post = pair.same(lambda db: db.recall("coffee", k=5, filter="{source: user}"))
    wide = pair.same(lambda db: db.recall_many(["coffee"], k=5, filter="{source: user}",
                                               pushdown=False))[0]
    assert len(post) == 5 and [h.doc_id for h in wide] == [h.doc_id for h in post]


def test_recall_pushdown_bounded_by_mask(pair):
    pair.same(lambda db: db.save_many([
        {"body": f"tea note {i}", "metadata": {"source": "user" if i in (17, 31) else "agent"}}
        for i in range(40)
    ]))
    pushed = pair.same(lambda db: db.recall("tea", k=5, filter="{source: user}", pushdown=True))
    assert sorted(h.doc_id for h in pushed) == [17, 31]
    assert len(pair.same(lambda db: db.recall("tea", k=1, filter="{source: user}",
                                              pushdown=True))) == 1
    assert pair.same(lambda db: db.recall("tea", k=3, filter="{source: missing}",
                                          pushdown=True)) == []


WORDS = ("tea coffee morning meeting project deadline budget review design kernel memory "
         "cache index vector search query filter record note user agent system priority "
         "garden recipe travel flight hotel train ticket museum concert").split()


def test_random_workload(pair):
    rng = np.random.default_rng(3)
    records = []
    for i in range(300):
        body = " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(3, 9))))
        meta = None if i % 7 == 0 else {"source": ["user", "agent"][i % 2],
                                         "priority": int(rng.integers(0, 5))}
        records.append({"body": body, "metadata": meta})
    queries = [" ".join(WORDS[j] for j in rng.integers(0, len(WORDS), 3)) for _ in range(16)]
    pair.same(lambda db: db.save_many(records))
    pair.same(lambda db: db.recall_many(queries, k=10))
    pair.same(lambda db: db.recall_many(queries, k=10, filter="{priority: {$gte: 3}}"))
    pair.same(lambda db: db.recall_many(queries, k=10, filter="{source: user}", pushdown=False))
    pair.same(lambda db: [db.recall(q, k=5) for q in queries[:4]])
    for doc_id in (5, 77, 120):
        pair.same(lambda db: db.delete(doc_id))
    pair.same(lambda db: db.reindex())
    pair.same(lambda db: db.recall_many(queries, k=10))


def test_resident_cache_and_failed_save(tmp_path, monkeypatch):
    import os
    import time

    db = TMemoDB(str(tmp_path / "db"), device="cpu")
    db.save_many([{"body": f"note {i}"} for i in range(6)])
    idx1, store1 = db._index(), db._store()
    db.recall("note", k=2)
    assert db._index() is idx1 and db._store() is store1
    db.save("fresh note")
    assert db._index().ntotal == 7
    other = TMemoDB(str(tmp_path / "db"), device="cpu")
    other.save("outside note")
    future = time.time() + 2
    for p in (db.records_path, db.index_path):
        os.utime(p, (future, future))
    assert db._index().ntotal == 8 and len(db._store()) == 8

    index = db._index()
    monkeypatch.setattr(index, "add", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        db.save("phantom")
    monkeypatch.undo()
    assert len(db) == 8
    assert db.save("real ninth note") == 8
