"""A run with its timed path broken underneath comes out not correct, for
each fault a query service can have: an answer altered where it is
produced, half of the batch left out, and a call that hands back the last
call's answers (its state unchanged)."""

import numpy as np
import pytest

from tiny import CELLS, run


def alter_search(search):
    def broken(self, queries, k, **kw):
        d, i = search(self, queries, k, **kw)
        i = i.copy()
        i[0, 0] = (i[0, 0] + 1) % self.ntotal
        return d, i
    return broken


def halve_search(search):
    def broken(self, queries, k, **kw):
        d, i = search(self, queries, k, **kw)
        d, i = d.copy(), i.copy()
        h = max(1, len(i) // 2)
        if len(i) == 1:        # one query a call: every other call answers nothing
            broken.calls = getattr(broken, "calls", 0) + 1
            if broken.calls % 2:
                return np.full_like(d, np.inf), np.full_like(i, -1)
            return d, i
        d[h:], i[h:] = d[:h][: len(i) - h], i[:h][: len(i) - h]
        return d, i
    return broken


def stale_search(search):
    def broken(self, queries, k, **kw):
        last = getattr(broken, "last", None)
        broken.last = search(self, queries, k, **kw)
        return last if last is not None and last[0].shape == broken.last[0].shape else broken.last
    return broken


FAULTS = {"altered": alter_search, "half_batch": halve_search, "stale": stale_search}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(monkeypatch, name, fault):
    from c99_vectordb_tpu_torch.models.flat import FlatIndex

    if name.endswith("recall_single"):
        # The single recall ranks every note: break its ranking instead.
        monkeypatch.setattr(FlatIndex, "ranked_all", ranked_fault(fault, FlatIndex.ranked_all))
    else:
        monkeypatch.setattr(FlatIndex, "search", FAULTS[fault](FlatIndex.search))
    out = run(name)
    assert not out["correct"], out["checks"]


def ranked_fault(fault, ranked_all):
    def broken(self, query):
        d, i = ranked_all(self, query)
        d, i = d.copy(), i.copy()
        if fault == "altered":
            i[0] = (i[0] + 1) % self.ntotal
        elif fault == "half_batch":
            broken.calls = getattr(broken, "calls", 0) + 1
            if broken.calls % 2:
                i[:] = -1
        else:
            last = getattr(broken, "last", None)
            broken.last = (d, i)
            if last is not None:
                return last
        return d, i
    return broken


@pytest.mark.parametrize("name", [c for c in CELLS if c.startswith("memo")])
def test_altered_record_is_caught(monkeypatch, name):
    from c99_vectordb_tpu_torch.storage.yaml_store import RecordStore

    meta_at = RecordStore.meta_at

    def broken(self, rid):
        m = meta_at(self, rid)
        return dict(m, priority=-1) if m else {"source": "altered"}

    monkeypatch.setattr(RecordStore, "meta_at", broken)
    out = run(name)
    assert not out["correct"] and out["checks"]["record_mismatches"]["value"] > 0
    assert out["checks"]["id_misses"]["value"] == 0
