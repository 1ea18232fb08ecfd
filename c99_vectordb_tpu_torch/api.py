"""Embedded Python API — the library-level equivalent of the CLI verbs.

The reference exposes only a CLI; this framework additionally offers a
programmatic surface with the same two-file persistence model and the
same semantics (ids, filters, score ordering), so applications can embed
the store without shelling out:

    from c99_vectordb_tpu_torch.api import MemoDB

    db = MemoDB("notes")                       # notes.yaml + notes.memo, on CUDA
    db.save("I prefer tea over coffee", metadata={"source": "user"})
    for hit in db.recall("tea preference", k=2):
        print(hit.doc_id, hit.score, hit.body)
    db.reindex()

Every MemoDB runs on one device (utils/runtime.resolve_device):
MemoDB("notes", device="cpu") runs on the CPU, the default on CUDA.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from .constants import DIM
from .ops.embed import embed_text, embed_texts
from .storage.index_io import load_index_or_fresh, write_index
from .storage.paths import db_paths
from .storage.yaml_store import RecordStore
from .utils.filters import matches, parse_filter
from .utils.runtime import resolve_device
from .utils.text import is_blank_body


@dataclass
class Hit:
    doc_id: int
    score: float
    body: str
    metadata: dict[str, Any] | None


class MemoDB:
    """A YAML-backed semantic memory database with a device vector index."""

    def __init__(self, base: str, cwd: str | None = None, device=None):
        self.device = resolve_device(device)
        self.index_path, self.records_path = db_paths(base, cwd or os.getcwd())
        # filter -> pushdown mask memo (the index families cache masked
        # scan stagings by mask OBJECT identity, so repeated filtered
        # recalls must hand them the same array).
        self._mask_memo: dict = {}
        # Resident store/index, keyed by file stat. The CLI is a fresh
        # process per verb so it pays the load+device-push every time; an
        # embedded MemoDB is the serving surface, so it must pay it once. Mutations through THIS
        # instance publish their in-memory objects back under the new
        # file stat (keeping warm device stagings); external file
        # changes invalidate by stat.
        self._store_cache: tuple[Any, RecordStore] | None = None
        self._index_cache: tuple[Any, Any] | None = None

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _stat_key(path) -> tuple[int, int, int] | None:
        try:
            st = path.stat()
        except OSError:
            return None
        # st_ino matters: both DB files publish via atomic tmp+rename
        # (new inode every write), while st_mtime_ns has kernel-tick
        # granularity — two same-size writes in one tick would otherwise
        # alias and a resident server would keep stale data forever.
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def _store(self) -> RecordStore:
        key = self._stat_key(self.records_path)
        if self._store_cache is not None and self._store_cache[0] == key:
            return self._store_cache[1]
        store = RecordStore.load(self.records_path)
        self._store_cache = (key, store)
        return store

    def _index(self):
        from .commands import make_index

        key = self._stat_key(self.index_path)
        if self._index_cache is not None and self._index_cache[0] == key:
            return self._index_cache[1]
        index = load_index_or_fresh(
            self.index_path, dim=DIM, device=self.device,
            fresh_factory=lambda: make_index(device=self.device),
        )
        self._index_cache = (key, index)
        return index

    def _publish_index(self, index) -> None:
        write_index(index, self.index_path)
        self._index_cache = (self._stat_key(self.index_path), index)

    def _publish_store(self, store: RecordStore) -> None:
        store.save(self.records_path)
        self._store_cache = (self._stat_key(self.records_path), store)

    def _drop_caches(self) -> None:
        self._store_cache = None
        self._index_cache = None
        self._mask_memo.clear()

    def _rebuild(self, store: RecordStore):
        from .commands import build_index_from_store

        index = build_index_from_store(store.bodies, device=self.device)
        self._publish_index(index)
        self._publish_store(store)
        return index

    # -- verbs ---------------------------------------------------------------

    def save(
        self,
        body: str,
        metadata: dict[str, Any] | None = None,
        doc_id: int | None = None,
    ) -> int:
        """Insert a record (or overwrite by explicit doc_id); returns its id."""
        store = self._store()
        index = self._index()
        if doc_id is not None:
            existing = set(int(i) for i in index.ids())
            if doc_id >= len(store) or doc_id not in existing:
                raise KeyError(f"override id {doc_id} does not exist")
        # The cached store/index mutate IN PLACE before the publish; a
        # mid-flight failure (device error, disk full) must not leave a
        # dirty resident cache that a later call would silently persist.
        try:
            if doc_id is not None:
                store.overwrite(doc_id, body, metadata)
                self._rebuild(store)
                return doc_id
            new_id = store.append(body, metadata)
            index.add(
                embed_texts([body], device=self.device),
                np.asarray([new_id], dtype=np.int64),
            )
            self._publish_index(index)
            self._publish_store(store)
            return new_id
        except BaseException:
            self._drop_caches()
            raise

    def save_many(self, records: list[dict[str, Any]]) -> list[int]:
        """Bulk insert: [{body, metadata?}, ...] embedded in one device batch.

        Validates each record like the CLI's save-input parser
        (commands.parse_save_input; reference memo_cli.py:369-400):
        required non-empty string body, optional mapping metadata."""
        if not records:
            raise ValueError("save_many requires at least one record")
        for r in records:
            if not isinstance(r, dict):
                raise ValueError("each record must be a mapping")
            body = r.get("body")
            if not isinstance(body, str) or body.strip() == "":
                raise ValueError("body must be a non-empty string")
            metadata = r.get("metadata")
            if metadata is not None and not isinstance(metadata, dict):
                raise ValueError("metadata must be a mapping when provided")
        store = self._store()
        index = self._index()
        try:
            ids = [store.append(r["body"], r.get("metadata")) for r in records]
            vectors = embed_texts([r["body"] for r in records], device=self.device)
            index.add(vectors, np.asarray(ids, dtype=np.int64))
            self._publish_index(index)
            self._publish_store(store)
            return ids
        except BaseException:
            self._drop_caches()  # in-place appends must not outlive a failure
            raise

    def metadata_mask(self, filter: str | dict[str, Any]) -> np.ndarray:
        """(max_id+1,) bool mask of records matching the filter (blank
        bodies excluded) — the device-side filter-pushdown operand for
        index.search(..., id_mask=...). MEMOIZED per (filter, records
        file state): the SAME array object comes back across calls, so
        the index families' identity-keyed masked-staging caches hit and
        repeated filtered recalls skip both the O(n) metadata scan and
        the mask re-staging."""
        active = parse_filter(filter) if isinstance(filter, str) else filter
        state = self._stat_key(self.records_path)
        key = (repr(sorted(active.items())) if active else None, state)
        hit = self._mask_memo.get(key)
        if hit is not None:
            return hit
        store = self._store()
        mask = np.zeros((max(len(store), 1),), bool)
        for doc_id, body, metadata in store:
            if is_blank_body(body or ""):
                continue
            if metadata and matches(metadata, active):
                mask[doc_id] = True
        self._mask_memo = {key: mask}  # one live filter at a time
        return mask

    def recall(
        self,
        query: str,
        k: int = 2,
        filter: str | dict[str, Any] | None = None,
        pushdown: bool = False,
    ) -> list[Hit]:
        """Ranked semantic recall with optional metadata filtering.

        pushdown=False (default) preserves CLI parity: exhaustive ranking
        + host-side post-filter. pushdown=True intersects a metadata
        bitmask INSIDE the device scan (index.search(id_mask=...)), so
        filtered recall scales with the index's fast path instead of the
        full ranking — the right mode at corpus scale. Results match the
        post-filter oracle wherever the index's search is exact (flat
        family; IVF families inherit their nprobe approximation)."""
        store = self._store()
        index = self._index()
        if index.ntotal == 0:
            return []
        active = (
            parse_filter(filter) if isinstance(filter, str) else filter
        )
        if pushdown and active is not None:
            # One fill-guarantee path for both API entry points:
            # recall_many's widening loop re-fetches past host-side misses
            # (stale ids, blanks) — a fixed k window here silently
            # under-filled on sparse masks.
            return self.recall_many([query], k, filter=filter, pushdown=True)[0]
        dists, ids = index.ranked_all(embed_text(query, device=self.device))
        hits: list[Hit] = []
        for dist, doc_id in zip(dists.tolist(), ids.tolist()):
            if len(hits) >= k:
                break
            if doc_id < 0 or doc_id >= len(store):
                continue
            metadata = store.meta_at(doc_id)
            if active is not None:
                if not metadata or not matches(metadata, active):
                    continue
            body = store.bodies[doc_id] or ""
            if is_blank_body(body):
                continue
            hits.append(Hit(doc_id, float(dist), body, metadata))
        return hits

    def recall_many(
        self,
        queries: list[str],
        k: int = 2,
        filter: str | dict[str, Any] | None = None,
        pushdown: bool = True,
    ) -> list[list[Hit]]:
        """Batched recall for serving: all queries embed in ONE device
        batch and search in ONE batched index program — the shape the
        scan kernel is built for (a Python loop over recall() would pay
        per-call dispatch and lose the corpus-outer batch amortization).
        Uses the index's fast search path (IVF families approximate by
        nprobe, like search); metadata filters push down by default."""
        if not queries:
            return []
        store = self._store()
        index = self._index()
        if index.ntotal == 0:
            return [[] for _ in queries]
        active = parse_filter(filter) if isinstance(filter, str) else filter
        id_mask = None
        # The widening loop can stop once every candidate the filter
        # could ever admit has been fetched — with a pushed-down sparse
        # mask that bound is the mask's popcount, NOT ntotal (widening
        # to ntotal on a corpus-scale index is a full-width top-k).
        limit = index.ntotal
        if active is not None and pushdown:
            id_mask = self.metadata_mask(active)
            limit = min(limit, int(id_mask.sum()))
            active = None  # pushed down — no host post-filter needed
        q = embed_texts(queries, device=self.device)
        fetch = k if active is None else min(4 * k, index.ntotal)
        fetch = max(min(fetch, limit), 1)

        def collect(d, i):
            out: list[list[Hit]] = []
            for qi in range(len(queries)):
                hits: list[Hit] = []
                for dist, doc_id in zip(d[qi].tolist(), i[qi].tolist()):
                    if len(hits) >= k:
                        break
                    if doc_id < 0 or doc_id >= len(store):
                        continue
                    metadata = store.meta_at(doc_id)
                    if active is not None and (
                        not metadata or not matches(metadata, active)
                    ):
                        continue
                    body = store.bodies[doc_id] or ""
                    if is_blank_body(body):
                        continue
                    hits.append(Hit(int(doc_id), float(dist), body, metadata))
                out.append(hits)
            return out

        # Widen through host-side misses (non-pushed-down filters,
        # blanks, stale ids): a fixed window silently under-fills k.
        while True:
            d, i = index.search(q, fetch, id_mask=id_mask)
            out = collect(d, i)
            if all(len(h) >= k for h in out) or fetch >= limit:
                return out
            fetch = min(max(fetch * 4, k), limit)

    def analyze(self, filter: str | dict[str, Any]) -> Iterator[tuple[int, dict[str, Any]]]:
        """Metadata-only scan yielding (doc_id, metadata) matches."""
        active = parse_filter(filter) if isinstance(filter, str) else filter
        for doc_id, _, metadata in self._store():
            if metadata and matches(metadata, active):
                yield doc_id, metadata

    def delete(self, doc_id: int) -> bool:
        """Soft-delete a record WITHOUT the full rebuild the CLI's
        overwrite path pays: the record body blanks out (reference
        lifecycle semantics — it stays a tombstone until `reindex`
        compacts it) and the vector leaves the index via
        index.remove_ids (in place on device-mode indexes). Returns
        False if the id does not exist or is already blank."""
        store = self._store()
        if doc_id < 0 or doc_id >= len(store):
            return False
        if is_blank_body(store.bodies[doc_id] or ""):
            return False
        index = self._index()
        # Mark the tombstone with the reference's deleted flag
        # (utils/text.is_deleted_record) so metadata scans (analyze)
        # see an explicit deletion rather than a live-looking record.
        meta = dict(store.meta_at(doc_id) or {})
        meta["deleted"] = True
        try:
            store.overwrite(doc_id, "", meta)
            index.remove_ids(np.asarray([doc_id], np.int64))
            self._publish_index(index)
            self._publish_store(store)
        except BaseException:
            self._drop_caches()
            raise
        self._mask_memo.clear()
        return True

    def reindex(self) -> int:
        """Compact (drop blank/deleted, re-sequence ids) + full rebuild.
        Returns the number of dropped records."""
        compacted, dropped = self._store().compact()
        self._rebuild(compacted)
        return dropped

    def clean(self) -> bool:
        """Remove both DB files; True if anything was removed."""
        removed = False
        for p in (self.index_path, self.records_path):
            try:
                p.unlink()
                removed = True
            except FileNotFoundError:
                pass
        self._store_cache = None
        self._index_cache = None
        self._mask_memo.clear()
        return removed

    def __len__(self) -> int:
        return sum(
            0 if is_blank_body(body) else 1 for _, body, _ in self._store()
        )
