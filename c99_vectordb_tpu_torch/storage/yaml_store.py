"""YAML record store — the human-readable source of truth.

The record database is a multi-document YAML stream; each document is a
mapping with a unique non-negative integer `id`, a string `body`, and an
optional `metadata` mapping. The store densifies records into parallel
arrays of length max_id+1 (gaps become ""-body / None-metadata fillers)
and writes back in a fixed canonical shape.

Behavior contract (reference memo_cli.py:66-128):
  - load validates types, rejects duplicate ids, densifies by max id
  - canonical dump: explicit `---` document starts, key order
    (id, metadata, body), `metadata: {}` when absent, body emitted as a
    literal block scalar, unicode passed through
The index is always derivable from this file (`reindex`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import yaml

from . import snapshot
from ..utils.text import is_blank_body, is_deleted_record


class _BlockStr(str):
    """Marker type dumped as a YAML literal block scalar (`|`)."""


def _represent_block_str(dumper: yaml.Dumper, value: "_BlockStr") -> yaml.ScalarNode:
    return dumper.represent_scalar("tag:yaml.org,2002:str", str(value), style="|")


yaml.SafeDumper.add_representer(_BlockStr, _represent_block_str)

# libyaml fast path. The C parser shares PyYAML's Python-side resolvers
# and constructors, so loaded objects are identical to SafeLoader's
# (measured 8.5x faster on a 20k-record DB; load runs on EVERY verb).
# The C EMITTER, however, diverges from SafeDumper in three ways:
# (1) it \U-escapes non-BMP scalars, dropping the literal block style
#     for emoji bodies;
# (2) it \N-escapes NEL/LS/PS in plain scalars where PyYAML emits them
#     raw (and they are YAML 1.1 line breaks anyway — not round-trip
#     safe in EITHER stack);
# (3) long DOUBLE-QUOTED scalars fold with backslash continuations in
#     PyYAML but with plain breaks in libyaml.
# dump() therefore uses the C emitter only when every string is
# provably parity-safe: no control/LS/PS/non-BMP chars, no leading or
# trailing whitespace on any line (those push a body out of literal
# block into double-quoted), and no newlines outside block-scalar
# bodies. Predicate validated by a 20k-case fuzz (0 mismatches on
# 8.2k safe samples) and pinned by
# tests/test_storage.py::TestCDumperParity.
_C_LOADER = getattr(yaml, "CSafeLoader", yaml.SafeLoader)
_C_DUMPER = getattr(yaml, "CSafeDumper", None)
if _C_DUMPER is not None:
    _C_DUMPER.add_representer(_BlockStr, _represent_block_str)

_C_DUMPER_UNSAFE = re.compile(
    "[\\x00-\\x09\\x0b-\\x1f\\x7f-\\x9f\\u2028\\u2029\\U00010000-\\U0010ffff]"
    "|[ \\t]\\n|[ \\t]$|^[ \\t]"
)


def _c_dumpable(value, is_block: bool = False) -> bool:
    """True if the C emitter provably byte-matches SafeDumper on value."""
    if isinstance(value, str):
        if _C_DUMPER_UNSAFE.search(value):
            return False
        return is_block or "\n" not in value
    if isinstance(value, dict):
        return all(_c_dumpable(k) and _c_dumpable(v) for k, v in value.items())
    if isinstance(value, (list, tuple, set)):
        return all(_c_dumpable(v) for v in value)
    return True


def block_str(value: str) -> str:
    """Wrap a string so SafeDumper emits it as a literal block scalar."""
    return _BlockStr(value)


@dataclass
class RecordStore:
    """Densified in-memory view of the record DB.

    bodies[i] / metas[i] are record id i's body and metadata; gap fillers
    are "" / None and are invisible to recall and purged by compact().
    """

    bodies: list[str] = field(default_factory=list)
    metas: list[dict[str, Any] | None] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.bodies)

    def __iter__(self) -> Iterator[tuple[int, str, dict[str, Any] | None]]:
        for i, body in enumerate(self.bodies):
            yield i, body, self.metas[i] if i < len(self.metas) else None

    # -- loading ---------------------------------------------------------

    @classmethod
    def load(cls, path: Path, cache: bool = True) -> "RecordStore":
        """Parse and densify the record DB; raises ValueError on bad shape.

        With cache=True (default) a hash-matched `<db>.yaml.snap`
        sidecar (storage/snapshot.py) skips the YAML parse entirely —
        ~20x at corpus scale — and a parse that had to run refreshes
        the snapshot for next time. The YAML stays the source of truth:
        the snapshot is derived and self-invalidating by content hash.
        """
        if not path.exists():
            return cls()
        text = path.read_text(encoding="utf-8")
        if cache:
            cached = snapshot.read_snapshot(snapshot.snap_path(path), text)
            if cached is not None:
                return cls(bodies=cached[0], metas=cached[1])
        docs = [d for d in yaml.load_all(text, Loader=_C_LOADER) if d is not None]
        if not docs:
            return cls()

        seen: set[int] = set()
        records: list[tuple[int, str, dict[str, Any] | None]] = []
        for doc in docs:
            if not isinstance(doc, dict):
                raise ValueError("database YAML entries must be mappings")
            if "id" not in doc or "body" not in doc:
                raise ValueError("database YAML entries require 'id' and 'body'")
            rid, body, meta = doc["id"], doc["body"], doc.get("metadata")
            # bool passes as int (True -> id 1): parity with the reference's
            # isinstance(id, int) check (memo_cli.py:79-100; ADVICE round 1).
            if not isinstance(rid, int) or rid < 0:
                raise ValueError("database YAML entry 'id' must be a non-negative integer")
            rid = int(rid)
            if rid in seen:
                raise ValueError(f"database YAML has duplicate id {rid}")
            if not isinstance(body, str):
                raise ValueError(f"database YAML entry body for id {rid} must be a string")
            if meta is not None and not isinstance(meta, dict):
                raise ValueError(f"database YAML entry metadata for id {rid} must be a mapping")
            seen.add(rid)
            records.append((rid, body, meta))

        size = max(rid for rid, _, _ in records) + 1
        store = cls(bodies=[""] * size, metas=[None] * size)
        for rid, body, meta in records:
            store.bodies[rid] = body
            store.metas[rid] = meta
        if cache:
            store._refresh_snapshot(path, text)
        return store

    def _refresh_snapshot(self, path: Path, text: str) -> None:
        """Best-effort sidecar refresh; small DBs drop the sidecar."""
        sp = snapshot.snap_path(path)
        try:
            if len(text) >= snapshot.SNAP_THRESHOLD_BYTES:
                snapshot.write_snapshot(sp, text, self.bodies, self.metas)
            else:
                sp.unlink(missing_ok=True)
        except (snapshot.Unsnapshotable, OSError):
            pass

    # -- saving ----------------------------------------------------------

    def dump(self) -> str:
        """Serialize to the canonical multi-document YAML shape."""
        docs: list[dict[str, Any]] = []
        for rid, body, meta in self:
            docs.append(
                {
                    "id": rid,
                    "metadata": meta if meta is not None else {},
                    "body": block_str(body),
                }
            )
        dumper = yaml.SafeDumper
        if _C_DUMPER is not None and all(
            _c_dumpable(d["metadata"]) and _c_dumpable(str(d["body"]), is_block=True)
            for d in docs
        ):
            dumper = _C_DUMPER
        return yaml.dump_all(
            docs,
            Dumper=dumper,
            explicit_start=True,
            sort_keys=False,
            allow_unicode=True,
        )

    def save(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        # Atomic publish (write-then-rename) so a crash mid-save can't
        # leave a truncated record DB — fixes the reference's torn-write
        # window (SURVEY.md §2.5 #14).
        text = self.dump()
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_text(text, encoding="utf-8")
        tmp.replace(path)
        self._refresh_snapshot(path, text)

    # -- mutation --------------------------------------------------------

    def meta_at(self, rid: int) -> dict[str, Any] | None:
        return self.metas[rid] if 0 <= rid < len(self.metas) else None

    def append(self, body: str, meta: dict[str, Any] | None) -> int:
        rid = len(self.bodies)
        self.bodies.append(body)
        self.metas.append(meta)
        return rid

    def overwrite(self, rid: int, body: str, meta: dict[str, Any] | None) -> None:
        self.bodies[rid] = body
        self.metas[rid] = meta

    def compact(self) -> tuple["RecordStore", int]:
        """Drop blank/deleted records and RE-SEQUENCE ids (reindex semantics).

        Returns (compacted_store, dropped_count). Matches the reference's
        reindex-time compaction (memo_cli.py:343-353; SURVEY.md §2.5 #3/#4):
        ids are only stable until the next reindex.
        """
        out = RecordStore()
        dropped = 0
        for _, body, meta in self:
            if is_blank_body(body) or is_deleted_record(meta, body):
                dropped += 1
                continue
            out.append(body, meta)
        return out, dropped
