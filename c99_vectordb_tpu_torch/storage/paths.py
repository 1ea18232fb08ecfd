"""Database path resolution.

Contract (reference memo_cli.py:47-58): a user-supplied
basename maps to the file pair `<base>.memo` (binary index) and
`<base>.yaml` (record store). Absolute paths are used as-is; relative
ones resolve against the invoking process's CWD.

DELIBERATE FIX over the reference (SURVEY.md §2.5 #13): the reference uses
`Path.with_suffix`, which REPLACES an existing extension — `-f my.db.v2`
silently becomes `my.db.memo`/`my.db.yaml`. Here the suffixes are appended,
so `my.db.v2` -> `my.db.v2.memo` / `my.db.v2.yaml`. Plain basenames are
unaffected.
"""

from __future__ import annotations

from pathlib import Path

INDEX_SUFFIX = ".memo"
RECORDS_SUFFIX = ".yaml"


def db_paths(base: str, user_cwd: str) -> tuple[Path, Path]:
    """Resolve a DB basename into (index_path, records_path)."""
    root = Path(base) if base.startswith("/") else Path(user_cwd) / base
    return (
        root.parent / (root.name + INDEX_SUFFIX),
        root.parent / (root.name + RECORDS_SUFFIX),
    )


def ensure_parent(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
