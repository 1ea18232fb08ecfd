"""Analytics formatting: field projection, tables, and per-key stats.

Output contract (reference memo_cli.py:529-633):
  - field lookup: `id` -> record id, `metadata` -> whole map, and both
    `metadata.X` and bare `X` -> metadata[X]
  - cells: None -> "", dict/list -> YAML flow style, else str()
  - default columns: id + first 3 sorted metadata keys across matches
  - table: cells ljust-padded to column width, joined with two spaces
  - stats: cardinality with top-4 values + "other" aggregate, then a
    numeric min/max/avg range if every value coerces to float, else a
    date range if every value parses as ISO datetime

DELIBERATE FIX over the reference (SURVEY.md §2.5 #11): the reference
crashes with an uncaught TypeError when a key mixes timezone-aware and
naive ISO datetimes (`min(dates)` on incomparable values). Here the
min/max comparison treats naive datetimes as UTC; printed output is
unchanged for homogeneous inputs.
"""

from __future__ import annotations

from collections import Counter
from datetime import datetime, timezone
from typing import Any

import yaml

Match = tuple[int, dict[str, Any]]


def parse_iso_datetime(value: Any) -> datetime | None:
    if not isinstance(value, str):
        return None
    text = value.strip()
    if not text:
        return None
    if text.endswith("Z"):
        text = text[:-1] + "+00:00"
    try:
        return datetime.fromisoformat(text)
    except ValueError:
        return None


def resolve_field(doc_id: int, metadata: dict[str, Any], field: str) -> Any:
    if field == "id":
        return doc_id
    if field == "metadata":
        return metadata
    key = field.removeprefix("metadata.")
    return metadata.get(key)


def format_cell(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, (dict, list)):
        return yaml.safe_dump(value, default_flow_style=True, sort_keys=False).strip()
    return str(value)


def default_fields(matches: list[Match]) -> list[str]:
    keys: set[str] = set()
    for _, metadata in matches:
        keys.update(str(k) for k in metadata)
    return ["id", *sorted(keys)[:3]]


def render_table(headers: list[str], rows: list[list[str]]) -> list[str]:
    """Render an ljust-padded table as a list of output lines."""
    if not headers:
        return []
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    lines = ["  ".join(h.ljust(widths[i]) for i, h in enumerate(headers))]
    for row in rows:
        lines.append("  ".join(cell.ljust(widths[i]) for i, cell in enumerate(row)))
    return lines


def _sort_key(dt: datetime) -> datetime:
    # Naive datetimes compare as UTC so mixed-awareness keys can't crash.
    return dt.replace(tzinfo=timezone.utc) if dt.tzinfo is None else dt


def render_stats(matches: list[Match], key: str) -> list[str]:
    """Render the --stats block for one metadata key as output lines."""
    values = [
        v for doc_id, metadata in matches
        if (v := resolve_field(doc_id, metadata, key)) is not None
    ]

    counts: Counter[str] = Counter(format_cell(v) for v in values)
    lines = [
        f"Key: {key}",
        f"Cardinality (distinct values): {len(counts)}",
        "Cardinality by value:",
    ]
    top = counts.most_common(4)
    for name, n in top:
        lines.append(f"  {name}: {n}")
    if len(counts) > 4:
        rest = sum(counts.values()) - sum(n for _, n in top)
        lines.append(f"  other (aggregate of {len(counts) - 4} additional values): {rest}")

    if not values:
        return lines

    numeric: list[float] = []
    for v in values:
        if isinstance(v, (int, float)):
            numeric.append(float(v))
            continue
        try:
            numeric.append(float(str(v)))
        except (ValueError, TypeError):
            numeric = []
            break
    if numeric:
        lines += [
            "Range (numeric):",
            f"  min: {min(numeric):g}",
            f"  max: {max(numeric):g}",
            f"  avg: {sum(numeric) / len(numeric):.2f}",
        ]
        return lines

    dates: list[datetime] = []
    for v in values:
        parsed = parse_iso_datetime(v)
        if parsed is None:
            dates = []
            break
        dates.append(parsed)
    if dates:
        start = min(dates, key=_sort_key)
        end = max(dates, key=_sort_key)
        lines += [
            "Range (date-like):",
            f"  start: {start.date().isoformat()}",
            f"  end:   {end.date().isoformat()}",
        ]
    return lines
