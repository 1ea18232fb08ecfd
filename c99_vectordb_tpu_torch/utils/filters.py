"""Metadata filter engine — YAML-flow expressions with Mongo-style operators.

Grammar and semantics contract (reference memo_cli.py:170-241;
documented SKILL.md:160-249):

  expr        := YAML flow mapping, e.g. '{source: user, priority: {$gte: 2}}'
  top level   := implicit AND of key conditions; `$and` / `$or` take lists
                 of sub-filters
  condition   := bare value (string-equality; lists match any element) or a
                 single-op mapping: $gte $lte $ne $prefix $contains

Edge semantics preserved exactly (SURVEY.md §2.5 #6/#7):
  - a missing key fails EVERY condition, including $ne
  - comparisons are numeric only when both sides are numeric, else string
  - an unknown operator or a multi-op mapping evaluates to False
  - `{}` / empty expression matches everything (records with metadata)
  - braceless input works only for single-key filters (YAML flow rules)
"""

from __future__ import annotations

from typing import Any

import yaml


def parse_filter(expr: str) -> dict[str, Any]:
    """Parse a filter expression string into a mapping; '' -> {} (match-all)."""
    parsed = yaml.safe_load(expr)
    if parsed is None:
        return {}
    if not isinstance(parsed, dict):
        raise ValueError("filter expression must parse to a YAML mapping")
    return parsed


def _order(lhs: Any, rhs: Any) -> int:
    """Three-way compare: numeric when both numeric, else string compare."""
    if isinstance(lhs, (int, float)) and isinstance(rhs, (int, float)):
        return (lhs > rhs) - (lhs < rhs)
    a, b = str(lhs), str(rhs)
    return (a > b) - (a < b)


def _string_eq(value: Any, expected: Any) -> bool:
    """Bare equality: stringified compare; list values match any element."""
    if isinstance(value, list):
        return any(str(v) == str(expected) for v in value)
    return str(value) == str(expected)


def _check(metadata: dict[str, Any], key: str, cond: Any) -> bool:
    if key not in metadata:
        return False
    value = metadata[key]

    if isinstance(cond, dict):
        if len(cond) != 1:
            return False
        op, operand = next(iter(cond.items()))
        match op:
            case "$gte":
                return _order(value, operand) >= 0
            case "$lte":
                return _order(value, operand) <= 0
            case "$ne":
                return not _string_eq(value, operand)
            case "$prefix":
                return isinstance(value, str) and value.startswith(str(operand))
            case "$contains":
                return isinstance(value, list) and any(str(v) == str(operand) for v in value)
            case _:
                return False

    return _string_eq(value, cond)


def matches(metadata: dict[str, Any], filt: dict[str, Any]) -> bool:
    """Evaluate a parsed filter against a record's metadata (implicit AND)."""
    for key, cond in filt.items():
        if key == "$and":
            if not isinstance(cond, list):
                return False
            if not all(isinstance(c, dict) and matches(metadata, c) for c in cond):
                return False
        elif key == "$or":
            if not isinstance(cond, list):
                return False
            if not any(isinstance(c, dict) and matches(metadata, c) for c in cond):
                return False
        elif not _check(metadata, key, cond):
            return False
    return True
