"""Text normalization and record-lifecycle predicates.

Behavior contract (reference memo_cli.py:138-155):
  - whitespace runs collapse to a single space, ends trimmed
  - a record body is "blank" if empty after whitespace normalization
  - a record is "deleted" if metadata.deleted is truthy, OR if its body
    parses as a YAML mapping carrying a truthy `deleted` key
"""

from __future__ import annotations

import re
from typing import Any

import yaml

_WS_RUN = re.compile(r"\s+")
_TOKEN = re.compile(r"[a-zA-Z0-9_]+")


def collapse_whitespace(text: str) -> str:
    return _WS_RUN.sub(" ", text).strip()


def tokenize(text: str) -> list[str]:
    """Lowercase word tokens: runs of [a-zA-Z0-9_] (reference memo_cli.py:160)."""
    return _TOKEN.findall(collapse_whitespace(text).lower())


def is_blank_body(body: str | None) -> bool:
    return body is None or collapse_whitespace(body) == ""


def is_deleted_record(metadata: dict[str, Any] | None, body: str | None) -> bool:
    if isinstance(metadata, dict) and bool(metadata.get("deleted")):
        return True
    if body is None:
        return False
    try:
        parsed = yaml.safe_load(body)
    except Exception:
        return False
    return isinstance(parsed, dict) and bool(parsed.get("deleted"))
